"""Training loops: masked-LM pretraining (fine-tuning trainers come
with the fine-tuning slice)."""

from .trainer import MaskedPLM
