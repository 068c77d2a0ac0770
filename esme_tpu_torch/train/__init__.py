"""Training loops: masked-LM pretraining on one device and over a mesh
(fine-tuning trainers come with the fine-tuning slice)."""

from .trainer import MaskedPLM
from .distributed import ShardedMaskedPLM, stack_batches
