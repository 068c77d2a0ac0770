"""Training loops: masked-LM pretraining on one device and over a mesh
(fine-tuning trainers come with the fine-tuning slice), and the float8
Adam they take as ``optimizer=adam8bit(...)``."""

from .optim import Adam8bit, adam8bit
from .trainer import MaskedPLM
from .distributed import ShardedMaskedPLM, stack_batches
