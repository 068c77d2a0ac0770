"""Training loops: masked-LM training on one device and over a mesh, the
fine-tuning trainers with a pooled head, the float8 Adam the MLM trainers
take as ``optimizer=adam8bit(...)``, and the checkpoint manager."""

from .optim import Adam8bit, adam8bit
from .trainer import (ClassificationTrainer, MaskedPLM, RegressionTrainer,
                      TrainState)
from .checkpoint import CheckpointManager
from .distributed import ShardedMaskedPLM, stack_batches
