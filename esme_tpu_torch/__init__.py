"""esme_tpu_torch — the PyTorch/CUDA port of the JAX package ``esme_tpu``.

Packed ("varlen") ESM inference, variant-effect scoring
(:mod:`esme_tpu_torch.variant`, ``python -m esme_tpu_torch.cli``),
masked-LM training fed from indexed FASTA (:mod:`esme_tpu_torch.data`,
the C++ reader of :mod:`esme_tpu_torch.native`), position extension
(:mod:`esme_tpu_torch.extend`) and LoRA fine-tuning
with pooled heads (:mod:`esme_tpu_torch.lora`,
:mod:`esme_tpu_torch.models.heads`, the trainers of
:mod:`esme_tpu_torch.train`) in PyTorch, for every family of the JAX
package (ESM2, ESM1b, ESM1v, ESMC), and
context-parallel inference over several processes
(:mod:`esme_tpu_torch.parallel`),
with hand-written CUDA kernels for Hopper (``sm_90a``) where the JAX
package had Pallas kernels: the segment-flash attention forward and
backward, its rectangular forward, RoPE, the head relayouts and the
attention probes of
:mod:`esme_tpu_torch.tools` (``csrc/``, built at first use by
:mod:`esme_tpu_torch._build`).
Everything else is plain PyTorch. The JAX package ``esme_tpu`` is the
reference the port is held to; the port imports nothing of it.

Entry points run on ``device='cuda'`` unless the caller asks for the
CPU, where every kernel runs through its plain PyTorch version.
"""

from .alphabet import (Alphabet, Alphabet3, mask_tokens, pack_tokens,
                       pad_tokens, padding_mask, tokenize, tokenize_unpad,
                       token_to_str)
from .data import (FastaDataset, FastaTokenDataset, MaskedFastaDataset,
                   MaskedFastaDataModule, MaskedFastaTokenDataset,
                   MaskedFastaTokenDataModule, LabeledDataset, PackedBatch,
                   Prefetcher, TokenSizeBatchSampler, balance_binary)
from .fasta import Fasta, read_fai, write_fai
from .logger import MetricLogger, read_log
from .models.config import (ESMConfig, config_for, esm1b_config,
                            esm1v_config, esm2_config, esmc_config)
from .models.esm import ESM, ESM1b, ESM1v, ESM2, ESMC

__version__ = '0.1.0'
