"""esme_tpu_torch — the PyTorch/CUDA port of the JAX package ``esme_tpu``.

Packed ("varlen") ESM2 inference and masked-LM training in PyTorch,
with hand-written CUDA kernels for Hopper (``sm_90a``) where the JAX
package had Pallas kernels: the segment-flash attention forward and
backward, RoPE, the head relayouts and the attention probes of
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
from .data import (FastaTokenDataset, MaskedFastaTokenDataset, PackedBatch,
                   TokenSizeBatchSampler)
from .fasta import Fasta
from .models.config import (ESMConfig, config_for, esm1b_config,
                            esm1v_config, esm2_config, esmc_config)
from .models.esm import ESM, ESM2

__version__ = '0.1.0'
