"""Multi-process parallelism of the port (counterpart of
``esme_tpu/parallel``): the process group and named device mesh
(:mod:`.mesh`) and context parallelism for inference (:mod:`.context`).
FSDP comes with ROADMAP.md Queue 1, item 24."""

from .mesh import initialize_distributed, make_mesh
from .context import (context_parallel_log_prob, forward_flat_cp,
                      make_kv_gather)
