"""Multi-process parallelism of the port (counterpart of
``esme_tpu/parallel``): the process group and named device mesh
(:mod:`.mesh`), context parallelism (:mod:`.context`) and FSDP
parameter sharding (:mod:`.fsdp`)."""

from .mesh import initialize_distributed, make_mesh
from .context import (context_parallel_log_prob, forward_flat_cp,
                      make_kv_gather)
from .fsdp import (fsdp_partition_specs, make_layer_gather,
                   make_outer_gather, shard_params)
