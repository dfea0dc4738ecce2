"""Training and serving across GPUs (counterpart of `f_lite_tpu/parallel/`):
the process group and the `("dp", "pp", "fsdp", "tp")` mesh (`mesh.py`),
tensor and sequence parallelism of the DiT (`tensor.py`), FSDP2 sharding
of the DiT and the batch and state across ranks (`sharding.py`), and
pipeline parallelism (`pipeline.py`, imported from there: it builds on
`models.dit`, which imports this package)."""

from f_lite_tpu_torch.parallel.mesh import (
    create_mesh,
    init_distributed,
    process_replica_info,
)
from f_lite_tpu_torch.parallel.sharding import (
    copy_full_,
    full_state_dict,
    load_full_state_dict,
    local_rows,
    shard_dit,
)
from f_lite_tpu_torch.parallel.tensor import parallelize_dit

__all__ = ["copy_full_", "create_mesh", "full_state_dict", "init_distributed",
           "load_full_state_dict", "local_rows", "parallelize_dit",
           "process_replica_info", "shard_dit"]
