"""The device mesh and host→device streaming of the port."""

from floodsr_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    param_sharding_rules,
    replicated_sharding,
)
from floodsr_tpu_torch.parallel.streaming import prefetch_to_device

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "param_sharding_rules",
    "prefetch_to_device",
]
