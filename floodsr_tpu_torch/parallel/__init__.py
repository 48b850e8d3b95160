"""The device mesh of the port (``mesh``) and host→device streaming (``streaming``)."""

from floodsr_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    param_sharding_rules,
    replicated_sharding,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "param_sharding_rules",
]
