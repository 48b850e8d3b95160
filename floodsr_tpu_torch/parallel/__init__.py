"""Host→device streaming for the port; the device mesh comes with the multi-GPU slice."""

from floodsr_tpu_torch.parallel.streaming import prefetch_to_device

__all__ = ["prefetch_to_device"]
