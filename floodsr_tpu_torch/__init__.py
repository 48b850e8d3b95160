"""floodsr-tpu-torch: the PyTorch/CUDA port of floodsr-tpu.

A second package beside the JAX reference (``floodsr_tpu``): the same ToHR
surface (``tohr``, the ``models.json`` registry, per-model workers, the
engine seam) with the compute path in PyTorch and the TPU's Pallas kernels
rewritten as hand-written CUDA C++ for Hopper (``csrc/``, built with
``nvcc`` at first use). Entry points run on the GPU unless the caller
passes ``device="cpu"``.
"""

__version__ = "1.0.0"
