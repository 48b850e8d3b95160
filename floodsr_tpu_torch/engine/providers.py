"""Runtime diagnostics for the ``doctor`` command.

Port of the JAX package's ``engine/providers.py`` for the PyTorch/CUDA stack:
the torch version and its CUDA runtime, whether CUDA is available, the visible
devices, the raster-I/O backend state, and the state of the hand-written
kernels' build (``nvcc`` found, libraries present, the bf16 route of ``hr_tail``
among them). A diagnosis touches no
device beyond asking its properties and builds nothing.
"""

from __future__ import annotations

import importlib.metadata as md


def get_torch_info() -> dict[str, object]:
    """PyTorch installation, CUDA runtime, and device diagnostics."""
    try:
        import torch
    except ImportError:  # pragma: no cover - torch is a hard dependency
        return {
            "installed": False, "version": None, "cuda_version": None,
            "cuda_available": False, "devices": [],
        }
    info: dict[str, object] = {
        "installed": True,
        "version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cuda_available": False,
        "devices": [],
    }
    try:
        info["cuda_available"] = bool(torch.cuda.is_available())
        if info["cuda_available"]:
            devices = []
            for index in range(torch.cuda.device_count()):
                props = torch.cuda.get_device_properties(index)
                devices.append({
                    "name": props.name,
                    "capability": f"{props.major}.{props.minor}",
                    "total_memory_bytes": int(props.total_memory),
                })
            info["devices"] = devices
    except Exception as err:  # a failed CUDA initialisation still yields diagnostics
        info["cuda_available"] = f"error: {err}"
    return info


def get_io_info() -> dict[str, object]:
    """Raster I/O backend diagnostics (self-contained codec + native library)."""
    from floodsr_tpu_torch.io import native

    return {
        "backend": "floodsr-tpu-geotiff",
        "native_codec": native.available(),
    }


def get_kernel_info() -> dict[str, object]:
    """Whether ``nvcc`` is found, which kernel libraries are built, and whether
    the built ``hr_tail`` library holds the bf16 route (a library built from an
    older source does not; it is rebuilt at its next use)."""
    from floodsr_tpu_torch.ops.kernels import KERNEL_SOURCES, _build

    try:
        nvcc = _build.nvcc_path()
    except RuntimeError:
        nvcc = None
    hr_tail_lib = _build.library_path("hr_tail")
    return {
        "nvcc": nvcc,
        "built": [n for n in KERNEL_SOURCES if _build.library_path(n).exists()],
        "hr_tail_bf16": (
            hr_tail_lib.exists() and b"hr_tail_bf16_launch" in hr_tail_lib.read_bytes()
        ),
    }


def get_optional_package_info(name: str) -> dict[str, object]:
    """Presence/version info for an optional dependency."""
    try:
        version = md.version(name)
    except md.PackageNotFoundError:
        return {"installed": False, "version": None}
    return {"installed": True, "version": version}


def doctor_info() -> dict[str, object]:
    """The `doctor` diagnostics as one dict (CLI key=value; daemon JSON)."""
    torch_info = get_torch_info()
    io_info = get_io_info()
    kernel_info = get_kernel_info()
    devices = torch_info["devices"]
    return {
        "torch_installed": torch_info["installed"],
        "torch_version": torch_info["version"],
        "cuda_version": torch_info["cuda_version"],
        "cuda_available": torch_info["cuda_available"],
        "cuda_devices": [d["name"] for d in devices],
        "cuda_capabilities": [d["capability"] for d in devices],
        "cuda_total_memory_bytes": [d["total_memory_bytes"] for d in devices],
        "nvcc_found": kernel_info["nvcc"] is not None,
        "kernels_built": kernel_info["built"],
        "hr_tail_bf16_built": kernel_info["hr_tail_bf16"],
        "io_backend": io_info["backend"],
        "io_native_codec": io_info["native_codec"],
    }
