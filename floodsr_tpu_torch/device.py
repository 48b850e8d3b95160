"""Device selection for the port's entry points.

Entry points run on the GPU by default. When CUDA is absent they raise
instead of carrying on quietly on the CPU; the CPU runs only when the caller
asks for it (``device="cpu"``), as the CPU test suite does.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: "str | torch.device | None" = "cuda") -> torch.device:
    """The ``torch.device`` to run on; raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: floodsr_tpu_torch runs on the GPU by "
                "default; pass device='cpu' to run on the CPU explicitly"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def set_strict_f32() -> None:
    """Full float32 convolutions and matmuls on the GPU (no TF32).

    cuDNN runs float32 convolutions in TF32 by default, about three decimal
    digits: the same silent precision loss the JAX package guards against on
    the TPU by pinning the convolution precision. Both switches are set off
    explicitly, so every f32 stage of every precision policy computes in full
    f32; a bf16 stage allows TF32 for its own products only, where it is exact,
    and restores these settings (``nn.resunet.bf16_products``). A bf16 matmul,
    should one run, accumulates in f32 as the policies assume: the reduced
    precision reduction is off too.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def card_info(device: "str | torch.device") -> dict:
    """``{"name", "power_limit"}`` of the card behind ``device``, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (the limit with its unit, e.g. ``"700.00 W"``); for the CPU, the
    device's name and ``None``.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"name": str(dev), "power_limit": None}
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    name, limit = lines[min(dev.index, len(lines) - 1)].rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}
