"""Hand-written CUDA kernels and their plain PyTorch versions.

Each module holds one kernel's wrapper (input checks, dispatch, launch
check, launch counter) beside its plain torch version: a CPU tensor goes to
the plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

KERNEL_SOURCES = ("tile_stats", "hr_tail", "relax_step")


def _modules():
    from floodsr_tpu_torch.ops.kernels import hr_tail, relax_step, tile_stats

    return {"tile_stats": tile_stats, "hr_tail": hr_tail, "relax_step": relax_step}


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for mod in _modules().values():
        mod.launches = 0
        for route in getattr(mod, "route_launches", {}):
            mod.route_launches[route] = 0


def launch_counts() -> dict[str, int]:
    """``{kernel name: launches since the last reset}``."""
    return {name: int(mod.launches) for name, mod in _modules().items()}


def route_counts() -> dict[str, dict[str, int]]:
    """``{kernel name: {route: launches since the last reset}}`` for the
    kernels with more than one route on the card."""
    return {
        name: dict(mod.route_launches)
        for name, mod in _modules().items() if hasattr(mod, "route_launches")
    }
