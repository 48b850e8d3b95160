"""One least-cost relaxation step: the ``relax_step`` CUDA kernel (K3).

Replaces the TPU kernel ``floodsr_tpu/ops/pallas/costgrow_stencil.py::
relax_step_pallas`` (pallas_call at :141). One 8-neighbour Bellman-Ford
relaxation of ``(dist, value)`` over an ``[H, W]`` f32 grid with the
MCP-geometric edge weight ``length * 0.5 * (cost[u] + cost[v])`` (length 1 or
sqrt 2): a candidate strictly below the best so far replaces it and carries
its neighbour's value. Neighbours are tried in the TPU kernel's order (W, E,
N, NW, NE, S, SW, SE), which decides whose value an exact tie keeps. The step
is Jacobi: it reads the old arrays and writes new ones.

Source: ``floodsr_tpu_torch/csrc/relax_step.cu`` (its header says what bounds
it on the card and what its design does about that). :func:`relax_step`
dispatches CPU tensors to :func:`relax_step_reference`, the same arithmetic in
plain torch, which the kernel equals bit for bit (NaN payloads aside); CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

#: ``length * 0.5`` folded to one f32 constant per step length, as the TPU
#: kernel's trace folds it; the f32 value is exact in a Python float.
K_ORTH = float(np.float32(1.0 * 0.5))
K_DIAG = float(np.float32(math.sqrt(2.0) * 0.5))

#: ``(dy, dx, k)`` of each neighbour, in the TPU kernel's order.
NEIGHBORS = (
    (0, -1, K_ORTH), (0, 1, K_ORTH),
    (-1, 0, K_ORTH), (-1, -1, K_DIAG), (-1, 1, K_DIAG),
    (1, 0, K_ORTH), (1, -1, K_DIAG), (1, 1, K_DIAG),
)

#: kernel launches since the last reset (ops.kernels.reset_launch_counts)
launches = 0

_MAX_ROWS = 65535 * 8  # gridDim.y limit times the tile's rows
_MAX_CELLS = 2**31 - 1


def shifted_views(h: int, w: int, dy: int, dx: int) -> tuple[tuple, tuple]:
    """``(dst, src)`` index pairs: ``src`` is ``dst``'s neighbour at ``(dy, dx)``.

    ``dst`` covers exactly the cells whose neighbour lies inside the grid.
    """
    dst = np.s_[max(0, -dy) : h - max(0, dy), max(0, -dx) : w - max(0, dx)]
    src = np.s_[max(0, dy) : h - max(0, -dy), max(0, dx) : w - max(0, -dx)]
    return dst, src


def relax_step_reference(
    dist: torch.Tensor, value: torch.Tensor, cost: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: the kernel's candidates, order and strict ``<``."""
    h, w = dist.shape
    best_d = dist.clone()
    best_v = value.clone()
    for dy, dx, k in NEIGHBORS:
        dst, src = shifted_views(h, w, dy, dx)
        cand = dist[src] + k * (cost[src] + cost[dst])
        take = cand < best_d[dst]
        best_d[dst] = torch.where(take, cand, best_d[dst])
        best_v[dst] = torch.where(take, value[src], best_v[dst])
    return best_d, best_v


def _lib():
    from floodsr_tpu_torch.ops.kernels import _build

    fn = _build.load("relax_step").relax_step_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p,
        ]
    return fn


def _check_grid(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"relax_step: {name} is on {t.device}, dist on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"relax_step: {name} has shape {tuple(t.shape)}, dist {tuple(shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"relax_step expects float32; {name} is {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"relax_step expects contiguous tensors; {name} is not")


def relax_step_cuda(
    dist: torch.Tensor, value: torch.Tensor, cost: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on ``[H, W]`` f32 contiguous CUDA tensors.

    The step is not in place: it writes two new tensors and leaves its inputs
    alone.
    """
    global launches
    from floodsr_tpu_torch.ops.kernels import _build

    if dist.device.type != "cuda":
        raise ValueError(f"relax_step_cuda needs CUDA tensors; got {dist.device}")
    if dist.ndim != 2:
        raise ValueError(f"relax_step expects [H, W]; got {tuple(dist.shape)}")
    h, w = (int(v) for v in dist.shape)
    if h > _MAX_ROWS or h * w > _MAX_CELLS:
        raise ValueError(f"grid {h}x{w} exceeds the kernel's launch limits")
    for name, t in (("dist", dist), ("value", value), ("cost", cost)):
        _check_grid(name, t, (h, w), dist.device)
    dist_out, value_out = torch.empty_like(dist), torch.empty_like(value)
    fn = _lib()
    with torch.cuda.device(dist.device):
        rc = fn(
            dist.data_ptr(), value.data_ptr(), cost.data_ptr(),
            dist_out.data_ptr(), value_out.data_ptr(), h, w,
            ctypes.c_float(K_ORTH), ctypes.c_float(K_DIAG),
            _build.current_stream_ptr(dist.device),
        )
    _build.check(rc, "relax_step")
    launches += 1
    return dist_out, value_out


def relax_step(
    dist: torch.Tensor, value: torch.Tensor, cost: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dist, value, cost)`` → ``(dist', value')``: the kernel on CUDA, the plain
    version on CPU."""
    if dist.ndim != 2:
        raise ValueError(f"relax_step expects [H, W]; got {tuple(dist.shape)}")
    if dist.device.type == "cuda":
        return relax_step_cuda(dist, value, cost)
    if dist.device.type != "cpu":
        raise ValueError(f"unsupported device {dist.device}")
    return relax_step_reference(dist, value, cost)
