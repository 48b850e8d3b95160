"""Per-tile DEM normalization stats: the ``tile_stats`` CUDA kernel (K2).

Replaces the TPU kernel ``floodsr_tpu/ops/pallas/tile_stats.py::
dem_tile_stats_pallas`` (pallas_call at :85). For each ``[H, W]`` tile of a
``[N, H, W]`` f32 stack: clamp to >= 0, min and max, 30 steps of value-domain
bisection for the order statistics around ``pct_clip`` (``np.nanpercentile``
linear interpolation), emitted as ``[p_clip, min(lo, p), min(hi, p)]``.

Source: ``floodsr_tpu_torch/csrc/tile_stats.cu`` (its header says what bounds
it on the card and what its design does about that). :func:`tile_stats`
dispatches a CPU tensor to :func:`tile_stats_reference`, the same bisection in
plain torch, which the kernel equals bit for bit; a CUDA tensor launches the
kernel or raises.

The kernel does not bisect over the data: it selects the two exact order
statistics and replays the bisection on them as scalar arithmetic, which gives
the same bits (:func:`tile_stats_by_selection` states that algorithm in plain
torch, for the tests; nothing on the main path calls it). Two routes on the
card, chosen from the tile's size and alignment alone (:func:`one_read_ok`):
one read of the tile into the shared memory of a cluster of 8 blocks, or the
same passes streaming from device memory. Each counts its launches in
:data:`route_launches`.
"""

from __future__ import annotations

import ctypes
import math

import torch

BISECT_ITERS = 30  # bracket shrinks to (range / 2^30), as on the TPU

#: kernel launches since the last reset (ops.kernels.reset_launch_counts)
launches = 0
#: the same launches by route
route_launches = {"one_read": 0, "stream": 0}

_MAX_COUNT = 2**31 - 1  # per-tile element count held in 32-bit block counters
CLUSTER_BLOCKS = 8  # blocks that share one tile on the one-read route
MAX_SLICE_BYTES = 192 * 1024  # a block's eighth of a tile, beside 33 KB of histograms


def percentile_ranks(count: int, pct_clip: float) -> tuple[int, int, float]:
    """``(k, min(k+1, count-1), frac)`` of ``np.nanpercentile``'s linear rule."""
    target = (float(pct_clip) / 100.0) * (count - 1)
    k = math.floor(target)
    return int(k), int(min(k + 1, count - 1)), float(target - k)


def tile_stats_reference(dem: torch.Tensor, pct_clip: float) -> torch.Tensor:
    """Plain torch version: the kernel's bisection, step for step. ``[N, 3]``."""
    n = dem.shape[0]
    flat = dem.reshape(n, -1).to(torch.float32)
    x = torch.where(flat > 0, flat, torch.zeros_like(flat))
    lo0 = x.amin(dim=1)
    hi0 = x.amax(dim=1)
    k, k1, frac = percentile_ranks(x.shape[1], pct_clip)
    want = torch.tensor([k + 1, k1 + 1], dtype=torch.int64, device=x.device)
    half = torch.tensor(0.5, dtype=torch.float32, device=x.device)
    lo = torch.stack([lo0, lo0], dim=1)
    hi = torch.stack([hi0, hi0], dim=1)
    for _ in range(BISECT_ITERS):
        mid = half * (lo + hi)
        le = (x[:, :, None] <= mid[:, None, :]).sum(dim=1)
        hit = le >= want
        lo = torch.where(hit, lo, mid)
        hi = torch.where(hit, mid, hi)
    a, b = hi[:, 0], hi[:, 1]
    p = a + torch.tensor(frac, dtype=torch.float32, device=x.device) * (b - a)
    return torch.stack([p, torch.minimum(lo0, p), torch.minimum(hi0, p)], dim=1)


def tile_stats_by_selection(dem: torch.Tensor, pct_clip: float) -> torch.Tensor:
    """The kernel's algorithm in plain torch: select, then replay. ``[N, 3]``.

    The bisection of :func:`tile_stats_reference` reads the data only through
    ``count(x <= mid) >= rank + 1``, which holds exactly when the ``rank``-th
    smallest value is ``<= mid``. So the two order statistics are taken from a
    sort and the 30 steps run on them alone, with the same f32 midpoints,
    brackets and lerp: equal to the reference bit for bit. For the tests.
    """
    n = dem.shape[0]
    flat = dem.reshape(n, -1).to(torch.float32)
    x = torch.where(flat > 0, flat, torch.zeros_like(flat))
    lo0 = x.amin(dim=1)
    hi0 = x.amax(dim=1)
    k, k1, frac = percentile_ranks(x.shape[1], pct_clip)
    ordered = torch.sort(x, dim=1).values
    s = torch.stack([ordered[:, k], ordered[:, k1]], dim=1)
    half = torch.tensor(0.5, dtype=torch.float32, device=x.device)
    lo = torch.stack([lo0, lo0], dim=1)
    hi = torch.stack([hi0, hi0], dim=1)
    for _ in range(BISECT_ITERS):
        mid = half * (lo + hi)
        hit = s <= mid
        lo = torch.where(hit, lo, mid)
        hi = torch.where(hit, mid, hi)
    a, b = hi[:, 0], hi[:, 1]
    p = a + torch.tensor(frac, dtype=torch.float32, device=x.device) * (b - a)
    return torch.stack([p, torch.minimum(lo0, p), torch.minimum(hi0, p)], dim=1)


def one_read_ok(count: int, data_ptr: int) -> bool:
    """Whether a tile of ``count`` elements takes the one-read (cluster) route:
    it splits into eight slices of whole 16-byte words that start on 16-byte
    boundaries and fit a block's shared memory."""
    return (
        count % (4 * CLUSTER_BLOCKS) == 0
        and (count // CLUSTER_BLOCKS) * 4 <= MAX_SLICE_BYTES
        and data_ptr % 16 == 0
    )


def _lib():
    from floodsr_tpu_torch.ops.kernels import _build

    lib = _build.load("tile_stats")
    fn = lib.tile_stats_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p,
        ]
    return fn


def tile_stats_cuda(dem: torch.Tensor, pct_clip: float) -> torch.Tensor:
    """Launch the CUDA kernel on a ``[N, H, W]`` f32 contiguous CUDA tensor."""
    global launches
    from floodsr_tpu_torch.ops.kernels import _build

    if dem.device.type != "cuda":
        raise ValueError(f"tile_stats_cuda needs a CUDA tensor; got {dem.device}")
    if dem.ndim != 3:
        raise ValueError(f"tile_stats expects [N, H, W]; got {tuple(dem.shape)}")
    if dem.dtype != torch.float32:
        raise TypeError(f"tile_stats expects float32; got {dem.dtype}")
    if not dem.is_contiguous():
        raise ValueError("tile_stats expects a contiguous tensor")
    n, h, w = (int(v) for v in dem.shape)
    count = h * w
    if count <= 0 or count > _MAX_COUNT:
        raise ValueError(f"tile of {count} elements is outside (0, {_MAX_COUNT}]")
    if n * CLUSTER_BLOCKS >= 2**31:
        raise ValueError(f"{n} tiles exceed the kernel's grid")
    if not 0.0 < float(pct_clip) <= 100.0:
        raise ValueError(f"pct_clip must be in (0, 100]; got {pct_clip}")
    k, k1, frac = percentile_ranks(count, pct_clip)
    out = torch.empty((n, 3), dtype=torch.float32, device=dem.device)
    route = "one_read" if one_read_ok(count, dem.data_ptr()) else "stream"
    fn = _lib()
    with torch.cuda.device(dem.device):
        rc = fn(
            dem.data_ptr(), out.data_ptr(), n, count, k, k1,
            ctypes.c_float(frac), int(route == "one_read"),
            _build.current_stream_ptr(dem.device),
        )
    _build.check(rc, f"tile_stats ({route} route)")
    launches += 1
    route_launches[route] += 1
    return out


def tile_stats(dem: torch.Tensor, pct_clip: float) -> torch.Tensor:
    """``[N, H, W]`` → ``[N, 3]`` stats: the kernel on CUDA, the plain version on CPU."""
    if dem.ndim != 3:
        raise ValueError(f"tile_stats expects [N, H, W]; got {tuple(dem.shape)}")
    if dem.device.type == "cuda":
        return tile_stats_cuda(dem, pct_clip)
    if dem.device.type != "cpu":
        raise ValueError(f"unsupported device {dem.device}")
    return tile_stats_reference(dem, pct_clip)
