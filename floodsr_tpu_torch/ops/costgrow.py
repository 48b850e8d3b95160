"""CostGrow primitives: least-cost distance/fill and connectivity filtering.

Port of the JAX package's ``ops/costgrow.py``. The reference's future CostGrow
model (reference: ``others/CostGrow_inline.ipynb`` cells 6, 14-22) uses
``skimage.graph.MCP_Geometric`` — a sequential Cython Dijkstra — for three
primitives:

- ``mcp_distance``: least-cost distance from seed cells over a domain;
- ``mcp_fill``: propagate each seed's VALUE along its least-cost paths
  (geometric edge weight: step length × mean of endpoint costs, 8-connected);
- ``keep_components_connected_to_anchor``: drop wet blobs disconnected from
  anchor cells.

All three are Bellman-Ford-style wavefront relaxations run until fixpoint on
the tensors' device. The (distance, value) relaxation goes through
:func:`floodsr_tpu_torch.ops.kernels.relax_step.relax_step`: the hand-written
CUDA kernel on CUDA tensors, its plain torch version on CPU tensors. The grid
distance and the component filter are plain torch ops, as the JAX package
leaves them to XLA. A sequential-Dijkstra numpy twin is the correctness
oracle (exact same edge-weight convention).

PyTorch runs eagerly, so every convergence check is a device-to-host read;
``relaxations_per_check`` relaxations run between two checks, in one call of
the kernel, which also says whether any distance fell. Relaxations at a
fixpoint change nothing, so the results do not depend on it.

:func:`traced_solve` makes one solve a span of the open request
(:mod:`floodsr_tpu_torch.tracing`), with its counts as the span's counters.
"""

from __future__ import annotations

import heapq
import math
import time
from contextlib import contextmanager

import numpy as np
import torch

import floodsr_tpu_torch.ops.kernels.relax_step as k3
from floodsr_tpu_torch import tracing
from floodsr_tpu_torch.ops.kernels.relax_step import relax_step, shifted_views

_SQRT2 = math.sqrt(2.0)
# 8-connected neighborhood: (dy, dx, step length)
_NEIGHBORS = [
    (-1, -1, _SQRT2), (-1, 0, 1.0), (-1, 1, _SQRT2),
    (0, -1, 1.0), (0, 1, 1.0),
    (1, -1, _SQRT2), (1, 0, 1.0), (1, 1, _SQRT2),
]


def mcp_fill(
    seed_values: torch.Tensor,
    seed_mask: torch.Tensor,
    cost_surface: torch.Tensor,
    domain_mask: torch.Tensor,
    target_mask: torch.Tensor | None = None,
    max_iters: int | None = None,
    relaxations_per_check: int = 8,
    stats: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Propagate seed values along least-cost paths; returns (filled, costs).

    Matches ``mcp_fill_fast`` semantics (reference notebook cell 6): the
    filled array keeps seed values on seeds, copies the source seed's value
    onto reachable target cells, and leaves everything else untouched.

    All tensors lie on one device; CUDA tensors relax through the CUDA
    kernel, CPU tensors through its plain version. ``stats``, when given, is
    filled with the solve's ``relaxations``, ``checks`` (convergence checks,
    each a device-to-host read), ``k3_launches`` (kernel launches, a
    difference of the process-wide ``relax_step.launches``: one solve at a
    time) and ``seconds``.
    """
    t0 = time.perf_counter()
    if relaxations_per_check < 1:
        raise ValueError(f"relaxations_per_check must be >= 1; got {relaxations_per_check}")
    h, w = seed_values.shape
    if max_iters is None:
        # Worst-case least-cost path visits every cell once (serpentine
        # channels); h*w relaxations guarantee convergence, and the loop
        # exits as soon as a sweep changes nothing.
        max_iters = h * w

    cost = torch.where(domain_mask, cost_surface.to(torch.float32), math.inf).contiguous()
    valid_seeds = seed_mask & domain_mask
    seed_values = seed_values.to(torch.float32)
    dist = torch.where(valid_seeds, 0.0, math.inf).contiguous()
    value = torch.where(valid_seeds, seed_values, math.nan).contiguous()
    launches = k3.launches
    it = checks = 0
    fell = valid_seeds.any()  # the first check: is there a seed at all
    while True:
        checks += 1
        if not (bool(fell) and it < max_iters):  # device-to-host read
            break
        dist, value, fell = relax_step(dist, value, cost, relaxations_per_check)
        it += relaxations_per_check

    if target_mask is None:
        fill_here = domain_mask & ~valid_seeds
    else:
        fill_here = target_mask & domain_mask & ~valid_seeds
    fill_here = fill_here & torch.isfinite(dist)
    filled = torch.where(fill_here, value, seed_values)
    if stats is not None:
        stats.update(
            relaxations=it, checks=checks, k3_launches=k3.launches - launches,
            seconds=time.perf_counter() - t0,
        )
    return filled, dist


@contextmanager
def traced_solve(name: str, solves: dict | None = None):
    """Span ``solve.<name>`` around one solve.

    A least-cost solve passes the ``solves`` dict of its caller and gets the
    entry ``solves[name]`` to fill as its ``stats``; the span then carries its
    ``relaxations``, ``checks`` and ``k3_launches``. Without ``solves`` it
    yields None.
    """
    stats = None if solves is None else solves.setdefault(name, {})
    with tracing.span(f"solve.{name}") as s:
        yield stats
    if stats is not None:
        for key in ("relaxations", "checks", "k3_launches"):
            s.add(key, stats[key])


def mcp_distance(
    seed_mask: torch.Tensor,
    domain_mask: torch.Tensor,
    max_iters: int | None = None,
    stats: dict | None = None,
) -> torch.Tensor:
    """Least-cost distance over a unit-cost domain (reference ``mcp_distance``)."""
    zeros = torch.zeros(seed_mask.shape, dtype=torch.float32, device=seed_mask.device)
    _, dist = mcp_fill(
        zeros, seed_mask, torch.ones_like(zeros), domain_mask,
        max_iters=max_iters, stats=stats,
    )
    return dist


def _grid_steps(orthogonal_only: bool) -> list[tuple[int, int]]:
    return [
        (dy, dx)
        for dy, dx, _len in _NEIGHBORS
        if not orthogonal_only or dy == 0 or dx == 0
    ]


def grid_distance(
    seed_mask: torch.Tensor,
    metric: str = "chessboard",
    max_iters: int | None = None,
    relaxations_per_check: int = 8,
) -> torch.Tensor:
    """Unit-step grid distance from seed cells over the whole array.

    Device twin of ``scipy.ndimage.distance_transform_cdt`` as the
    reference's PCRaster CostGrow variant uses it (reference
    ``others/CostGrow_pcraster_inline.ipynb`` ``_distance_fill`` /
    ``_03_dry_partials``): ``"chessboard"`` = Chebyshev distance
    (8-neighbor unit steps), ``"taxicab"`` = Manhattan (4-neighbor).
    No domain masking — the reference computes it over the full raster
    and masks afterwards. Returns float32 distances in pixels
    (``inf`` where no seed is reachable, i.e. only when no seed exists).
    """
    if metric not in ("chessboard", "taxicab"):
        raise ValueError(f"metric must be 'chessboard' or 'taxicab', got {metric!r}")
    h, w = seed_mask.shape
    if max_iters is None:
        # Chebyshev/Manhattan eccentricity is bounded by the grid extent.
        max_iters = h + w
    views = [shifted_views(h, w, dy, dx) for dy, dx in _grid_steps(metric == "taxicab")]
    dist = torch.where(seed_mask, 0.0, math.inf)
    prev = torch.full_like(dist, math.inf)
    it = 0
    while bool((dist < prev).any()) and it < max_iters:
        prev = dist
        for _ in range(relaxations_per_check):
            best = dist.clone()
            for dst, src in views:
                best[dst] = torch.minimum(best[dst], dist[src] + 1.0)
            dist = best
        it += relaxations_per_check
    return dist

def nearest_fill_numpy(
    values: np.ndarray, metric: str = "chessboard"
) -> np.ndarray:
    """Fill NaN cells with the value of the nearest finite cell (host side).

    Behavioral twin of the reference's ``_distance_fill`` (reference
    ``others/CostGrow_pcraster_inline.ipynb``: ``distance_transform_cdt``
    index lookup): each empty cell takes the value of its nearest finite
    cell under the chosen grid metric. Ties between equidistant sources are
    resolved by neighbor-scan order (the reference inherits scipy's
    internal tie-break; both pick *some* nearest source). Runs as iterated
    dilation in numpy — intended for the small coarse grid.
    """
    if metric not in ("chessboard", "taxicab"):
        raise ValueError(f"metric must be 'chessboard' or 'taxicab', got {metric!r}")
    out = np.asarray(values, dtype=np.float64).copy()
    filled = np.isfinite(out)
    if not filled.any():
        raise ValueError("nearest_fill_numpy: array has no finite cells")
    steps = [
        (dy, dx)
        for dy, dx, _len in _NEIGHBORS
        if metric == "chessboard" or dy == 0 or dx == 0
    ]
    h, w = out.shape
    while not filled.all():
        # Read only the previous ring: filling must not chain within one
        # dilation step or the metric degrades (taxicab would pick up
        # diagonal jumps composed from two orthogonal shifts).
        prev_out = out.copy()
        prev_filled = filled.copy()
        for dy, dx in steps:
            src_slice = (
                slice(max(0, -dy), h - max(0, dy)),
                slice(max(0, -dx), w - max(0, dx)),
            )
            dst_slice = (
                slice(max(0, dy), h - max(0, -dy)),
                slice(max(0, dx), w - max(0, -dx)),
            )
            take = ~filled[dst_slice] & prev_filled[src_slice]
            if take.any():
                dst_view = out[dst_slice]
                dst_view[take] = prev_out[src_slice][take]
                filled[dst_slice] |= take
    return out


def keep_components_connected_to_anchor(
    wet_mask: torch.Tensor,
    anchor_mask: torch.Tensor,
    max_iters: int | None = None,
    connectivity: int = 1,
) -> torch.Tensor:
    """Keep wet cells connected to any anchor (reference notebook cell 22).

    ``connectivity`` follows the skimage convention the reference uses
    (``label(..., connectivity=1)`` in both ``others/CostGrow_inline.ipynb``
    and ``others/CostGrow_pcraster_inline.ipynb``): 1 = orthogonal
    neighbors only (the reference default), 2 = diagonals included.
    """
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")
    h, w = wet_mask.shape
    if max_iters is None:
        # A connected component can snake through every wet cell, so the
        # safe dilation bound is h*w; convergence exits the loop early.
        max_iters = h * w
    wet = wet_mask.to(torch.bool)
    reach = anchor_mask.to(torch.bool) & wet
    views = [shifted_views(h, w, dy, dx) for dy, dx in _grid_steps(connectivity == 1)]
    prev_count, it = -1, 0
    while True:
        count = int(reach.sum())  # device-to-host read
        if not (count > prev_count and it < max_iters):
            break
        prev_count = count
        for _ in range(8):
            grown = reach.clone()
            for dst, src in views:
                grown[dst] |= reach[src]
            reach = grown & wet
        it += 8
    return reach


# ---------------------------------------------------------------------------
# numpy oracle (sequential Dijkstra; tests only — small grids)
# ---------------------------------------------------------------------------


def mcp_fill_numpy(
    seed_values: np.ndarray,
    seed_mask: np.ndarray,
    cost_surface: np.ndarray,
    domain_mask: np.ndarray,
    target_mask: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact Dijkstra twin of :func:`mcp_fill` (MCP_Geometric weights)."""
    h, w = seed_values.shape
    cost = np.where(domain_mask, cost_surface.astype(np.float64), np.inf)
    valid_seeds = seed_mask & domain_mask
    if not valid_seeds.any():
        raise ValueError("No valid seed cells available for MCP fill.")

    dist = np.full((h, w), np.inf)
    value = np.full((h, w), np.nan)
    heap: list[tuple[float, int, int]] = []
    rows, cols = np.nonzero(valid_seeds)
    for r, c in zip(rows, cols):
        dist[r, c] = 0.0
        value[r, c] = seed_values[r, c]
        heapq.heappush(heap, (0.0, int(r), int(c)))

    while heap:
        d, r, c = heapq.heappop(heap)
        if d > dist[r, c]:
            continue
        for dy, dx, length in _NEIGHBORS:
            nr, nc = r + dy, c + dx
            if not (0 <= nr < h and 0 <= nc < w):
                continue
            if not np.isfinite(cost[nr, nc]):
                continue
            nd = d + length * 0.5 * (cost[r, c] + cost[nr, nc])
            if nd < dist[nr, nc]:
                dist[nr, nc] = nd
                value[nr, nc] = value[r, c]
                heapq.heappush(heap, (nd, nr, nc))

    if target_mask is None:
        fill_here = domain_mask & ~valid_seeds
    else:
        fill_here = target_mask & domain_mask & ~valid_seeds
    fill_here = fill_here & np.isfinite(dist)
    filled = np.where(fill_here, value, seed_values.astype(np.float64))
    return filled.astype(np.float32), dist.astype(np.float32)
