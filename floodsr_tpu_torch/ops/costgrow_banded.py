"""Row-band-sharded CostGrow fill for multi-GPU scale-out.

Port of the JAX package's ``ops/costgrow_banded.py``. The single-device fill
(:func:`floodsr_tpu_torch.ops.costgrow.mcp_fill`) relaxes the whole scene;
continental-scale DEMs outgrow one device's memory. This module cuts the
scene into contiguous row bands over a mesh axis (one band per ``dp`` row,
on that row's first device, driven by this one process) and runs the same
relaxation per band with an overlapping halo, exchanging only the band-edge
rows between relaxation blocks.

Why this is exact: after ``k`` relaxations, information travels at most
``k`` rows. Each outer block (a) refreshes a ``k``-row halo from the
neighbouring bands' current state (one :func:`~floodsr_tpu_torch.parallel.
mesh.ppermute` per direction), (b) relaxes ``k`` times on the halo-padded
band through the ``relax_step`` kernel (its plain version on the CPU), (c)
crops back to the core rows. Core rows after a block equal the unsharded
relaxation's rows after the same ``k`` steps; halo rows are scratch,
re-fetched each block. Both fills are Jacobi steps with the same arithmetic
and run to the same fixpoint, so the result equals :func:`mcp_fill`'s bit
for bit. Convergence is a global fixpoint test: the per-band change flags
are summed on one device and read once per block.

Communication per block: 2 buffers (distance, carried value) × 2 directions ×
``k`` rows; the cost surface's halo is static and exchanged once.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from floodsr_tpu_torch.ops.kernels.relax_step import relax_step
from floodsr_tpu_torch.parallel.mesh import Mesh, any_across, gather_to, ppermute, to_device


def _exchange_halos(cores: list[torch.Tensor], k: int, fill: float) -> list[torch.Tensor]:
    """Pad each band's ``(band, w)`` core with ``k`` rows from each neighbour.

    The first band's top halo and the last band's bottom halo have no
    source; ``ppermute`` leaves them zero, so they are ``fill`` instead (an
    impassable or neutral boundary, matching the unsharded array's edge).
    """
    n = len(cores)
    down = [(d, d + 1) for d in range(n - 1)]  # my bottom -> next top
    up = [(d, d - 1) for d in range(1, n)]  # my top -> prev bottom
    top = ppermute([c[-k:] for c in cores], down)
    bot = ppermute([c[:k] for c in cores], up)
    top[0] = torch.full_like(top[0], fill)
    bot[-1] = torch.full_like(bot[-1], fill)
    return [torch.cat([t, c, b]) for t, c, b in zip(top, cores, bot)]


# (mesh, shape, axis, relaxations_per_check, max_iters) -> built fill
_BUILD_CACHE: dict[tuple, object] = {}


def build_banded_mcp_fill(
    mesh: Mesh,
    shape: tuple[int, int],
    *,
    batch_axis: str = "dp",
    relaxations_per_check: int = 8,
    max_iters: int | None = None,
):
    """A row-band-sharded least-cost fill for a fixed ``(h, w)``.

    Returns ``fn(seed_values, seed_mask, cost_surface, domain_mask, stats=None)
    -> (filled, dist)`` over full ``(h, w)`` tensors; the results lie on the
    mesh's first device. ``h`` must divide evenly by the mesh axis size (use
    :func:`mcp_fill_sharded` for the padding wrapper). ``stats``, when given,
    receives ``relaxations`` (per band), ``checks`` (host reads) and
    ``seconds``.
    """
    h, w = (int(v) for v in shape)
    devices = mesh.axis_devices(batch_axis)
    n_bands = len(devices)
    if h % n_bands != 0:
        raise ValueError(f"height {h} not divisible by {n_bands} bands")
    cache_key = (mesh, (h, w), batch_axis, relaxations_per_check, max_iters)
    cached = _BUILD_CACHE.get(cache_key)
    if cached is not None:
        return cached
    # Information travels one row per relaxation: running more relaxations
    # per block than the halo holds would read stale neighbour state, so the
    # block size is clamped to the band height (= widest exchangeable halo).
    k = max(1, min(relaxations_per_check, h // n_bands))
    cap = h * w if max_iters is None else max_iters
    band = h // n_bands

    def split(t: torch.Tensor) -> list[torch.Tensor]:
        return [to_device(t[d * band : (d + 1) * band], dev) for d, dev in enumerate(devices)]

    @torch.no_grad()
    def fn(seed_values, seed_mask, cost_surface, domain_mask, stats: dict | None = None):
        t0 = time.perf_counter()
        seeds_b, mask_b, cost_b, domain_b = (
            split(t) for t in (seed_values, seed_mask, cost_surface, domain_mask)
        )
        cost, dist, value, valid = [], [], [], []
        for sv, sm, cs, dm in zip(seeds_b, mask_b, cost_b, domain_b):
            vs = sm & dm
            cost.append(torch.where(dm, cs.to(torch.float32), math.inf).contiguous())
            dist.append(torch.where(vs, 0.0, math.inf).contiguous())
            value.append(torch.where(vs, sv.to(torch.float32), math.nan).contiguous())
            valid.append(vs)

        # The friction surface never changes: exchange its halo once.
        cost_h = _exchange_halos(cost, k, math.inf)
        it = checks = 0
        changed = True
        while changed and it < cap:
            dist_h = _exchange_halos(dist, k, math.inf)
            value_h = _exchange_halos(value, k, math.nan)
            for d in range(n_bands):
                for _ in range(k):
                    dist_h[d], value_h[d] = relax_step(dist_h[d], value_h[d], cost_h[d])
            new_dist = [t[k:-k] for t in dist_h]
            flags = [(new < old).any() for new, old in zip(new_dist, dist)]
            dist, value = new_dist, [t[k:-k] for t in value_h]
            it += k
            checks += 1
            changed = bool(any_across(flags, devices[0]))  # one host read a block

        filled = []
        for sv, dm, vs, dd, vv in zip(seeds_b, domain_b, valid, dist, value):
            fill_here = dm & ~vs & torch.isfinite(dd)
            filled.append(torch.where(fill_here, vv, sv.to(torch.float32)))
        if stats is not None:
            stats.update(relaxations=it, checks=checks, seconds=time.perf_counter() - t0)
        return gather_to(filled, devices[0]), gather_to(dist, devices[0])

    _BUILD_CACHE[cache_key] = fn
    return fn


def mcp_fill_sharded(
    seed_values,
    seed_mask,
    cost_surface,
    domain_mask,
    mesh: Mesh,
    *,
    batch_axis: str = "dp",
    relaxations_per_check: int = 8,
    max_iters: int | None = None,
    stats: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Row-band-sharded twin of :func:`floodsr_tpu_torch.ops.costgrow.mcp_fill`.

    Takes numpy arrays or tensors. Pads the scene to a band multiple with
    impassable rows, runs the halo-exchange relaxation over the bands, and
    crops; returns host arrays ``(filled, dist)``, as the JAX package's does.
    Semantics (including unreachable cells) match the unsharded fill exactly;
    only the execution layout differs.
    """

    def tensor(a, dtype):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(dtype)

    sv = tensor(seed_values, torch.float32)
    sm = tensor(seed_mask, torch.bool)
    cs = tensor(cost_surface, torch.float32)
    dm = tensor(domain_mask, torch.bool)
    h, w = (int(v) for v in sv.shape)
    n_bands = mesh.shape[batch_axis]
    pad = (-h) % n_bands
    if pad:

        def rows(t, value):
            return torch.cat([t, torch.full((pad, w), value, dtype=t.dtype, device=t.device)])

        sv, sm, cs, dm = rows(sv, math.nan), rows(sm, False), rows(cs, math.inf), rows(dm, False)

    fn = build_banded_mcp_fill(
        mesh,
        (h + pad, w),
        batch_axis=batch_axis,
        relaxations_per_check=relaxations_per_check,
        max_iters=max_iters,
    )
    filled, dist = fn(sv, sm, cs, dm, stats=stats)
    return filled[:h].cpu().numpy(), dist[:h].cpu().numpy()
