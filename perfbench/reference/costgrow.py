"""CostGrow worked out again from its raw inputs, in plain PyTorch.

The method is cefect/floodsr's ``others/CostGrow_inline.ipynb`` (cells 6 and
14-22): a coarse water surface (WSE) is brought onto the DEM's grid and grown
over the terrain along least-cost paths.

- 01: the LR WSE bilinearly resampled onto the DEM grid: pixel centres, the
  four taps clamped at the edges, weights renormalised over valid (not nodata)
  sources; a cell is kept where the nearest LR cell is valid and the DEM is.
- 02: wet anchors where that WSE lies strictly above the DEM.
- 03: three least-cost solves over the DEM's valid cells: a neutral fill of
  the resampled WSE at unit cost; the anchors' distance at unit cost, grown
  cells within ``max_grow_coarse_pixels x downscale`` of it; the anchors' WSE
  carried along paths over the cost ``1`` where the neutral fill lies above
  the DEM, else ``1 + |fill - DEM| x terrain_penalty_scale``, less
  ``decay_per_meter`` per metre travelled. A grown cell keeps its WSE where
  that lies above the DEM.
- 04: only wet cells orthogonally connected to an anchor stay wet.

Each solve relaxes every cell from its 8 neighbours with the geometric edge
weight ``length x (cost[u] + cost[v]) / 2`` (length 1, or sqrt 2 on a
diagonal), a candidate replacing the best so far only when strictly below
it, and carrying its source's value: Jacobi sweeps (each reads the previous
sweep's arrays) until a sweep changes nothing. Of equal candidates the first
in the order W, E, N, NW, NE, S, SW, SE wins.

Departures from the notebook: rasterio's warp is replaced by the bilinear
above, evaluated in float64 and rounded once to float32 (GDAL also
interpolates in double); skimage's ``MCP_Geometric`` (a sequential Dijkstra)
by the Jacobi sweeps, which reach the same distances; where two paths tie
exactly, the carried value may differ from the one Dijkstra's heap order
picks. Everything after the resample is float32 with TF32 off. Imports
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
#: ``(dy, dx, length)`` of the 8 neighbours, in the order whose first exact
#: tie wins.
NEIGHBOURS = (
    (0, -1, 1.0), (0, 1, 1.0),
    (-1, 0, 1.0), (-1, -1, SQRT2), (-1, 1, SQRT2),
    (1, 0, 1.0), (1, -1, SQRT2), (1, 1, SQRT2),
)
#: the orthogonal neighbours of phase 04, and its dilations between two counts
ORTHOGONAL = ((0, -1), (0, 1), (-1, 0), (1, 0))
DILATIONS_PER_CHECK = 16


def _shifted(padded: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Each cell's neighbour at ``(dy, dx)`` from an array padded by one."""
    h, w = padded.shape[0] - 2, padded.shape[1] - 2
    return padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def least_cost(seed_values: torch.Tensor, seed_mask: torch.Tensor, cost: torch.Tensor,
               domain: torch.Tensor, *, acc: torch.dtype = torch.float32,
               max_sweeps: int | None = None) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Least-cost distance from the seeds over ``domain``, and each cell's
    source value: ``(value, dist, sweeps)``, ``sweeps`` counting the last one
    that changed nothing. ``acc``: the dtype the distances accumulate in;
    ``max_sweeps`` stops the sweeps early."""
    inf = math.inf
    c = torch.where(domain, cost.to(torch.float32), inf)
    seeds = seed_mask & domain
    cp = F.pad(c, (1, 1, 1, 1), value=inf)
    weights = [((_shifted(cp, dy, dx) + c) * length / 2).to(acc) for dy, dx, length in NEIGHBOURS]
    dist = torch.where(seeds, 0.0, inf).to(acc)
    value = torch.where(seeds, seed_values.to(torch.float32), math.nan)
    sweeps = 0
    while max_sweeps is None or sweeps < max_sweeps:
        dp = F.pad(dist, (1, 1, 1, 1), value=inf)
        vp = F.pad(value, (1, 1, 1, 1), value=math.nan)
        best, best_v = dist, value
        for (dy, dx, _), w in zip(NEIGHBOURS, weights):
            cand = _shifted(dp, dy, dx) + w
            take = cand < best
            best = torch.where(take, cand, best)
            best_v = torch.where(take, _shifted(vp, dy, dx), best_v)
        sweeps += 1
        changed = bool((best < dist).any())
        dist, value = best, best_v
        if not changed:
            break
    return value, dist, sweeps


def fill(seed_values: torch.Tensor, seed_mask: torch.Tensor, cost: torch.Tensor,
         domain: torch.Tensor, target: torch.Tensor | None = None, **kw):
    """The notebook's fill: seeds keep their values, reachable ``target``
    cells of the domain (every one without ``target``) take their source
    seed's, the rest keep ``seed_values``. ``(filled, dist, sweeps)``."""
    value, dist, sweeps = least_cost(seed_values, seed_mask, cost, domain, **kw)
    here = domain & ~(seed_mask & domain) & torch.isfinite(dist)
    if target is not None:
        here &= target
    return torch.where(here, value, seed_values.to(torch.float32)), dist, sweeps


def connected_to(wet: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Wet cells orthogonally connected to an anchor through wet cells."""
    reach = anchors & wet
    count = -1
    while True:
        now = int(reach.sum())
        if now == count:
            return reach
        count = now
        for _ in range(DILATIONS_PER_CHECK):
            rp = F.pad(reach, (1, 1, 1, 1), value=False)
            grown = reach.clone()
            for dy, dx in ORTHOGONAL:
                grown |= _shifted(rp, dy, dx)
            reach = grown & wet


def _axis(n_dst: int, origin: float, dst_step: float, src_step: float, n_src: int, device):
    """Fractional source index of each destination pixel centre along one axis
    (the grids share the edge ``origin``; steps signed, negative down a
    north-up column), and its two clamped taps. The centre's world coordinate
    goes through the source grid's inverse geotransform, as a warper does."""
    centre = origin + (torch.arange(n_dst, dtype=torch.float64, device=device) + 0.5) * dst_step
    inv = 1.0 / src_step
    pos = (centre * inv - origin * inv) - 0.5
    lo = torch.floor(pos)
    frac = pos - lo
    lo = lo.to(torch.int64)
    return pos, frac, lo.clamp(0, n_src - 1), (lo + 1).clamp(0, n_src - 1)


def resample(wse_lr: np.ndarray, nodata: float, hr_shape, lr_res: float, hr_res: float,
             west: float, north: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 01: ``(bilinear float32 WSE with NaN where no valid source,
    validity of the nearest LR cell)`` on the HR grid."""
    src = torch.from_numpy(np.asarray(wse_lr, np.float64)).to(device)
    ok = torch.isfinite(src) & (src != nodata)
    h_s, w_s = src.shape
    pr, fr, r0, r1 = _axis(hr_shape[0], north, -hr_res, -lr_res, h_s, device)
    pc, fc, c0, c1 = _axis(hr_shape[1], west, hr_res, lr_res, w_s, device)
    acc = torch.zeros(tuple(hr_shape), dtype=torch.float64, device=device)
    wacc = torch.zeros_like(acc)
    for rr, cc, wr, wc in ((r0, c0, 1 - fr, 1 - fc), (r0, c1, 1 - fr, fc),
                           (r1, c0, fr, 1 - fc), (r1, c1, fr, fc)):
        tap_ok = ok[rr[:, None], cc[None, :]]
        w = torch.where(tap_ok, wr[:, None] * wc[None, :], 0.0)
        acc += torch.where(tap_ok, src[rr[:, None], cc[None, :]], 0.0) * w
        wacc += w
    out = torch.where(wacc > 0, acc / wacc.clamp_min(1e-12), math.nan).to(torch.float32)
    nr = torch.round(pr).to(torch.int64)
    nc = torch.round(pc).to(torch.int64)
    inside = ((nr >= 0) & (nr < h_s))[:, None] & ((nc >= 0) & (nc < w_s))[None, :]
    nearest_ok = ok[nr.clamp(0, h_s - 1)[:, None], nc.clamp(0, w_s - 1)[None, :]] & inside
    return out, nearest_ok


def costgrow(wse_lr: np.ndarray, dem: np.ndarray, *, lr_res: float, hr_res: float,
             west: float, north: float, nodata: float, params: dict, device,
             acc: torch.dtype = torch.float32, sweep_share: float | None = None) -> np.ndarray:
    """Phases 01-04 on ``device``; the WSE on the DEM grid, NaN where dry.

    ``acc`` and ``sweep_share`` make the controls: the distances accumulated
    in another dtype, or each solve stopped after that share of the sweeps it
    needs.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def solve(*args, **kw):
        if sweep_share is not None:
            _, _, sweeps = fill(*args, **kw, acc=acc)
            kw["max_sweeps"] = int(sweeps * sweep_share)
        filled, dist, _ = fill(*args, **kw, acc=acc)
        return filled, dist.to(torch.float32)

    dem_t = torch.from_numpy(np.asarray(dem, np.float32)).to(device)
    domain = torch.isfinite(dem_t) & (dem_t != nodata)
    dem_t = torch.where(domain, dem_t, math.inf)
    wse_fine, nearest_ok = resample(wse_lr, nodata, dem.shape, lr_res, hr_res, west, north, device)
    wse_fine = torch.where(nearest_ok & domain, wse_fine, math.nan)
    downscale = max(1, int(round(lr_res / hr_res)))

    # 02
    anchors = wse_fine > dem_t
    wse_wet = torch.where(anchors, wse_fine, math.nan)
    # 03
    ones = torch.ones_like(dem_t)
    neutral, _ = solve(wse_fine, torch.isfinite(wse_fine), ones, domain)
    delta = neutral - dem_t
    cost = torch.where(delta > 0.0, 1.0, 1.0 + delta.abs() * float(params["terrain_penalty_scale"]))
    _, dist = solve(torch.zeros_like(dem_t), anchors, ones, domain)
    grow = torch.isfinite(dist) & (dist <= float(params["max_grow_coarse_pixels"]) * downscale)
    grown, _ = solve(wse_wet, anchors, cost, domain, target=grow)
    decay = dist * (float(params["decay_per_meter"]) * hr_res)
    grown = grown - torch.where(torch.isfinite(decay), decay, 0.0)
    out = torch.where(~anchors & grow & torch.isfinite(grown) & (grown > dem_t), grown, wse_wet)
    # 04
    keep = connected_to(torch.isfinite(out), anchors)
    return torch.where(keep & domain, out, math.nan).cpu().numpy()
