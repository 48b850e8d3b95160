"""One ``tohr`` request worked out again from its raw inputs, in plain PyTorch.

The semantics the configuration states, step by step (floodsr's
``ResUNet_16x_DEM`` flow): the DEM, sent to the device as uint16 codes over
its range when it is large; bilinearly resampled (pixel centres, edges
clamped) onto the model grid, ``scale`` times the LR grid over the LR extent;
padded with zeros to whole tiles; cut into feathered windows (stride = tile -
overlap, a last window flush with the far edge); per window the depth
log1p-scaled and the DEM clipped to its own ``dem_pct_clip`` percentile and
min-max scaled; the network; the depth back in metres; a feathered mosaic
(linear ramps over the overlap, flat at the scene's edges, divided by the
summed weights); clipped and sent back as uint16 codes; resampled onto the
raw DEM grid, clipped, depths under ``low_depth_mask_m`` zeroed, sent as
uint16 codes again. Windows run in blocks, so that the reference fits beside
nothing else on the card. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.model import Reference


def quantize_dem(dem: np.ndarray, nodata: float | None, min_bytes: int) -> np.ndarray:
    """The DEM as the device receives it: uint16 codes 0..65534 over the valid
    range (65535 keeps nodata exact) when it has ``min_bytes`` or more."""
    a = np.ascontiguousarray(dem, np.float32)
    if a.nbytes < min_bytes:
        return a
    valid = np.ones(a.shape, bool) if nodata is None else ~np.isclose(a, nodata)
    vmin, vmax = float(a[valid].min()), float(a[valid].max())
    if vmax <= vmin:
        return a
    step = (vmax - vmin) / 65534.0
    codes = np.clip(np.round((a - vmin) * (1.0 / step)), 0.0, 65534.0).astype(np.uint16)
    out = codes.astype(np.float32) * np.float32(step) + np.float32(vmin)
    return np.where(valid, out, np.float32(nodata if nodata is not None else 0.0))


def axis_plan(n_src: int, src_origin: float, src_step: float, n_dst: int,
              dst_origin: float, dst_step: float):
    """Bilinear sample plan along one axis: ``(i0, i1, frac)`` (float64)."""
    centers = dst_origin + (np.arange(n_dst, dtype=np.float64) + 0.5) * dst_step
    coords = (centers - src_origin) / src_step - 0.5
    i0 = np.floor(coords)
    frac = coords - i0
    i0 = i0.astype(np.int64)
    return np.clip(i0, 0, n_src - 1), np.clip(i0 + 1, 0, n_src - 1), frac


def resample(src: torch.Tensor, rows, cols) -> torch.Tensor:
    """Separable bilinear resample with the two axis plans, in float64."""
    dev = src.device
    r0, r1, fr = (torch.from_numpy(np.asarray(v)).to(dev) for v in rows)
    c0, c1, fc = (torch.from_numpy(np.asarray(v)).to(dev) for v in cols)
    x = src.to(torch.float64)
    x = x[r0] * (1 - fr)[:, None] + x[r1] * fr[:, None]
    return x[:, c0] * (1 - fc)[None, :] + x[:, c1] * fc[None, :]


def starts(total: int, tile: int, stride: int) -> list[int]:
    s = list(range(0, max(total - tile + 1, 1), stride))
    if s[-1] != total - tile:
        s.append(total - tile)
    return s


def ramp(tile: int, overlap: int) -> np.ndarray:
    r = np.ones(tile, np.float64)
    if overlap > 0:
        up = np.linspace(0.0, 1.0, overlap + 2)[1:-1]
        r[:overlap] = up
        r[-overlap:] = up[::-1]
    return np.clip(r, 1e-3, 1.0)


def window_stats(dem: torch.Tensor, pct: float):
    """Per window ``(p, lo, hi)``: the ``pct`` percentile (linear between order
    statistics) of the DEM with negatives as 0, and min and max clipped to it."""
    x = torch.clamp_min(dem.reshape(dem.shape[0], -1), 0.0)
    p = torch.quantile(x.to(torch.float64), pct / 100.0, dim=1).to(torch.float32)
    lo = torch.minimum(x.amin(dim=1), p)
    hi = torch.minimum(x.amax(dim=1), p)
    return p, lo, hi


def run_request(model: Reference, dem_raw: np.ndarray, depth: np.ndarray, geo: dict,
                cfg: dict, block: int = 8) -> np.ndarray:
    """The raster a request should write: ``dem_raw`` (raw DEM grid) and
    ``depth`` (LR grid) share one extent, described by ``geo``."""
    dev = next(iter(model.t.values())).device
    arch, pre, transfer = model.arch, cfg["preprocess"], cfg["transfer"]
    s, lr_tile = int(arch["scale"]), int(arch["lr_tile"])
    tile = lr_tile * s
    overlap = (lr_tile // 4) * s
    max_depth, pct = float(pre["max_depth"]), float(pre["dem_pct_clip"])
    q = 65535.0 / max_depth
    h, w = depth.shape
    H, W = h * s, w * s
    raw_h, raw_w = dem_raw.shape
    north, west = geo["north"], geo["west"]
    model_res_y, model_res_x = h * geo["lr_res"] / H, w * geo["lr_res"] / W

    dem = torch.from_numpy(quantize_dem(dem_raw, geo["nodata"], int(transfer["dem_min_bytes"]))).to(dev)
    dem_model = resample(
        dem,
        axis_plan(raw_h, north, -geo["hr_res"], H, north, -model_res_y),
        axis_plan(raw_w, west, geo["hr_res"], W, west, model_res_x),
    ).to(torch.float32)
    ch, cw = -(-H // tile) * tile, -(-W // tile) * tile
    dem_pad = torch.zeros((ch, cw), dtype=torch.float32, device=dev)
    dem_pad[:H, :W] = dem_model
    depth_pad = torch.zeros((ch // s, cw // s), dtype=torch.float32, device=dev)
    depth_pad[:h, :w] = torch.from_numpy(depth).to(dev)

    ys, xs = starts(ch, tile, tile - overlap), starts(cw, tile, tile - overlap)
    wins = [(yi, xi, y, x) for yi, y in enumerate(ys) for xi, x in enumerate(xs)]
    r = ramp(tile, overlap)
    acc = torch.zeros((ch, cw), dtype=torch.float64, device=dev)
    wsum = torch.zeros_like(acc)
    denom = float(np.log1p(max_depth))
    for b in range(0, len(wins), block):
        part = wins[b : b + block]
        d = torch.stack([depth_pad[y // s : y // s + lr_tile, x // s : x // s + lr_tile] for _, _, y, x in part])
        e = torch.stack([dem_pad[y : y + tile, x : x + tile] for _, _, y, x in part])
        d = torch.clamp(torch.log1p(torch.clamp(d, 0.0, max_depth)) / denom, 0.0, 1.0)
        p, lo, hi = window_stats(e, pct)
        rng = (hi - lo)[:, None, None]
        e = torch.clamp((torch.minimum(torch.clamp_min(e, 0.0), p[:, None, None]) - lo[:, None, None])
                        / torch.where(rng > 0, rng, torch.ones_like(rng)), 0.0, 1.0)
        e = torch.where(rng > 0, e, torch.zeros_like(e))
        pred = model.forward(d, e)
        pred = torch.clamp(torch.expm1(torch.clamp(pred, 0.0, 1.0) * denom), 0.0, max_depth)
        for k, (yi, xi, y, x) in enumerate(part):
            wy, wx = r.copy(), r.copy()
            if yi == 0:
                wy[:overlap] = 1.0
            if yi == len(ys) - 1:
                wy[tile - overlap :] = 1.0
            if xi == 0:
                wx[:overlap] = 1.0
            if xi == len(xs) - 1:
                wx[tile - overlap :] = 1.0
            wt = torch.from_numpy(np.outer(wy, wx)).to(dev)
            acc[y : y + tile, x : x + tile] += pred[k].to(torch.float64) * wt
            wsum[y : y + tile, x : x + tile] += wt
    scene = torch.where(wsum > 0, acc / torch.clamp_min(wsum, 1e-6), torch.zeros_like(acc))
    codes = torch.round(torch.clamp(scene, 0.0, max_depth) * q)[:H, :W]

    mask = float(pre["low_depth_mask_m"])
    if (raw_h, raw_w) != (H, W):
        out = resample(
            codes / q,
            axis_plan(H, north, -model_res_y, raw_h, north, -geo["hr_res"]),
            axis_plan(W, west, model_res_x, raw_w, west, geo["hr_res"]),
        )
        out = torch.clamp(out, 0.0, max_depth)
        out = torch.where(out < mask, torch.zeros_like(out), out)
        codes = torch.round(out * q)
        return (codes / q).to(torch.float32).cpu().numpy()
    out = (codes / q).to(torch.float32)
    return torch.where(out < mask, torch.zeros_like(out), out).cpu().numpy()
