"""Banded (row-sharded) scene executor: scenes beyond one device's memory.

Port of the JAX package's ``engine/scene_banded.py``. ADR-0006's default
sharded formulation (``engine/scene.py`` under a mesh) keeps the whole scene
and its accumulators on one device; a country-scale mosaic (32k² f32 is
4 GB, times two accumulators and every input) does not fit there. This
variant shards the SCENE by row bands over the ``dp`` axis:

- the scene is cut into per-band inputs with a one-tile bottom halo (a tile
  whose origin lies in band *d* extends at most ``tile-1`` rows past the
  band's end), ``[band + tile, W]`` each, on the band's device; the last
  band's halo is zeros;
- each band runs gather → log1p-scale the depth → per-tile DEM stats (the
  ``tile_stats`` kernel) → normalize → forward (trunk and the ``hr_tail``
  kernel) → invert → feather weights → add into its local ``[band + tile,
  W]`` accumulator pair, tile by tile, for ONLY its own tiles; every band's
  tile list is padded with zero-weight dummy slots to a common count, as the
  JAX package's SPMD program needs (a chunk of dummies only is skipped: it
  would add zeros);
- one :func:`~floodsr_tpu_torch.parallel.mesh.ppermute` per buffer sends the
  bottom-halo rows to the next band, which adds them to its top rows after
  its own tiles (own + received, the reference's order);
- weight-normalize, clip and quantize run band-locally; the caller gathers
  the ``[band, W]`` bands.

The bands' work is interleaved chunk by chunk, each enqueued on its band's
device, so distinct GPUs compute at once. Numerics are the unsharded
executor's (same gather, normalization, forward, feather math) up to the
order of the sums at a seam and the batch a tile runs in.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from floodsr_tpu_torch.engine.scene import feather_weights_chunk, predict_tiles
from floodsr_tpu_torch.parallel.mesh import Mesh, ppermute, to_device

IDX_KEYS = ("y0", "x0", "yf", "yl", "xf", "xl", "valid")


def band_plan(
    scene_shape: tuple[int, int], n_bands: int, tile: int
) -> dict[str, int]:
    """Row-band geometry; raises when the bucket cannot band evenly."""
    h, w = int(scene_shape[0]), int(scene_shape[1])
    assert h % n_bands == 0, (
        f"bucket height {h} must divide into {n_bands} bands "
        f"(pick a bucket quantum divisible by dp)"
    )
    band = h // n_bands
    if not (band % tile == 0 or band >= tile):
        raise ValueError(f"band height {band} must be at least one tile ({tile})")
    return {"band": band, "halo": tile, "width": w, "n_bands": n_bands}


def _check_scale(band: int, scale: int) -> None:
    if band % scale != 0:
        # Not an assert: under python -O a stripped assert would re-enable
        # exactly the silent LR-band misalignment this guards against.
        raise ValueError(
            f"band height {band} must be a multiple of scale {scale}: band-"
            f"relative tile origins are divided by scale to index the LR band, "
            f"which silently misaligns otherwise"
        )


def band_inputs(
    depth_pad: torch.Tensor,
    dem_pad: torch.Tensor,
    *,
    n_bands: int,
    tile: int,
    scale: int,
    devices: "list[torch.device] | None" = None,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Overlapping input bands: ``depth [(band+halo)/scale, W/scale]`` and
    ``dem [band+halo, W]`` for each band, on ``devices[d]`` (default: where
    the inputs are). Rows past the scene are zeros."""
    h, w = (int(v) for v in dem_pad.shape)
    plan = band_plan((h, w), n_bands, tile)
    band, halo = plan["band"], plan["halo"]
    _check_scale(band, scale)
    devices = devices or [dem_pad.device] * n_bands
    depth_bands, dem_bands = [], []
    for d in range(n_bands):
        lo = d * band
        hi = min(h, lo + band + halo)
        dem_b = F.pad(dem_pad[lo:hi], (0, 0, 0, band + halo - (hi - lo)))
        depth_b = depth_pad[lo // scale : hi // scale]
        depth_b = F.pad(depth_b, (0, 0, 0, (band + halo) // scale - depth_b.shape[0]))
        dem_bands.append(to_device(dem_b.contiguous(), devices[d]))
        depth_bands.append(to_device(depth_b.contiguous(), devices[d]))
    return depth_bands, dem_bands


def pack_band_indices(
    grid: dict[str, np.ndarray | int],
    *,
    n_bands: int,
    band: int,
    chunk: int,
    cap: "int | None" = None,
) -> dict[str, np.ndarray]:
    """Chunked per-band tile indices ``[dp, n_chunks, chunk]`` (origins
    RELATIVE to the band start) and the host-only ``grid_slot`` map.

    Bands own tiles by origin row; every band is dummy-padded (``valid`` 0)
    to the same chunk-rounded count, ``cap`` when given.
    """
    y0 = np.asarray(grid["y0"], np.int64)
    x0 = np.asarray(grid["x0"], np.int64)
    yi = np.asarray(grid["yi"], np.int64)
    xi = np.asarray(grid["xi"], np.int64)
    ny, nx = int(grid["ny"]), int(grid["nx"])
    owner = np.minimum(y0 // band, n_bands - 1)

    counts = [(owner == d).sum() for d in range(n_bands)]
    needed = -(-max(1, int(max(counts))) // chunk) * chunk
    if cap is None:
        cap = needed
    else:
        # Caller-fixed capacity (the executor's bucket-level cap): every
        # content grid within a bucket packs to the SAME shapes.
        assert cap % chunk == 0 and cap >= needed, (
            f"cap={cap} cannot hold {needed} tiles (chunk={chunk})"
        )

    def field(default, dtype):
        return np.full((n_bands, cap), default, dtype)

    fy0 = field(0, np.int32)
    fx0 = field(0, np.int32)
    fyf = field(False, bool)
    fyl = field(False, bool)
    fxf = field(False, bool)
    fxl = field(False, bool)
    fvalid = field(0.0, np.float32)
    slot = np.full((n_bands, cap), -1, np.int64)
    for d in range(n_bands):
        sel = np.nonzero(owner == d)[0]
        n = len(sel)
        fy0[d, :n] = (y0[sel] - d * band).astype(np.int32)  # band-relative
        fx0[d, :n] = x0[sel].astype(np.int32)
        fyf[d, :n] = yi[sel] == 0
        fyl[d, :n] = yi[sel] == ny - 1
        fxf[d, :n] = xi[sel] == 0
        fxl[d, :n] = xi[sel] == nx - 1
        fvalid[d, :n] = 1.0
        slot[d, :n] = sel

    n_chunks = cap // chunk
    fields = {"y0": fy0, "x0": fx0, "yf": fyf, "yl": fyl, "xf": fxf, "xl": fxl, "valid": fvalid}
    out = {k: v.reshape(n_bands, n_chunks, chunk) for k, v in fields.items()}
    # host-only: grid index served by each band slot (-1 = dummy), for
    # reassembling per-tile stats into grid order.
    out["grid_slot"] = slot
    return out


def pack_banded_scene(
    depth_pad: np.ndarray,
    dem_pad: np.ndarray,
    grid: dict[str, np.ndarray | int],
    *,
    n_bands: int,
    tile: int,
    scale: int,
    chunk: int,
    cap: "int | None" = None,
) -> dict[str, np.ndarray]:
    """Host-side banding: overlapping input bands + per-band tile indices.

    Returns arrays stacked on a leading ``dp`` axis:
    ``depth [dp, (band+halo)/scale, W/scale]``, ``dem [dp, band+halo, W]``,
    and chunked per-band index arrays ``[dp, n_chunks, chunk]`` (see
    :func:`band_inputs` and :func:`pack_band_indices`).
    """
    depth_bands, dem_bands = band_inputs(
        torch.from_numpy(np.ascontiguousarray(depth_pad, np.float32)),
        torch.from_numpy(np.ascontiguousarray(dem_pad, np.float32)),
        n_bands=n_bands, tile=tile, scale=scale,
    )
    return {
        "depth": torch.stack(depth_bands).numpy(),
        "dem": torch.stack(dem_bands).numpy(),
        **pack_band_indices(
            grid, n_bands=n_bands, band=dem_pad.shape[0] // n_bands, chunk=chunk, cap=cap
        ),
    }


def band_devices(mesh: Mesh, batch_axis: str = "dp") -> list[torch.device]:
    """The device each band lives on (the counterpart of the JAX package's
    ``banded_in_shardings``): band ``d`` on the first device of ``dp`` row ``d``."""
    return mesh.axis_devices(batch_axis)


def build_banded_scene_executor(
    cfg,
    *,
    scene_shape: tuple[int, int],
    overlap_hr: int,
    chunk: int,
    max_depth: float,
    dem_pct_clip: float,
    mesh: Mesh,
    replicas: dict,
    batch_axis: str = "dp",
    transfer_dtype: str = "float32",
    transposed: bool = False,
):
    """The banded executor for one scene geometry over ``mesh[batch_axis]``.

    Returns ``(fn, n_bands)``. ``fn(banded)`` takes the :func:`pack_banded_scene`
    dict (its ``depth``/``dem`` stacked numpy arrays or per-band tensors;
    ``grid_slot`` is not read) and returns ``(bands, stats)``: ``bands[d]`` is
    band ``d``'s ``[band, W]`` output and ``stats[d]`` its ``[cap, 3]`` tile
    stats (zero on skipped dummy chunks), on the band's device. ``replicas``
    maps each band device to its forward ``(depth_nhwc, dem_nhwc) -> pred``.

    ``transposed=True`` is the COLUMN-banding mode for wide scenes: the caller
    feeds the TRANSPOSED scene (and a grid built on it), so row bands shard
    the original scene's columns. Each gathered tile is swapped back to the
    original orientation before the forward (convolutions are not
    transpose-equivariant) and its prediction swapped again before the
    scatter. The feather weights need no special case: the separable ramp is
    symmetric, so weights from the transposed grid's edge flags ARE the
    transposed weights.
    """
    assert transfer_dtype in {"uint16", "float32"}, transfer_dtype
    tile = cfg.hr_tile
    devices = band_devices(mesh, batch_axis)
    n_bands = len(devices)
    plan = band_plan(scene_shape, n_bands, tile)
    band, halo, width = plan["band"], plan["halo"], plan["width"]
    overlap_hr = int(overlap_hr)

    def put(arr, dev, dtype=None):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
        return to_device(t if dtype is None else t.to(dtype), dev)

    @torch.no_grad()
    def run(banded):
        n_chunks = int(np.shape(banded["valid"])[1])
        valid_host = np.asarray(banded["valid"])
        depth = [put(banded["depth"][d], dev) for d, dev in enumerate(devices)]
        dem = [put(banded["dem"][d], dev) for d, dev in enumerate(devices)]
        idx = [
            {k: put(np.asarray(banded[k][d]).reshape(-1), dev) for k in IDX_KEYS}
            for d, dev in enumerate(devices)
        ]
        for ix in idx:
            ix["y0"], ix["x0"] = ix["y0"].long(), ix["x0"].long()
        origins = [
            (np.asarray(banded["y0"][d]).reshape(-1).tolist(),
             np.asarray(banded["x0"][d]).reshape(-1).tolist())
            for d in range(n_bands)
        ]
        accs = [torch.zeros((band + halo, width), dtype=torch.float32, device=dev) for dev in devices]
        wsums = [torch.zeros_like(a) for a in accs]
        stats = [
            torch.zeros((n_chunks * chunk, 3), dtype=torch.float32, device=dev) for dev in devices
        ]
        for c in range(n_chunks):
            s, e = c * chunk, (c + 1) * chunk
            for d, dev in enumerate(devices):
                if not valid_host[d, c].any():
                    continue
                ix = idx[d]
                pred_m, stats[d][s:e] = predict_tiles(
                    replicas[dev], depth[d], dem[d], ix["y0"][s:e], ix["x0"][s:e], cfg,
                    max_depth, dem_pct_clip, transposed,
                )
                weights = feather_weights_chunk(
                    tile, overlap_hr, ix["yf"][s:e], ix["yl"][s:e], ix["xf"][s:e],
                    ix["xl"][s:e], ix["valid"][s:e],
                )
                pw = pred_m * weights
                acc, ws = accs[d], wsums[d]
                for i, (y, x) in enumerate(zip(origins[d][0][s:e], origins[d][1][s:e])):
                    acc[y : y + tile, x : x + tile] += pw[i]
                    ws[y : y + tile, x : x + tile] += weights[i]

        # Halo exchange: my bottom-halo rows belong to the NEXT band's top,
        # added after that band's own tiles.
        perm = [(d, d + 1) for d in range(n_bands - 1)]
        bands = []
        for bufs in (accs, wsums):
            received = ppermute([b[band:] for b in bufs], perm)
            for b, r in zip(bufs, received):
                b[:halo] += r
        for acc, ws in zip(accs, wsums):
            acc, ws = acc[:band], ws[:band]
            scene = torch.where(ws > 0, acc / torch.clamp_min(ws, 1e-6), torch.zeros_like(acc))
            out = torch.clamp(scene, 0.0, float(max_depth))
            if transfer_dtype == "uint16":
                q = torch.tensor(65535.0 / float(max_depth), dtype=torch.float32, device=out.device)
                out = torch.round(out * q).to(torch.uint16)
            bands.append(out)
        return bands, stats

    return run, n_bands
