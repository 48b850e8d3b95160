"""Whole-scene executor in eager PyTorch: two-phase, or single-phase for a graph.

Port of the JAX package's ``engine/scene.py``: the two-phase executor
(:378-427) for the native ResUNet, which splits into a trunk and a tail, and
the single-phase one (``scene_fn``, :429-465) for a model that runs whole (an
ONNX graph, interpreted or converted). Everything stays on the device between
one upload and one download. Two-phase:

    phase 1, over ``trunk_chunk``-tile batches:
        gather tiles by index arithmetic → log1p-scale the depth →
        per-tile DEM percentile stats (the ``tile_stats`` CUDA kernel) →
        normalize the DEM → ResUNet trunk → LR features
    phase 2, over ``chunk``-tile batches:
        re-gather the DEM tiles → normalize with the phase-1 stats →
        ResUNet tail (the ``hr_tail`` CUDA kernel) → invert to meters →
        feather-weight → add into the scene mosaic, tile by tile in grid order
    finish: weight-normalize → clip → optional uint16 quantization.

Single-phase, over ``chunk``-tile batches: gather → log1p-scale the depth →
per-tile DEM stats (the ``tile_stats`` kernel) → normalize → one whole forward →
invert → mosaic; then the same finish.

Tiles are added to the mosaic in the same order as the JAX package's
``fori_loop`` (grid order), so the float sums keep the same order. The JAX
executor pads scenes and tile counts to shape buckets only to avoid XLA
recompiles; eager PyTorch has nothing to recompile, so the port runs the
content grid as it is.

With a ``mesh`` (ADR-0006's replicated formulation, JAX ``scene.py``
:256-258 and :470-482) the executor is single-phase, its chunk rounded up to
a multiple of ``dp`` (:func:`resolve_chunk`), and each chunk is split over the
``dp`` devices: each runs gather → normalize (``tile_stats``) → forward
(trunk and ``hr_tail``) → invert on its sub-chunk, with its own copy of the
padded scene and of the model. The predictions move to the accumulator's
device (the scene's, the mesh's first) and are added in the unsharded chunk
order. The JAX package keeps a replicated accumulator on every device; one
on the first device gives the same numbers, and the finish reads one device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from floodsr_tpu_torch.nn.resunet import ResUNet
from floodsr_tpu_torch.parallel.mesh import to_device
from floodsr_tpu_torch.ops.normalize import (
    dem_tile_stats,
    invert_depth_log1p,
    normalize_dem_with_stats,
    scale_depth_log1p,
)
from floodsr_tpu_torch.tiling.windows import build_feather_ramp

#: Default tiles per tail batch and per trunk batch. Fixed widths: the JAX
#: package picks its tail chunk from a TPU cost table, which does not apply.
DEFAULT_CHUNK = 8
DEFAULT_TRUNK_CHUNK = 32


def gather_tiles(
    scene: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, tile: int
) -> torch.Tensor:
    """``[n, tile, tile]`` windows of a 2-D scene at origins ``(y0, x0)``."""
    ar = torch.arange(tile, device=scene.device)
    rows = y0[:, None] + ar[None, :]
    cols = x0[:, None] + ar[None, :]
    return scene[rows[:, :, None], cols[:, None, :]]


def predict_tiles(
    forward, depth_pad, dem_pad, y0, x0, cfg, max_depth: float, dem_pct_clip: float,
    transposed: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One single-phase batch: gather → log1p-scale the depth → per-tile DEM
    stats (the ``tile_stats`` kernel) → normalize → ``forward`` → invert.

    Returns the ``[n, tile, tile]`` meter-domain predictions and the ``[n, 3]``
    stats (``p_clip, dem_min, dem_max``). ``transposed``: the scenes are
    transposed views of the model's; each tile is swapped back for the
    forward (convolutions are not transpose-equivariant) and its prediction
    swapped again.
    """
    tile, lr_tile, scale = cfg.hr_tile, cfg.lr_tile, cfg.scale
    depth_tiles = gather_tiles(depth_pad, y0 // scale, x0 // scale, lr_tile)
    dem_tiles = gather_tiles(dem_pad, y0, x0, tile)
    if transposed:
        depth_tiles = depth_tiles.transpose(-2, -1).contiguous()
        dem_tiles = dem_tiles.transpose(-2, -1).contiguous()
    depth_norm = scale_depth_log1p(depth_tiles, max_depth)
    p_clip, dem_min, dem_max = dem_tile_stats(dem_tiles, dem_pct_clip)
    dem_norm = normalize_dem_with_stats(dem_tiles, p_clip, dem_min, dem_max)
    pred_norm = forward(depth_norm[..., None], dem_norm[..., None])
    pred_m = invert_depth_log1p(pred_norm[..., 0], max_depth)
    if transposed:
        pred_m = pred_m.transpose(-2, -1)
    return pred_m, torch.stack([p_clip, dem_min, dem_max], dim=-1)


def axis_feather_weights(
    tile: int, overlap: int, first: torch.Tensor, last: torch.Tensor
) -> torch.Tensor:
    """Edge-flattened 1-D feather ramps for a batch of tiles, ``[n, tile]``.

    Scene-edge tiles keep weight 1.0 over their outward overlap (edge
    flattening); membership arrives as per-tile boolean flags.
    """
    ramp = torch.from_numpy(build_feather_ramp(tile, overlap)).to(first.device)
    w = ramp[None, :].expand(first.shape[0], tile)
    if overlap > 0:
        pos = torch.arange(tile, device=first.device)
        one = torch.ones((), dtype=torch.float32, device=first.device)
        w = torch.where(first[:, None] & (pos < overlap)[None, :], one, w)
        w = torch.where(last[:, None] & (pos >= tile - overlap)[None, :], one, w)
    return w


def feather_weights_chunk(
    tile: int,
    overlap: int,
    y_first: torch.Tensor,
    y_last: torch.Tensor,
    x_first: torch.Tensor,
    x_last: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Edge-flattened separable feather weights for a batch of tiles."""
    wy = axis_feather_weights(tile, overlap, y_first, y_last)
    wx = axis_feather_weights(tile, overlap, x_first, x_last)
    w = wy[:, :, None] * wx[:, None, :]
    return (w * valid[:, None, None]).to(torch.float32)


def select_mosaic_mode(overlap_hr: int) -> str:
    """Mosaic accumulator formulation for ``overlap_hr`` (env-overridable).

    ``hard`` (overlap 0, disjoint tiles: no weight sum), ``separable``
    (feathered: the weight sum factors into two 1-D profiles), or
    ``general`` (a 2-D weight sum; ``FLOODSR_SCENE_GENERAL_MOSAIC=1``).
    """
    if os.environ.get("FLOODSR_SCENE_GENERAL_MOSAIC"):
        return "general"
    return "hard" if int(overlap_hr) == 0 else "separable"


def validate_hard_grid(grid: dict[str, np.ndarray | int], tile: int) -> None:
    """Require a disjoint tile grid (the ``hard`` mosaic's invariant).

    The hard fast path skips the weight-sum normalization because disjoint
    full-weight tiles always sum to weight 1.0 under covered pixels. A grid
    with a clamped trailing start (content not a stride multiple) overlaps
    its last two tiles, which would silently DOUBLE depths in the seam band
    — callers must pad content to tile multiples first (``run_scene`` does).
    """
    for axis in ("y0", "x0"):
        starts = np.unique(np.asarray(grid[axis], np.int64))
        if starts.size > 1 and np.min(np.diff(starts)) < tile:
            raise ValueError(
                f"hard (overlap-0) mosaic requires disjoint tiles; {axis} "
                f"starts {starts.tolist()} overlap at tile={tile}. Pad the "
                f"content extent to a tile multiple before building the grid."
            )


def resolve_chunk(chunk: int, mesh=None, batch_axis: str = "dp") -> int:
    """The executor's actual per-step tile chunk (mesh-divisible when sharded)."""
    chunk = int(chunk)
    if mesh is not None:
        dp = int(mesh.shape[batch_axis])
        chunk = max(chunk, dp)
        chunk = -(-chunk // dp) * dp
    return chunk


def pack_scene_indices(
    grid: dict[str, np.ndarray | int], capacity: int, chunk: int
) -> dict[str, np.ndarray]:
    """Chunked per-tile index/flag arrays for a scene's content grid.

    ``capacity`` is a tile budget (chunk-rounded); the content grid is padded
    up to it with zero-weight dummies. The torch executor takes
    ``capacity == chunk == n`` (one row, no dummies).
    """
    n = len(grid["y0"])
    assert capacity % chunk == 0, (capacity, chunk)
    assert n <= capacity, f"grid has {n} tiles; executor capacity is {capacity}"
    ny, nx = int(grid["ny"]), int(grid["nx"])
    yi = np.asarray(grid["yi"], np.int64)
    xi = np.asarray(grid["xi"], np.int64)

    def pad_i32(a):
        return np.concatenate(
            [np.asarray(a, np.int32), np.zeros(capacity - n, np.int32)]
        ).reshape(-1, chunk)

    def pad_flag(a):
        return np.concatenate(
            [np.asarray(a, bool), np.zeros(capacity - n, bool)]
        ).reshape(-1, chunk)

    return {
        "y0": pad_i32(grid["y0"]),
        "x0": pad_i32(grid["x0"]),
        "yf": pad_flag(yi == 0),
        "yl": pad_flag(yi == ny - 1),
        "xf": pad_flag(xi == 0),
        "xl": pad_flag(xi == nx - 1),
        "valid": np.concatenate(
            [np.ones(n, np.float32), np.zeros(capacity - n, np.float32)]
        ).reshape(-1, chunk),
    }


def scene_indices(grid: dict[str, np.ndarray | int]) -> dict[str, np.ndarray]:
    """Flat ``[n]`` index/flag arrays of a content grid (no dummy tiles)."""
    n = len(grid["y0"])
    return {k: v.reshape(-1) for k, v in pack_scene_indices(grid, n, n).items()}


class SceneExecutor:
    """Scene executor for one scene geometry.

    Two-phase over ``model.trunk`` / ``model.tail`` (under the ``precision``
    policy) unless ``forward_fn(depth_nhwc, dem_nhwc) -> pred_nhwc`` is given:
    then single-phase, one whole forward per ``chunk`` of tiles, and ``model``
    may be ``None`` (``cfg`` must then name the tile geometry).

    With ``mesh``: single-phase and sharded over ``mesh[batch_axis]``;
    ``replicas`` maps each device of that axis to its forward
    ``(depth_nhwc, dem_nhwc) -> pred_nhwc`` (the model's copy there).

    ``executor(depth_pad, dem_pad, idx)`` takes the LR depth and HR DEM
    zero-padded to ``scene_shape`` (HR) / ``scene_shape // scale`` (LR), on
    the model's device, plus :func:`scene_indices` of the content grid, and
    returns ``(scene_out, stats)``: the ``scene_shape`` meter-domain mosaic
    (clipped to ``[0, max_depth]``, uint16-quantized when configured) and the
    per-tile DEM stats ``[n, 3]`` (``p_clip, dem_min, dem_max``).
    """

    def __init__(
        self,
        model: ResUNet,
        *,
        scene_shape: tuple[int, int],
        overlap_hr: int,
        max_depth: float,
        dem_pct_clip: float,
        chunk: int = DEFAULT_CHUNK,
        trunk_chunk: int = DEFAULT_TRUNK_CHUNK,
        transfer_dtype: str = "uint16",
        cfg=None,
        precision=None,
        forward_fn=None,
        mesh=None,
        batch_axis: str = "dp",
        replicas: "dict | None" = None,
    ):
        assert transfer_dtype in {"uint16", "float32"}, transfer_dtype
        if mesh is not None:
            self.shard_devices = mesh.axis_devices(batch_axis)
            assert replicas is not None and set(self.shard_devices) <= set(replicas), (
                "a sharded scene executor needs a forward on every device of the mesh"
            )
        self.mesh = mesh
        self.replicas = replicas
        assert model is not None or (forward_fn is not None and cfg is not None), (
            "a scene executor needs a model to split, or forward_fn and cfg"
        )
        self.model = model
        self.precision = precision
        self.forward_fn = forward_fn
        self.cfg = cfg if cfg is not None else model.cfg
        self.scene_shape = (int(scene_shape[0]), int(scene_shape[1]))
        self.overlap_hr = int(overlap_hr)
        self.max_depth = float(max_depth)
        self.dem_pct_clip = float(dem_pct_clip)
        self.chunk = max(1, resolve_chunk(chunk, mesh, batch_axis))
        self.trunk_chunk = max(1, int(trunk_chunk))
        self.transfer_dtype = transfer_dtype
        self.mosaic_mode = select_mosaic_mode(self.overlap_hr)

    # -- mosaic -------------------------------------------------------------

    def _mosaic_init(self, device):
        accum = torch.zeros(self.scene_shape, dtype=torch.float32, device=device)
        if self.mosaic_mode == "hard":
            return [accum]
        if self.mosaic_mode == "separable":
            return [
                accum,
                torch.zeros(self.scene_shape[0], dtype=torch.float32, device=device),
                torch.zeros(self.scene_shape[1], dtype=torch.float32, device=device),
            ]
        return [accum, torch.zeros_like(accum)]

    def _mosaic_accumulate(self, carry, idx_c, pred_m) -> None:
        """Add one batch of tile predictions into ``carry``, tile by tile."""
        tile = self.cfg.hr_tile
        y0s = idx_c["y0_host"]
        x0s = idx_c["x0_host"]
        valid = idx_c["valid"]
        if self.mosaic_mode == "hard":
            pw = pred_m * valid[:, None, None]
            for i, (y, x) in enumerate(zip(y0s, x0s)):
                carry[0][y : y + tile, x : x + tile] += pw[i]
            return
        weights = feather_weights_chunk(
            tile, self.overlap_hr,
            idx_c["yf"], idx_c["yl"], idx_c["xf"], idx_c["xl"], valid,
        )
        pw = pred_m * weights
        if self.mosaic_mode == "separable":
            wy = axis_feather_weights(tile, self.overlap_hr, idx_c["yf"], idx_c["yl"])
            wx = axis_feather_weights(tile, self.overlap_hr, idx_c["xf"], idx_c["xl"])
            # One representative tile per grid row (x-first) / col (y-first)
            # feeds the 1-D profiles.
            row_contrib = wy * (valid * idx_c["xf"])[:, None]
            col_contrib = wx * (valid * idx_c["yf"])[:, None]
            acc, py, px = carry
            for i, (y, x) in enumerate(zip(y0s, x0s)):
                acc[y : y + tile, x : x + tile] += pw[i]
                py[y : y + tile] += row_contrib[i]
                px[x : x + tile] += col_contrib[i]
            return
        acc, ws = carry
        for i, (y, x) in enumerate(zip(y0s, x0s)):
            acc[y : y + tile, x : x + tile] += pw[i]
            ws[y : y + tile, x : x + tile] += weights[i]

    def _finish(self, carry) -> torch.Tensor:
        if self.mosaic_mode == "hard":
            scene = carry[0]
        else:
            if self.mosaic_mode == "separable":
                accum, wy_sum, wx_sum = carry
                wsum = wy_sum[:, None] * wx_sum[None, :]
            else:
                accum, wsum = carry
            ratio = accum / torch.clamp_min(wsum, 1e-6)
            scene = torch.where(wsum > 0, ratio, torch.zeros_like(ratio))
        out = torch.clamp(scene, 0.0, self.max_depth)
        if self.transfer_dtype == "uint16":
            # Fixed-point transfer encoding: quantization step max_depth/65535
            # (~7.6e-5 m at the default 5 m); the host dequantizes, then
            # crops/post-resamples/masks. torch.round rounds half to even,
            # as jnp.round does.
            q = torch.tensor(65535.0 / self.max_depth, dtype=torch.float32, device=out.device)
            return torch.round(out * q).to(torch.uint16)
        return out

    # -- the phases ---------------------------------------------------------

    def _chunk_indices(self, idx: dict, dev):
        """Per-tile flags and weights on the device, origins on the host."""
        flags = {
            k: torch.from_numpy(np.asarray(idx[k], bool)).to(dev)
            for k in ("yf", "yl", "xf", "xl")
        }
        valid = torch.from_numpy(np.asarray(idx["valid"], np.float32)).to(dev)
        y0_host = np.asarray(idx["y0"], np.int64).tolist()
        x0_host = np.asarray(idx["x0"], np.int64).tolist()

        def chunk(s: int, e: int) -> dict:
            idx_c = {k: v[s:e] for k, v in flags.items()}
            idx_c["valid"] = valid[s:e]
            idx_c["y0_host"] = y0_host[s:e]
            idx_c["x0_host"] = x0_host[s:e]
            return idx_c

        return chunk

    @torch.no_grad()
    def __call__(self, depth_pad: torch.Tensor, dem_pad: torch.Tensor, idx: dict):
        cfg = self.cfg
        tile, lr_tile, scale = cfg.hr_tile, cfg.lr_tile, cfg.scale
        assert tuple(dem_pad.shape) == self.scene_shape, (
            f"DEM must be padded to {self.scene_shape}; got {tuple(dem_pad.shape)}"
        )
        dev = dem_pad.device
        n = int(len(idx["y0"]))
        y0 = torch.from_numpy(np.asarray(idx["y0"], np.int64)).to(dev)
        x0 = torch.from_numpy(np.asarray(idx["x0"], np.int64)).to(dev)
        chunk_idx = self._chunk_indices(idx, dev)
        stats = torch.empty((n, 3), dtype=torch.float32, device=dev)

        if self.mesh is not None:
            return self._sharded(depth_pad, dem_pad, y0, x0, chunk_idx, stats)

        if self.forward_fn is not None:
            # Single phase — one whole forward per chunk.
            carry = self._mosaic_init(dev)
            for s in range(0, n, self.chunk):
                e = min(n, s + self.chunk)
                pred_m, stats[s:e] = predict_tiles(
                    self.forward_fn, depth_pad, dem_pad, y0[s:e], x0[s:e], cfg,
                    self.max_depth, self.dem_pct_clip,
                )
                self._mosaic_accumulate(carry, chunk_idx(s, e), pred_m)
            return self._finish(carry), stats

        # Phase 1 — trunk over wide batches; keep LR features + stats.
        feats = None
        for s in range(0, n, self.trunk_chunk):
            e = min(n, s + self.trunk_chunk)
            depth_tiles = gather_tiles(
                depth_pad, y0[s:e] // scale, x0[s:e] // scale, lr_tile
            )
            dem_tiles = gather_tiles(dem_pad, y0[s:e], x0[s:e], tile)
            depth_norm = scale_depth_log1p(depth_tiles, self.max_depth)
            p_clip, dem_min, dem_max = dem_tile_stats(dem_tiles, self.dem_pct_clip)
            dem_norm = normalize_dem_with_stats(dem_tiles, p_clip, dem_min, dem_max)
            feat = self.model.trunk(
                depth_norm[..., None], dem_norm[..., None], self.precision
            )
            if feats is None:
                feats = torch.empty((n, *feat.shape[1:]), dtype=feat.dtype, device=dev)
            feats[s:e] = feat
            stats[s:e] = torch.stack([p_clip, dem_min, dem_max], dim=-1)

        # Phase 2 — HR tail + mosaic at the tail chunk, reusing phase-1 stats.
        carry = self._mosaic_init(dev)
        for s in range(0, n, self.chunk):
            e = min(n, s + self.chunk)
            dem_tiles = gather_tiles(dem_pad, y0[s:e], x0[s:e], tile)
            st = stats[s:e]
            dem_norm = normalize_dem_with_stats(dem_tiles, st[:, 0], st[:, 1], st[:, 2])
            pred_norm = self.model.tail(feats[s:e], dem_norm[..., None], self.precision)
            pred_m = invert_depth_log1p(pred_norm[..., 0], self.max_depth)
            self._mosaic_accumulate(carry, chunk_idx(s, e), pred_m)
        return self._finish(carry), stats

    def _sharded(self, depth_pad, dem_pad, y0, x0, chunk_idx, stats):
        """The single-phase loop with each chunk split over the ``dp`` devices."""
        dev = dem_pad.device
        n = int(y0.shape[0])
        inputs = {
            d: tuple(to_device(t, d) for t in (depth_pad, dem_pad, y0, x0))
            for d in dict.fromkeys(self.shard_devices)
        }
        sub = self.chunk // len(self.shard_devices)
        carry = self._mosaic_init(dev)
        for s in range(0, n, self.chunk):
            e = min(n, s + self.chunk)
            shards = []
            # enqueue every shard's work before the first copy back
            for i, d in enumerate(self.shard_devices):
                a, b = s + i * sub, min(e, s + (i + 1) * sub)
                if a >= b:
                    break
                depth_d, dem_d, y0_d, x0_d = inputs[d]
                shards.append(predict_tiles(
                    self.replicas[d], depth_d, dem_d, y0_d[a:b], x0_d[a:b], self.cfg,
                    self.max_depth, self.dem_pct_clip,
                ))
            pred_m = torch.cat([to_device(p, dev) for p, _ in shards])
            stats[s:e] = torch.cat([to_device(st, dev) for _, st in shards])
            self._mosaic_accumulate(carry, chunk_idx(s, e), pred_m)
        return self._finish(carry), stats
