"""PyTorch inference engine over ``.fsrz`` artifacts — port of ``EngineJAX``.

Same seam as the JAX engine (``floodsr_tpu/engine/jax_engine.py``):
construction loads the model and resolves a :class:`ModelIOContract`;
``run_tile`` takes prepared meter arrays, applies the shared nodata /
normalization policy, runs the model and inverts to meters; ``run_scene``
runs a whole scene through the two-phase executor
(:mod:`floodsr_tpu_torch.engine.scene`) with one upload and one download,
then finishes on the host (crop → dequant → resample → low-depth mask, the
reference order).

The engine runs on the GPU unless constructed with ``device="cpu"``, and
raises when CUDA is absent. It sets TF32 off for cuDNN and matmuls when it
loads: ``f32`` is the only precision policy ported.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from floodsr_tpu_torch.device import resolve_device, set_strict_f32
from floodsr_tpu_torch.engine.base import EngineBase, ModelIOContract
from floodsr_tpu_torch.engine.scene import (
    DEFAULT_CHUNK,
    DEFAULT_TRUNK_CHUNK,
    SceneExecutor,
    scene_indices,
    validate_hard_grid,
)
from floodsr_tpu_torch.nn.checkpoint import load_artifact, params_from_jax
from floodsr_tpu_torch.nn.resunet import ResUNet, ResUNetConfig, resolve_precision_policy
from floodsr_tpu_torch.ops.normalize import (
    _parse_dem_normalization_stats,
    invert_depth_log1p,
    normalize_dem_batch,
    normalize_dem_with_stats,
    replace_nodata_with_zero,
    scale_depth_log1p,
)
from floodsr_tpu_torch.ops.resample import StreamingSeparableResampler, reproject_bilinear
from floodsr_tpu_torch.tiling import build_window_grid

_POLICY_BY_NAME = {"float32": "f32", "bfloat16": "bf16", "mixed": "mixed"}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EngineTorch(EngineBase):
    """Batched PyTorch engine over ``.fsrz`` model artifacts."""

    def __init__(
        self,
        model_fp: str | Path,
        *,
        logger=None,
        compute_dtype: str = "float32",
        device: "str | torch.device" = "cuda",
        max_batch: int = 8,
        output_transfer: str = "uint16",
        scene_chunk: int = DEFAULT_CHUNK,
        scene_trunk_chunk: int = DEFAULT_TRUNK_CHUNK,
    ):
        self.device = resolve_device(device)
        self._model_fp = Path(model_fp).expanduser().resolve()
        assert self._model_fp.exists(), f"model file does not exist: {self._model_fp}"
        self.log = logger or logging.getLogger(__name__)
        assert compute_dtype in _POLICY_BY_NAME, (
            f"compute_dtype must be one of {sorted(_POLICY_BY_NAME)}; got {compute_dtype}"
        )
        self.precision_policy = resolve_precision_policy(_POLICY_BY_NAME[compute_dtype])
        if output_transfer not in {"uint16", "float32"}:
            if output_transfer == "uint12":
                raise NotImplementedError("output_transfer='uint12' is not ported yet")
            raise AssertionError(f"unsupported output_transfer={output_transfer}")
        self.output_transfer = output_transfer
        self.max_batch = int(max_batch)
        self.scene_chunk = int(scene_chunk)
        self.scene_trunk_chunk = int(scene_trunk_chunk)
        self.config: ResUNetConfig | None = None
        self.model: ResUNet | None = None
        self.contract: ModelIOContract | None = None
        self.last_scene_timings: dict[str, float] = {}
        self.load()

    # -- lifecycle ----------------------------------------------------------

    def model_path(self) -> Path:
        return self._model_fp

    def load(self) -> None:
        """Load the artifact, resolve the contract, place the weights on the device."""
        if self.device.type == "cuda":
            set_strict_f32()
        if self._model_fp.suffix.lower() == ".onnx":
            raise NotImplementedError(
                "ONNX artifacts are not ported to floodsr_tpu_torch yet; use .fsrz"
            )
        artifact = load_artifact(self._model_fp)
        manifest = artifact["manifest"]
        if manifest.get("architecture", "ResUNet_DEM") != "ResUNet_DEM":
            raise NotImplementedError(
                f"architecture {manifest.get('architecture')!r} is not ported yet"
            )
        self.config = artifact["config"]
        contract = manifest["io_contract"]
        self.contract = ModelIOContract(
            depth_input_name=contract["depth_input_name"],
            dem_input_name=contract["dem_input_name"],
            output_name=contract["output_name"],
            depth_lr_hwc=tuple(contract["depth_lr_hwc"]),
            dem_hr_hwc=tuple(contract["dem_hr_hwc"]),
            output_hwc=tuple(contract["output_hwc"]),
            scale=int(contract["scale"]),
        )
        model = ResUNet(self.config)
        model.load_state_dict(params_from_jax(artifact["params"], artifact["state"]))
        self.model = model.to(self.device).eval()
        self.log.info(
            f"loaded torch model '{self._model_fp.name}' "
            f"({manifest.get('architecture', 'ResUNet_DEM')}) "
            f"scale={self.contract.scale} device={self.device} dtype=float32"
        )

    def close(self) -> None:
        """Release the device weights."""
        self.model = None
        self.contract = None
        self.config = None

    # -- geometry -----------------------------------------------------------

    def scene_config(self, tile_lr: "int | None" = None) -> ResUNetConfig:
        """The config driving scene windowing — contract tile or an override.

        ``tile_lr`` (LR px) != the artifact's trained tile runs the SAME
        weights convolutionally at a different window size.
        """
        assert self.config is not None
        cfg = self.config
        if tile_lr is None or int(tile_lr) == cfg.lr_tile:
            return cfg
        tile_lr = int(tile_lr)
        divisor = 2 ** cfg.levels
        assert tile_lr >= divisor and tile_lr % divisor == 0, (
            f"tile_size override {tile_lr} must be a positive multiple of "
            f"2^levels={divisor} (UNet skip shapes)"
        )
        import dataclasses as _dc

        return _dc.replace(cfg, lr_tile=tile_lr)

    def content_shape(
        self, crop_shape: tuple[int, int], tile_lr: "int | None" = None
    ) -> tuple[int, int]:
        """The crop extent padded up to whole tiles (HR px): the executed scene."""
        tile = self.scene_config(tile_lr).hr_tile
        return (
            -(-int(crop_shape[0]) // tile) * tile,
            -(-int(crop_shape[1]) // tile) * tile,
        )

    def _put_padded(self, arr, target_shape: tuple[int, int]) -> torch.Tensor:
        """``arr`` (numpy or tensor) as a float32 device tensor zero-padded to shape."""
        th, tw = target_shape
        h, w = int(arr.shape[0]), int(arr.shape[1])
        assert h <= th and w <= tw, f"scene {tuple(arr.shape)} exceeds {target_shape}"
        if isinstance(arr, np.ndarray):
            arr32 = np.ascontiguousarray(arr, dtype=np.float32)
            if (h, w) != (th, tw):
                arr32 = np.pad(arr32, ((0, th - h), (0, tw - w)))
            return torch.from_numpy(arr32).to(self.device)
        dev = arr.to(self.device, torch.float32)
        if (h, w) != (th, tw):
            dev = F.pad(dev, (0, tw - w, 0, th - h))
        return dev.contiguous()

    # -- scenes -------------------------------------------------------------

    def warmup(
        self,
        crop_shapes,
        *,
        stride_hr: int,
        overlap_hr: int,
        max_depth: float,
        dem_pct_clip: float,
        tile_lr: "int | None" = None,
    ) -> int:
        """Run one scene of zeros per distinct scene geometry, before traffic.

        Eager PyTorch compiles nothing at run time and the port carries no
        shape buckets, so there is no executable to precompile. What the
        first scene of a geometry does pay for, and what this does ahead of
        it: on CUDA, ``nvcc`` builds and loads the hand-written kernels the
        model uses (all at once); the first tail call packs the ``hr_tail``
        weights, with the tensor-core pack at the widths that route takes;
        and the zeros scene lets cuDNN choose its algorithms at these batch
        shapes and fills the caching allocator's pools (device and pinned
        host) at this scene size. ``crop_shapes``: iterable of expected HR
        scene extents; extents that pad to the same whole-tile scene are
        warmed once. Returns the number of distinct geometries warmed.
        """
        assert self.model is not None and self.config is not None, (
            "engine must be loaded before warmup"
        )
        cfg = self.scene_config(tile_lr)
        if self.device.type == "cuda":
            from floodsr_tpu_torch.nn.resunet import hr_tail_eligible
            from floodsr_tpu_torch.ops.kernels import _build

            names = ["tile_stats"] + (["hr_tail"] if hr_tail_eligible(self.model) else [])
            _build.build(names)
            for name in names:
                _build.load(name)
        warmed = set()
        for shape in crop_shapes:
            shape = (int(shape[0]), int(shape[1]))
            content = self.content_shape(shape, tile_lr)
            if content in warmed:
                continue
            warmed.add(content)
            self.run_scene(
                np.zeros((content[0] // cfg.scale, content[1] // cfg.scale), np.float32),
                np.zeros(content, np.float32),
                stride_hr=int(stride_hr),
                overlap_hr=int(overlap_hr),
                max_depth=float(max_depth),
                dem_pct_clip=float(dem_pct_clip),
                crop_shape=content,
                tile_lr=tile_lr,
            )
        self.log.info(f"warmed {len(warmed)} scene geometry(ies)")
        return len(warmed)

    def run_scene(
        self,
        depth_raw,
        dem_raw,
        *,
        stride_hr: int,
        overlap_hr: int,
        max_depth: float,
        dem_pct_clip: float,
        crop_shape: tuple[int, int],
        post_resample=None,
        low_depth_mask_m: float = 1e-3,
        row_sink=None,
        tile_lr: "int | None" = None,
    ) -> tuple[np.ndarray, dict[str, np.ndarray]]:
        """Whole-scene execution: one upload, the two-phase executor, one download.

        ``depth_raw``/``dem_raw`` are the UNPADDED LR/HR scenes (numpy arrays
        or tensors already on the device). The engine pads them to whole
        tiles, runs the executor over the window grid derived from
        ``stride_hr``, then finishes on the host (:meth:`_finish_scene`).
        ``row_sink(band)`` receives the finished rows top to bottom.

        Returns the finished meter-domain scene and per-tile DEM stats
        (``p_clip``/``dem_min``/``dem_max``) in the grid's row-major order.
        """
        assert self.model is not None and self.config is not None, (
            "engine must be loaded before inference"
        )
        cfg = self.scene_config(tile_lr)
        tile, scale = cfg.hr_tile, cfg.scale
        crop_h, crop_w = int(crop_shape[0]), int(crop_shape[1])
        self.last_scene_timings = {}
        content = self.content_shape((crop_h, crop_w), tile_lr)
        grid = build_window_grid(content[0], content[1], tile, int(stride_hr))
        if int(overlap_hr) == 0:
            validate_hard_grid(grid, tile)
        n = len(grid["y0"])
        idx = scene_indices(grid)
        executor = SceneExecutor(
            self.model,
            cfg=cfg,
            scene_shape=content,
            overlap_hr=int(overlap_hr),
            max_depth=float(max_depth),
            dem_pct_clip=float(dem_pct_clip),
            chunk=self.scene_chunk,
            trunk_chunk=self.scene_trunk_chunk,
            transfer_dtype=self.output_transfer,
        )

        t0 = time.perf_counter()
        depth_dev = self._put_padded(depth_raw, (content[0] // scale, content[1] // scale))
        dem_dev = self._put_padded(dem_raw, content)
        _sync(self.device)
        t1 = time.perf_counter()
        out, stats = executor(depth_dev, dem_dev, idx)
        _sync(self.device)
        t2 = time.perf_counter()

        stats_np = stats.cpu().numpy()
        out_np = self._finish_scene(
            out,
            crop_shape=(crop_h, crop_w),
            max_depth=float(max_depth),
            post_resample=post_resample,
            low_depth_mask_m=float(low_depth_mask_m),
            row_sink=row_sink,
        )
        t3 = time.perf_counter()
        self.log.debug(
            f"run_scene timings: h2d={t1 - t0:.3f}s exec={t2 - t1:.3f}s "
            f"d2h+post={t3 - t2:.3f}s tiles={n} scene={content}"
        )
        # Diagnostic breakdown of the last scene (read by the worker into its
        # diagnostics): upload, device execution (after a synchronize), and
        # the download + host finish.
        self.last_scene_timings = {
            "h2d_s": t1 - t0,
            "exec_s": t2 - t1,
            "finish_s": t3 - t2,
            "tiles": n,
            **self._finish_timings,
        }
        return out_np, {
            "p_clip": stats_np[:, 0],
            "dem_min": stats_np[:, 1],
            "dem_max": stats_np[:, 2],
        }

    def _finish_scene(
        self,
        out: torch.Tensor,
        *,
        crop_shape: tuple[int, int],
        max_depth: float,
        post_resample,
        low_depth_mask_m: float,
        row_sink=None,
    ) -> np.ndarray:
        """One download of the cropped scene, then crop → dequant → resample → mask.

        Reference postprocess order (``floodsr/models/ResUNet_16x_DEM.py:
        554-583``): crop → clip (on the device) → resample → low-depth mask.
        Rows go to ``row_sink`` in bands as they are finished.
        """
        crop_h, crop_w = crop_shape
        t0 = time.perf_counter()
        host = out[:crop_h, :crop_w].cpu().numpy()
        t1 = time.perf_counter()
        if self.output_transfer == "uint16":
            scene = host.astype(np.float32)
            scene *= float(max_depth) / 65535.0  # in place: no second temporary
        else:
            scene = np.asarray(host, np.float32)
        t2 = time.perf_counter()

        if post_resample is not None:
            dst_shape, src_t, dst_t = post_resample
            dst_shape = tuple(int(v) for v in dst_shape)
            if src_t.is_rectilinear() and dst_t.is_rectilinear():
                resampler = StreamingSeparableResampler(
                    (crop_h, crop_w), src_t, dst_shape, dst_t
                )
                _, scene = resampler.feed(scene)
                assert resampler.complete, "separable resample did not cover all rows"
            else:
                scene = reproject_bilinear(scene, src_t, dst_shape, dst_t)
        t3 = time.perf_counter()

        scene = np.clip(scene, 0.0, max_depth)
        final = np.where(scene < low_depth_mask_m, 0.0, scene).astype(np.float32)
        sink_s = 0.0
        if row_sink is not None:
            band_rows = 512
            for r in range(0, final.shape[0], band_rows):
                ts = time.perf_counter()
                row_sink(final[r : r + band_rows])
                sink_s += time.perf_counter() - ts
        t4 = time.perf_counter()
        self._finish_timings = {
            "d2h_wait_s": t1 - t0,
            "host_dequant_s": t2 - t1,
            "host_resample_s": t3 - t2,
            "host_sink_s": sink_s,
            "host_post_s": t4 - t1,
        }
        return final

    # -- tiles --------------------------------------------------------------

    @torch.no_grad()
    def run_tiles(
        self,
        depth_lr_m: np.ndarray,
        dem_hr_m: np.ndarray,
        max_depth: float = 5.0,
        dem_pct_clip: float = 95.0,
        dem_ref_stats: dict[str, float] | None = None,
        normalize_inputs: bool = True,
        logger=None,
    ) -> dict[str, Any]:
        """Batched inference: ``[N,h,w]`` depth + ``[N,H,W]`` DEM → ``[N,H,W]`` meters."""
        assert self.contract is not None and self.model is not None, (
            "engine must be loaded before inference"
        )
        start = time.perf_counter()
        depth = np.asarray(depth_lr_m, dtype=np.float32)
        dem = np.asarray(dem_hr_m, dtype=np.float32)
        assert depth.ndim == 3 and dem.ndim == 3, (
            f"run_tiles expects [N,h,w] + [N,H,W]; got {depth.shape}, {dem.shape}"
        )
        n = depth.shape[0]
        assert dem.shape[0] == n, f"batch mismatch: {depth.shape[0]} vs {dem.shape[0]}"
        assert depth.shape[1:] == self.contract.depth_lr_hwc[:2], (
            f"depth tile shape {depth.shape[1:]} != contract {self.contract.depth_lr_hwc[:2]}"
        )
        assert dem.shape[1:] == self.contract.dem_hr_hwc[:2], (
            f"DEM tile shape {dem.shape[1:]} != contract {self.contract.dem_hr_hwc[:2]}"
        )
        ref = None
        if dem_ref_stats is not None:
            ref = _parse_dem_normalization_stats(dem_ref_stats)

        preds_m = np.empty_like(dem)
        preds_norm = np.empty_like(dem)
        stats_out = {k: np.empty((n,), np.float32) for k in ("p_clip", "dem_min", "dem_max")}
        for pos in range(0, n, self.max_batch):
            end = min(n, pos + self.max_batch)
            d = torch.from_numpy(depth[pos:end]).to(self.device)
            m = torch.from_numpy(dem[pos:end]).to(self.device)
            b = end - pos
            if normalize_inputs:
                depth_norm = scale_depth_log1p(d, max_depth)
                if ref is not None:
                    st = [
                        torch.full((b,), v, dtype=torch.float32, device=self.device)
                        for v in ref
                    ]
                    dem_norm = normalize_dem_with_stats(m, *st)
                    stats = dict(zip(("p_clip", "dem_min", "dem_max"), st))
                else:
                    dem_norm, stats = normalize_dem_batch(m, dem_pct_clip)
            else:
                depth_norm, dem_norm = d, m
                stats = {
                    "p_clip": torch.full((b,), float(dem_pct_clip)),
                    "dem_min": torch.zeros((b,)),
                    "dem_max": torch.ones((b,)),
                }
            pred_norm = self.model(depth_norm[..., None], dem_norm[..., None])[..., 0]
            pred_m = invert_depth_log1p(pred_norm, max_depth)
            preds_m[pos:end] = pred_m.cpu().numpy()
            preds_norm[pos:end] = pred_norm.cpu().numpy()
            for k in stats_out:
                stats_out[k][pos:end] = stats[k].cpu().numpy()
        return {
            "predictions_m": preds_m,
            "predictions_norm": preds_norm,
            "dem_stats_used": stats_out,
            "runtime_s": float(time.perf_counter() - start),
        }

    def run_tile(
        self,
        depth_lr_m: np.ndarray,
        dem_hr_m: np.ndarray,
        max_depth: float = 5.0,
        dem_pct_clip: float = 95.0,
        dem_ref_stats: dict[str, float] | None = None,
        depth_lr_nodata: float | None = None,
        dem_hr_nodata: float | None = None,
        normalize_inputs: bool = True,
        logger=None,
    ) -> dict[str, Any]:
        """Single-tile inference with the reference engine's exact contract.

        Matches ``EngineORT.run_tile`` semantics (reference:
        ``floodsr/engine/ort.py:128-208``) including nodata replacement,
        finite/range validation, and the returned dict keys.
        """
        assert self.contract is not None, "engine must be loaded before inference"
        start = time.perf_counter()
        depth_np = np.asarray(depth_lr_m, dtype=np.float32)
        dem_np = np.asarray(dem_hr_m, dtype=np.float32)

        if normalize_inputs:
            depth_np = replace_nodata_with_zero(depth_np, depth_lr_nodata)
            dem_np = replace_nodata_with_zero(dem_np, dem_hr_nodata)
            assert np.isfinite(depth_np).all(), (
                "low-res depth contains non-finite values after nodata replacement"
            )
            assert np.isfinite(dem_np).all(), (
                "DEM contains non-finite values after nodata replacement"
            )
        else:
            assert np.isfinite(depth_np).all(), "low-res depth contains non-finite values"
            assert np.isfinite(dem_np).all(), "DEM contains non-finite values"
            assert float(depth_np.min()) >= 0.0 and float(depth_np.max()) <= 1.0, (
                "depth tile must be normalized to [0, 1]"
            )
            assert float(dem_np.min()) >= 0.0 and float(dem_np.max()) <= 1.0, (
                "DEM tile must be normalized to [0, 1]"
            )

        result = self.run_tiles(
            depth_np[None],
            dem_np[None],
            max_depth=float(max_depth),
            dem_pct_clip=float(dem_pct_clip),
            dem_ref_stats=dem_ref_stats,
            normalize_inputs=normalize_inputs,
            logger=logger or self.log,
        )
        prediction_m = result["predictions_m"][0]
        prediction_norm = result["predictions_norm"][0]
        assert prediction_m.shape == self.contract.output_hwc[:2], (
            f"prediction shape {prediction_m.shape} != expected {self.contract.output_hwc[:2]}"
        )
        if normalize_inputs:
            dem_stats_used = {
                k: float(result["dem_stats_used"][k][0])
                for k in ("p_clip", "dem_min", "dem_max")
            }
        elif dem_ref_stats is not None and isinstance(dem_ref_stats, dict):
            dem_stats_used = {
                k: float(v)
                for k, v in dem_ref_stats.items()
                if k in {"p_clip", "dem_min", "dem_max"}
            }
        else:
            dem_stats_used = {"p_clip": float(dem_pct_clip), "dem_min": 0.0, "dem_max": 1.0}

        return {
            "prediction_m": prediction_m.astype(np.float32, copy=False),
            "prediction_norm": prediction_norm.astype(np.float32, copy=False),
            "dem_stats_used": dem_stats_used,
            "runtime_s": float(time.perf_counter() - start),
        }
