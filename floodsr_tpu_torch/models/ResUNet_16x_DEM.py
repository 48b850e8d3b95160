"""16× DEM-conditioned ResUNet model worker — the ToHR flow on PyTorch/CUDA.

Port of the JAX package's worker (``floodsr_tpu/models/ResUNet_16x_DEM.py``),
itself at reference parity (``floodsr/models/ResUNet_16x_DEM.py:140-640``):
input alignment, pad-to-tile-multiple, hard/feather windowing with
forced trailing-edge coverage, meter-domain clipping, optional bilinear
post-resample back to the raw DEM grid, low-depth masking, bounds-asserted
GeoTIFF write, and the same diagnostics dict keys.

The whole scene runs on the device through :meth:`EngineTorch.run_scene`
(one upload of the DEM, uint16-encoded when large; the two-phase executor;
one download). The worker runs on the GPU unless constructed with
``device="cpu"``, and raises when CUDA is absent. ``mesh`` and ``scene_mode``
go to the engine (:class:`EngineTorch`); under a mesh the DEM cache and the
prefetch keep their DEMs on the mesh's first device, where the engine keeps
the scene, as the JAX worker keeps them on its default device.

Serving: recently used DEMs stay resident on the device (terrain is static
across forecast cycles), :meth:`ModelWorker.prefetch_dem` decodes and uploads
a DEM in a background thread on a CUDA stream of its own, and
:meth:`ModelWorker.run_many` streams scenes through one engine with the next
scene's DEM in flight while the current scene computes.
"""

from __future__ import annotations

import contextvars
import logging
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Any

import numpy as np
import torch

from floodsr_tpu_torch import tracing
from floodsr_tpu_torch.device import resolve_device
from floodsr_tpu_torch.engine import EngineTorch
from floodsr_tpu_torch.io.geotiff import pixel_size, raster_bounds
from floodsr_tpu_torch.models.base import Model
from floodsr_tpu_torch.parallel.mesh import mesh_device
from floodsr_tpu_torch.preprocessing import (
    _read_single_band_raster,
    prepare_inputs,
    resolve_preprocess_config,
)
from floodsr_tpu_torch.tiling import build_window_grid


class _BuildingMaskSink:
    """A sink that zeroes depths inside building footprints (``mask``, the
    output grid's) as the rows go to ``writer``, counting the wet cells it
    blocks.

    It has ``write_rows`` only. Not being a
    :class:`~floodsr_tpu_torch.io.tiff.StripStreamWriter`, it gets the
    finished rows in bands, never the codes of the finish's one pass: the
    file must hold the masked rows.
    """

    def __init__(self, writer, mask: np.ndarray):
        self._writer, self._mask = writer, mask
        self._row = 0
        self.blocked_wet = 0

    def write_rows(self, band: np.ndarray) -> None:
        m = self._mask[self._row : self._row + band.shape[0]]
        self.blocked_wet += int(((band > 0) & m).sum())
        self._row += band.shape[0]
        self._writer.write_rows(np.where(m, 0.0, band).astype(band.dtype, copy=False))


class ModelWorker(Model):
    """Model worker implementing the batched ToHR flow for ``ResUNet_16x_DEM``."""

    model_version = "ResUNet_16x_DEM"
    low_depth_mask_m = 1e-3

    def __init__(
        self,
        model_fp: str | Path,
        *,
        logger=None,
        compute_dtype: str = "float32",
        max_batch: int = 8,
        mesh=None,
        scene_mode: str = "replicated",
        output_transfer: str = "uint16",
        input_transfer: str = "uint16",
        device: str = "cuda",
    ):
        super().__init__(model_fp=model_fp, model_version=self.model_version, logger=logger)
        self.device = resolve_device(device) if mesh is None else mesh_device(mesh, device)
        self.mesh = mesh
        self.scene_mode = scene_mode
        self.compute_dtype = compute_dtype
        self.max_batch = int(max_batch)
        self.output_transfer = output_transfer
        self.input_transfer = input_transfer
        self.engine: EngineTorch | None = None
        self._dem_device_cache: OrderedDict = OrderedDict()
        self._dem_prefetch: dict = {}
        # Guards cache + prefetch-registry mutation: run() on the calling
        # thread and the background prefetch insert/evict concurrently.
        self._dem_cache_lock = threading.Lock()
        self._dem_cache_bytes = 0
        # The prefetch thread's own CUDA stream (made on entry, CUDA only).
        self._prefetch_stream = None
        #: DEM decodes made inside run(), decodes made by the prefetch thread,
        #: and run() calls that found their DEM resident, since construction.
        self.dem_counts = {"decoded_in_run": 0, "decoded_by_prefetch": 0, "resident": 0}

    def __enter__(self):
        self.engine = EngineTorch(
            self.model_fp,
            logger=self.log,
            compute_dtype=self.compute_dtype,
            max_batch=self.max_batch,
            mesh=self.mesh,
            scene_mode=self.scene_mode,
            output_transfer=self.output_transfer,
            device=self.device,
        )
        if self.device.type == "cuda":
            self._prefetch_stream = torch.cuda.Stream(self.device)
        return self

    def __exit__(self, exc_type, exc, tb):
        # Join in-flight DEM prefetch threads BEFORE clearing: a late
        # _dem_cache_put would otherwise repopulate the "cleared" cache of a
        # closed worker (retaining a large device buffer) and race
        # interpreter teardown with a mid-flight upload.
        with self._dem_cache_lock:
            inflight = list(self._dem_prefetch.values())
        for t in inflight:
            t.join(timeout=60.0)
        if self.engine is not None:
            self.engine.close()
        self.engine = None
        with self._dem_cache_lock:
            self._dem_device_cache.clear()
            self._dem_cache_bytes = 0
            self._dem_prefetch.clear()
        self._prefetch_stream = None
        return False

    # -- DEM device cache / scene streaming ----------------------------

    #: max device-resident DEMs kept across runs (terrain is static across
    #: forecast cycles; a hit skips both GeoTIFF decode and the upload).
    DEM_CACHE_CAP = 4
    #: byte budget for the cached device DEMs (float32 on the device, so
    #: 4 bytes a pixel: count alone could pressure device memory on
    #: country-scale terrain).
    DEM_CACHE_MAX_BYTES = 2 * 1024**3

    def _dem_cache_key(self, path: Path):
        try:
            st = path.stat()
        except OSError:
            return None
        return (str(path), st.st_mtime_ns, st.st_size, self.input_transfer)

    def _decode_and_upload_dem(self, dem_hr_path: Path, stream=None):
        """GeoTIFF decode + quantized upload of one DEM; returns the cache value.

        ``stream`` is the side stream of a background upload (see
        :func:`floodsr_tpu_torch.ops.transfer.device_put_dem_quantized`).
        """
        from floodsr_tpu_torch.ops.normalize import nodata_mask
        from floodsr_tpu_torch.ops.transfer import device_put_dem_quantized

        dem_raw, nodata, profile = _read_single_band_raster(dem_hr_path)
        assert np.isfinite(
            np.where(nodata_mask(dem_raw, nodata), 0.0, dem_raw)
        ).all(), "DEM contains non-finite values"
        dem_dev = device_put_dem_quantized(
            dem_raw, nodata, enabled=self.input_transfer == "uint16",
            device=self.device, stream=stream,
        )
        return dem_dev, nodata, profile

    @staticmethod
    def _nbytes(value) -> int:
        return int(value[0].numel() * value[0].element_size())

    def _dem_cache_put(self, key, value) -> None:
        # Lock-guarded with a running byte counter: the prefetch thread and
        # the run() thread both insert/evict, and iterating the OrderedDict
        # for a byte total while the other thread mutates it raises
        # "mutated during iteration".
        with self._dem_cache_lock:
            cache = self._dem_device_cache
            old = cache.pop(key, None)
            if old is not None:
                self._dem_cache_bytes -= self._nbytes(old)
            cache[key] = value
            self._dem_cache_bytes += self._nbytes(value)
            while len(cache) > 1 and (
                len(cache) > self.DEM_CACHE_CAP
                or self._dem_cache_bytes > self.DEM_CACHE_MAX_BYTES
            ):
                _, evicted = cache.popitem(last=False)
                self._dem_cache_bytes -= self._nbytes(evicted)

    def _dem_cache_get(self, key):
        if key is None:
            return None
        with self._dem_cache_lock:
            value = self._dem_device_cache.get(key)
            if value is not None:
                self._dem_device_cache.move_to_end(key)
            return value

    def prefetch_dem(self, dem_hr_fp) -> "threading.Thread | None":
        """Decode + upload a scene's DEM in a background thread.

        Scene-streaming hook: while scene *i* computes on the device, scene
        *i+1*'s DEM (usually the dominant input) decodes and uploads —
        :meth:`run` then hits the device cache. Safe to call for a DEM
        already cached or in flight (no duplicate work). On CUDA the thread
        uploads and dequantizes on the worker's side stream, so its copies
        do not queue behind the running scene's kernels; the stream is
        synchronized before the tensor enters the cache, so whoever takes it
        from there may read it on any stream.
        """
        path = Path(dem_hr_fp).expanduser().resolve()
        key = self._dem_cache_key(path)
        if key is None:
            return None

        def work():
            try:
                if self.device.type == "cuda":
                    # A new thread starts on device 0.
                    torch.cuda.set_device(self.device)
                with tracing.span("prefetch.dem"):
                    value = self._decode_and_upload_dem(path, stream=self._prefetch_stream)
                self._dem_cache_put(key, value)
                with self._dem_cache_lock:
                    self.dem_counts["decoded_by_prefetch"] += 1
            except Exception:
                self.log.exception(f"DEM prefetch failed for {path}")
            finally:
                with self._dem_cache_lock:
                    self._dem_prefetch.pop(key, None)

        with self._dem_cache_lock:
            if key in self._dem_device_cache or key in self._dem_prefetch:
                return None
            # In a copy of the caller's context: its spans join the request
            # that started it.
            t = threading.Thread(
                target=contextvars.copy_context().run, args=(work,),
                name="floodsr-dem-prefetch", daemon=True,
            )
            self._dem_prefetch[key] = t
        t.start()
        return t

    def warmup(
        self,
        hr_shapes,
        *,
        window_method: str = "feather",
        tile_overlap: int | None = None,
        max_depth: float | None = None,
        dem_pct_clip: float | None = None,
        tile_size: int | None = None,
    ) -> int:
        """Warm the engine for expected HR scene extents before the first request.

        Serving hook. Resolves windowing and normalization parameters exactly
        as :meth:`run` would (train-config defaults + overrides), so what is
        warmed is what real requests run, then hands over to
        :meth:`EngineTorch.warmup`. Returns the number of distinct scene
        geometries warmed.
        """
        assert self.engine is not None, "worker must be entered before warmup"
        preprocess_cfg = resolve_preprocess_config(
            self.model_fp, max_depth=max_depth, dem_pct_clip=dem_pct_clip,
            logger=self.log,
        )
        contract = self.engine.contract
        assert contract is not None
        scale = int(contract.scale)
        lr_tile = (
            int(tile_size) if tile_size is not None
            else int(contract.depth_lr_hwc[0])
        )
        hr_tile = lr_tile * scale
        overlap_lr = int(tile_overlap) if tile_overlap is not None else lr_tile // 4
        if window_method == "hard":
            stride_hr, weight_overlap = hr_tile, 0
        else:
            if overlap_lr <= 0:
                # Same validation as run(): warming a hard geometry for
                # arguments every run() would reject leaves a "healthy"
                # server that fails 100% of real requests.
                raise AssertionError("feather windowing requires overlap_lr > 0")
            stride_hr = hr_tile - overlap_lr * scale
            weight_overlap = overlap_lr * scale
        return self.engine.warmup(
            hr_shapes,
            stride_hr=stride_hr,
            overlap_hr=weight_overlap,
            max_depth=float(preprocess_cfg["max_depth"]),
            dem_pct_clip=float(preprocess_cfg["dem_pct_clip"]),
            tile_lr=lr_tile if tile_size is not None else None,
        )

    def run_many(self, jobs, **shared_kwargs) -> list[dict]:
        """Pipelined multi-scene serving: stream scenes through one engine.

        ``jobs`` is a sequence of dicts with at least ``depth_lr_fp``,
        ``dem_hr_fp``, ``output_fp`` (plus optional per-job overrides of any
        :meth:`run` keyword). The next scene's DEM decodes and uploads in a
        background thread while the current scene computes, and every scene
        reuses the loaded engine and the device DEM cache. Returns the
        per-job diagnostics dicts in order.
        """
        jobs = [dict(j) for j in jobs]
        results = []
        for i, job in enumerate(jobs):
            if i + 1 < len(jobs):
                self.prefetch_dem(jobs[i + 1]["dem_hr_fp"])
            results.append(self.run(**{**shared_kwargs, **job}))
        return results

    # ------------------------------------------------------------------

    def _run_tiled_model_on_prepared(
        self,
        *,
        depth_lr_raw: np.ndarray,
        dem_hr_raw: torch.Tensor,
        depth_lr_profile: dict,
        dem_hr_profile: dict,
        preprocess_cfg: dict[str, object],
        model_lr_tile: int,
        model_scale: int,
        contract_hr_tile: int,
        window_method: str,
        overlap_lr: int,
        post_resample: tuple | None = None,
        sink=None,
    ) -> tuple[np.ndarray, int, dict[str, float] | None]:
        """Fused tiled execution over prepared arrays → final meter-domain scene.

        The compute path (tile gather, normalization, forward, feather
        mosaic) runs on the device (:meth:`EngineTorch.run_scene`), and so do
        the post-resample and the low-depth mask unless the engine has a mesh
        (:meth:`EngineTorch._finish_scene`); ``sink`` gets the finished rows.
        Returns the finished prediction, the number of unique tiles executed
        (the reference's tile-cache size), and a DEM-stat summary.
        """
        log = self.log
        assert self.engine is not None, "worker must be entered before running inference"
        assert window_method in {"hard", "feather"}, (
            f"unsupported window_method={window_method}"
        )

        assert depth_lr_raw.ndim == 2 and dem_hr_raw.ndim == 2
        assert np.isfinite(depth_lr_raw).all(), "aligned depth contains non-finite values"
        # (the device DEM was finite-checked before its upload)

        max_depth = float(preprocess_cfg["max_depth"])
        dem_pct_clip = float(preprocess_cfg["dem_pct_clip"])
        crop_h, crop_w = dem_hr_raw.shape
        expected_lr = (crop_h // model_scale, crop_w // model_scale)
        assert expected_lr[0] > 0 and expected_lr[1] > 0
        assert depth_lr_raw.shape == expected_lr, (
            f"depth shape {depth_lr_raw.shape} does not match crop/scale target {expected_lr}"
        )
        if float(depth_lr_raw.max()) > max_depth:
            log.warning("low-res depth values exceed max_depth; model preprocessing will clip them.")

        log.info(
            "prepared inputs summary:\n"
            f"  aligned depth_lr shape={depth_lr_raw.shape} res={pixel_size(depth_lr_profile)} m/pix\n"
            f"  aligned dem_hr shape={dem_hr_raw.shape} res={pixel_size(dem_hr_profile)} m/pix\n"
            f"  max_depth={max_depth}\n  dem_pct_clip={dem_pct_clip}"
        )

        overlap_hr = overlap_lr * model_scale
        if window_method == "hard":
            stride_hr = contract_hr_tile
            weight_overlap = 0
        else:
            if overlap_lr <= 0:
                raise AssertionError("feather windowing requires overlap_lr > 0")
            stride_hr = contract_hr_tile - overlap_hr
            if stride_hr <= 0:
                raise AssertionError(
                    f"feather stride must be > 0; overlap_lr={overlap_lr}, tile={contract_hr_tile}"
                )
            weight_overlap = overlap_hr

        # The engine pads the crop to whole tiles and runs that grid.
        content = self.engine.content_shape((crop_h, crop_w), model_lr_tile)
        n_tiles = len(
            build_window_grid(content[0], content[1], contract_hr_tile, stride_hr)["y0"]
        )
        log.info(
            f"window config\n  method={window_method}\n  overlap_lr={overlap_lr}\n"
            f"  overlap_hr={overlap_hr}\n  tile_size_lr={model_lr_tile}\n"
            f"  tile_size_hr={contract_hr_tile}\n  scene={content} ({n_tiles} tiles)"
        )

        prediction_out_m, stats = self.engine.run_scene(
            depth_lr_raw,
            dem_hr_raw,
            stride_hr=stride_hr,
            overlap_hr=weight_overlap,
            max_depth=max_depth,
            dem_pct_clip=dem_pct_clip,
            crop_shape=(crop_h, crop_w),
            post_resample=post_resample,
            low_depth_mask_m=float(self.low_depth_mask_m),
            sink=sink,
            tile_lr=model_lr_tile,
        )

        n_tiles = int(len(stats["p_clip"]))

        # Reference-parity guard: a zero DEM range is only legal on pinned
        # (all-zero) padded tiles (reference: floodsr/preprocessing.py:71-82).
        ranges = stats["dem_max"] - stats["dem_min"]
        bad = (ranges <= 0) & ~np.isclose(stats["dem_min"], 0.0)
        if bad.any():
            idx = int(np.argmax(bad))
            raise AssertionError(
                f"DEM range must be > 0; got min={stats['dem_min'][idx]}, "
                f"max={stats['dem_max'][idx]} (tile {idx})"
            )

        tile_dem_stats_summary = None
        if n_tiles > 0:
            dem_range_np = stats["dem_max"] - stats["dem_min"]
            tile_dem_stats_summary = {
                "tile_count": float(n_tiles),
                "dem_p_clip_min": float(stats["p_clip"].min()),
                "dem_p_clip_mean": float(stats["p_clip"].mean()),
                "dem_p_clip_max": float(stats["p_clip"].max()),
                "dem_range_min": float(dem_range_np.min()),
                "dem_range_mean": float(dem_range_np.mean()),
                "dem_range_max": float(dem_range_np.max()),
            }

        return prediction_out_m, n_tiles, tile_dem_stats_summary

    # ------------------------------------------------------------------

    def run(
        self,
        *,
        depth_lr_fp: str | Path,
        dem_hr_fp: str | Path,
        output_fp: str | Path,
        max_depth: float | None = None,
        dem_pct_clip: float | None = None,
        window_method: str = "feather",
        tile_overlap: int | None = None,
        tile_size: int | None = None,
        input_kind: str | None = None,
        buildings_fp: str | Path | None = None,
        output_compress: str | None = None,
    ) -> dict[str, Any]:
        """Run the model-specific ToHR workflow; returns output path + diagnostics.

        ``output_compress`` selects the output GeoTIFF compression
        (``lzw``/``zstd``/``deflate``/``packbits``/``none``; ``None`` =
        ``lzw``, the reference's default write profile — reference
        ``floodsr/io/rasterio_io.py:4-14``). ``zstd``/``none`` trade file
        size for host encode time.

        ``input_kind="wse"`` ingests a water-surface-elevation raster and
        converts it to depth against the DEM on the LR grid
        (:func:`floodsr_tpu_torch.preprocessing.wse_to_depth_lr` — the
        reference's planned WSE feature, reference ``PLAN.md``). ``buildings_fp``
        (GeoJSON footprints) zeroes super-resolved depths inside buildings
        (the reference's planned building-blocking feature, its ADR-0016).

        The run is span ``worker.run`` (``runtime_s``) of the request open in
        this context, the service's, or of a request of its own, whose record
        it then returns as ``scene_timings["trace"]``
        (:meth:`~floodsr_tpu_torch.tracing.Trace.export`).
        """
        opened = tracing.current() is None
        with tracing.request() as trace, tracing.span("worker.run") as root:
            log = self.log
            assert self.engine is not None, "worker must be used under context management"

            with tracing.span("worker.inputs"):
                depth_lr_path = Path(depth_lr_fp).expanduser().resolve()
                dem_hr_path = Path(dem_hr_fp).expanduser().resolve()
                out_path = Path(output_fp).expanduser().resolve()
                assert depth_lr_path.exists(), f"low-res depth raster does not exist: {depth_lr_path}"
                assert dem_hr_path.exists(), f"DEM raster does not exist: {dem_hr_path}"
                window_method = (window_method or "feather").strip().lower()
                assert window_method in {"hard", "feather"}, (
                    f"unsupported window_method={window_method}"
                )
                input_kind = (input_kind or "depth").strip().lower()
                assert input_kind in {"depth", "wse"}, (
                    f"unsupported input_kind={input_kind}"
                )
                output_compress = (output_compress or "lzw").strip().lower()
                assert output_compress in {"lzw", "zstd", "deflate", "packbits", "none"}, (
                    f"unsupported output_compress={output_compress}"
                )

            log.info(
                f"starting tohr inference with model_version={self.model_version}\n"
                f"model\n    {self.model_fp}\ndepth_lr\n    {depth_lr_path}\n"
                f"dem_hr\n    {dem_hr_path}\noutput\n    {out_path}"
            )

            with tracing.span("read") as read:
                # Terrain is static across forecast runs: keep recently uploaded DEMs
                # resident on the device, keyed by file identity (path, mtime, size).
                # A hit skips both the GeoTIFF decode and the upload. A prefetch
                # started by run_many/prefetch_dem is joined rather than duplicated.
                dem_cache_key = self._dem_cache_key(dem_hr_path)
                with self._dem_cache_lock:
                    inflight = self._dem_prefetch.get(dem_cache_key) if dem_cache_key else None
                if inflight is not None:
                    with tracing.span("read.dem_join"):
                        inflight.join()
                cached = self._dem_cache_get(dem_cache_key)
                dem_resident = cached is not None
                if dem_resident:
                    dem_hr_dev, dem_hr_raw_nodata, dem_hr_raw_profile = cached
                    if dem_hr_dev.is_cuda:
                        # The tensor may have been allocated on the prefetch stream:
                        # tell the allocator that this stream reads it, so an evicted
                        # DEM's memory is not handed out while a scene still uses it.
                        dem_hr_dev.record_stream(torch.cuda.current_stream(dem_hr_dev.device))
                    log.debug("DEM device cache hit; skipping decode + upload")
                else:
                    # Decode + upload the DEM first (uint16 fixed-point encoded when
                    # large, halving the bytes on the link — ops/transfer.py).
                    with tracing.span("read.dem_decode"):
                        dem_hr_dev, dem_hr_raw_nodata, dem_hr_raw_profile = (
                            self._decode_and_upload_dem(dem_hr_path)
                        )
                    if dem_cache_key is not None:
                        self._dem_cache_put(
                            dem_cache_key,
                            (dem_hr_dev, dem_hr_raw_nodata, dem_hr_raw_profile),
                        )
                with self._dem_cache_lock:
                    self.dem_counts["resident" if dem_resident else "decoded_in_run"] += 1
                    dem_counts = dict(self.dem_counts)
                with tracing.span("read.depth"):
                    depth_lr_raw, depth_lr_raw_nodata, depth_lr_raw_profile = (
                        _read_single_band_raster(depth_lr_path)
                    )
            depth_lr_bounds = raster_bounds(depth_lr_raw_profile)
            dem_raw_shape = (dem_hr_raw_profile["height"], dem_hr_raw_profile["width"])
            log.info(
                "raw inputs\n"
                f"  depth_lr shape={depth_lr_raw.shape} res={pixel_size(depth_lr_raw_profile)} m/pix\n"
                f"  dem_hr shape={dem_raw_shape} res={pixel_size(dem_hr_raw_profile)} m/pix"
            )

            with tracing.span("worker.config"):
                preprocess_cfg = resolve_preprocess_config(
                    self.model_fp, max_depth=max_depth, dem_pct_clip=dem_pct_clip, logger=log
                )
            assert self.engine.contract is not None, "engine contract must be available"
            contract_scale = int(self.engine.contract.scale)
            contract_lr_tile = int(self.engine.contract.depth_lr_hwc[0])
            contract_hr_tile = int(self.engine.contract.dem_hr_hwc[0])

            model_scale = (
                int(preprocess_cfg["scale"])
                if isinstance(preprocess_cfg.get("scale"), (int, float))
                else contract_scale
            )
            if model_scale != contract_scale:
                log.warning(f"using contract scale {contract_scale} over configured scale {model_scale}")
                model_scale = contract_scale

            model_lr_tile = (
                int(preprocess_cfg["lr_tile"])
                if isinstance(preprocess_cfg.get("lr_tile"), (int, float))
                else contract_lr_tile
            )
            if model_lr_tile != contract_lr_tile:
                log.warning(
                    f"model config LR tile {model_lr_tile} overrides contract tile {contract_lr_tile}; "
                    "using contract tile for strict model shape checks."
                )
                model_lr_tile = contract_lr_tile

            tile_override = False
            if tile_size is not None:
                tile_size = int(tile_size)
                if tile_size != contract_lr_tile:
                    # Fully-convolutional window override: the ResUNet applies the SAME trained weights at any LR window
                    # divisible by 2^levels (the reference's fixed-shape tf2onnx
                    # graph cannot). scene_config raises a clear error for
                    # graph-executor models or non-divisible sizes.
                    self.engine.scene_config(tile_size)
                    tile_override = True
                    log.warning(
                        f"tile_size={tile_size} differs from the trained LR tile "
                        f"({contract_lr_tile}): per-window DEM normalization "
                        "follows the window, which is OFF the training "
                        "distribution, and quality degrades at non-trained "
                        "window sizes. Use the "
                        "trained tile unless you have re-validated quality."
                    )
                model_lr_tile = tile_size

            if not tile_override and model_lr_tile * model_scale != contract_hr_tile:
                raise AssertionError(
                    f"model tile mismatch: LR tile {model_lr_tile} x scale {model_scale} "
                    f"!= contract HR tile {contract_hr_tile}"
                )

            # Reference default overlap = LR tile // 4 (follows the RUN tile so a
            # window-size override keeps the reference's overlap proportion).
            overlap_lr = int(tile_overlap) if tile_overlap is not None else model_lr_tile // 4
            if overlap_lr < 0:
                raise AssertionError(f"tile_overlap must be >= 0; got {overlap_lr}")

            with tracing.span("worker.prepare"):
                prepped = prepare_inputs(
                    depth_lr_raw, depth_lr_raw_nodata, depth_lr_raw_profile,
                    dem_hr_dev, dem_hr_raw_nodata, dem_hr_raw_profile,
                    scale=model_scale, input_kind=input_kind, device=self.device,
                    logger=log,
                )
            log.info(
                "preprocessing complete\n"
                f"  scale={model_scale} (HR/LR ratio)\n"
                f"  aligned depth shape={prepped['depth_lr_shape']} resampled={prepped['resampled']}\n"
                f"  aligned dem shape={prepped['dem_hr_shape']} raw_dem_shape={prepped['dem_raw_shape']}\n"
                f"  max_depth={float(preprocess_cfg['max_depth'])} "
                f"dem_pct_clip={float(preprocess_cfg['dem_pct_clip'])}"
            )

            model_space_shape = tuple(prepped["dem_hr_shape"])
            post_resampled = tuple(prepped["dem_raw_shape"]) != model_space_shape
            post_spec = None
            if post_resampled:
                log.info(
                    f"post-resampling model output from {model_space_shape} "
                    f"to {tuple(prepped['dem_raw_shape'])} on raw DEM grid "
                    "with bilinear interpolation."
                )
                post_spec = (
                    tuple(prepped["dem_raw_shape"]),
                    prepped["dem_profile"]["transform"],
                    prepped["dem_raw_profile"]["transform"],
                )

            # Streaming write: the engine's finish hands the output GeoTIFF's
            # writer the scene, which encodes and writes it strip by strip.
            from floodsr_tpu_torch.io.geotiff import open_raster_stream

            output_profile = dict(prepped["dem_raw_profile"])
            output_profile.update(dtype="float32", count=1)
            # The output compression is a fixed write profile (reference
            # default: LZW), never inherited from the input DEM's tags.
            output_profile["compress"] = (
                None if output_compress == "none" else output_compress.upper()
            )
            output_profile.pop("predictor", None)

            # Building blocking (reference's planned feature, its ADR-0016):
            # zero depths inside footprints as the rows stream to disk, and
            # apply the same mask to the in-memory prediction below. Loaded
            # BEFORE the output stream opens: a bad buildings file must
            # fail cleanly, not truncate/corrupt the requested output path.
            with tracing.span("worker.open"):
                building_mask = None
                if buildings_fp is not None:
                    from floodsr_tpu_torch.features import building_mask_for_grid

                    building_mask = building_mask_for_grid(
                        buildings_fp,
                        output_profile["transform"],
                        tuple(prepped["dem_raw_shape"]),
                        crs=str(output_profile["crs"]),
                        logger_=log,
                    )

                stream_writer = open_raster_stream(out_path, output_profile)
                sink = (
                    stream_writer if building_mask is None
                    else _BuildingMaskSink(stream_writer, building_mask)
                )

            try:
                prediction_out_m, tile_cache_size, tile_dem_stats = (
                    self._run_tiled_model_on_prepared(
                        depth_lr_raw=prepped["depth_lr"],
                        dem_hr_raw=prepped["dem_hr"],
                        depth_lr_profile=prepped["depth_lr_profile"],
                        dem_hr_profile=prepped["dem_profile"],
                        preprocess_cfg=preprocess_cfg,
                        model_lr_tile=model_lr_tile,
                        model_scale=model_scale,
                        # The RUN tile (== contract tile unless overridden).
                        contract_hr_tile=model_lr_tile * model_scale,
                        window_method=window_method,
                        overlap_lr=overlap_lr,
                        post_resample=post_spec,
                        sink=sink,
                    )
                )
                with tracing.span("worker.check"):
                    assert prediction_out_m.shape == tuple(prepped["dem_raw_shape"]), (
                        f"prediction shape {prediction_out_m.shape} must match "
                        f"raw DEM shape {prepped['dem_raw_shape']}"
                    )
                    if building_mask is not None:
                        # Keep the in-memory prediction identical to the streamed
                        # (masked) file contents.
                        prediction_out_m = np.where(
                            building_mask, 0.0, prediction_out_m
                        ).astype(np.float32)

                    # The pipeline already clipped to [0, max_depth] and applied the
                    # low-depth mask; a cheap range guard replaces host re-work.
                    assert prediction_out_m.dtype == np.float32
                    assert float(prediction_out_m.max(initial=0.0)) <= float(
                        preprocess_cfg["max_depth"]
                    ) + 1e-6, "postprocess failed to clip to max_depth"

                    prepared_dem_bounds = raster_bounds(prepped["dem_raw_profile"])
                    assert all(
                        np.isclose(a, b, atol=1e-6, rtol=0.0)
                        for a, b in zip(prepared_dem_bounds, depth_lr_bounds)
                    ), (
                        f"output profile bounds {prepared_dem_bounds} do not match "
                        f"incoming low-res bounds {depth_lr_bounds}"
                    )

                with tracing.span("worker.close"):
                    stream_writer.close()
                out_written_fp = Path(out_path)
                from floodsr_tpu_torch.io.geotiff import read_raster_header

                with tracing.span("worker.verify"):
                    written_profile = read_raster_header(out_written_fp)
                    written_shape = (
                        int(written_profile["height"]), int(written_profile["width"])
                    )
                    assert written_shape == tuple(prepped["dem_raw_shape"]), (
                        f"written output shape {written_shape} must match raw DEM "
                        f"shape {prepped['dem_raw_shape']}"
                    )
                    written_bounds = raster_bounds(written_profile)
                    assert all(
                        np.isclose(a, b, atol=1e-6, rtol=0.0)
                        for a, b in zip(written_bounds, depth_lr_bounds)
                    ), (
                        f"written output bounds {written_bounds} must match incoming "
                        f"low-res bounds {depth_lr_bounds}"
                    )
            except BaseException:
                # Cover the WHOLE produce-and-verify span (inference, range/
                # bounds asserts, stream close, written-file checks): any
                # failure must not leave a corrupt partial GeoTIFF at the
                # requested output path or leak the handle.
                try:
                    stream_writer._handle.close()
                finally:
                    Path(out_path).unlink(missing_ok=True)
                raise

        out_file_size = int(out_written_fp.stat().st_size)
        log.info(
            f"finished tohr inference in {root.seconds:.3f}s; wrote {out_file_size:,} bytes to\n"
            f"    {out_written_fp}"
        )
        result = {
            "output_fp": str(out_written_fp),
            "runtime_s": root.seconds,
            "model_version": self.model_version,
            "model_fp": str(self.model_fp),
            "output_size_bytes": out_file_size,
            # Device/transfer/host budget of the scene execution (see
            # EngineTorch.run_scene): h2d_s, exec_s, finish_s, and finish's
            # d2h_wait_s vs host_post_s (dequant/resample/encode); beside it
            # the read stage, whether it found the DEM resident, and the
            # worker's DEM counts after this scene. Each time is a span's;
            # "trace" is the request's record, where this run opened it.
            "scene_timings": {
                **(getattr(self.engine, "last_scene_timings", {}) or {}),
                "read_s": read.seconds,
                "dem_resident": dem_resident,
                "dem_counts": dem_counts,
            },
            "preprocess": {
                "max_depth": float(preprocess_cfg["max_depth"]),
                "dem_pct_clip": float(preprocess_cfg["dem_pct_clip"]),
                "dem_ref_stats": preprocess_cfg["dem_ref_stats"],
                "window_method": window_method,
                "input_kind": input_kind,
                "building_blocked_wet_cells": (
                    sink.blocked_wet if building_mask is not None else None
                ),
                "tile_overlap_lr": overlap_lr,
                "tile_size_lr": model_lr_tile,
                "tile_size_hr": model_lr_tile * model_scale,
                "model_scale": model_scale,
                "tile_cache_size": tile_cache_size,
                "tile_dem_stats": tile_dem_stats,
                "input_shape": {
                    "crop_height": int(prediction_out_m.shape[0]),
                    "crop_width": int(prediction_out_m.shape[1]),
                    "model_space_crop_height": int(model_space_shape[0]),
                    "model_space_crop_width": int(model_space_shape[1]),
                    "aligned_depth_shape": [int(x) for x in prepped["depth_lr_shape"]],
                    "aligned_dem_shape": [int(x) for x in prepped["dem_hr_shape"]],
                    "output_shape": [int(x) for x in prepped["dem_raw_shape"]],
                },
                "prepared_inputs": {
                    # the reference's prepared-raster files; none is written
                    "depth_lr_prepared_fp": None,
                    "dem_hr_prepared_fp": None,
                    "prepped_depth_was_resampled": bool(prepped["resampled"]),
                    "prepped_dem_was_resampled": bool(prepped["resampled"]),
                    "post_sr_was_resampled": bool(post_resampled),
                },
            },
        }
        if opened:
            result["scene_timings"]["trace"] = trace.export(root)
        return result
