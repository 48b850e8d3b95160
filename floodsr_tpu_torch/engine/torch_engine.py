"""PyTorch inference engine over ``.fsrz`` and ``.onnx`` artifacts — port of ``EngineJAX``.

Same seam as the JAX engine (``floodsr_tpu/engine/jax_engine.py``):
construction loads the model and resolves a :class:`ModelIOContract`;
``run_tile`` takes prepared meter arrays, applies the shared nodata /
normalization policy, runs the model and inverts to meters; ``run_scene``
runs a whole scene through the scene executor
(:mod:`floodsr_tpu_torch.engine.scene`: two-phase for the native ResUNet,
single-phase for a graph) with one upload and one download, then finishes
(crop → dequant → resample → low-depth mask, the reference order), on the
device where the resample is rectilinear and on the host otherwise.

Three kinds of artifact load: a native ResUNet ``.fsrz``; an ``.onnx`` file,
run by the graph interpreter (:mod:`floodsr_tpu_torch.nn.onnx_exec`); and an
``onnx-graph`` ``.fsrz`` written by the converter
(:mod:`floodsr_tpu_torch.nn.onnx_convert`), run from its stored NHWC IR.

``compute_dtype`` names the precision policy: ``float32`` (every stage f32),
``bfloat16`` (body in bf16, head f32) or ``mixed`` (trunk and SR upsample in
bf16, tail f32); see :mod:`floodsr_tpu_torch.nn.resunet`. ``output_transfer``
names the download's encoding: ``uint16``, ``uint12`` (the uint16 codes
reduced to 12 bits and packed 2 pixels into 3 bytes on the device) or
``float32``.

The engine runs on the GPU unless constructed with ``device="cpu"``, and
raises when CUDA is absent. It sets TF32 off for cuDNN and matmuls when it
loads, so every f32 stage computes in full f32; a bf16 stage allows TF32 for
its own products only (exact for bf16 values) and puts the switches back.
"""

from __future__ import annotations

import logging
import os
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
from floodsr_tpu_torch.ops.resample import (
    StreamingSeparableResampler,
    _axis_interp_indices,
    reproject_bilinear,
)
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
        self.precision_policy = _POLICY_BY_NAME[compute_dtype]
        self._stage_dtypes = resolve_precision_policy(self.precision_policy)
        # the one dtype a converted graph computes in (it has no stages)
        self.compute_dtype = (
            torch.bfloat16 if self.precision_policy == "bf16" else torch.float32
        )
        assert output_transfer in {"uint16", "uint12", "float32"}, (
            f"unsupported output_transfer={output_transfer}"
        )
        self.output_transfer = output_transfer
        # uint12 reuses the uint16 scene program: the 12-bit reduction and the
        # pack run on the finished scene, just before the download.
        self._scene_transfer_dtype = (
            "uint16" if output_transfer == "uint12" else output_transfer
        )
        self.max_batch = int(max_batch)
        self.scene_chunk = int(scene_chunk)
        self.scene_trunk_chunk = int(scene_trunk_chunk)
        self.config: ResUNetConfig | None = None
        self.model: ResUNet | None = None
        self.contract: ModelIOContract | None = None
        # (depth_nhwc, dem_nhwc) -> pred_nhwc, normalized domain, on the device
        self._forward = None
        self.last_scene_timings: dict[str, float] = {}
        self.load()

    # -- lifecycle ----------------------------------------------------------

    def model_path(self) -> Path:
        return self._model_fp

    def load(self) -> None:
        """Load the artifact, resolve the contract, place the weights on the device.

        Accepts native ``.fsrz`` checkpoints, converted ``onnx-graph``
        ``.fsrz`` artifacts, or ONNX files; the latter run through the in-tree
        graph interpreter, so the reference's released ``model_infer.onnx``
        works directly (contract resolution mirrored from
        ``floodsr/engine/ort.py:75-102``).
        """
        if self.device.type == "cuda":
            set_strict_f32()
        if self._model_fp.suffix.lower() == ".onnx":
            self._load_onnx()
            return
        artifact = load_artifact(self._model_fp)
        manifest = artifact["manifest"]
        architecture = manifest.get("architecture", "ResUNet_DEM")
        if architecture not in ("ResUNet_DEM", "onnx-graph"):
            raise NotImplementedError(f"architecture {architecture!r} is not supported")
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
        if architecture == "onnx-graph":
            # Converted-ONNX artifact: forward executes the stored NHWC IR.
            from floodsr_tpu_torch.nn.onnx_convert import GraphProgram

            program = GraphProgram(manifest["graph_ir"], artifact["params"], self.device)
            out_edge = manifest["graph_output_edge"]
            d_name = self.contract.depth_input_name
            m_name = self.contract.dem_input_name
            dtype = self.compute_dtype

            def graph_forward(depth_nhwc, dem_nhwc):
                feeds = {d_name: depth_nhwc, m_name: dem_nhwc}
                return program(feeds, [out_edge], dtype)[out_edge]

            self._forward = graph_forward
        else:
            model = ResUNet(self.config)
            model.load_state_dict(params_from_jax(artifact["params"], artifact["state"]))
            self.model = model.to(self.device).eval()
            stage = self._stage_dtypes
            self._forward = lambda depth, dem: self.model(depth, dem, precision=stage)
        self.log.info(
            f"loaded torch model '{self._model_fp.name}' ({architecture}) "
            f"scale={self.contract.scale} device={self.device} "
            f"dtype={self.compute_dtype} policy={self.precision_policy}"
        )

    def _load_onnx(self) -> None:
        """Resolve contract + forward fn from an ONNX graph (torch interpreter)."""
        from floodsr_tpu_torch.nn.onnx_exec import OnnxGraphExecutor
        from floodsr_tpu_torch.nn.onnx_reader import load_model

        model = load_model(self._model_fp)
        executor = OnnxGraphExecutor(model, self.device)
        inputs = {vi.name: vi for vi in model.graph_inputs}
        assert "depth_lr" in inputs, "model input 'depth_lr' not found"
        assert "dem_hr" in inputs, "model input 'dem_hr' not found"
        assert model.outputs, "model outputs are empty"
        output_name = model.outputs[0].name

        def resolve_hwc(vi, name):
            dims = vi.shape
            assert len(dims) == 4, f"{name} must be rank-4 NHWC; got {dims}"
            h, w, c = dims[1], dims[2], dims[3]
            assert isinstance(h, int) and h > 0, f"{name} height must be fixed int; got {h}"
            assert isinstance(w, int) and w > 0, f"{name} width must be fixed int; got {w}"
            assert isinstance(c, int) and c == 1, f"{name} channels must be 1; got {c}"
            return (h, w, c)

        depth_lr_hwc = resolve_hwc(inputs["depth_lr"], "depth_lr")
        dem_hr_hwc = resolve_hwc(inputs["dem_hr"], "dem_hr")
        output_hwc = resolve_hwc(model.outputs[0], output_name)
        assert dem_hr_hwc == output_hwc, (
            f"DEM input shape {dem_hr_hwc} must match output shape {output_hwc}"
        )
        assert dem_hr_hwc[0] % depth_lr_hwc[0] == 0, (
            f"HR/LR height ratio must be integer; got HR={dem_hr_hwc}, LR={depth_lr_hwc}"
        )
        self.contract = ModelIOContract(
            depth_input_name="depth_lr",
            dem_input_name="dem_hr",
            output_name=output_name,
            depth_lr_hwc=depth_lr_hwc,
            dem_hr_hwc=dem_hr_hwc,
            output_hwc=output_hwc,
            scale=int(dem_hr_hwc[0] // depth_lr_hwc[0]),
        )
        # Minimal config so the scene executor knows the tile geometry.
        self.config = ResUNetConfig(lr_tile=depth_lr_hwc[0], scale=self.contract.scale)

        def onnx_forward(depth_nhwc, dem_nhwc):
            return executor({"depth_lr": depth_nhwc, "dem_hr": dem_nhwc})[output_name]

        self._forward = onnx_forward
        self.log.info(
            f"loaded ONNX model '{self._model_fp.name}' via the torch graph executor; "
            f"opset={model.opset} producer='{model.producer}' "
            f"params={sum(a.size for a in model.initializers.values()):,} "
            f"scale={self.contract.scale} device={self.device}"
        )

    def close(self) -> None:
        """Release the device weights."""
        self.model = None
        self._forward = None
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
        weights, with the tensor-core pack of the policy's route (3xTF32 or
        bf16) at the widths those routes take;
        and the zeros scene lets cuDNN choose its algorithms at these batch
        shapes and fills the caching allocator's pools (device and pinned
        host) at this scene size. ``crop_shapes``: iterable of expected HR
        scene extents; extents that pad to the same whole-tile scene are
        warmed once. Returns the number of distinct geometries warmed.
        """
        assert self._forward is not None and self.config is not None, (
            "engine must be loaded before warmup"
        )
        cfg = self.scene_config(tile_lr)
        if self.device.type == "cuda":
            from floodsr_tpu_torch.nn.resunet import hr_tail_eligible
            from floodsr_tpu_torch.ops.kernels import _build

            fused = self.model is not None and hr_tail_eligible(self.model)
            names = ["tile_stats"] + (["hr_tail"] if fused else [])
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
        """Whole-scene execution: one upload, the scene executor, one download.

        ``depth_raw``/``dem_raw`` are the UNPADDED LR/HR scenes (numpy arrays
        or tensors already on the device). The engine pads them to whole
        tiles, runs the executor over the window grid derived from
        ``stride_hr``, then finishes (:meth:`_finish_scene`).
        ``row_sink(band)`` receives the finished rows top to bottom.

        Returns the finished meter-domain scene and per-tile DEM stats
        (``p_clip``/``dem_min``/``dem_max``) in the grid's row-major order.
        """
        assert self._forward is not None and self.config is not None, (
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
            transfer_dtype=self._scene_transfer_dtype,
            precision=self._stage_dtypes,
            # only the native ResUNet splits into trunk and tail; a graph
            # runs whole, one forward per chunk
            forward_fn=None if self.model is not None else self._forward,
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
        """One download of the finished scene: crop → dequant → resample → mask.

        Reference postprocess order (``floodsr/models/ResUNet_16x_DEM.py:
        554-583``): crop → clip (on the device) → resample → low-depth mask.
        A rectilinear ``post_resample`` runs on the device
        (:meth:`_postproc_on_device`: the download is then the raw DEM grid,
        already clipped and masked) unless ``FLOODSR_DEVICE_POSTPROC=0``; then,
        and for a general warp, the host resamples. With
        ``output_transfer="uint12"`` the uint16 codes are reduced to 12 bits
        and packed on the device (:meth:`_pack12`) and unpacked here
        (:meth:`_unpack12`). Rows go to ``row_sink`` in bands as they are
        finished.
        """
        crop_h, crop_w = crop_shape
        transfer12 = self.output_transfer == "uint12"
        if transfer12:
            dequant = float(max_depth) / 4095.0
        elif self.output_transfer == "uint16":
            dequant = float(max_depth) / 65535.0
        else:
            dequant = None

        t0 = time.perf_counter()
        device_masked = False
        host_resample = None
        if post_resample is not None:
            dst_shape, src_t, dst_t = post_resample
            dst_shape = tuple(int(v) for v in dst_shape)
            rectilinear = src_t.is_rectilinear() and dst_t.is_rectilinear()
            if rectilinear and os.environ.get("FLOODSR_DEVICE_POSTPROC", "1") == "1":
                # Device-side postprocess: the index and weight plan is
                # _axis_interp_indices, the same the host resampler uses, so
                # values match to f32 lerp rounding plus one more quantization
                # round trip on the uint16 transfer (max_depth/65535/sqrt(12)
                # rmse). Afterwards the host must not clip and mask again: a
                # pixel the device kept could be zeroed by rounding near the
                # threshold.
                out = self._postproc_on_device(
                    out, (crop_h, crop_w), dst_shape, src_t, dst_t,
                    max_depth, low_depth_mask_m,
                )
                crop_h, crop_w = dst_shape
                device_masked = True
            else:
                host_resample = (rectilinear, dst_shape, src_t, dst_t)
        band = out[:crop_h, :crop_w]
        if transfer12:
            band = self._pack12(band)
        _sync(self.device)
        t_dev = time.perf_counter()
        host = band.cpu().numpy()
        t1 = time.perf_counter()
        if transfer12:
            scene = self._unpack12(host, crop_w, dequant)
        elif dequant is not None:
            scene = host.astype(np.float32)
            scene *= dequant  # in place: no second temporary
        else:
            scene = np.asarray(host, np.float32)
        t2 = time.perf_counter()

        if host_resample is not None:
            rectilinear, dst_shape, src_t, dst_t = host_resample
            if rectilinear:
                resampler = StreamingSeparableResampler(
                    (crop_h, crop_w), src_t, dst_shape, dst_t
                )
                _, scene = resampler.feed(scene)
                assert resampler.complete, "separable resample did not cover all rows"
            else:
                scene = reproject_bilinear(scene, src_t, dst_shape, dst_t)
        t3 = time.perf_counter()

        if device_masked:
            final = np.asarray(scene, np.float32)
        else:
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
            "device_post_s": t_dev - t0,
            "d2h_wait_s": t1 - t_dev,
            "d2h_bytes": int(host.nbytes),
            "host_dequant_s": t2 - t1,
            "host_resample_s": t3 - t2,
            "host_sink_s": sink_s,
            "host_post_s": t4 - t1,
        }
        return final

    @staticmethod
    def _pack12(band: torch.Tensor) -> torch.Tensor:
        """uint16 depth codes ``[rows, cols]`` → ``[rows, 3 * ceil(cols/2)]`` uint8.

        The codes are rescaled to 12 bits, ``round(q16 * 4095 / 65535)`` as the
        exact integer ``(q16 * 4095 + 32767) // 65535`` (in int32: the largest
        intermediate is 268,398,592), and consecutive column pairs packed as
        ``[a >> 4, (a & 0xF) << 4 | b >> 8, b & 0xFF]``; an odd width is padded
        by one column of zeros. Quantization rmse ``max_depth / 4095 /
        sqrt(12)``. Plain torch ops on the scene's device.
        """
        rows, cols = int(band.shape[0]), int(band.shape[1])
        q16 = band.to(torch.int32)
        if cols & 1:
            q16 = F.pad(q16, (0, 1))
        q12 = (q16 * 4095 + 32767) // 65535
        pair = q12.reshape(rows, -1, 2)
        a, b = pair[:, :, 0], pair[:, :, 1]
        packed = torch.stack([a >> 4, ((a & 0xF) << 4) | (b >> 8), b & 0xFF], dim=-1)
        return packed.to(torch.uint8).reshape(rows, -1)

    @staticmethod
    def _unpack12(buf: np.ndarray, cols: int, dequant: float) -> np.ndarray:
        """Host-side inverse of :meth:`_pack12` → float32 meters.

        ``buf`` is ``(rows, 3 * ceil(cols/2))`` uint8; returns
        ``(rows, cols)`` float32 (``code * dequant``).
        """
        rows = buf.shape[0]
        t = buf.reshape(rows, -1, 3).astype(np.uint16)
        a = (t[:, :, 0] << np.uint16(4)) | (t[:, :, 1] >> np.uint16(4))
        b = ((t[:, :, 1] & np.uint16(0xF)) << np.uint16(8)) | t[:, :, 2]
        out = np.empty((rows, a.shape[1] * 2), np.float32)
        out[:, 0::2] = a
        out[:, 1::2] = b
        out *= np.float32(dequant)
        return out[:, :cols]

    @torch.no_grad()
    def _postproc_on_device(
        self,
        out: torch.Tensor,
        crop_shape: tuple[int, int],
        dst_shape: tuple[int, int],
        src_t,
        dst_t,
        max_depth: float,
        low_depth_mask_m: float,
    ) -> torch.Tensor:
        """Crop → dequant → separable resample → clip → mask → requant on the
        device. Returns a tensor shaped ``dst_shape`` in the scene's transfer
        dtype (uint16 or float32), ready for the download."""
        crop_h, crop_w = crop_shape
        r0, r1, fr = _axis_interp_indices(
            crop_h, src_t.f, src_t.e, dst_shape[0], dst_t.f, dst_t.e
        )
        c0, c1, fc = _axis_interp_indices(
            crop_w, src_t.c, src_t.a, dst_shape[1], dst_t.c, dst_t.a
        )
        dev = out.device

        def index(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

        def weight(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

        r0, r1, c0, c1 = index(r0), index(r1), index(c0), index(c1)
        fr, fc = weight(fr), weight(fc)
        is_u16 = out.dtype == torch.uint16
        depth_max = torch.tensor(float(max_depth), dtype=torch.float32, device=dev)
        mask_m = torch.tensor(float(low_depth_mask_m), dtype=torch.float32, device=dev)
        x = out[:crop_h, :crop_w]
        xf = x.to(torch.float32) * (depth_max / 65535.0) if is_u16 else x.to(torch.float32)
        rows = xf[r0, :] * (1.0 - fr)[:, None] + xf[r1, :] * fr[:, None]
        res = rows[:, c0] * (1.0 - fc)[None, :] + rows[:, c1] * fc[None, :]
        res = torch.minimum(torch.clamp_min(res, 0.0), depth_max)
        res = torch.where(res < mask_m, torch.zeros_like(res), res)
        if is_u16:
            res = torch.round(res * (65535.0 / depth_max)).to(torch.uint16)
        return res

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
        assert self.contract is not None and self._forward is not None, (
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
            pred_norm = self._forward(depth_norm[..., None], dem_norm[..., None])[..., 0]
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
