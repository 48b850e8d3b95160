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

``mesh`` (a :class:`~floodsr_tpu_torch.parallel.mesh.Mesh`) spreads the work
over several devices, driven from this one process: ``scene_mode=
"replicated"`` splits each chunk of tiles over the ``dp`` devices
(:mod:`~floodsr_tpu_torch.engine.scene`), ``"banded"`` shards the scene by row
(or column) bands (:mod:`~floodsr_tpu_torch.engine.scene_banded`); ``run_tiles``
splits each batch over ``dp``. Each distinct device of the mesh holds its own
copy of the model (and so its own ``hr_tail`` weight pack); the scene lives
on the mesh's first device, and the device postprocess stays off, as in the
JAX package. With ``mesh=None`` nothing of this runs.

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
from floodsr_tpu_torch.engine.scene_banded import (
    band_devices,
    band_inputs,
    build_banded_scene_executor,
    pack_band_indices,
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
from floodsr_tpu_torch.parallel.mesh import batch_sharding, gather_to, mesh_device
from floodsr_tpu_torch.parallel.streaming import prefetch_to_device
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
        mesh=None,
        batch_axis: str = "dp",
        scene_mode: str = "replicated",
    ):
        self.device = resolve_device(device) if mesh is None else mesh_device(mesh, device)
        self.mesh = mesh
        self.batch_axis = batch_axis
        # Sharded-scene formulation (mesh only): "replicated" = ADR-0006's
        # split-the-chunk default (the scene on one device); "banded" = the
        # scene sharded by bands for scenes beyond one device's memory.
        assert scene_mode in {"replicated", "banded"}, scene_mode
        self.scene_mode = scene_mode
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
        # the same forward on each distinct device of the mesh (the model's
        # copy there); {self.device: self._forward} without a mesh
        self._replicas: dict[torch.device, Any] = {}
        self.last_scene_timings: dict[str, float] = {}
        # The keyword arguments of the last run_scene's geometry (crop_shape,
        # stride_hr, overlap_hr, max_depth, dem_pct_clip, tile_lr): what
        # scene_executor takes to build that scene's executor again.
        self.last_scene_args: dict[str, Any] = {}
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

            out_edge = manifest["graph_output_edge"]
            d_name = self.contract.depth_input_name
            m_name = self.contract.dem_input_name
            dtype = self.compute_dtype

            def make_forward(device):
                program = GraphProgram(manifest["graph_ir"], artifact["params"], device)

                def graph_forward(depth_nhwc, dem_nhwc):
                    feeds = {d_name: depth_nhwc, m_name: dem_nhwc}
                    return program(feeds, [out_edge], dtype)[out_edge]

                return graph_forward
        else:
            state_dict = params_from_jax(artifact["params"], artifact["state"])
            stage = self._stage_dtypes
            models = {}

            def make_forward(device):
                model = ResUNet(self.config)
                model.load_state_dict(state_dict)
                model = models[device] = model.to(device).eval()
                return lambda depth, dem: model(depth, dem, precision=stage)

        self._build_replicas(make_forward)
        if architecture != "onnx-graph":
            self.model = models[self.device]
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

        def make_forward(device):
            run = executor if device == self.device else OnnxGraphExecutor(model, device)

            def onnx_forward(depth_nhwc, dem_nhwc):
                return run({"depth_lr": depth_nhwc, "dem_hr": dem_nhwc})[output_name]

            return onnx_forward

        self._build_replicas(make_forward)
        self.log.info(
            f"loaded ONNX model '{self._model_fp.name}' via the torch graph executor; "
            f"opset={model.opset} producer='{model.producer}' "
            f"params={sum(a.size for a in model.initializers.values()):,} "
            f"scale={self.contract.scale} device={self.device}"
        )

    def _build_replicas(self, make_forward) -> None:
        """``make_forward(device)`` on the engine's device, then on every other
        distinct device of the mesh."""
        devices = [self.device]
        if self.mesh is not None:
            devices += [d for d in self.mesh.distinct_devices() if d != self.device]
        self._replicas = {d: make_forward(d) for d in devices}
        self._forward = self._replicas[self.device]

    def close(self) -> None:
        """Release the device weights."""
        self.model = None
        self._forward = None
        self._replicas = {}
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
        warmed once (under ``scene_mode="banded"``: the same banded bucket in
        the same orientation, which is what the banded path runs). Returns
        the number of distinct geometries warmed.
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
        banded = self.mesh is not None and self.scene_mode == "banded"
        warmed = set()
        for shape in crop_shapes:
            shape = (int(shape[0]), int(shape[1]))
            content = self.content_shape(shape, tile_lr)
            # A tall and a wide shape can band to the same bucket in opposite
            # orientations: key on both.
            if banded:
                _, bucket, _, _, transposed = self.banded_scene_executor(
                    content, stride_hr=stride_hr, overlap_hr=overlap_hr,
                    max_depth=max_depth, dem_pct_clip=dem_pct_clip, tile_lr=tile_lr,
                )
            key = (bucket, transposed) if banded else content
            if key in warmed:
                continue
            warmed.add(key)
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
        self.log.info(f"warmed {len(warmed)} {'banded ' if banded else ''}scene geometry(ies)")
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
        crop_h, crop_w = int(crop_shape[0]), int(crop_shape[1])
        self.last_scene_timings = {}
        self.last_scene_args = {
            "crop_shape": (crop_h, crop_w),
            "stride_hr": int(stride_hr),
            "overlap_hr": int(overlap_hr),
            "max_depth": float(max_depth),
            "dem_pct_clip": float(dem_pct_clip),
            "tile_lr": tile_lr,
        }
        if self.mesh is not None and self.scene_mode == "banded":
            return self._run_scene_banded(
                depth_raw, dem_raw,
                stride_hr=stride_hr, overlap_hr=overlap_hr,
                max_depth=max_depth, dem_pct_clip=dem_pct_clip,
                crop_shape=(crop_h, crop_w), post_resample=post_resample,
                low_depth_mask_m=low_depth_mask_m, row_sink=row_sink,
                tile_lr=tile_lr,
            )
        scale = self.scene_config(tile_lr).scale
        executor, idx, content, n = self.scene_executor(**self.last_scene_args)

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
        self._record_timings(t0, t1, t2, t3, n, content)
        return out_np, {
            "p_clip": stats_np[:, 0],
            "dem_min": stats_np[:, 1],
            "dem_max": stats_np[:, 2],
        }

    def scene_executor(
        self,
        crop_shape: tuple[int, int],
        *,
        stride_hr: int,
        overlap_hr: int,
        max_depth: float,
        dem_pct_clip: float,
        tile_lr: "int | None" = None,
    ) -> tuple[SceneExecutor, dict[str, np.ndarray], tuple[int, int], int]:
        """The scene executor :meth:`run_scene` runs for ``crop_shape`` (not
        banded): ``(executor, idx, content, n_windows)``.

        ``content`` is the crop padded to whole tiles, ``idx`` the
        :func:`~floodsr_tpu_torch.engine.scene.scene_indices` of its window
        grid and ``n_windows`` that grid's window count. ``executor(depth,
        dem, idx)`` takes the depth and DEM zero-padded to ``content // scale``
        and ``content`` on the engine's device (as :meth:`_put_padded` puts
        them) and returns ``(scene_out, stats)``.
        """
        cfg = self.scene_config(tile_lr)
        tile = cfg.hr_tile
        content = self.content_shape((int(crop_shape[0]), int(crop_shape[1])), tile_lr)
        grid = build_window_grid(content[0], content[1], tile, int(stride_hr))
        if int(overlap_hr) == 0:
            validate_hard_grid(grid, tile)
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
            mesh=self.mesh,
            batch_axis=self.batch_axis,
            replicas=self._replicas,
        )
        return executor, scene_indices(grid), content, len(grid["y0"])

    def _record_timings(self, t0, t1, t2, t3, n: int, scene: tuple[int, int]) -> None:
        self.log.debug(
            f"run_scene timings: h2d={t1 - t0:.3f}s exec={t2 - t1:.3f}s "
            f"d2h+post={t3 - t2:.3f}s tiles={n} scene={scene}"
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

    def banded_scene_executor(
        self,
        crop_shape: tuple[int, int],
        *,
        stride_hr: int,
        overlap_hr: int,
        max_depth: float,
        dem_pct_clip: float,
        tile_lr: "int | None" = None,
    ):
        """The banded executor for ``crop_shape``: ``(fn, bucket, chunk, cap,
        transposed)``, as the JAX engine's (``fn`` from
        :func:`~floodsr_tpu_torch.engine.scene_banded.build_banded_scene_executor`;
        eager PyTorch has nothing to cache, so it is built per call).

        The bucket is the content (the crop padded to whole tiles) with its
        rows padded to the quantum ``n_bands × tile``, so each band holds at
        least one tile. ``transposed=True`` means the scene is banded by
        COLUMNS: ``bucket`` (and the grid the caller builds) live in the
        TRANSPOSED scene space. It is chosen when row banding would pad a
        wide scene's rows ≥2× but column banding would not; when neither
        orientation offers one content tile row per band without ≥2× padding,
        this raises. ``cap`` is the bucket-level tile capacity of a band: the
        most a band of the bucket can own (the stride rows plus a forced
        trailing-edge row) times the bucket's tile columns, chunk-rounded, so
        every crop of the bucket packs to the same shapes.
        """
        assert self.mesh is not None, "banded scenes require a mesh"
        tile = self.scene_config(tile_lr).hr_tile
        n_bands = int(self.mesh.shape[self.batch_axis])
        quantum = n_bands * tile

        def banded_bucket(h, w):
            return (-(-h // quantum) * quantum, w)

        crop = (int(crop_shape[0]), int(crop_shape[1]))
        content_h, content_w = self.content_shape(crop, tile_lr)
        bucket = banded_bucket(content_h, content_w)
        transposed = False
        if bucket[0] >= 2 * content_h:
            bucket_t = banded_bucket(content_w, content_h)
            if bucket_t[0] < 2 * content_w:
                transposed = True
                bucket = bucket_t
            else:
                n_useful = max(1, max(content_h, content_w) // tile)
                dem_gb = bucket[0] * bucket[1] * 4 / 1e9
                raise ValueError(
                    f"scene too small to band: banding over {n_bands} bands "
                    f"needs a {quantum}-px quantum on the banded axis, "
                    f"padding the {crop} scene to {bucket[0]} rows "
                    f"({bucket[0] / content_h:.1f}x the content, "
                    f"~{dem_gb:.2f} GB DEM in HBM plus accumulators, "
                    f"and the same factor in dummy tile compute) in BOTH "
                    f"orientations. Use scene_mode='replicated' (dp over "
                    f"tile chunks, no row quantum), or a mesh with "
                    f"dp<={n_useful} so each band holds >=1 content tile "
                    f"row."
                )
        chunk = self.max_batch
        band = bucket[0] // n_bands
        cap_rows = -(-band // int(stride_hr)) + 1
        nx_bucket = int(build_window_grid(tile, bucket[1], tile, int(stride_hr))["nx"])
        cap = -(-(cap_rows * nx_bucket) // chunk) * chunk
        fn, _ = build_banded_scene_executor(
            self.scene_config(tile_lr), scene_shape=bucket, overlap_hr=int(overlap_hr),
            chunk=chunk, max_depth=float(max_depth), dem_pct_clip=float(dem_pct_clip),
            mesh=self.mesh, batch_axis=self.batch_axis, replicas=self._replicas,
            transfer_dtype=self._scene_transfer_dtype, transposed=transposed,
        )
        return fn, bucket, chunk, cap, transposed

    def _run_scene_banded(
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
        """Band-sharded scene execution for scenes beyond one device's memory.

        Each band's device holds only its band (+ a one-tile halo) of every
        input and accumulator; the only exchange is the seam halo
        (:mod:`floodsr_tpu_torch.engine.scene_banded`). Column banding runs
        the whole pipeline on the transposed scene and transposes the merged
        scene back before the finish; the per-tile stats come back in the
        original orientation's row-major grid order, as on the other paths.
        """
        cfg = self.scene_config(tile_lr)
        tile, scale = cfg.hr_tile, cfg.scale
        crop_h, crop_w = crop_shape
        n_bands = int(self.mesh.shape[self.batch_axis])
        run, bucket, chunk, cap, transposed = self.banded_scene_executor(
            (crop_h, crop_w), stride_hr=stride_hr, overlap_hr=overlap_hr,
            max_depth=max_depth, dem_pct_clip=dem_pct_clip, tile_lr=tile_lr,
        )
        eff = (crop_w, crop_h) if transposed else (crop_h, crop_w)
        grid = build_window_grid(*self.content_shape(eff, tile_lr), tile, int(stride_hr))
        n = len(grid["y0"])

        t0 = time.perf_counter()
        # Pad on the scene's device in the original orientation, then
        # transpose for column banding.
        lr_shape = (bucket[0] // scale, bucket[1] // scale)
        if transposed:
            depth_dev = self._put_padded(depth_raw, lr_shape[::-1]).t().contiguous()
            dem_dev = self._put_padded(dem_raw, bucket[::-1]).t().contiguous()
        else:
            depth_dev = self._put_padded(depth_raw, lr_shape)
            dem_dev = self._put_padded(dem_raw, bucket)
        banded = pack_band_indices(
            grid, n_bands=n_bands, band=bucket[0] // n_bands, chunk=chunk, cap=cap
        )
        grid_slot = banded.pop("grid_slot")
        banded["depth"], banded["dem"] = band_inputs(
            depth_dev, dem_dev, n_bands=n_bands, tile=tile, scale=scale,
            devices=band_devices(self.mesh, self.batch_axis),
        )
        del depth_dev, dem_dev
        _sync(self.device)
        t1 = time.perf_counter()
        bands, stats = run(banded)
        # Merge the bands on the scene's device.
        out = gather_to(bands, self.device)
        if transposed:
            out = out.t().contiguous()
        stats_np = np.stack([st.cpu().numpy() for st in stats])
        _sync(self.device)
        t2 = time.perf_counter()

        # Reassemble per-tile stats into grid order via the slot map.
        grid_stats = np.zeros((n, 3), np.float32)
        for d in range(n_bands):
            sel = grid_slot[d]
            live = sel >= 0
            grid_stats[sel[live]] = stats_np[d][live]
        if transposed:
            # The transposed grid enumerates tiles in TRANSPOSED row-major
            # order; re-sort into the ORIGINAL orientation's row-major order
            # (primary: original y = transposed x0, secondary: original
            # x = transposed y0).
            order = np.lexsort((np.asarray(grid["y0"]), np.asarray(grid["x0"])))
            grid_stats = grid_stats[order]

        out_np = self._finish_scene(
            out,
            crop_shape=(crop_h, crop_w),
            max_depth=float(max_depth),
            post_resample=post_resample,
            low_depth_mask_m=float(low_depth_mask_m),
            row_sink=row_sink,
        )
        t3 = time.perf_counter()
        self._record_timings(t0, t1, t2, t3, n, bucket)
        return out_np, {
            "p_clip": grid_stats[:, 0],
            "dem_min": grid_stats[:, 1],
            "dem_max": grid_stats[:, 2],
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
            # (under a mesh the host resamples, as in the JAX package)
            if (
                rectilinear
                and os.environ.get("FLOODSR_DEVICE_POSTPROC", "1") == "1"
                and self.mesh is None
            ):
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
        keys = ("p_clip", "dem_min", "dem_max")
        stats_out = {k: np.empty((n,), np.float32) for k in keys}
        if self.mesh is None:
            for pos in range(0, n, self.max_batch):
                end = min(n, pos + self.max_batch)
                d = torch.from_numpy(depth[pos:end]).to(self.device)
                m = torch.from_numpy(dem[pos:end]).to(self.device)
                pred_m, pred_norm, stats = self._tiles_forward(
                    self._forward, d, m, max_depth, dem_pct_clip, ref, normalize_inputs
                )
                preds_m[pos:end] = pred_m.cpu().numpy()
                preds_norm[pos:end] = pred_norm.cpu().numpy()
                for k in keys:
                    stats_out[k][pos:end] = stats[k].cpu().numpy()
        else:
            for pos, take, shards in self._sharded_batches(depth, dem):
                # every shard's work is enqueued before the first download
                outs = [
                    self._tiles_forward(
                        self._replicas[dev], d, m, max_depth, dem_pct_clip, ref, normalize_inputs
                    )
                    for (d, m), dev in zip(shards, self.mesh.axis_devices(self.batch_axis))
                ]
                for dst, i in ((preds_m, 0), (preds_norm, 1)):
                    got = gather_to([o[i] for o in outs], self.device)
                    dst[pos : pos + take] = got[:take].cpu().numpy()
                for k in keys:
                    got = gather_to([o[2][k] for o in outs], self.device)
                    stats_out[k][pos : pos + take] = got[:take].cpu().numpy()
        return {
            "predictions_m": preds_m,
            "predictions_norm": preds_norm,
            "dem_stats_used": stats_out,
            "runtime_s": float(time.perf_counter() - start),
        }

    def _tiles_forward(self, forward, d, m, max_depth, dem_pct_clip, ref, normalize_inputs):
        """Normalize, forward and invert one batch of tiles on their device:
        ``(pred_m, pred_norm, stats)``."""
        b = d.shape[0]
        if normalize_inputs:
            depth_norm = scale_depth_log1p(d, max_depth)
            if ref is not None:
                st = [torch.full((b,), v, dtype=torch.float32, device=d.device) for v in ref]
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
        pred_norm = forward(depth_norm[..., None], dem_norm[..., None])[..., 0]
        return invert_depth_log1p(pred_norm, max_depth), pred_norm, stats

    def _sharded_batches(self, depth: np.ndarray, dem: np.ndarray):
        """``(pos, take, [(depth, dem) per dp shard])`` for each batch of a
        meshed ``run_tiles``: the batch's power-of-two bucket rounded up to a
        multiple of the mesh size and zero-padded (the JAX engine's rule, so
        the shards are even), split over ``dp`` by :func:`prefetch_to_device`
        with the next batch's upload in flight."""
        n = depth.shape[0]
        mesh_size = self.mesh.size
        metas: list[tuple[int, int]] = []

        def host_batches():
            pos = 0
            while pos < n:
                take = min(self.max_batch, n - pos)
                bucket = 1
                while bucket < take and bucket < self.max_batch:
                    bucket *= 2
                bucket = max(min(bucket, self.max_batch), mesh_size)
                bucket = -(-bucket // mesh_size) * mesh_size
                d, m = depth[pos : pos + take], dem[pos : pos + take]
                if take < bucket:
                    d = np.concatenate([d, np.zeros((bucket - take,) + d.shape[1:], np.float32)])
                    m = np.concatenate([m, np.zeros((bucket - take,) + m.shape[1:], np.float32)])
                metas.append((pos, take))
                yield d, m
                pos += take

        placed = prefetch_to_device(host_batches(), sharding=batch_sharding(self.mesh))
        for i, (d_shards, m_shards) in enumerate(placed):
            yield (*metas[i], list(zip(d_shards, m_shards)))

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
