"""The port's scene executor and ``tohr`` vs the JAX package, on the CPU.

Also: the port imports nothing of JAX or of the JAX package, and its entry
points run on CUDA unless the caller asks for the CPU.
"""

import ast
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from floodsr_tpu.engine.scene import build_scene_executor, pack_scene_indices
from floodsr_tpu.nn import ResUNetConfig as ResUNetConfigJax
from floodsr_tpu.nn import init_resunet
from floodsr_tpu.nn.resunet import resunet_tail_apply, resunet_trunk_apply
from floodsr_tpu.tiling import build_window_grid
from floodsr_tpu.tohr import tohr as tohr_jax
from floodsr_tpu_torch.engine import EngineTorch
from floodsr_tpu_torch.engine.scene import SceneExecutor, scene_indices
from floodsr_tpu_torch.eval import compute_depth_error_metrics
from floodsr_tpu_torch.io import read_raster
from floodsr_tpu_torch.models.ResUNet_16x_DEM import ModelWorker
from floodsr_tpu_torch.nn.checkpoint import params_from_jax
from floodsr_tpu_torch.nn.resunet import ResUNet, ResUNetConfig
from floodsr_tpu_torch.ops.normalize import replace_nodata_with_zero
from floodsr_tpu_torch.serve import TohrService, serve
from floodsr_tpu_torch.tohr import tohr as tohr_torch
from floodsr_tpu_torch.tohr import tohr_many as tohr_many_torch

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
DATA = Path(__file__).parent / "data"
MAX_DEPTH = 5.0
PCT = 95.0

# Two fuse blocks, so the port's tail goes through hr_tail (its plain
# version on the CPU); the JAX side runs its unfused chain.
CFG = ResUNetConfigJax(
    base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
    fuse_filters=8, fuse_blocks=2, scale=4, lr_tile=16, hr_s2d=2,
)


def _split_forward(cfg):
    def trunk(params, state, depth, dem):
        return resunet_trunk_apply(params, state, depth, dem, cfg)[0]

    def tail(params, state, feat, dem):
        return resunet_tail_apply(params, state, feat, dem, cfg, pallas_tail=False)[0]

    return trunk, tail


@pytest.mark.parametrize(
    "overlap,general", [(0, False), (16, False), (16, True)],
    ids=["hard", "separable", "general"],
)
def test_scene_executor_matches_jax(overlap, general, monkeypatch):
    # Both packages read the mosaic override when the executor is built.
    if general:
        monkeypatch.setenv("FLOODSR_SCENE_GENERAL_MOSAIC", "1")
    else:
        monkeypatch.delenv("FLOODSR_SCENE_GENERAL_MOSAIC", raising=False)
    tile = CFG.hr_tile
    scene = (2 * tile, 3 * tile)
    rng = np.random.default_rng(7)
    dem = (300.0 + np.cumsum(rng.normal(0, 1.0, scene), axis=1)).astype(np.float32)
    depth = rng.uniform(0, 3, (scene[0] // CFG.scale, scene[1] // CFG.scale)).astype(np.float32)
    params, state = init_resunet(3, CFG)
    grid = build_window_grid(scene[0], scene[1], tile, tile - overlap)
    n = len(grid["y0"])

    fn, _ = build_scene_executor(
        CFG, scene_shape=scene, capacity=n, overlap_hr=overlap, chunk=n,
        max_depth=MAX_DEPTH, dem_pct_clip=PCT, transfer_dtype="uint16",
        split_forward=_split_forward(CFG), trunk_chunk=n,
    )
    idx = jax.tree.map(jnp.asarray, pack_scene_indices(grid, n, n))
    want, want_stats = fn(params, state, jnp.asarray(depth), jnp.asarray(dem), idx)
    want = np.asarray(want)

    model = ResUNet(ResUNetConfig.from_dict(CFG.to_dict()))
    model.load_state_dict(params_from_jax(params, state), strict=True)
    # Chunks narrower than the grid, so the port's batching is exercised.
    executor = SceneExecutor(
        model.eval(), scene_shape=scene, overlap_hr=overlap, max_depth=MAX_DEPTH,
        dem_pct_clip=PCT, chunk=2, trunk_chunk=4, transfer_dtype="uint16",
    )
    assert executor.mosaic_mode == ("general" if general else ("hard" if overlap == 0 else "separable"))
    got, stats = executor(torch.from_numpy(depth), torch.from_numpy(dem), scene_indices(grid))
    assert got.dtype == torch.uint16 and want.dtype == np.uint16
    assert tuple(got.shape) == want.shape == scene
    # Same stats bisection bit for bit; the f32 network sums in another
    # order, so a code may round to its neighbour: within ±1 (7.6e-5 m).
    np.testing.assert_array_equal(stats.numpy(), np.asarray(want_stats).reshape(n, 3))
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert want.max() > 0


def _case(name):
    case_dir = DATA / name
    spec = json.loads((case_dir / "case_spec.json").read_text())
    model_fp = DATA / spec.get("model_artifact", "_artifacts/model_infer_test.fsrz")
    return case_dir, spec, model_fp


# synth_flagship (the full-width trained artifact) at one pixel: two of its
# nine tiles carry trunk features up to 2.5e3 and fuse-block activations up to
# 5.4e3 (~25 elsewhere), where f32 rounding at that magnitude, amplified by the
# head and the log1p inverse, moves a pixel by millimetres. Against a float64
# evaluation of the same network on the same inputs the JAX package's scene
# sits up to 1.10e-3 m off and the port's (oneDNN's convolutions, ~2x the
# rounding of XLA's at those magnitudes) up to 3.19e-3 m
# (tests/flagship_rounding_study.py); so the two may sit up to their sum,
# 4.3e-3 m, apart at any pixel (3.43e-3 m measured), and at most 0.1% of the
# pixels over 2e-4 m (86 of 1,048,576 measured).
FLAGSHIP_MAX_ABS_M = 5e-3


@pytest.mark.parametrize(
    "case", ["synth_single_tile", "synth_mersch", "synth_dudelange", "synth_flagship"]
)
def test_tohr_matches_jax_tohr_and_case_metrics(case, tmp_path):
    case_dir, spec, model_fp = _case(case)
    truth_raw, truth_nodata, _ = read_raster(case_dir / spec["inputs"]["truth_fp"])
    truth = replace_nodata_with_zero(truth_raw, truth_nodata)
    for label, run in spec["expected"].items():
        kw = dict(
            model_fp=model_fp,
            depth_lr_fp=case_dir / spec["inputs"]["lowres_fp"],
            dem_hr_fp=case_dir / spec["inputs"]["dem_fp"],
            **run["params"],
        )
        out_t, out_j = tmp_path / f"{label}_torch.tif", tmp_path / f"{label}_jax.tif"
        tohr_torch(output_fp=out_t, device="cpu", **kw)
        tohr_jax(output_fp=out_j, **kw)
        pred_t, _, _ = read_raster(out_t)
        pred_j, _, _ = read_raster(out_j)
        assert pred_t.shape == pred_j.shape and pred_t.dtype == np.float32
        # Both quantize to uint16 codes of 7.6e-5 m; f32 sums in another
        # order move a few codes by one, far inside 1e-4 m RMSE.
        assert float(np.sqrt(np.mean((pred_t - pred_j) ** 2))) <= 1e-4
        if case == "synth_flagship":
            d = np.abs(pred_t.astype(np.float64) - pred_j)
            assert d.max() <= FLAGSHIP_MAX_ABS_M and (d > 2e-4).sum() <= 1e-3 * d.size
        metrics = compute_depth_error_metrics(truth, pred_t, max_depth=MAX_DEPTH)
        precision = int(run["metrics"].get("precision", 3))
        got = {k: round(float(metrics[k]), precision) for k in ("mase_m", "rmse_m", "ssim")}
        want = {k: round(float(run["metrics"][k]), precision) for k in got}
        assert got == want, f"{case}/{label}"


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "floodsr_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "bench_torch.py", ROOT / "bin" / "parity_gate_torch.py",
        ROOT / "docs" / "scripts" / "build_cli_reference_torch.py",
    ] + sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(files) > 20
    covered = {str(path.relative_to(ROOT)) for path in files}
    assert {
        "floodsr_tpu_torch/ops/costgrow.py",
        "floodsr_tpu_torch/ops/kernels/relax_step.py",
        "floodsr_tpu_torch/models/CostGrow.py",
        "floodsr_tpu_torch/models/CostGrow_pcraster.py",
        "floodsr_tpu_torch/features/footprints.py",
        "floodsr_tpu_torch/dem_sources/geodesy.py",
        "floodsr_tpu_torch/cli.py",
        "floodsr_tpu_torch/serve.py",
        "floodsr_tpu_torch/engine/providers.py",
        "floodsr_tpu_torch/cache_policy.py",
        "floodsr_tpu_torch/hostmem.py",
        "floodsr_tpu_torch/dem_sources/base.py",
        "floodsr_tpu_torch/dem_sources/catalog.py",
        "floodsr_tpu_torch/dem_sources/hrdem_stac.py",
        "floodsr_tpu_torch/features/nrcan_buildings.py",
        "floodsr_tpu_torch/nn/onnx_reader.py",
        "floodsr_tpu_torch/nn/onnx_exec.py",
        "floodsr_tpu_torch/nn/onnx_convert.py",
        "floodsr_tpu_torch/eval/metrics.py",
        "floodsr_tpu_torch/train/trainer.py",
        "floodsr_tpu_torch/train/data.py",
        "floodsr_tpu_torch/train/synth.py",
        "floodsr_tpu_torch/parallel/streaming.py",
        "chip_smoke.py",
        "bench_torch.py",
        "bin/parity_gate_torch.py",
        "docs/scripts/build_cli_reference_torch.py",
        "examples/train_model_torch.py",
        "examples/run_tohr_torch.py",
        "examples/serve_scenes_torch.py",
        "examples/tutorial_torch.py",
    } <= covered
    banned = ("jax", "floodsr_tpu")
    offenders = [
        f"{path.relative_to(ROOT)}: {name}"
        for path in files
        for name in _imported_modules(path)
        if any(name == b or name.startswith(b + ".") for b in banned)
    ]
    assert offenders == []
    # The rule matches module paths, not prefixes: the port's own modules pass.
    own = _imported_modules(ROOT / "floodsr_tpu_torch" / "engine" / "torch_engine.py")
    assert "floodsr_tpu_torch.engine.scene" in own


@pytest.mark.parametrize(
    "entry",
    [tohr_torch, tohr_many_torch, EngineTorch.__init__, ModelWorker.__init__,
     TohrService.__init__, serve],
)
def test_entry_points_default_to_cuda(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case_dir, spec, model_fp = _case("synth_single_tile")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EngineTorch(model_fp)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelWorker(model_fp)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tohr_torch(
            model_version="ResUNet_16x_DEM", model_fp=model_fp,
            depth_lr_fp=case_dir / spec["inputs"]["lowres_fp"],
            dem_hr_fp=case_dir / spec["inputs"]["dem_fp"],
            output_fp=tmp_path / "out.tif",
        )
    assert not (tmp_path / "out.tif").exists()
    # The CPU runs only when asked for.
    assert EngineTorch(model_fp, device="cpu").device.type == "cpu"
