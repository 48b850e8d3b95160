"""The engine, ``tohr`` and the CLI under a precision policy or a ``uint12`` transfer.

``EngineTorch`` with ``compute_dtype`` ``bfloat16``/``mixed`` against ``EngineJAX``
on the test artifact, and the options reaching the engine from ``tohr`` and
from the CLI's config.
"""

import numpy as np
import pytest
import torch

from floodsr_tpu.engine import EngineJAX
from floodsr_tpu_torch import cli as cli_torch
from floodsr_tpu_torch.engine import EngineTorch
from floodsr_tpu_torch.io import read_raster
from floodsr_tpu_torch.tohr import tohr as tohr_torch

from test_torch_precision import _rms

pytestmark = pytest.mark.unit

MODEL_FP = "tests/data/_artifacts/model_infer_test.fsrz"


def _scene(scale, tile, seed=11):
    """An LR depth and an HR DEM of 2.5 x 3.25 tiles."""
    rng = np.random.default_rng(seed)
    lr = (int(2.5 * tile) // scale, int(3.25 * tile) // scale)
    depth = rng.uniform(0, 3, lr).astype(np.float32)
    hr = (lr[0] * scale, lr[1] * scale)
    dem = (300.0 + np.cumsum(rng.normal(0, 0.3, hr), axis=1)).astype(np.float32)
    return depth, dem


@pytest.mark.parametrize("dtype", ["bfloat16", "mixed"])
def test_engine_under_a_policy_matches_the_jax_engine(dtype, request):
    model_fp = request.config.rootpath / MODEL_FP
    outs = {}
    for name, make in (
        ("jax", lambda d: EngineJAX(model_fp, compute_dtype=d, output_transfer="float32")),
        ("torch", lambda d: EngineTorch(
            model_fp, compute_dtype=d, output_transfer="float32", device="cpu")),
    ):
        for d in (dtype, "float32"):
            eng = make(d)
            tile, scale = eng.config.hr_tile, eng.config.scale
            depth, dem = _scene(scale, tile)
            outs[name, d], _ = eng.run_scene(
                depth, dem, stride_hr=tile - tile // 4, overlap_hr=tile // 4, max_depth=5.0,
                dem_pct_clip=95.0, crop_shape=dem.shape,
            )
            if name == "torch":
                assert eng.precision_policy == {"bfloat16": "bf16", "mixed": "mixed"}.get(d, "f32")
            eng.close()
    want, got = outs["jax", dtype], outs["torch", dtype]
    gap = _rms(want - outs["jax", "float32"])
    assert gap > 1e-5  # the policy moves the scene
    # The JAX engine jits its scene, and XLA's CPU compiler then keeps chains
    # of elementwise bf16 operations in f32 (it drops the conversion pairs
    # between them), where the port, like JAX run operation by operation in
    # test_resunet_under_a_policy_matches_jax, rounds after each one. So the
    # two engines sit within the policy's own distance to f32 of each other,
    # not within a flipped rounding: measured 0.45 of it (bfloat16) and 0.68
    # (mixed) in the root mean square, 4e-3 to 6e-3 m.
    assert _rms(got - want) < gap and _rms(got - want) < 2e-2, (_rms(got - want), gap)
    # the f32 engines keep the bar of tests/test_torch_scene_tohr.py
    assert _rms(outs["torch", "float32"] - outs["jax", "float32"]) <= 1e-4


def test_engine_rejects_an_unknown_compute_dtype_or_transfer(request):
    model_fp = request.config.rootpath / MODEL_FP
    with pytest.raises(AssertionError, match="compute_dtype must be one of"):
        EngineTorch(model_fp, compute_dtype="float16", device="cpu")
    with pytest.raises(AssertionError, match="unsupported output_transfer"):
        EngineTorch(model_fp, output_transfer="uint8", device="cpu")
    eng = EngineTorch(model_fp, compute_dtype="bfloat16", output_transfer="uint12", device="cpu")
    assert eng.compute_dtype == torch.bfloat16 and eng._scene_transfer_dtype == "uint16"
    assert eng._stage_dtypes["tail"] == torch.bfloat16 and eng._stage_dtypes["head"] == torch.float32
    eng.close()


@pytest.mark.parametrize("dtype", ["bfloat16", "mixed"])
def test_tohr_and_the_cli_run_under_a_policy(
    dtype, tiny_model_fp, synthetic_tohr_tiles, tmp_path, monkeypatch
):
    lr, dem = synthetic_tohr_tiles["depth_lr_fp"], synthetic_tohr_tiles["dem_fp"]
    results = {}
    for d in ("float32", dtype):
        out_fp = tmp_path / f"lib_{d}.tif"
        tohr_torch(
            model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp, depth_lr_fp=lr,
            dem_hr_fp=dem, output_fp=out_fp, device="cpu",
            engine_options={"compute_dtype": d},
        )
        results[d] = read_raster(out_fp)[0]
    assert np.isfinite(results[dtype]).all()
    # another arithmetic, the same scene: the randomly initialised model
    # saturates between 0 and max_depth, so single pixels move far; the scene
    # as a whole does not
    assert 0 < _rms(results[dtype] - results["float32"]) < 0.1 * _rms(results["float32"])
    # the CLI reads the policy from the config's environment variable
    monkeypatch.setenv("FLOODSR_COMPUTE_DTYPE", dtype)
    cli_fp = tmp_path / "cli.tif"
    code = cli_torch.main([
        "tohr", "--in", str(lr), "--dem", str(dem), "--out", str(cli_fp),
        "--model-path", str(tiny_model_fp), "--device", "cpu",
    ])
    assert code == 0
    np.testing.assert_array_equal(read_raster(cli_fp)[0], results[dtype])


def _cli_argv(tiles, model_fp, out_fp):
    return [
        "tohr", "--in", str(tiles["depth_lr_fp"]), "--dem", str(tiles["dem_fp"]),
        "--out", str(out_fp), "--model-path", str(model_fp), "--device", "cpu",
    ]


@pytest.mark.parametrize("name,value", [
    ("FLOODSR_COMPUTE_DTYPE", "float16"), ("FLOODSR_OUTPUT_TRANSFER", "uint8"),
])
def test_an_unknown_compute_dtype_or_transfer_is_an_error_line_not_a_traceback(
    name, value, tiny_model_fp, synthetic_tohr_tiles, tmp_path, monkeypatch
):
    monkeypatch.setenv(name, value)
    out_fp = tmp_path / "bad.tif"
    assert cli_torch.main(_cli_argv(synthetic_tohr_tiles, tiny_model_fp, out_fp)) == 1
    assert not out_fp.exists()


def test_uint12_output_transfer_from_the_config_runs(
    tiny_model_fp, synthetic_tohr_tiles, tmp_path, monkeypatch
):
    u16_fp, out_fp = tmp_path / "u16.tif", tmp_path / "u12.tif"
    assert cli_torch.main(_cli_argv(synthetic_tohr_tiles, tiny_model_fp, u16_fp)) == 0
    monkeypatch.setenv("FLOODSR_OUTPUT_TRANSFER", "uint12")
    assert cli_torch.main(_cli_argv(synthetic_tohr_tiles, tiny_model_fp, out_fp)) == 0
    got, want = read_raster(out_fp)[0], read_raster(u16_fp)[0]
    # the two quantization steps, half of each
    assert float(np.abs(got - want).max()) <= 0.5 * 5.0 / 4095 + 0.5 * 5.0 / 65535 + 1e-6
