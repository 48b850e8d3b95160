"""The finish stage across engines: the port vs the JAX engine, the worker, the daemon.

The device postprocess with the switch on and off against ``EngineJAX`` (the
cases of ``tests/test_model_engine.py``'s ``TestDevicePostprocess``), ``tohr`` on
a DEM off the model grid, and the daemon with a precision policy, a ``uint12``
transfer and an ONNX model. Tolerances as in ``tests/test_torch_finish.py``.
"""

import numpy as np
import pytest

from floodsr_tpu_torch.io import read_raster
from floodsr_tpu_torch.tohr import tohr as tohr_torch

from test_torch_finish import MAX_DEPTH, _run_postproc, engines  # noqa: F401  (a fixture)

pytestmark = pytest.mark.unit


@pytest.mark.parametrize("enabled", [True, False], ids=["switch_on", "switch_off"])
@pytest.mark.parametrize("transfer", ["float32", "uint16"])
def test_device_postproc_matches_the_jax_engine(engines, monkeypatch, enabled, transfer):
    got = _run_postproc(engines, monkeypatch, "torch", enabled, transfer)
    want = _run_postproc(engines, monkeypatch, "jax", enabled, transfer)
    assert got.shape == want.shape == (60, 60)
    # The scenes themselves agree to 1e-4 m RMSE; pixel by pixel within two
    # uint16 codes (the network's sums, then the lerp), except where one side
    # falls under the low-depth mask and the other does not.
    both = (got >= 1e-3) == (want >= 1e-3)
    assert float(np.mean(both)) > 0.999
    assert float(np.sqrt(np.mean((got - want) ** 2))) <= 1e-4
    assert float(np.abs(got - want)[both].max()) <= 2.5 * MAX_DEPTH / 65535.0


@pytest.mark.parametrize("transfer", ["uint16", "uint12"])
def test_tohr_on_a_dem_off_the_model_grid_with_the_switch_on_and_off(
    transfer, tiny_model_fp, synthetic_nonnative_tiles, tmp_path, monkeypatch
):
    # A 96x96 DEM over a 64x64 model space: the worker hands the engine a
    # rectilinear post_resample, which the device takes unless switched off.
    outs = {}
    for switch in ("1", "0"):
        monkeypatch.setenv("FLOODSR_DEVICE_POSTPROC", switch)
        fp = tmp_path / f"post_{switch}.tif"
        diag = tohr_torch(
            model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp,
            depth_lr_fp=synthetic_nonnative_tiles["depth_lr_fp"],
            dem_hr_fp=synthetic_nonnative_tiles["dem_fp"], output_fp=fp, device="cpu",
            engine_options={"output_transfer": transfer},
        )
        outs[switch] = read_raster(fp)[0]
        assert outs[switch].shape == synthetic_nonnative_tiles["dem_shape"]
        resampled_on_host = diag["scene_timings"]["host_resample_s"] > 1e-4
        assert resampled_on_host == (switch == "0")
    step = MAX_DEPTH / (65535.0 if transfer == "uint16" else 4095.0)
    both = (outs["1"] >= 1e-3) == (outs["0"] >= 1e-3)
    assert float(np.mean(both)) > 0.995
    assert float(np.abs(outs["1"] - outs["0"])[both].max()) <= 2 * step


def test_the_daemon_serves_a_policy_a_uint12_transfer_and_an_onnx_model(
    tiny_model_fp, synthetic_tohr_tiles, tmp_path
):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_onnx import build_dual_input_onnx

    from floodsr_tpu_torch.serve import TohrService

    onnx_fp = tmp_path / "model_infer.onnx"
    onnx_fp.write_bytes(build_dual_input_onnx(lr_tile=8, scale=4, channels=8, seed=5))
    lr, dem = synthetic_tohr_tiles["depth_lr_fp"], synthetic_tohr_tiles["dem_fp"]
    for name, model_fp, options in (
        ("bf16", tiny_model_fp, {"compute_dtype": "bfloat16"}),
        ("mixed_u12", tiny_model_fp, {"compute_dtype": "mixed", "output_transfer": "uint12"}),
        ("onnx", onnx_fp, {"output_transfer": "uint12"}),
    ):
        service = TohrService(
            device="cpu", model_version="ResUNet_16x_DEM", model_fp=model_fp,
            engine_options=options,
        )
        service.start()
        try:
            out_fp = tmp_path / f"{name}.tif"
            body = service.handle_tohr({"in": str(lr), "dem": str(dem), "out": str(out_fp)})
            assert body["output_fp"] == str(out_fp), body
            want_fp = tmp_path / f"{name}_lib.tif"
            tohr_torch(
                model_version="ResUNet_16x_DEM", model_fp=model_fp, depth_lr_fp=lr,
                dem_hr_fp=dem, output_fp=want_fp, device="cpu", engine_options=options,
            )
            np.testing.assert_array_equal(read_raster(out_fp)[0], read_raster(want_fp)[0])
        finally:
            service.close()
