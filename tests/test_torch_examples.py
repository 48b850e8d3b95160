"""The port's user examples against the JAX package's, on the CPU.

``examples/run_tohr_torch.py`` and ``examples/serve_scenes_torch.py`` with
``--device cpu`` against ``examples/run_tohr.py`` and
``examples/serve_scenes.py`` run into another directory: the same artifact
bytes, and each raster within the port's bar against the JAX package (1e-4 m
RMSE, 2e-4 m at any pixel). ``examples/tutorial_torch.py --device cpu
--no-figure`` against ``floodsr_tpu.tohr.tohr`` on ``synth_flagship`` at
that case's bar (``tests/test_torch_scene_tohr.py::FLAGSHIP_MAX_ABS_M``), its
SR and bilinear rows against ``case_spec.json``'s metrics at the file's
precision. Every script raises without CUDA unless ``--device cpu`` is given.
"""

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from floodsr_tpu.tohr import tohr as tohr_jax
from floodsr_tpu_torch.io import read_raster

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
CASE = ROOT / "tests" / "data" / "synth_flagship"
RMSE_M, MAX_ABS_M = 1e-4, 2e-4
# the flagship case's bar, as tests/test_torch_scene_tohr.py states it
FLAGSHIP_MAX_ABS_M = 5e-3


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_example", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha256(fp: Path) -> str:
    return hashlib.sha256(fp.read_bytes()).hexdigest()


def _held(a_fp: Path, b_fp: Path, max_abs_m: float) -> np.ndarray:
    a = read_raster(a_fp)[0].astype(np.float64)
    b = read_raster(b_fp)[0].astype(np.float64)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert float(np.sqrt(np.mean(d ** 2))) <= RMSE_M
    assert d.max() <= max_abs_m, float(d.max())
    return d


def _run_jax_example(name: str, out_dir: Path, monkeypatch) -> None:
    # the JAX examples read their directory from sys.argv
    monkeypatch.setattr(sys, "argv", [f"{name}.py", str(out_dir)])
    assert _example(name).main() == 0


@pytest.mark.parametrize(
    "name,rasters",
    [
        ("run_tohr", ["depth_sr.tif"]),
        ("serve_scenes", [f"forecast_t{t}_sr.tif" for t in range(4)]),
    ],
)
def test_example_matches_the_jax_example(name, rasters, tmp_path, monkeypatch, capsys):
    port, ref = tmp_path / "torch", tmp_path / "jax"
    assert _example(f"{name}_torch").main([str(port), "--device", "cpu"]) == 0
    assert "on cpu" in capsys.readouterr().out
    _run_jax_example(name, ref, monkeypatch)
    assert _sha256(port / "model_infer.fsrz") == _sha256(ref / "model_infer.fsrz")
    for raster in rasters:
        _held(port / raster, ref / raster, MAX_ABS_M)
        assert read_raster(ref / raster)[0].max() > 0, raster


def test_tutorial_matches_jax_tohr_and_the_case_metrics(tmp_path, capsys):
    metrics = _example("tutorial_torch").main([str(tmp_path), "--device", "cpu", "--no-figure"])
    out = capsys.readouterr().out
    assert not (tmp_path / "tutorial_compare.png").exists()
    for row in ("nearest (LR)", "bilinear", "FloodSR SR"):
        assert any(line.startswith(row) for line in out.splitlines()), row
    assert set(metrics) == {"nearest (LR)", "bilinear", "FloodSR SR"}

    spec = json.loads((CASE / "case_spec.json").read_text())
    want = tmp_path / "jax.tif"
    tohr_jax(
        model_version="ResUNet_16x_DEM",
        model_fp=CASE.parent / spec["model_artifact"],
        depth_lr_fp=CASE / spec["inputs"]["lowres_fp"],
        dem_hr_fp=CASE / spec["inputs"]["dem_fp"],
        output_fp=want,
    )
    d = _held(tmp_path / "depth_sr.tif", want, FLAGSHIP_MAX_ABS_M)
    assert (d > MAX_ABS_M).sum() <= 1e-3 * d.size

    expected = spec["expected"]["ResUNet_16x_DEM_default"]["metrics"]
    precision = int(expected["precision"])
    for row, ref in (("FloodSR SR", expected), ("bilinear", spec["baseline_bilinear"])):
        got = {k: round(float(metrics[row][k]), precision) for k in ("mase_m", "rmse_m", "ssim")}
        assert got == {k: round(float(ref[k]), precision) for k in got}, row


@pytest.mark.parametrize("name", ["run_tohr_torch", "serve_scenes_torch", "tutorial_torch"])
def test_example_raises_without_cuda_unless_asked_for_the_cpu(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out_dir = tmp_path / "out"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example(name).main([str(out_dir)])
    assert not out_dir.exists()


def test_tutorial_without_matplotlib_names_the_flag(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    with pytest.raises(RuntimeError, match="--no-figure"):
        _example("tutorial_torch").main([str(tmp_path), "--device", "cpu"])
    assert not (tmp_path / "depth_sr.tif").exists()
