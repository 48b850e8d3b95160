"""``bin/parity_gate_torch.py`` against ``bin/parity_gate.py`` and the JAX
package's ``tohr``, on the CPU.

The gate's case runner on ``device="cpu"`` is held to ``floodsr_tpu.tohr.tohr``
on the CPU at the port's bar (``tests/test_torch_scene_tohr.py``): 1e-4 m RMSE;
and 2e-4 m at any pixel (the port's scene sits up to 1.25e-4 m from the JAX
package's near the ``max_depth`` clip, ROADMAP §3) but where the finish is
discontinuous: a last-bit difference in the scene moves a pixel across the
1e-3 m low-depth mask (one side 0) or across one step of the ``uint12``
download's 12-bit codes (max_depth / 4095); such pixels stay under 0.1% of the
scene (``synth_mersch``: 1 and 6 of 16,384). The banded row on a mesh
of four CPU entries is held to 1e-4 m against the plain engine (the port's
bar between a meshed and its plain scene, ``tests/test_torch_engine_mesh.py``).
The result's keys are ``bin/parity_gate.py``'s plus ``device``; zero cases
fail; without CUDA ``main`` runs nothing.
"""

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
DATA = ROOT / "tests" / "data"
RMSE_M, MAX_ABS_M = 1e-4, 2e-4
LOW_DEPTH_MASK_M, MAX_DEPTH_M = 1e-3, 5.0


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_under_test", ROOT / "bin" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pg = _load("parity_gate_torch")
# The JAX gate's committed result: the keys of a case row and of the banded row.
COMMITTED = json.loads((ROOT / "PARITY_r05.json").read_text())


def _held_to_jax(a_fp, b_fp, code_step_m: float) -> None:
    a = read_raster(a_fp)[0].astype(np.float64)
    b = read_raster(b_fp)[0].astype(np.float64)
    d = np.abs(a - b)
    assert float(np.sqrt(np.mean(d ** 2))) <= RMSE_M
    off = d > MAX_ABS_M
    mask_edge = (np.minimum(a, b) == 0) & (np.maximum(a, b) < LOW_DEPTH_MASK_M + MAX_ABS_M)
    code_edge = d <= code_step_m + MAX_ABS_M
    assert not (off & ~mask_edge & ~code_edge).any(), float(d.max())
    assert off.sum() <= 1e-3 * d.size


@pytest.mark.parametrize(
    "case,method,engine_options",
    [
        ("synth_single_tile", "feather", None),
        ("synth_mersch", "feather", None),
        ("synth_mersch", "hard", None),
        ("synth_mersch", "feather", {"output_transfer": "uint12"}),
    ],
    ids=["synth_single_tile", "synth_mersch", "synth_mersch@hard", "synth_mersch@pack12"],
)
def test_case_runner_on_the_cpu_matches_jax_tohr(case, method, engine_options, tmp_path):
    got = tmp_path / "torch.tif"
    wall = pg.tohr_case(DATA, case, method, engine_options, got, "cpu")
    assert wall > 0
    spec = json.loads((DATA / case / "case_spec.json").read_text())
    want = tmp_path / "jax.tif"
    tohr_jax(
        model_version="ResUNet_16x_DEM",
        model_fp=DATA / spec["model_artifact"],
        depth_lr_fp=DATA / case / spec["inputs"]["lowres_fp"],
        dem_hr_fp=DATA / case / spec["inputs"]["dem_fp"],
        output_fp=want,
        window_method=method,
        engine_options=engine_options,
    )
    uint12 = (engine_options or {}).get("output_transfer") == "uint12"
    _held_to_jax(got, want, MAX_DEPTH_M / (4095 if uint12 else 65535))


def test_runs_are_the_jax_gates_runs():
    labels = [label for label, *_ in pg.gate_runs(DATA)]
    assert labels == list(COMMITTED["cases"])
    assert ("synth_mersch@pack12", "synth_mersch", "feather", {"output_transfer": "uint12"}) in (
        pg.gate_runs(DATA)
    )


def test_a_case_row_has_the_jax_gates_keys(tmp_path):
    # On the CPU against the CPU: the same bits.
    row = pg.case_row(DATA, "synth_single_tile", "synth_single_tile", "feather", None,
                      tmp_path, "cpu")
    assert set(row) == set(COMMITTED["cases"]["synth_single_tile"])
    assert row["rmse_m"] == 0.0 and row["max_abs_m"] == 0.0 and row["pass"] is True
    # The gate rounds the tail from the unrounded walls (as bin/parity_gate.py
    # does); the row holds three values each rounded to 2 decimals, so the
    # tail may sit one step of 0.01 from the difference of the rounded walls.
    tail = max(0.0, row["accelerator_wall_s"] - row["steady_s"])
    assert abs(row["compile_tail_s"] - tail) <= 0.01 + 1e-9


def test_banded_row_on_a_cpu_mesh(tmp_path):
    row = pg.banded_vs_plain_row("cpu")
    assert set(row) == set(COMMITTED["banded_vs_replicated"])
    assert row["scene"] == COMMITTED["banded_vs_replicated"]["scene"]
    assert row["rmse_m"] <= RMSE_M and row["max_abs_m"] <= RMSE_M and row["pass"] is True


def test_an_empty_data_directory_fails_with_the_jax_gates_keys(tmp_path, monkeypatch):
    empty = tmp_path / "data"
    empty.mkdir()
    result = pg.gate(empty, tmp_path, "cpu")
    assert result["pass"] is False and result["cases"] == {}
    assert "no golden cases" in result["error"]
    assert result["device"] == {"name": "cpu", "power_limit": None}

    jax_gate = _load("parity_gate")
    out = tmp_path / "jax.json"
    monkeypatch.setattr(jax_gate, "_DATA_DIR", empty)
    monkeypatch.setattr(sys, "argv", ["parity_gate.py", "--out", str(out)])
    assert jax_gate.main() == 1
    assert set(result) == set(json.loads(out.read_text())) | {"device"}


@pytest.mark.parametrize("argv", [[], ["--device", "cpu"]], ids=["default", "cpu"])
def test_main_runs_nothing_without_cuda(argv, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pg, "gate", lambda *a, **kw: pytest.fail("the gate ran"))
    out = tmp_path / "out.json"
    assert pg.main(argv + ["--out", str(out)]) == 2
    assert not out.exists()
    captured = capsys.readouterr()
    assert captured.out == "" and "nothing was run" in captured.err
