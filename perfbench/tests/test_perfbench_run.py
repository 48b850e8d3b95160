"""A run end to end on the CPU at a tiny size, the same run with the timed path
broken underneath (``correct`` must come out false), and the refusals: no
card, JAX loaded."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import run
from perfbench.harness import spec

SEED = 2**35 + 3
LIMITS = {"rmse_m": 1e-4, "max_abs_m": 1e-3}


def _run(cell, **kw):
    entry, cfg, mix = cell
    return run.run_cell(entry, cfg, mix, LIMITS, seed=SEED, seconds=1.0, trace=False,
                        device="cpu", **kw)


@pytest.mark.parametrize("traffic,hr_s2d", [("resident", 4), ("resident", 1), ("new_terrain", 4)])
def test_a_sound_run_is_correct(tiny_cell, traffic, hr_s2d):
    result = _run(tiny_cell("resunet16x_flagship", traffic, hr_s2d=hr_s2d))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["failed"] == 0


def test_a_short_window_judges_an_output_nothing_wrote_over(tiny_cell):
    """No judged job in the window: the last job's output is judged, not the
    first's, which the later jobs wrote over (one rotating path)."""
    entry, cfg, mix = tiny_cell("resunet16x_flagship", "resident")
    result = run.run_cell(entry, cfg, dict(mix, judged=0, rotate_outputs=1), LIMITS, seed=SEED,
                          seconds=2.0, trace=False, device="cpu")
    assert result["attempted"] >= 2 and result["checks"]["judged"]["value"] == 1
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name", ["flagship-resident", "flagship-newterrain"])
def test_a_cell_reports_its_end_to_end_metrics(tiny_cell, name):
    entry, _, _ = spec.cell(name)
    result = _run(tiny_cell(entry["config"], entry["traffic"], name))
    reported = {m["name"] for m in spec.metrics_of(name, "end_to_end")}
    assert set(result["metrics"]) == reported


def _alter_answer(monkeypatch):
    import floodsr_tpu_torch.engine.scene as scene

    real = scene.invert_depth_log1p
    monkeypatch.setattr(scene, "invert_depth_log1p", lambda x, d: real(x, d) * 1.01)


def _half_the_batch(monkeypatch):
    from floodsr_tpu_torch.nn.resunet import ResUNet

    real = ResUNet.tail

    def tail(self, feat, dem, precision=None):
        out = real(self, feat, dem, precision)
        half = out.shape[0] // 2
        if half:  # the second half left out: the first half's answers stand in
            out = torch.cat([out[: out.shape[0] - half], out[:half]])
        return out

    monkeypatch.setattr(ResUNet, "tail", tail)


@pytest.mark.parametrize("fault", [_alter_answer, _half_the_batch])
@pytest.mark.parametrize("traffic", ["resident", "new_terrain"])
def test_a_broken_path_is_not_correct(tiny_cell, monkeypatch, fault, traffic):
    fault(monkeypatch)
    result = _run(tiny_cell("resunet16x_flagship", traffic))
    assert not result["correct"], result["checks"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "flagship-resident", "--seed", str(SEED), "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_host_threads_are_set_before_torch_loads():
    code = (
        "import os, sys; sys.path.insert(0, '.');"
        "from perfbench import run; from perfbench.harness import spec;"
        "entry, cfg, mix = spec.cell('flagship-resident');"
        "assert 'torch' not in sys.modules and 'numpy' not in sys.modules;"
        "run.apply_host(cfg); import torch;"
        "print(os.environ['FLOODSR_CODEC_THREADS'], torch.get_num_threads())"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True, env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    host = spec.config("resunet16x_flagship")["host"]
    assert out.stdout.split() == [str(host["codec_threads"]), str(host["torch_threads"])]


def test_jax_loaded_no_result(monkeypatch, tiny_cell, capsys):
    """The check compares whole top-level names: the port's own name passes."""
    monkeypatch.setitem(sys.modules, "floodsr_tpu_torch_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "floodsr_tpu.nn", object())
    assert run.forbidden_modules() == ["floodsr_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import perfbench.run, perfbench.harness.trace, perfbench.reference.pipeline;"
        "from perfbench.harness import spec;"
        "[spec.metric_reader(m['name']) for m in spec.benchmark()['per_layer'] + spec.benchmark()['end_to_end']];"
        "import floodsr_tpu_torch.serve;"
        "from floodsr_tpu_torch.model_registry import resolve_model_worker_class;"
        "resolve_model_worker_class('ResUNet_16x_DEM');"
        "print(perfbench.run.forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True, env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    """Nor does a family: the program's service is started by ``run.py`` alone."""
    for fp in [*(spec.BENCH_DIR / "reference").glob("*.py"), *(spec.BENCH_DIR / "families").glob("*.py")]:
        for node in ast.walk(ast.parse(fp.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in {"floodsr_tpu_torch", "floodsr_tpu", "jax", "jaxlib", "flax"}, (fp, n)
                if fp.parent.name == "reference":
                    assert not n.startswith("perfbench.harness"), (fp, n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship-resident", "flagship-newterrain"])
def test_the_tf32_control_fails_at_the_cells_size(name):
    """The reference in TF32 in the program's place, at the cell's own size,
    on three seeds: its widest rmse lies above the cell's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    entry, cfg, mix = spec.cell(name)
    limits = run.limits_of(name)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        result = run.run_cell(entry, cfg, mix, limits, seed=seed, seconds=2.0, trace=False,
                              device="cuda", control=True)
        assert not result["correct"], json.dumps(result["checks"])
