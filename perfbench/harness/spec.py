"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); a configuration names its model family
(``families/<name>.py``); a mix names its loop (``loops/<name>.py``) and its
front (``fronts/<name>.py``); a metric is ``metrics/<name>.py``. A later
cell, family, mix, loop, front or metric is a new file and a new entry, never
an edit here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def config(name: str) -> dict:
    entry = next(c for c in benchmark()["configs"] if c["name"] == name)
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def cell(name: str) -> tuple[dict, dict, dict]:
    """``(workload entry, configuration, traffic mix)`` of a cell."""
    entry = next((w for w in benchmark()["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    return entry, config(entry["config"]), traffic(entry["traffic"])


def metrics_of(cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those that
    list it under ``workloads``, or that name none. A per-layer metric without
    a ``workloads`` key follows the cells of the metric it moves."""
    bench = benchmark()
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def lists_cell(m: dict) -> bool:
        return cell_name in m.get("workloads", [cell_name])

    def covers(m: dict) -> bool:
        if kind == "per_layer" and "workloads" not in m:
            return lists_cell(e2e[m["moves"]])
        return lists_cell(m)

    return [m for m in bench[kind] if covers(m)]


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (``metrics``, ``loops``, ``fronts`` or ``families``)."""
    fp = BENCH_DIR / kind / f"{name}.py"
    if not fp.is_file():
        raise KeyError(f"no file {kind}/{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}", fp)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The module ``metrics/<name>.py``; its ``read(run)`` returns a number or None."""
    return module("metrics", name)


def family(cfg: dict):
    """The module ``families/<name>.py`` of the configuration's ``family``
    (``resunet`` where it names none): what the harness knows of the model.

    It gives ``artifact(cfg, workdir, device)``, the file served as
    ``model_fp``; ``service_options(cfg)``, the service's ``engine_options``;
    ``warmup_shapes(cfg, plan)``, the HR shapes ``TohrService.warmup`` builds;
    ``lr_raster(cfg, dem, base_m, offset_m, tilt_m, lr_shape)``, a scenario's
    LR input (``traffic.build``); ``per_job(cfg, plan)``, the run's ``arch``
    and ``windows_per_job`` for the work counts (either may be None); and
    ``judge(cfg, plan, done, limits, device, control)``, every check of the
    outputs as ``{"value", "limit"}``, ``judged`` among them.
    """
    return module("families", cfg.get("family", "resunet"))
