"""BENCHMARK.json against its rules: names resolve to files, metrics cover
the cells that report what they move, names and units use allowed characters."""

from __future__ import annotations

import json
import re

import pytest

from perfbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_name_resolves_to_its_file(bench):
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert spec.config(c["name"])["architecture"]
    for w in bench["workloads"]:
        entry, cfg, mix = spec.cell(w["name"])
        assert mix["hr_shape"] and cfg["policy"]
        assert (spec.BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
        assert callable(spec.module("loops", mix["loop"]).drive)
        front = spec.module("fronts", mix["front"])
        assert callable(front.body) and callable(front.handler)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


def test_a_missing_file_is_named():
    with pytest.raises(KeyError, match="loops/open.py"):
        spec.module("loops", "open")


def test_a_configuration_without_family_is_a_resunet():
    cfg = spec.config("resunet16x_flagship")
    assert "family" not in cfg
    assert spec.family(cfg).__file__ == str(spec.BENCH_DIR / "families" / "resunet.py")


def test_an_unknown_family_is_named():
    with pytest.raises(KeyError, match="families/costgrow_x.py"):
        spec.family({"family": "costgrow_x"})


def test_names_units_and_keys(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for kind in ("end_to_end", "per_layer"):
        assert len({m["name"] for m in bench[kind]}) == len(bench[kind])
        for m in bench[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert sum(m["name"] == "setup_s" for m in bench["end_to_end"]) == 1


def test_per_layer_metrics_cover_their_cells(bench):
    """A per-layer metric lists exactly cells that report the metric it moves;
    every cell reports set-up, another end-to-end metric and a per-layer one."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in bench["workloads"]:
        reported = {m["name"] for m in spec.metrics_of(w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(w["name"], "per_layer")


def test_layers_are_named_alike(bench):
    by_layer: dict[str, set] = {}
    for m in bench["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_a_metric_without_workloads_follows_what_it_moves(monkeypatch, bench):
    bench = json.loads(json.dumps(bench))
    bench["per_layer"].append({"name": "x.scene", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "service", "moves": "hr_mps"})
    monkeypatch.setattr(spec, "benchmark", lambda: bench)
    for w in bench["workloads"]:
        assert "x.scene" in {m["name"] for m in spec.metrics_of(w["name"], "per_layer")}
