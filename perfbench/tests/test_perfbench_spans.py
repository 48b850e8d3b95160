"""The span readers on made-up runs: self time, sums over repeated spans, and
nothing where a job carries no record (a program without spans)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench.harness import spec
from perfbench.harness.spans import span_ms

MS = 1_000_000  # ns

READERS = ("service_ms.scene", "prepare_ms.scene", "dem_wait_ms.scene", "encode_ms.scene",
           "write_ms.scene")


def _job(scale: int = 1, join: bool = True) -> dict:
    """One job's result: spans laid out in ms times ``scale``."""
    s = scale
    spans = [
        ["service.request", -1, 0, 100 * s * MS],
        ["prefetch.dem", 0, 1 * MS, 60 * s * MS],      # another thread's work for the request
        ["service.job", 0, 0, 100 * s * MS],
        ["worker.run", 2, 2 * MS, 97 * s * MS],
        ["read", 3, 2 * MS, 12 * MS],
        ["read.dem_join", 4, 2 * MS, 9 * MS],
        ["worker.prepare", 3, 12 * MS, 15 * MS],
        ["engine.exec", 3, 15 * MS, 45 * MS],
        ["engine.finish", 3, 45 * MS, 90 * MS],
        ["finish.sink", 8, 50 * MS, 90 * MS],
        ["sink.encode", 9, 50 * MS, 60 * MS],
        ["sink.write", 9, 60 * MS, 62 * MS],
        ["sink.encode", 9, 62 * MS, 80 * MS],
        ["sink.write", 9, 80 * MS, 81 * MS],
        ["worker.close", 3, 90 * MS, 91 * MS],
        ["worker.verify", 3, 91 * MS, 92 * MS],
        ["read.dem_decode", 4, 20 * MS, 0],            # still open: not counted
    ]
    if not join:
        spans = [sp if sp[0] != "read.dem_join" else ["read.depth", 4, 2 * MS, 9 * MS]
                 for sp in spans]
    return {"ok": True, "scene_timings": {
        "exec_s": 0.03, "trace": {"request": 7, "spans": spans,
                                  "counters": {"device_s": 0.05}}}}


def _run(*results):
    return SimpleNamespace(jobs=[(None, r) for r in results])


def _read(name, run):
    return spec.metric_reader(name).read(run)


def test_self_time_and_sums_over_repeated_spans():
    job = _job()
    assert span_ms(job, "service.job") == pytest.approx(100.0)
    # its time less its own child worker.run; the prefetch hangs elsewhere
    assert span_ms(job, "service.job", self_time=True) == pytest.approx(5.0)
    assert span_ms(job, "finish.sink", self_time=True) == pytest.approx(9.0)
    assert span_ms(job, "sink.encode") == pytest.approx(28.0)
    assert span_ms(job, "read.dem_decode") == 0.0 and span_ms(job, "absent") == 0.0


@pytest.mark.parametrize("name,want", [
    ("service_ms.scene", 5.0), ("prepare_ms.scene", 3.0), ("dem_wait_ms.scene", 7.0),
    ("encode_ms.scene", 28.0), ("write_ms.scene", 4.0),
])
def test_each_reader_on_one_job(name, want):
    assert _read(name, _run(_job())) == pytest.approx(want)


def test_a_reader_takes_the_mean_over_jobs():
    run = _run(_job(), _job(join=False), _job(scale=3))
    assert _read("dem_wait_ms.scene", run) == pytest.approx(14.0 / 3)
    assert _read("encode_ms.scene", run) == pytest.approx(28.0)
    # service.job at scale 3: 300 ms less worker.run's 289
    assert _read("service_ms.scene", run) == pytest.approx((5.0 + 5.0 + 11.0) / 3)


def test_no_record_reads_nothing():
    bare = {"ok": True, "scene_timings": {"exec_s": 0.03, "read_s": 0.004}}
    for name in READERS:
        assert _read(name, _run(bare, {"ok": True})) is None, name
        assert _read(name, _run()) is None, name
    # jobs with records are read, those without are left out of the mean
    assert _read("encode_ms.scene", _run(bare, _job())) == pytest.approx(28.0)


def test_the_new_metrics_are_in_the_benchmark():
    per_layer = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["unit"] == "ms" and m["better"] == "lower" and m["moves"] == "hr_mps"
        assert m["source"] == "program_span"
    assert per_layer["dem_wait_ms.scene"]["workloads"] == ["flagship-newterrain"]
