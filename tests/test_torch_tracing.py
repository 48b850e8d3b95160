"""The port's request-scoped spans (``floodsr_tpu_torch/tracing.py``) on the CPU.

A ``TohrService`` on the tiny artifact serves one ``handle_tohr`` and one
``handle_tohr_many`` of two jobs over new DEMs (so the batch prefetches the
second DEM on its own thread). Their records are held to the request ids,
the parents across threads, the coverage of ``worker.run`` by its children,
the ``scene_timings`` keys, and ``floodsr_device_busy_seconds``; a traced
request to ``torch.profiler`` recording every thread.
"""

import threading
import time

import pytest
import torch

from floodsr_tpu_torch import tracing
from floodsr_tpu_torch.models.ResUNet_16x_DEM import ModelWorker
from floodsr_tpu_torch.serve import TohrService
from test_torch_stream import _scene

pytestmark = pytest.mark.unit

#: ``scene_timings`` key -> the span whose time it is
KEY_SPANS = {
    "read_s": "read", "h2d_s": "engine.h2d", "exec_s": "engine.exec",
    "finish_s": "engine.finish", "device_post_s": "finish.device",
    "d2h_wait_s": "finish.d2h", "host_dequant_s": "finish.dequant",
    "host_resample_s": "finish.resample", "host_sink_s": "finish.sink",
    "host_post_s": "finish.host",
}


def _spans(result):
    return result["scene_timings"]["trace"]["spans"]


def _named(result, name):
    return [s for s in _spans(result) if s[0] == name]


def _seconds(span):
    return (span[3] - span[2]) * 1e-9


def _body(dem_fp, depth_fp, out_fp):
    return {"in": str(depth_fp), "dem": str(dem_fp), "out": str(out_fp)}


@pytest.fixture(scope="module")
def served(tiny_model_fp, tmp_path_factory):
    """One single request and one batch of two, on DEMs the service has not
    seen; the DEM decodes' threads are noted, and the prefetch is slowed so
    that the job after it waits on it."""
    tmp = tmp_path_factory.mktemp("tracing")
    scenes = [_scene(tmp, 40 + k, f"t{k}", hr=(128, 128)) for k in range(3)]
    service = TohrService(model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp, device="cpu")
    service.start()
    worker, decoded_on = service._worker, []
    real_decode, real_run = worker._decode_and_upload_dem, worker.run
    ran = threading.Event()

    def noting(path, stream=None):
        decoded_on.append((path.name, threading.current_thread().name))
        if threading.current_thread().name == "floodsr-dem-prefetch":
            # outlast the job that started it: the next job waits on it
            ran.wait(timeout=60)
            time.sleep(0.2)
        return real_decode(path, stream=stream)

    def run(**kw):
        try:
            return real_run(**kw)
        finally:
            ran.set()

    worker._decode_and_upload_dem, worker.run = noting, run
    try:
        single = service.handle_tohr(_body(*scenes[0], tmp / "single.tif"))
        ran.clear()
        batch = service.handle_tohr_many({"jobs": [
            _body(*scenes[k], tmp / f"batch{k}.tif") for k in (1, 2)
        ]})
        metrics = service.metrics_text()
    finally:
        service.close()
    busy = float(next(
        ln.split()[1] for ln in metrics.splitlines()
        if ln.startswith("floodsr_device_busy_seconds ")
    ))
    return {"single": single, "batch": batch, "busy": busy, "decoded_on": decoded_on,
            "scenes": scenes, "tmp": tmp}


def test_every_span_of_a_call_carries_its_request_id(served):
    single, (first, second) = served["single"], served["batch"]
    ids = [r["scene_timings"]["trace"]["request"] for r in (single, first, second)]
    assert ids[1] == ids[2] != ids[0]
    for result in (single, first, second):
        names = [s[0] for s in _spans(result)]
        assert names[0] == "service.request" and "worker.run" in names
        # one job each: the batch's other job is left out of a job's record
        assert names.count("service.job") == names.count("worker.run") == 1
        for i, (name, parent, t0, t1) in enumerate(_spans(result)):
            assert -1 <= parent < i and t0 <= t1
            if parent >= 0:
                p = _spans(result)[parent]
                assert p[2] <= t0 and t1 <= p[3], (name, p[0])


def test_parents_link_across_the_device_and_prefetch_threads(served):
    first, second = served["batch"]
    dem1, dem2 = (served["scenes"][k][0].name for k in (1, 2))
    # job 1's DEM was decoded by the prefetch thread that job 0 started,
    # every other DEM in a run on the device thread
    threads = dict(served["decoded_on"])
    assert threads[dem2] == "floodsr-dem-prefetch"
    assert threads[dem1].startswith("floodsr-device")
    for result in (first, second):
        spans = _spans(result)
        by_name = {s[0]: i for i, s in enumerate(spans)}
        assert spans[by_name["worker.run"]][1] == by_name["service.job"]
        # the prefetch works for the request: its span hangs under it
        assert spans[by_name["prefetch.dem"]][1] == by_name["service.request"]
    assert _named(first, "read.dem_decode") and not _named(first, "read.dem_join")
    (join,) = _named(second, "read.dem_join")
    assert _seconds(join) > 0 and not _named(second, "read.dem_decode")
    assert second["scene_timings"]["dem_resident"] is True


@pytest.mark.parametrize("which", ["single", "batch0", "batch1"])
def test_children_of_worker_run_cover_it(served, which):
    result = served["single"] if which == "single" else served["batch"][int(which[-1])]
    spans = _spans(result)
    root = next(i for i, s in enumerate(spans) if s[0] == "worker.run")
    children = sum(_seconds(s) for s in spans if s[1] == root)
    assert children >= 0.9 * _seconds(spans[root])
    assert result["runtime_s"] == pytest.approx(_seconds(spans[root]), abs=1e-9)


@pytest.mark.parametrize("which", ["single", "batch1"])
def test_scene_timings_are_the_spans(served, which):
    result = served["single"] if which == "single" else served["batch"][1]
    timings = result["scene_timings"]
    for key, name in KEY_SPANS.items():
        assert timings[key] == pytest.approx(sum(_seconds(s) for s in _named(result, name)),
                                             abs=1e-9), key
    record = timings["trace"]
    assert timings["d2h_bytes"] == record["counters"]["d2h_bytes"] > 0
    assert timings["tiles"] > 0 and isinstance(timings["dem_counts"], dict)
    # on the CPU the device time is the host time of the device's spans
    device = sum(_seconds(s) for n in ("engine.h2d", "engine.exec", "finish.device", "finish.d2h")
                 for s in _named(result, n))
    assert record["counters"]["device_s"] == pytest.approx(device, abs=1e-8)
    # the encode and write of the output are spans of the finish's sink
    sink = sum(_seconds(s) for n in ("sink.encode", "sink.write") for s in _named(result, n))
    assert 0 < sink <= timings["host_sink_s"]


def test_device_busy_seconds_counts_the_requests_device_time(served):
    results = [served["single"], *served["batch"]]
    device = sum(r["scene_timings"]["trace"]["counters"]["device_s"] for r in results)
    assert served["busy"] == pytest.approx(device)
    assert 0 < served["busy"] <= sum(r["runtime_s"] for r in results)


def test_the_profiler_sees_the_device_threads_spans_on_the_same_clock(served, tiny_model_fp):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    dem_fp, depth_fp = served["scenes"][0]
    service = TohrService(model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp, device="cpu")
    service.start()
    try:
        for k in range(2):  # the first traced call also warms the profiler
            with profile(activities=[ProfilerActivity.CPU],
                         experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
                result = service.handle_tohr(_body(dem_fp, depth_fp, served["tmp"] / f"p{k}.tif"))
    finally:
        service.close()
    seen = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PROFILER_PREFIX):
            seen.setdefault(e.name()[len(tracing.PROFILER_PREFIX):], []).append(e.start_ns())
    for name in ("worker.run", "read", "engine.exec", "finish.d2h", "finish.sink", "sink.encode"):
        starts = seen[name]
        for s in _named(result, name):
            assert min(abs(t - s[2]) for t in starts) < 1_000_000, name


def test_no_record_function_is_built_without_a_profiler(served, monkeypatch, tiny_model_fp):
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    dem_fp, depth_fp = served["scenes"][0]
    with ModelWorker(model_fp=tiny_model_fp, device="cpu") as worker:
        worker.run(depth_lr_fp=depth_fp, dem_hr_fp=dem_fp, output_fp=served["tmp"] / "n.tif")
        assert entered == []
        # the same run while a profiler records enters one range a span
        monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
        result = worker.run(depth_lr_fp=depth_fp, dem_hr_fp=dem_fp,
                            output_fp=served["tmp"] / "p.tif")
    assert entered == [tracing.PROFILER_PREFIX + s[0] for s in _spans(result)]


def test_a_run_outside_the_service_makes_its_own_request(served, tiny_model_fp):
    dem_fp, depth_fp = served["scenes"][0]
    with ModelWorker(model_fp=tiny_model_fp, device="cpu") as worker:
        a, b = (worker.run(depth_lr_fp=depth_fp, dem_hr_fp=dem_fp,
                           output_fp=served["tmp"] / f"own{k}.tif") for k in range(2))
    ids = {r["scene_timings"]["trace"]["request"] for r in (a, b, served["single"])}
    assert len(ids) == 3
    assert [s[0] for s in _spans(a)][:2] == ["worker.run", "worker.inputs"] and _spans(a)[0][1] == -1


def test_a_run_inside_an_open_request_leaves_the_record_to_its_opener(served, tiny_model_fp):
    dem_fp, depth_fp = served["scenes"][0]
    assert tracing.current() is None
    with ModelWorker(model_fp=tiny_model_fp, device="cpu") as worker:
        with tracing.request() as trace, tracing.span("caller") as caller:
            assert tracing.current() is trace
            result = worker.run(depth_lr_fp=depth_fp, dem_hr_fp=dem_fp,
                                output_fp=served["tmp"] / "inside.tif")
    assert tracing.current() is None
    assert "trace" not in result["scene_timings"]
    record = trace.export(caller)
    names = [s[0] for s in record["spans"]]
    assert names[:2] == ["caller", "worker.run"] and record["spans"][1][1] == 0
    assert result["runtime_s"] == pytest.approx(_seconds(record["spans"][1]), abs=1e-9)
    assert record["counters"]["device_s"] > 0


def test_chip_smokes_worker_stages_are_the_spans_under_worker_run(served, tiny_model_fp):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_stages", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    dem_fp, depth_fp = served["scenes"][0]
    with ModelWorker(model_fp=tiny_model_fp, device="cpu") as worker:
        result = worker.run(depth_lr_fp=depth_fp, dem_hr_fp=dem_fp,
                            output_fp=served["tmp"] / "stages.tif")
    stages = chip_smoke.run_stages(result)
    for name in ("read", "worker.prepare", "engine.exec", "engine.finish", "worker.close"):
        assert stages[name] > 0, name
    assert stages["read"] == pytest.approx(result["scene_timings"]["read_s"], abs=1e-9)
    assert stages["engine.finish"] == pytest.approx(result["scene_timings"]["finish_s"], abs=1e-9)
    assert sum(stages.values()) <= result["runtime_s"] + 1e-9


def test_export_keeps_a_jobs_own_subtree_and_the_requests_work():
    with tracing.request() as trace, tracing.span("request"):
        with tracing.span("job") as first:
            with tracing.span("work") as w:
                w.add("n", 2)
        with tracing.span("shared"):
            pass
        with tracing.span("job") as second:
            with tracing.span("work") as w:
                w.add("n", 3)
                with tracing.request() as inner:  # joins the open request
                    assert inner is trace
    record = trace.export(second)
    assert [s[:2] for s in record["spans"]] == [
        ["request", -1], ["shared", 0], ["job", 0], ["work", 2]]
    assert record["counters"] == {"n": 3.0}
    assert trace.export(first)["counters"] == {"n": 2.0}
    seconds, counters = trace.totals(second)
    assert seconds == {"work": w.seconds} and counters == {"n": 3.0}
    # outside a request a span still times its block and is kept nowhere
    with tracing.span("alone") as alone:
        pass
    assert alone.index == -1 and alone.seconds > 0


def test_threads_in_copies_of_one_context_share_a_record():
    """Spans from more threads than cores, switching often: every span keeps
    its own place in the record and its parent on the thread that started it."""
    import contextvars
    import sys

    threads, per_thread = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.request() as trace, tracing.span("request") as root:
            def work():
                with tracing.span("thread"):
                    for _ in range(per_thread):
                        with tracing.span("leaf"):
                            pass

            pool = [threading.Thread(target=contextvars.copy_context().run, args=(work,))
                    for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    spans = trace.spans
    assert len(spans) == 1 + threads * (1 + per_thread)
    assert [s.index for s in spans] == list(range(len(spans)))
    tops = {s.index for s in spans if s.name == "thread"}
    assert all(spans[i].parent == root.index for i in tops)
    leaves = [s for s in spans if s.name == "leaf"]
    assert all(s.parent in tops for s in leaves)
    assert sorted(sum(s.parent == t for s in leaves) for t in tops) == [per_thread] * threads
