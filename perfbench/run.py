#!/usr/bin/env python3
"""Run one cell of the benchmark of ``floodsr_tpu_torch`` once, on the GPU.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program. A cell (``BENCHMARK.json``
``workloads``) names a configuration (``perfbench/configs/<name>.json``) and a
traffic mix (``perfbench/traffic/<name>.json``); the configuration's model
family (``perfbench/families/<name>.py``) gives the served file, the engine's
options, the warm-up shapes, the scenarios' LR rasters, the work a job and the
judge; the cell's limits of correctness are
``perfbench/limits/<cell>.json``; each metric is read by
``perfbench/metrics/<metric>.py``; a mix's loop and front are
``perfbench/loops/<loop>.py`` and ``perfbench/fronts/<front>.py``.

Set-up: the seed's inputs are written as GeoTIFFs under ``$TMPDIR`` (timed
apart, printed on stderr), then the program's resident service
(``floodsr_tpu_torch.serve.TohrService``) is started and warmed: ``start()``,
``warmup()`` for the cell's scene geometry, and the mix's warm-up calls. The
window: the mix's loop sends machine-interface payloads through its front
(``handle_tohr`` or ``handle_tohr_many``) until ``--seconds`` have passed
(in a closed loop the call running then completes and closes the window). With
``--trace 1`` the window runs under ``torch.profiler``. After the window: the
peak device memory is read, the service closed, and a sample of the window's
outputs, drawn from the seed, is judged by the family (the ResUNet's: worked
out again by the plain reference, ``perfbench/reference/``, and compared).

The last stdout line is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit (also the last stderr
lines). Exits non-zero with no result without CUDA, with fewer cards than the
cell asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T_MODULE = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from functools import partial  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Every cache at a fixed path inside the checkout, so that only a cell's first
# run there builds (the program's own CUDA and TIFF libraries already build
# under floodsr_tpu_torch/).
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(BENCH / "_build" / "torch_kernels")
os.environ["TRITON_CACHE_DIR"] = str(BENCH / "_build" / "triton")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "floodsr_tpu"})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (its start time in ``/proc``)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = float(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_MODULE


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def apply_host(cfg: dict) -> None:
    """The configuration's host threads (``host``), set before PyTorch loads:
    the program's codec threads and PyTorch's and OpenMP's."""
    host = cfg.get("host", {})
    if "codec_threads" in host:
        os.environ["FLOODSR_CODEC_THREADS"] = str(int(host["codec_threads"]))
    if "torch_threads" in host:
        os.environ["OMP_NUM_THREADS"] = str(int(host["torch_threads"]))


def limits_of(cell: str) -> dict:
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())


def run_cell(entry: dict, cfg: dict, mix: dict, limits: dict, *, seed: int, seconds: float,
             trace: bool, device: str = "cuda", control: bool = False) -> dict:
    """One run of a cell; returns the result object (``checks`` last).

    ``control`` puts the family's control in the program's place for the
    judged outputs (the comparison must then fail): for the ResUNet, the
    reference computed with TF32.
    """
    import torch

    from perfbench.harness import spec, traffic
    from perfbench.harness.trace import span, traced

    cuda = device.startswith("cuda")
    family = spec.family(cfg)
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        workdir = Path(tmp)
        t0 = time.perf_counter()
        plan = traffic.build(mix, seed, workdir, partial(family.lr_raster, cfg))
        artifact = family.artifact(cfg, workdir, device)
        gen_s = time.perf_counter() - t0
        log(f"# inputs: {len(plan.areas)} areas, {len(plan.scenarios)} scenarios, "
            f"{plan.bytes_written} bytes written, {gen_s:.3f} s (not set-up)")

        from floodsr_tpu_torch.serve import TohrService

        service = TohrService(
            model_version=cfg["model_version"], model_fp=artifact, device=device,
            engine_options=family.service_options(cfg),
        )
        front = spec.module("fronts", mix["front"])
        loop = spec.module("loops", mix["loop"])
        handle = front.handler(service)
        jpc = plan.jobs_per_call
        failures = []

        def call(index: int, warmup: bool = False) -> dict:
            jobs = [plan.job(index + k, warmup) for k in range(jpc)]
            payload = front.body([plan.body(j) for j in jobs])
            ts = time.perf_counter()
            try:
                with span(mix["front"]):
                    results = handle(payload)
            except Exception as err:  # noqa: BLE001 - a failed request is counted
                results = [{"ok": False, "error": repr(err)} for _ in jobs]
            te = time.perf_counter()
            plan.release(jobs)
            return {"t0": ts, "t1": te, "latency_s": te - ts, "jobs": jobs, "results": results}

        try:
            log(f"# set-up: imports and CUDA context done at {process_age_s() - gen_s:.3f} s")
            service.start()
            log(f"# set-up: service started at {process_age_s() - gen_s:.3f} s")
            service.warmup(family.warmup_shapes(cfg, plan))
            log(f"# set-up: geometry warmed at {process_age_s() - gen_s:.3f} s")
            for w in range(int(mix.get("warmup_calls", 1))):
                c = call(w * jpc, warmup=True)
                bad = [r for r in c["results"] if r.get("ok") is False]
                if bad:
                    raise RuntimeError(f"a warm-up call failed: {bad[0]['error']}")
                log(f"# set-up: warm-up call {w} took {c['latency_s']:.3f} s")
            if cuda:
                torch.cuda.synchronize()
            setup_s = process_age_s() - gen_s
            log(f"# set-up {setup_s:.3f} s")

            cpu0 = sum(os.times()[:2])
            with traced() if trace else contextlib.nullcontext({}) as trace_out:
                tw0 = time.perf_counter()
                calls = loop.drive(call, seconds, jpc)
                window_s = calls[-1]["t1"] - tw0
                cpu_s = sum(os.times()[:2]) - cpu0
            log(f"# this process used {cpu_s:.2f} s of CPU in the window")
            if trace:
                log(f"# trace read in {time.perf_counter() - tw0 - window_s:.3f} s")
            peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        finally:
            service.close()
        del service
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        done = []
        for c in calls:
            for job, res in zip(c["jobs"], c["results"]):
                if res.get("ok") is False:
                    failures.append(res.get("error"))
                else:
                    done.append((job, res))
        attempted = sum(len(c["jobs"]) for c in calls)
        written = sum(int(r.get("output_size_bytes", 0)) for _, r in done)
        log(f"# window {window_s:.3f} s: {attempted} jobs in {len(calls)} calls, "
            f"{len(failures)} failed, peak {peak} bytes, {written} bytes of output written")
        for err in failures[:3]:
            log(f"# failed: {err}")
        lat = sorted(c["latency_s"] for c in calls)
        log("# latency s: " + " ".join(
            f"p{q}={lat[min(len(lat) - 1, int(q / 100 * len(lat)))]:.4f}" for q in (10, 50, 90, 95, 99, 100)))
        stages = {}
        for _, r in done:
            for k, v in r.get("scene_timings", {}).items():
                if k.endswith("_s") and isinstance(v, (int, float)):
                    stages.setdefault(k, []).append(v)
        log("# mean stage s: " + " ".join(f"{k}={sum(v) / len(v):.4f}" for k, v in stages.items()))

        t_ref = time.perf_counter()
        checks = family.judge(cfg, plan, done, limits, device, control)
        log(f"# reference: {checks['judged']['value']} outputs, {time.perf_counter() - t_ref:.3f} s")
        checks["failed"] = {"value": len(failures), "limit": 0}

    run = SimpleNamespace(
        calls=calls, jobs=done, window_s=window_s, setup_s=setup_s, trace=trace_out or None,
        cfg=cfg, mix=mix, entry=entry, geometry=plan.geometry, **family.per_job(cfg, plan),
    )
    metrics = {}
    for m in spec.metrics_of(entry["name"], "per_layer" if trace else "end_to_end"):
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    correct = all(
        v["value"] <= v["limit"] for k, v in checks.items() if k != "judged"
    ) and checks["judged"]["value"] >= checks["judged"]["limit"]
    result = {"correct": bool(correct), "attempted": attempted, "failed": len(failures),
              "metrics": metrics}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(entry.get("chips", 1)), "memory_peak_bytes": peak}
    if trace_out:
        dev["busy_s"] = trace_out["busy_s"]
        dev["window_s"] = trace_out["window_us"] * 1e-6
        result["breakdown"] = {"device_ops": trace_out["device_ops"],
                               "idle_gaps": trace_out["idle_gaps"]}
    result["device"] = dev
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench.harness import spec

    entry, cfg, mix = spec.cell(args.workload)
    apply_host(cfg)
    import torch

    log(f"# host threads: codec {os.environ.get('FLOODSR_CODEC_THREADS', 'default')}, "
        f"torch {torch.get_num_threads()}")

    if not torch.cuda.is_available():
        log("perfbench: CUDA is not available; nothing was run")
        return 2
    if torch.cuda.device_count() < int(entry.get("chips", 1)):
        log(f"perfbench: the cell needs {entry['chips']} cards, "
            f"{torch.cuda.device_count()} are visible; nothing was run")
        return 2
    try:
        import subprocess

        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
        log(f"# card: {card[0] if card else 'unknown'}")
    except (OSError, subprocess.SubprocessError):
        log("# card: nvidia-smi did not answer")
    result = run_cell(entry, cfg, mix, limits_of(args.workload), seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"perfbench: modules of JAX or the JAX package were loaded: {', '.join(found)}")
        return 3
    for name, v in result["checks"].items():
        log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except SystemExit:
        raise
    except BaseException:  # noqa: BLE001 - no result line on any failure
        traceback.print_exc()
        raise SystemExit(1)
