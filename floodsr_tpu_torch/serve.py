"""Resident HTTP serving daemon for ToHR inference (``floodsr serve``).

Port of the JAX package's ``serve.py``. The reference is a one-shot CLI —
runtime/serving concerns are explicitly out of its MVP scope (reference
``docs/dev/adr/0000-scope.md:15-17``) — but a GPU deployment wants a resident
process: the model weights load onto the device once, the hand-written
kernels are built and loaded once, the device DEM LRU persists across
requests, and ``ModelWorker.warmup()`` can run a scene of zeros per expected
scene geometry at boot so the first real request finds the kernels built and
the allocator's pools filled.

This daemon is the thinnest possible network front for that worker:

- stdlib ``ThreadingHTTPServer`` — connection threads only parse JSON and
  stage errors; all device work is serialized through one lock (one device
  runs one scene at a time; queued requests wait their turn).
- The request body for ``POST /v1/tohr`` is the machine-interface JSON
  payload the CLI already accepts via ``--machine-json`` (same keys, same
  validation posture: unknown keys are an error, never a silent drop).
  Model identity and the device are pinned at boot — per-request
  ``model_version`` / ``model_path`` / ``device`` is rejected so a fleet's
  routing layer, not a request body, decides which process serves which
  model on which device.
- Rasters travel by filesystem path, not request body — matching the
  pipeline contract everywhere else in the framework (scenes are tens to
  hundreds of MB; a shared filesystem or object-store mount is assumed).
  ``out`` is required on every request: a daemon writing files to a
  cwd-relative default would scatter outputs nobody asked for.

Security posture: binds loopback by default. Two opt-in hardening knobs cut
the footgun when a trusted boundary is not available:

- ``--auth-token TOKEN`` requires ``Authorization: Bearer TOKEN``
  (constant-time compare) on every endpoint except ``/v1/healthz`` (load
  balancers probe health without secrets); missing/invalid -> 401.
- ``--data-root DIR`` restricts every request-named filesystem path
  (inputs, DEM, buildings, outputs, fetch destinations) to that directory
  prefix after symlink resolution; outside paths -> 400.

Without them the daemon executes read/write on any path the request names —
deploy behind a trusted boundary (localhost callers, a sidecar, or an
authenticated reverse proxy), exactly like other file-path-oriented
inference daemons. Request bodies are capped at 16 MiB (paths, scalars and
optionally inline GeoJSON footprints; raster data never travels in the
body).

Endpoints::

    POST /v1/tohr      {"in": ..., "dem": ..., "out": ..., ...} -> diagnostics
    POST /v1/tohr_many {"jobs": [{...}, ...], <shared options>} -> [diag, ...]
    GET  /v1/healthz   {"status": "ok", "model_version": ..., ...}
    GET  /v1/doctor    runtime/device diagnostics (CLI `doctor` as JSON)
    GET  /v1/metrics   Prometheus text-format counters

Every request is a record of spans (:mod:`floodsr_tpu_torch.tracing`):
``service.request`` and a ``service.job`` per scene on the caller's thread,
the worker's spans on the device thread, a batch's DEM prefetch on its own.
Each scene's answer carries its view of the record as
``scene_timings["trace"]``. ``floodsr_device_busy_seconds`` sums the
requests' ``device_s``: the stream's wall time, timed by CUDA events, from
each scene's upload to the executor's return and over the finish's device
part and download. Gaps between launches and the host's waits inside the
executor count, so while the executor is bound by its launches this is
close to those stages' host time, not the device's busy time.

``/v1/tohr_many`` streams the batch under one lock acquisition with the
``run_many`` pipeline shape: scene N+1's DEM decodes and uploads in a
background thread while scene N computes — the HTTP analogue of
``floodsr tohr --in a.tif b.tif …``. A failed scene reports its error in
its own result entry (``"ok": false``) and the batch continues.
Backpressure: at most ``max_pending`` requests may wait on the device
lock and a batch carries at most ``max_jobs_per_batch`` scenes; beyond
either bound the daemon answers 503/400 immediately so callers retry
elsewhere instead of piling onto a device that is far behind.

Every handler thread takes the one device lock and hands the worker's call to
the service's single long-lived device thread. ``ThreadingHTTPServer`` starts a
new thread for every request, and PyTorch keeps cuDNN's execution plans in
thread-local caches: on handler threads every request would build the plans
of all the network's convolutions again, and what ``warmup`` had warmed would
belong to another thread. On one device thread the plans, the kernels' launch
counters and the process-wide precision flags see one thread, always the same.
"""

from __future__ import annotations

import contextvars
import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from floodsr_tpu_torch import tracing
from floodsr_tpu_torch.model_registry import resolve_model_worker_class

logger = logging.getLogger(__name__)

#: Per-request keys accepted by POST /v1/tohr (machine-interface names) and
#: the worker.run keyword each maps to. Kept aligned with cli._MACHINE_SCHEMA.
_REQUEST_KEYS: dict[str, str] = {
    "in": "depth_lr_fp",
    "in_fp": "depth_lr_fp",
    "dem": "dem_hr_fp",
    "out": "output_fp",
    "max_depth": "max_depth",
    "dem_pct_clip": "dem_pct_clip",
    "window_method": "window_method",
    "tile_overlap": "tile_overlap",
    "tile_size": "tile_size",
    "input_kind": "input_kind",
    "output_compress": "output_compress",
    "buildings": "buildings_fp",
    "fetch_hrdem": "fetch_hrdem",
    "fetch_out": "fetch_out",
    "fetch_buildings": "fetch_buildings",
}

#: Machine-json keys that configure model/cache identity or the device;
#: pinned at boot.
_BOOT_ONLY_KEYS = frozenset(
    {"model_version", "model_path", "manifest", "cache_dir", "backend", "force",
     "device"}
)


class RequestError(ValueError):
    """Client-side request problem -> HTTP 400."""


class AuthError(RuntimeError):
    """Missing or invalid bearer token -> HTTP 401."""


class BusyError(RuntimeError):
    """Device queue full -> HTTP 503 (caller should retry elsewhere/later)."""


def _json_safe(value):
    """Recursively convert a diagnostics dict to JSON-serializable types."""
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if isinstance(value, Path):
        return str(value)
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    if isinstance(value, np.ndarray):
        if value.size <= 16:
            return _json_safe(value.tolist())
        return {"shape": list(value.shape), "dtype": str(value.dtype)}
    if isinstance(value, np.generic):
        value = value.item()
    if isinstance(value, float) and not np.isfinite(value):
        # json.dumps would emit bare NaN/Infinity — invalid JSON that strict
        # clients reject; null is the faithful wire encoding.
        return None
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return str(value)


class TohrService:
    """One loaded model worker + the request->run translation.

    Owns the worker lifecycle (context-entered on ``start``), the device
    lock, and request counters. Independent of HTTP so tests (and other
    fronts) can drive it directly.
    """

    def __init__(
        self,
        *,
        model_version: str,
        model_fp: str | Path,
        engine_options: dict | None = None,
        run_defaults: dict | None = None,
        max_pending: int = 8,
        auth_token: str | None = None,
        data_root: str | Path | None = None,
        logger_: logging.Logger | None = None,
        device: str = "cuda",
    ):
        self.model_version = model_version
        self.device = device
        self.model_fp = Path(model_fp).expanduser().resolve()
        if not self.model_fp.exists():
            raise FileNotFoundError(f"model file does not exist: {self.model_fp}")
        self.auth_token = auth_token or None
        self.data_root = (
            Path(data_root).expanduser().resolve() if data_root is not None else None
        )
        if self.data_root is not None and not self.data_root.is_dir():
            raise NotADirectoryError(
                f"--data-root must be an existing directory: {self.data_root}"
            )
        self.log = logger_ or logger
        self._engine_options = dict(engine_options or {})
        self._run_defaults = {
            k: v for k, v in (run_defaults or {}).items() if v is not None
        }
        self.max_pending = int(max_pending)
        if self.max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self._worker = None
        self._device_lock = threading.Lock()
        # The one thread that calls the worker (see the module docstring);
        # made at the first call, ended by close().
        self._device_thread: ThreadPoolExecutor | None = None
        self._pending_lock = threading.Lock()
        self._pending = 0
        self._stats_lock = threading.Lock()  # counters bump from HTTP threads
        self._started = time.time()
        self._requests_done = 0
        self._requests_failed = 0
        self._scenes_done = 0
        self._device_busy_s = 0.0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        from floodsr_tpu_torch.tohr import filter_engine_options

        worker_class = resolve_model_worker_class(self.model_version)
        extra = filter_engine_options(worker_class, self._engine_options)
        self._worker = worker_class(
            model_fp=self.model_fp, logger=self.log, device=self.device, **extra
        ).__enter__()

    def warmup(self, hr_shapes: list[tuple[int, int]], **kw) -> int:
        assert self._worker is not None, "service not started"
        if not hasattr(self._worker, "warmup"):
            return 0
        with self._device_lock:
            return self._on_device_thread(self._worker.warmup, hr_shapes, **kw)

    def close(self) -> None:
        if self._worker is not None:
            self._worker.__exit__(None, None, None)
            self._worker = None
        with self._device_lock:
            if self._device_thread is not None:
                self._device_thread.shutdown(wait=True)
                self._device_thread = None

    def _on_device_thread(self, fn, *args, **kw):
        """Run ``fn`` on the service's device thread and return what it
        returns, or raise what it raises. The caller holds the device lock."""
        if self._device_thread is None:
            self._device_thread = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="floodsr-device"
            )
        # In a copy of the caller's context: the request open there (its
        # spans) continues on the device thread.
        return self._device_thread.submit(
            contextvars.copy_context().run, fn, *args, **kw
        ).result()

    # -- request handling ----------------------------------------------------

    def check_auth(self, authorization: str | None) -> None:
        """Constant-time bearer-token check (no-op when no token is set)."""
        if self.auth_token is None:
            return
        import hmac

        expected = f"Bearer {self.auth_token}"
        if authorization is None or not hmac.compare_digest(
            authorization.encode("utf-8", "replace"), expected.encode()
        ):
            raise AuthError("missing or invalid bearer token")

    #: Request keys whose values are filesystem paths, subject to --data-root.
    _PATH_RUN_KWARGS = ("depth_lr_fp", "dem_hr_fp", "output_fp", "buildings_fp")

    def _check_data_root(self, run_kwargs: dict, fetch_out) -> None:
        """Reject request-named paths outside the configured data root.

        Resolution follows symlinks (a link inside the root pointing outside
        it is rejected), so the prefix check is on real filesystem identity.
        ``buildings`` may carry inline GeoJSON text instead of a path — the
        same leading-brace rule :func:`features.footprints.load_footprints`
        uses decides which it is.
        """
        if self.data_root is None:
            return
        named = [(k, run_kwargs[k]) for k in self._PATH_RUN_KWARGS if k in run_kwargs]
        if fetch_out is not None:
            named.append(("fetch_out", fetch_out))
        for key, value in named:
            if key == "buildings_fp" and isinstance(value, str) and value.lstrip()[
                :1
            ] in ("{", "["):
                continue  # inline GeoJSON, not a path
            resolved = Path(str(value)).expanduser().resolve()
            if not resolved.is_relative_to(self.data_root):
                raise RequestError(
                    f"path for '{key}' is outside the served data root "
                    f"{self.data_root}: {resolved}"
                )

    @staticmethod
    def _unwrap(payload: dict, key: str) -> dict:
        if not isinstance(payload, dict):
            raise RequestError("request body must be a JSON object")
        if key in payload:
            # Nested form: siblings would silently bypass key validation
            # (including the boot-only-key rejection) if ignored.
            siblings = sorted(k for k in payload if k != key)
            if siblings:
                raise RequestError(
                    f"a nested '{key}' payload cannot carry sibling keys: "
                    + ", ".join(siblings)
                )
            payload = payload[key]
        if not isinstance(payload, dict):
            raise RequestError(f"'{key}' payload must be a JSON object")
        return payload

    def _translate_body(self, body: dict) -> tuple[dict, bool, bool, object]:
        """Machine-interface keys -> (run kwargs, fetch flags, fetch_out)."""
        run_kwargs: dict = {}
        fetch_hrdem = False
        fetch_buildings = False
        fetch_out = None
        for raw_key, value in body.items():
            key = str(raw_key).strip().lstrip("-").replace("-", "_")
            if key in _BOOT_ONLY_KEYS:
                raise RequestError(
                    f"key '{raw_key}' is fixed when the daemon starts; "
                    "run one `floodsr serve` process per model"
                )
            if key not in _REQUEST_KEYS:
                raise RequestError(f"unsupported tohr request key: {raw_key}")
            if key in ("fetch_hrdem", "fetch_buildings"):
                if not isinstance(value, bool):
                    raise RequestError(f"key '{raw_key}' must be boolean")
                if key == "fetch_hrdem":
                    fetch_hrdem = value
                else:
                    fetch_buildings = value
            elif key == "fetch_out":
                fetch_out = value
            elif value is not None:
                run_kwargs[_REQUEST_KEYS[key]] = value

        if "depth_lr_fp" not in run_kwargs:
            raise RequestError("request must name an input raster ('in')")
        if "output_fp" not in run_kwargs:
            raise RequestError(
                "request must name an output path ('out'); a serving daemon "
                "does not invent cwd-relative output locations"
            )
        if fetch_out is not None and not fetch_hrdem:
            raise RequestError("'fetch_out' requires 'fetch_hrdem'")
        if fetch_hrdem and "dem_hr_fp" in run_kwargs:
            raise RequestError("pass either 'dem' or 'fetch_hrdem', not both")
        if not fetch_hrdem and "dem_hr_fp" not in run_kwargs:
            raise RequestError("request must name a DEM ('dem' or 'fetch_hrdem')")
        if fetch_buildings and "buildings_fp" in run_kwargs:
            raise RequestError(
                "pass either 'buildings' or 'fetch_buildings', not both"
            )
        # Fill request-absent options from the daemon's configured defaults
        # (e.g. window_method from the user config file), so the same job
        # through the CLI and the daemon produces the same raster.
        for key, value in self._run_defaults.items():
            run_kwargs.setdefault(key, value)
        return run_kwargs, fetch_hrdem, fetch_buildings, fetch_out

    def _resolve_fetches(
        self, run_kwargs: dict, fetch_hrdem: bool, fetch_buildings: bool,
        fetch_out,
    ) -> dict:
        """Resolve fetch_* flags into real paths. Caller holds the device
        lock: the fetchers' session caches and scratch files are shared
        process state with no cross-thread coordination, and two concurrent
        requests for the same scene would race check-then-write on the same
        scratch raster. Fetch latency serializing with compute is the trade.
        """
        if fetch_hrdem:
            from floodsr_tpu_torch.dem_sources import fetch_dem

            run_kwargs["dem_hr_fp"] = fetch_dem(
                source_id="hrdem",
                depth_lr_fp=run_kwargs["depth_lr_fp"],
                output_fp=fetch_out,
                logger=self.log,
            ).dem_fp
        if fetch_buildings:
            from floodsr_tpu_torch.features.nrcan_buildings import (
                fetch_buildings_for_raster,
            )

            run_kwargs["buildings_fp"] = fetch_buildings_for_raster(
                raster_fp=run_kwargs["depth_lr_fp"], logger=self.log
            ).buildings_fp
        return run_kwargs

    def _acquire_slot(self):
        """Backpressure: admit at most max_pending requests to the device
        queue; answer 503 beyond that instead of stacking minutes of work."""
        with self._pending_lock:
            if self._pending >= self.max_pending:
                raise BusyError(
                    f"server busy: {self._pending} requests already queued "
                    f"(max_pending={self.max_pending})"
                )
            self._pending += 1

    def _release_slot(self):
        with self._pending_lock:
            self._pending -= 1

    def handle_tohr(self, payload: dict) -> dict:
        """Validate one machine-interface payload and run it on the worker."""
        with tracing.request() as trace, tracing.span("service.request"):
            body = self._unwrap(payload, "tohr")
            run_kwargs, f_dem, f_bld, f_out = self._translate_body(body)
            self._check_data_root(run_kwargs, f_out)
            assert self._worker is not None, "service not started"
            self._acquire_slot()
            try:
                with tracing.span("service.job") as job, self._device_lock:
                    run_kwargs = self._resolve_fetches(run_kwargs, f_dem, f_bld, f_out)
                    result = _json_safe(
                        self._on_device_thread(self._worker.run, **run_kwargs)
                    )
            finally:
                self._release_slot()
        device_s = self._attach_trace(result, trace, job)
        with self._stats_lock:
            self._device_busy_s += device_s
            self._requests_done += 1
            self._scenes_done += 1
        return result

    @staticmethod
    def _attach_trace(result: dict, trace, job) -> float:
        """Put the request's record, as ``job`` sees it, in the result's
        ``scene_timings["trace"]`` (a worker that keeps no ``scene_timings``
        gets none); returns its device seconds (``device_s``)."""
        timings = result.get("scene_timings") if isinstance(result, dict) else None
        if not isinstance(timings, dict):
            return 0.0
        timings["trace"] = record = trace.export(job)
        return float(record["counters"].get("device_s", 0.0))

    #: Scenes per /v1/tohr_many request. A batch occupies one pending slot
    #: for its whole runtime, so an unbounded batch would defeat the
    #: max_pending backpressure; larger workloads should split requests.
    max_jobs_per_batch = 64

    def handle_tohr_many(self, payload: dict) -> list[dict]:
        """Batch form: shared options at the top level, per-scene paths in
        ``jobs``. The whole batch runs under ONE lock acquisition with the
        next scene's DEM prefetching in a background thread while the
        current scene computes (the ``run_many`` pipeline). Each entry of
        the response carries ``"ok"``: a failed scene reports its error in
        place and the batch continues — earlier outputs on disk are valid.
        """
        with tracing.request() as trace, tracing.span("service.request"):
            results, job_spans = self._run_batch(payload)
        device_s = sum(
            self._attach_trace(result, trace, job)
            for result, job in zip(results, job_spans) if result["ok"]
        )
        with self._stats_lock:
            self._device_busy_s += device_s
            self._requests_done += 1
            self._scenes_done += sum(result["ok"] for result in results)
        return results

    def _run_batch(self, payload: dict) -> tuple[list[dict], list]:
        """:meth:`handle_tohr_many`'s validation and jobs, in its request:
        the results and each job's span."""
        body = self._unwrap(payload, "tohr_many")
        jobs_spec = body.get("jobs")
        if not isinstance(jobs_spec, list) or not jobs_spec:
            raise RequestError("'jobs' must be a non-empty array of objects")
        if len(jobs_spec) > self.max_jobs_per_batch:
            raise RequestError(
                f"too many jobs ({len(jobs_spec)} > {self.max_jobs_per_batch}); "
                "split the batch across requests"
            )
        shared_body = {k: v for k, v in body.items() if k != "jobs"}
        jobs: list[dict] = []
        fetches: list[tuple[bool, bool, object]] = []
        for i, job_body in enumerate(jobs_spec):
            if not isinstance(job_body, dict):
                raise RequestError(f"jobs[{i}] must be a JSON object")
            merged = {**shared_body, **job_body}
            run_kwargs, f_dem, f_bld, f_out = self._translate_body(merged)
            self._check_data_root(run_kwargs, f_out)
            if f_out is not None:
                # Same rule as the multi-input CLI: one named DEM file per
                # batch means every job's fetch would overwrite it.
                raise RequestError(
                    "'fetch_out' names a single DEM file and cannot be used "
                    "in a batch (each scene fetches its own DEM)"
                )
            jobs.append(run_kwargs)
            fetches.append((f_dem, f_bld, f_out))
        outs = {Path(j["output_fp"]).expanduser().resolve() for j in jobs}
        if len(outs) != len(jobs):
            raise RequestError("jobs write to colliding output paths")

        assert self._worker is not None, "service not started"
        can_prefetch = hasattr(self._worker, "prefetch_dem")
        # A prefetch works for the request, not for the job that starts it:
        # its thread's spans hang under service.request.
        request_context = contextvars.copy_context()
        results: list[dict] = []
        job_spans = []
        self._acquire_slot()
        try:
            with self._device_lock:
                for i, (job, (f_dem, f_bld, f_out)) in enumerate(
                    zip(jobs, fetches)
                ):
                    with tracing.span("service.job") as job_span:
                        try:
                            self._resolve_fetches(job, f_dem, f_bld, f_out)
                            # run_many's pipeline shape: next scene's DEM decodes
                            # and uploads in the background while this one runs
                            # (only for already-resolved local DEM paths).
                            if can_prefetch and i + 1 < len(jobs):
                                nxt = jobs[i + 1].get("dem_hr_fp")
                                if nxt is not None:
                                    request_context.run(self._worker.prefetch_dem, nxt)
                            result = _json_safe(
                                self._on_device_thread(self._worker.run, **job)
                            )
                            result["ok"] = True
                        except Exception as err:  # noqa: BLE001 — report per job
                            self.log.error(f"serve: batch job {i} failed: {err}")
                            self.log.debug("serve: job traceback", exc_info=True)
                            result = {
                                "ok": False,
                                "error": str(err),
                                "output_fp": str(job.get("output_fp")),
                            }
                    results.append(result)
                    job_spans.append(job_span)
        finally:
            self._release_slot()
        return results, job_spans

    def note_failure(self) -> None:
        with self._stats_lock:
            self._requests_failed += 1

    def health(self) -> dict:
        return {
            "status": "ok" if self._worker is not None else "starting",
            "model_version": self.model_version,
            "model_path": str(self.model_fp),
            "device": str(self.device),
            "uptime_s": round(time.time() - self._started, 3),
            "requests_done": self._requests_done,
            "requests_failed": self._requests_failed,
            "pending": self._pending,
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition of the serving counters
        (``floodsr_device_busy_seconds``: see the module docstring)."""
        lines = []
        for name, kind, value in (
            ("floodsr_requests_done", "counter", self._requests_done),
            ("floodsr_requests_failed", "counter", self._requests_failed),
            ("floodsr_scenes_done", "counter", self._scenes_done),
            ("floodsr_device_busy_seconds", "counter", self._device_busy_s),
            ("floodsr_pending_requests", "gauge", self._pending),
            ("floodsr_uptime_seconds", "gauge", time.time() - self._started),
        ):
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {value}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def doctor() -> dict:
        from floodsr_tpu_torch.engine import doctor_info

        return doctor_info()


class _Handler(BaseHTTPRequestHandler):
    # Set by make_server(); class attribute so the stdlib handler-per-request
    # instantiation can reach the shared service.
    service: TohrService

    protocol_version = "HTTP/1.1"
    # 16 MiB request-body ceiling: payloads are file paths + scalars, never
    # raster data; anything larger is a misdirected upload.
    max_body_bytes = 16 * 1024 * 1024

    def log_message(self, fmt, *args):  # route to our logger, not stderr
        self.service.log.debug("serve: " + fmt % args)

    def _reply_raw(self, status: int, content_type: str, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply(self, status: int, payload: dict) -> None:
        self._reply_raw(status, "application/json", json.dumps(payload).encode())

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler naming)
        if self.path in ("/v1/healthz", "/healthz"):
            # Health stays token-free: load balancers probe it without
            # secrets, and it exposes only coarse liveness counters.
            self._reply(200, self.service.health())
            return
        try:
            self.service.check_auth(self.headers.get("Authorization"))
        except AuthError as err:
            self.service.note_failure()
            self._reply(401, {"error": str(err)})
            return
        if self.path in ("/v1/doctor", "/doctor"):
            self._reply(200, self.service.doctor())
        elif self.path in ("/v1/metrics", "/metrics"):
            self._reply_raw(
                200, "text/plain; version=0.0.4",
                self.service.metrics_text().encode(),
            )
        else:
            self._reply(404, {"error": f"unknown path: {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        if self.path in ("/v1/tohr", "/tohr"):
            handle = self.service.handle_tohr
        elif self.path in ("/v1/tohr_many", "/tohr_many"):
            handle = self.service.handle_tohr_many
        else:
            self._reply(404, {"error": f"unknown path: {self.path}"})
            return
        try:
            try:
                self.service.check_auth(self.headers.get("Authorization"))
            except AuthError:
                # Reject BEFORE reading the body, and drop the connection:
                # an unauthenticated caller does not get to stream 16 MiB.
                self.close_connection = True
                raise
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                # Same keep-alive hazard as the unread-body paths below.
                self.close_connection = True
                raise RequestError("malformed Content-Length header") from None
            if length <= 0 or length > self.max_body_bytes:
                # Replying without reading the body would leave its bytes in
                # the socket and desync this HTTP/1.1 keep-alive connection
                # (they'd parse as the next request line) — drop it instead.
                self.close_connection = True
                raise RequestError(
                    "request must carry a JSON body"
                    if length <= 0
                    else "request body too large"
                )
            try:
                payload = json.loads(self.rfile.read(length))
            except json.JSONDecodeError as err:
                raise RequestError(f"invalid JSON body: {err}") from None
            started = time.perf_counter()
            result = handle(payload)
            runtime = round(time.perf_counter() - started, 4)
            if isinstance(result, dict):
                result["serve_runtime_s"] = runtime
                self._reply(200, result)
            else:  # tohr_many: list of per-job diagnostics
                self._reply(200, {"results": result, "serve_runtime_s": runtime})
        except RequestError as err:
            self.service.note_failure()
            self._reply(400, {"error": str(err)})
        except AuthError as err:
            self.service.note_failure()
            self._reply(401, {"error": str(err)})
        except BusyError as err:
            self.service.note_failure()
            self._reply(503, {"error": str(err)})
        except Exception as err:  # noqa: BLE001 — daemon must not die per-request
            self.service.note_failure()
            self.service.log.error(f"serve: request failed: {err}")
            self.service.log.debug("serve: request traceback", exc_info=True)
            self._reply(500, {"error": str(err)})


def make_server(
    service: TohrService, host: str = "127.0.0.1", port: int = 0
) -> ThreadingHTTPServer:
    """Bind (but do not run) the HTTP server; ``server.server_port`` is the
    resolved port when 0 was requested (tests bind ephemeral ports)."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def serve(
    *,
    model_version: str,
    model_fp: str | Path,
    host: str = "127.0.0.1",
    port: int = 8571,
    warmup_hr_shapes: list[tuple[int, int]] | None = None,
    engine_options: dict | None = None,
    run_defaults: dict | None = None,
    max_pending: int = 8,
    auth_token: str | None = None,
    data_root: str | Path | None = None,
    logger_: logging.Logger | None = None,
    device: str = "cuda",
) -> int:
    """Run the daemon until interrupted. Returns a process exit code."""
    log = logger_ or logger
    service = TohrService(
        model_version=model_version,
        model_fp=model_fp,
        engine_options=engine_options,
        run_defaults=run_defaults,
        max_pending=max_pending,
        auth_token=auth_token,
        data_root=data_root,
        logger_=log,
        device=device,
    )
    service.start()
    try:
        if warmup_hr_shapes:
            n = service.warmup(warmup_hr_shapes)
            log.info(f"serve: warmed {n} scene geometry(ies)")
        server = make_server(service, host=host, port=port)
        log.info(
            f"serve: {model_version} ({service.model_fp.name}) listening on "
            f"http://{host}:{server.server_port}"
        )
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            log.info("serve: interrupted, shutting down")
        finally:
            server.server_close()
        return 0
    finally:
        service.close()
