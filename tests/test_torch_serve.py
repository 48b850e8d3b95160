"""The port's ``serve`` daemon: request contract, lifecycle, concurrency.

The cases of ``tests/test_serve.py`` run against ``floodsr_tpu_torch.serve``
with ``device="cpu"`` (a live server on an ephemeral loopback port, the tiny
committed model), and for the same request the port's status codes and
response keys are held against the JAX package's daemon.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import floodsr_tpu.serve as serve_jax
from floodsr_tpu_torch.io import read_raster
from floodsr_tpu_torch.serve import TohrService, _json_safe, make_server
from floodsr_tpu_torch.tohr import tohr

pytestmark = pytest.mark.unit


@pytest.fixture(scope="module")
def live_server(tiny_model_fp, logger):
    service = TohrService(
        device="cpu",
        model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp, logger_=logger
    )
    service.start()
    server = make_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_port}", service
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        service.close()


def _post(base: str, payload: dict, headers: dict | None = None) -> tuple[int, dict]:
    req = urllib.request.Request(
        base + "/v1/tohr",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _get(base: str, path: str) -> tuple[int, dict]:
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


class TestEndpoints:
    def test_healthz_and_doctor(self, live_server):
        base, _ = live_server
        status, health = _get(base, "/v1/healthz")
        assert status == 200
        assert health["status"] == "ok"
        assert health["model_version"] == "ResUNet_16x_DEM"
        status, doc = _get(base, "/v1/doctor")
        assert status == 200
        assert doc["torch_installed"] is True
        assert doc["cuda_available"] in (True, False)
        assert health["device"] == "cpu"

    def test_unknown_path_404(self, live_server):
        base, _ = live_server
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base, "/v1/nope")
        assert err.value.code == 404

    def test_tohr_request_matches_library_output(
        self, live_server, tiny_model_fp, synthetic_tohr_tiles, tmp_path, logger
    ):
        base, _ = live_server
        served_fp = tmp_path / "served.tif"
        status, result = _post(base, {
            "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
            "dem": str(synthetic_tohr_tiles["dem_fp"]),
            "out": str(served_fp),
        })
        assert status == 200, result
        assert result["output_fp"] == str(served_fp)
        assert "serve_runtime_s" in result

        # Same job through the library entry point -> identical raster.
        lib_fp = tmp_path / "lib.tif"
        tohr(
            model_version="ResUNet_16x_DEM",
            model_fp=tiny_model_fp,
            depth_lr_fp=synthetic_tohr_tiles["depth_lr_fp"],
            dem_hr_fp=synthetic_tohr_tiles["dem_fp"],
            output_fp=lib_fp,
            logger=logger,
            device="cpu",
        )
        served, _, _ = read_raster(served_fp)
        expected, _, _ = read_raster(lib_fp)
        np.testing.assert_array_equal(served, expected)

    def test_output_compress_request_key(
        self, live_server, synthetic_tohr_tiles, tmp_path
    ):
        from floodsr_tpu_torch.io.geotiff import read_raster_header

        base, _ = live_server
        out_fp = tmp_path / "served_none.tif"
        status, result = _post(base, {
            "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
            "dem": str(synthetic_tohr_tiles["dem_fp"]),
            "out": str(out_fp),
            "output_compress": "none",
        })
        assert status == 200, result
        assert read_raster_header(out_fp).get("compress") is None

    def test_nested_tohr_payload_accepted(
        self, live_server, synthetic_tohr_tiles, tmp_path
    ):
        base, _ = live_server
        out_fp = tmp_path / "nested.tif"
        status, result = _post(base, {"tohr": {
            "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
            "dem": str(synthetic_tohr_tiles["dem_fp"]),
            "out": str(out_fp),
            "window_method": "hard",
        }})
        assert status == 200, result
        assert out_fp.exists()

    def test_concurrent_requests_serialized_and_both_served(
        self, live_server, synthetic_tohr_tiles, tmp_path
    ):
        base, service = live_server
        results = {}

        def job(name):
            results[name] = _post(base, {
                "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
                "dem": str(synthetic_tohr_tiles["dem_fp"]),
                "out": str(tmp_path / f"{name}.tif"),
            })

        threads = [threading.Thread(target=job, args=(n,)) for n in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert results["a"][0] == 200 and results["b"][0] == 200
        a, _, _ = read_raster(tmp_path / "a.tif")
        b, _, _ = read_raster(tmp_path / "b.tif")
        np.testing.assert_array_equal(a, b)


class TestBatchAndMetrics:
    def test_tohr_many_streams_batch(
        self, live_server, synthetic_tohr_tiles, tmp_path
    ):
        base, _ = live_server
        req = urllib.request.Request(
            base + "/v1/tohr_many",
            data=json.dumps({
                "window_method": "hard",
                "jobs": [
                    {"in": str(synthetic_tohr_tiles["depth_lr_fp"]),
                     "dem": str(synthetic_tohr_tiles["dem_fp"]),
                     "out": str(tmp_path / "m1.tif")},
                    {"in": str(synthetic_tohr_tiles["depth_lr_fp"]),
                     "dem": str(synthetic_tohr_tiles["dem_fp"]),
                     "out": str(tmp_path / "m2.tif"),
                     "window_method": "feather"},  # per-job override
                ],
            }).encode(),
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=600) as resp:
            body = json.loads(resp.read())
        assert len(body["results"]) == 2
        assert all(r["ok"] for r in body["results"])
        m1, _, _ = read_raster(tmp_path / "m1.tif")
        m2, _, _ = read_raster(tmp_path / "m2.tif")
        assert m1.shape == m2.shape
        assert body["results"][0]["preprocess"]["window_method"] == "hard"
        assert body["results"][1]["preprocess"]["window_method"] == "feather"

    def test_tohr_many_mid_batch_failure_reports_per_job(
        self, live_server, synthetic_tohr_tiles, tmp_path
    ):
        base, _ = live_server
        good = {"in": str(synthetic_tohr_tiles["depth_lr_fp"]),
                "dem": str(synthetic_tohr_tiles["dem_fp"])}
        status, body = _post_path(base, "/v1/tohr_many", {"jobs": [
            {**good, "out": str(tmp_path / "ok1.tif")},
            {"in": str(tmp_path / "missing.tif"), "dem": good["dem"],
             "out": str(tmp_path / "bad.tif")},
            {**good, "out": str(tmp_path / "ok2.tif")},
        ]})
        assert status == 200
        oks = [r["ok"] for r in body["results"]]
        assert oks == [True, False, True]
        assert "error" in body["results"][1]
        # The scenes around the failure completed and are valid rasters.
        a, _, _ = read_raster(tmp_path / "ok1.tif")
        b, _, _ = read_raster(tmp_path / "ok2.tif")
        np.testing.assert_array_equal(a, b)
        assert not (tmp_path / "bad.tif").exists()

    def test_tohr_many_validation(self, live_server, tmp_path):
        base, _ = live_server
        toobig = [{"in": "a", "dem": "b", "out": str(tmp_path / f"{i}.tif")}
                  for i in range(65)]
        for bad, needle in (
            ({"jobs": []}, "non-empty"),
            ({"jobs": [{"in": "a", "dem": "b", "out": str(tmp_path / "x.tif")},
                       {"in": "c", "dem": "d", "out": str(tmp_path / "x.tif")}]},
             "colliding"),
            ({"jobs": ["nope"]}, "jobs[0]"),
            ({"jobs": toobig}, "too many jobs"),
            ({"fetch_hrdem": True, "fetch_out": "/tmp/one_dem.tif",
              "jobs": [{"in": "a", "out": str(tmp_path / "y.tif")}]},
             "fetch_out"),
        ):
            status, body = _post_path(base, "/v1/tohr_many", bad)
            assert status == 400, (bad, body)
            assert needle in body["error"]

    def test_metrics_endpoint(self, live_server):
        base, service = live_server
        with urllib.request.urlopen(base + "/v1/metrics", timeout=60) as resp:
            assert resp.status == 200
            text = resp.read().decode()
        assert "# TYPE floodsr_requests_done counter" in text
        assert "floodsr_device_busy_seconds" in text
        assert "floodsr_pending_requests" in text

    def test_busy_503(self, tiny_model_fp, logger):
        from floodsr_tpu_torch.serve import BusyError, TohrService

        service = TohrService(
            device="cpu",
            model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp,
            max_pending=1, logger_=logger,
        )
        blocker = threading.Event()

        class SlowWorker:
            def run(self, **kw):
                blocker.wait(timeout=60)
                return {"output_fp": kw["output_fp"]}

        service._worker = SlowWorker()
        job = {"in": "a.tif", "dem": "b.tif", "out": "c.tif"}
        first = threading.Thread(target=service.handle_tohr, args=(dict(job),))
        first.start()
        try:
            deadline = time.time() + 10
            while service._pending < 1 and time.time() < deadline:
                time.sleep(0.01)
            with pytest.raises(BusyError):
                service.handle_tohr(dict(job))
        finally:
            blocker.set()
            first.join(timeout=60)
        assert service._pending == 0
        # Slot released: a new request is admitted again.
        service.handle_tohr(dict(job))


def _post_path(base: str, path: str, payload: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(), method="POST"
    )
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


class TestJsonSafe:
    def test_non_finite_floats_become_null(self):
        # json.dumps would emit bare NaN/Infinity (invalid JSON) otherwise.
        from floodsr_tpu_torch.serve import _json_safe

        out = _json_safe({
            "nan": float("nan"),
            "inf": np.float32("inf"),
            "arr": np.array([1.0, float("-inf")]),
            "path": __import__("pathlib").Path("/x"),
        })
        assert out["nan"] is None and out["inf"] is None
        assert out["arr"] == [1.0, None]
        json.dumps(out, allow_nan=False)  # strict-JSON round trip

    def test_torch_values_become_strings_or_numbers(self):
        import torch

        out = _json_safe({
            "device": torch.device("cpu"),
            "dtype": torch.float32,
            "scalar": torch.tensor(2.5),
            "small": torch.tensor([1.0, float("nan")]),
            "big": torch.zeros(5, 5),
        })
        assert out["device"] == "cpu" and out["dtype"] == "torch.float32"
        assert out["scalar"] == 2.5 and out["small"] == [1.0, None]
        assert out["big"] == {"shape": [5, 5], "dtype": "float32"}
        json.dumps(out, allow_nan=False)


class TestRequestValidation:
    def test_unknown_key_400(self, live_server):
        base, _ = live_server
        status, body = _post(base, {"in": "x.tif", "dem": "y.tif",
                                    "out": "z.tif", "bogus": 1})
        assert status == 400
        assert "bogus" in body["error"]

    def test_boot_only_key_400(self, live_server):
        base, _ = live_server
        status, body = _post(base, {"in": "x.tif", "dem": "y.tif",
                                    "out": "z.tif", "model_version": "other"})
        assert status == 400
        assert "fixed when the daemon starts" in body["error"]

    def test_device_is_boot_only_400(self, live_server):
        base, _ = live_server
        status, body = _post(base, {"in": "x.tif", "dem": "y.tif",
                                    "out": "z.tif", "device": "cpu"})
        assert status == 400
        assert "fixed when the daemon starts" in body["error"]
        status, body = _post_path(base, "/v1/tohr_many", {
            "device": "cuda",
            "jobs": [{"in": "x.tif", "dem": "y.tif", "out": "z.tif"}],
        })
        assert status == 400
        assert "fixed when the daemon starts" in body["error"]

    def test_missing_out_400(self, live_server, synthetic_tohr_tiles):
        base, _ = live_server
        status, body = _post(base, {
            "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
            "dem": str(synthetic_tohr_tiles["dem_fp"]),
        })
        assert status == 400
        assert "'out'" in body["error"]

    def test_missing_dem_400(self, live_server, synthetic_tohr_tiles):
        base, _ = live_server
        status, body = _post(base, {
            "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
            "out": "z.tif",
        })
        assert status == 400
        assert "dem" in body["error"].lower()

    def test_nested_payload_sibling_keys_400(self, live_server):
        # Siblings of a nested 'tohr' object would bypass key validation
        # (including boot-only rejection) if silently dropped.
        base, _ = live_server
        status, body = _post(base, {
            "tohr": {"in": "x.tif", "dem": "y.tif", "out": "z.tif"},
            "model_version": "other",
        })
        assert status == 400
        assert "sibling" in body["error"]

    def test_run_defaults_fill_absent_options(self, tiny_model_fp, logger):
        # A daemon configured with window_method='hard' must apply it to
        # requests that don't name one (CLI/daemon output parity).
        from floodsr_tpu_torch.serve import RequestError, TohrService

        service = TohrService(
            device="cpu",
            model_version="ResUNet_16x_DEM",
            model_fp=tiny_model_fp,
            run_defaults={"window_method": "hard"},
            logger_=logger,
        )
        captured = {}

        class FakeWorker:
            def run(self, **kw):
                captured.update(kw)
                return {"output_fp": kw["output_fp"]}

        service._worker = FakeWorker()
        service.handle_tohr({"in": "a.tif", "dem": "b.tif", "out": "c.tif"})
        assert captured["window_method"] == "hard"
        service.handle_tohr({"in": "a.tif", "dem": "b.tif", "out": "c.tif",
                             "window_method": "feather"})
        assert captured["window_method"] == "feather"  # request wins
        with pytest.raises(RequestError):
            service.handle_tohr({"in": "a.tif", "out": "c.tif"})

    def test_invalid_json_400(self, live_server):
        base, _ = live_server
        req = urllib.request.Request(
            base + "/v1/tohr", data=b"{not json", method="POST"
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400

    def test_malformed_content_length_400_closes_connection(self, live_server):
        import http.client
        from urllib.parse import urlparse

        base, _ = live_server
        parsed = urlparse(base)
        conn = http.client.HTTPConnection(parsed.hostname, parsed.port, timeout=60)
        try:
            conn.putrequest("POST", "/v1/tohr")
            conn.putheader("Content-Length", "abc")
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == 400
            body = json.loads(resp.read())
            assert "Content-Length" in body["error"]
            # The server must drop the connection (unread body bytes would
            # desync keep-alive): a follow-up request on the same socket
            # cannot get a response.
            with pytest.raises((http.client.HTTPException, OSError)):
                conn.putrequest("GET", "/v1/healthz")
                conn.endheaders()
                conn.getresponse().read()
        finally:
            conn.close()

    def test_runtime_failure_500_daemon_survives(self, live_server, tmp_path):
        base, service = live_server
        status, body = _post(base, {
            "in": str(tmp_path / "missing.tif"),
            "dem": str(tmp_path / "missing_dem.tif"),
            "out": str(tmp_path / "o.tif"),
        })
        assert status == 500
        assert "error" in body
        # Daemon still healthy after the failure.
        status, health = _get(base, "/v1/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["requests_failed"] >= 1


class TestOtherWorkers:
    def test_serve_costgrow_pcraster(self, tmp_path, logger):
        """The daemon fronts ANY registered worker, not just ResUNet.

        CostGrow workers have no ``warmup``; the service must boot, report
        the pinned identity, and serve a job through the same contract.
        """
        from floodsr_tpu_torch.io import from_origin, write_raster

        nodata = -9999.0
        dem = np.full((64, 64), 100.0, np.float32)
        wse = np.full((8, 8), nodata, np.float32)
        wse[3:5, 2:6] = 102.5
        base_profile = {
            "count": 1, "dtype": "float32", "crs": "EPSG:32633",
            "nodata": nodata, "compress": "LZW",
        }
        wse_fp = tmp_path / "wse.tif"
        dem_fp = tmp_path / "dem.tif"
        write_raster(wse_fp, wse, dict(base_profile, height=8, width=8,
                     transform=from_origin(0, 512, 64.0, 64.0)))
        write_raster(dem_fp, dem, dict(base_profile, height=64, width=64,
                     transform=from_origin(0, 512, 8.0, 8.0)))
        params_fp = tmp_path / "p.json"
        params_fp.write_text(json.dumps({"dp_coarse_pixel_max": 2}))

        service = TohrService(
            device="cpu",
            model_version="CostGrow_pcraster", model_fp=params_fp, logger_=logger
        )
        service.start()
        server = make_server(service, host="127.0.0.1", port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_port}"
        try:
            assert service.warmup([(512, 512)]) == 0  # no-op for CostGrow
            status, health = _get(base, "/v1/healthz")
            assert status == 200
            assert health["model_version"] == "CostGrow_pcraster"
            out_fp = tmp_path / "grown.tif"
            status, resp = _post(base, {
                "in_fp": str(wse_fp), "dem": str(dem_fp), "out": str(out_fp),
            })
            assert status == 200, resp
            assert resp["preprocess"]["variant"] == "pcraster"
            arr, out_nodata, _ = read_raster(out_fp)
            assert (~np.isclose(arr, out_nodata)).sum() > 0
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
            service.close()


class TestCliPlumbing:
    def test_parse_serve_args(self):
        from floodsr_tpu_torch.cli import _parse_arguments

        args = _parse_arguments(
            ["serve", "--port", "9000", "--model-path", "m.fsrz",
             "--warmup", "3840x3840", "--warmup", "512x512"]
        )
        assert args.command == "serve"
        assert args.port == 9000
        assert args.warmup == ["3840x3840", "512x512"]

    def test_bad_warmup_spec_errors(self, tiny_model_fp):
        from floodsr_tpu_torch.cli import main

        code = main([
            "serve", "--model-path", str(tiny_model_fp), "--warmup", "nope"
        ])
        assert code == 1  # CLI catch-all -> exit 1


class TestHardening:
    """Opt-in auth token + data-root path allowlist (serve hardening)."""

    TOKEN = "test-secret-token"

    @pytest.fixture(scope="class")
    def hardened_server(self, tiny_model_fp, logger, tmp_path_factory):
        # Both the synthetic-tile fixtures and per-test tmp_path live under
        # pytest's base temp, so it doubles as the served data root.
        data_root = tmp_path_factory.getbasetemp()
        service = TohrService(
            device="cpu",
            model_version="ResUNet_16x_DEM",
            model_fp=tiny_model_fp,
            auth_token=self.TOKEN,
            data_root=data_root,
            logger_=logger,
        )
        service.start()
        server = make_server(service, host="127.0.0.1", port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            yield f"http://127.0.0.1:{server.server_port}", service
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
            service.close()

    def _auth(self):
        return {"Authorization": f"Bearer {self.TOKEN}"}

    def test_post_without_token_rejected_401(
        self, hardened_server, synthetic_tohr_tiles, tmp_path
    ):
        base, _ = hardened_server
        payload = {
            "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
            "dem": str(synthetic_tohr_tiles["dem_fp"]),
            "out": str(tmp_path / "noauth.tif"),
        }
        status, body = _post(base, payload)
        assert status == 401
        assert "bearer token" in body["error"]
        status, body = _post(base, payload, headers={
            "Authorization": "Bearer wrong-token"})
        assert status == 401

    def test_get_doctor_requires_token_healthz_does_not(self, hardened_server):
        base, _ = hardened_server
        status, health = _get(base, "/v1/healthz")  # LB probe: token-free
        assert status == 200 and health["status"] == "ok"
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base, "/v1/doctor")
        assert err.value.code == 401
        req = urllib.request.Request(
            base + "/v1/doctor", headers=self._auth())
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200

    def test_path_outside_data_root_rejected(
        self, hardened_server, synthetic_tohr_tiles
    ):
        base, _ = hardened_server
        status, body = _post(base, {
            "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
            "dem": str(synthetic_tohr_tiles["dem_fp"]),
            "out": "/outside-the-data-root/out.tif",
        }, headers=self._auth())
        assert status == 400
        assert "data root" in body["error"] and "out" in body["error"]
        # Symlink escape: a link inside the root pointing outside is caught
        # by symlink resolution, not just a string-prefix check.
        status, body = _post(base, {
            "in": "/etc/hostname",
            "dem": str(synthetic_tohr_tiles["dem_fp"]),
            "out": str(synthetic_tohr_tiles["dem_fp"].parent / "x.tif"),
        }, headers=self._auth())
        assert status == 400
        assert "depth_lr_fp" in body["error"]

    def test_valid_token_and_inside_paths_served(
        self, hardened_server, synthetic_tohr_tiles, tmp_path
    ):
        base, _ = hardened_server
        out_fp = tmp_path / "hardened-ok.tif"
        status, result = _post(base, {
            "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
            "dem": str(synthetic_tohr_tiles["dem_fp"]),
            "out": str(out_fp),
        }, headers=self._auth())
        assert status == 200, result
        assert out_fp.exists()

    def test_data_root_must_exist(self, tiny_model_fp, logger):
        with pytest.raises(NotADirectoryError):
            TohrService(
                device="cpu",
                model_version="ResUNet_16x_DEM",
                model_fp=tiny_model_fp,
                data_root="/nonexistent/data/root",
                logger_=logger,
            )


class TestDeviceThread:
    def test_every_worker_call_runs_on_the_one_device_thread(self, tiny_model_fp, logger):
        """Handler threads come and go; the worker sees one thread (PyTorch
        keeps cuDNN's plans per thread), and its errors reach the caller."""
        service = TohrService(
            device="cpu", model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp,
            logger_=logger,
        )
        seen = []

        class FakeWorker:
            def run(self, **kw):
                seen.append(threading.current_thread())
                if kw["depth_lr_fp"] == "bad.tif":
                    raise FileNotFoundError("no such raster")
                return {"output_fp": kw["output_fp"]}

            def warmup(self, hr_shapes, **kw):
                seen.append(threading.current_thread())
                return len(hr_shapes)

        service._worker = FakeWorker()
        job = {"in": "a.tif", "dem": "b.tif", "out": "c.tif"}
        callers = [
            threading.Thread(target=service.handle_tohr, args=(dict(job),)) for _ in range(3)
        ]
        for t in callers:
            t.start()
        for t in callers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in callers)
        assert service.warmup([(64, 64), (128, 128)]) == 2
        batch = service.handle_tohr_many({"jobs": [
            {**job, "out": "d.tif"}, {**job, "in": "bad.tif", "out": "e.tif"},
        ]})
        assert [r["ok"] for r in batch] == [True, False]
        with pytest.raises(FileNotFoundError, match="no such raster"):
            service.handle_tohr({**job, "in": "bad.tif"})
        assert len(seen) == 7 and len(set(seen)) == 1
        assert seen[0].name.startswith("floodsr-device")
        assert seen[0] not in callers and seen[0] is not threading.current_thread()
        service._worker = None
        service.close()
        assert not seen[0].is_alive()


class TestWarmup:
    def test_service_warmup_counts_distinct_geometries(self, live_server):
        _, service = live_server
        # The tiny model's HR tile is 64: 60x60 and 64x64 pad to one scene.
        assert service.warmup([(64, 64), (60, 60), (128, 64)]) == 2


@pytest.fixture(scope="module")
def jax_server(tiny_model_fp, logger):
    service = serve_jax.TohrService(
        model_version="ResUNet_16x_DEM", model_fp=tiny_model_fp, logger_=logger
    )
    service.start()
    server = serve_jax.make_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_port}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        service.close()


class TestSameContractAsTheJaxDaemon:
    """One request to both daemons: same status, same response keys."""

    @pytest.mark.parametrize("case", [
        "ok", "unknown_key", "boot_only", "missing_out", "missing_dem",
        "missing_input_file",
    ])
    def test_tohr_status_and_keys(
        self, case, live_server, jax_server, synthetic_tohr_tiles, tmp_path
    ):
        good = {"in": str(synthetic_tohr_tiles["depth_lr_fp"]),
                "dem": str(synthetic_tohr_tiles["dem_fp"])}
        payload = {
            "ok": {**good, "window_method": "hard"},
            "unknown_key": {**good, "bogus": 1},
            "boot_only": {**good, "model_version": "other"},
            "missing_out": dict(good),
            "missing_dem": {"in": good["in"]},
            "missing_input_file": {**good, "in": str(tmp_path / "missing.tif")},
        }[case]
        answers = {}
        for name, base in (("torch", live_server[0]), ("jax", jax_server)):
            body = dict(payload)
            if case != "missing_out":
                body["out"] = str(tmp_path / f"{name}.tif")
            answers[name] = _post(base, body)
        (status_t, body_t), (status_j, body_j) = answers["torch"], answers["jax"]
        assert status_t == status_j
        assert set(body_t) == set(body_j)
        if case == "ok":
            assert status_t == 200
            assert set(body_t["preprocess"]) == set(body_j["preprocess"])
            assert set(body_t["preprocess"]["input_shape"]) == set(
                body_j["preprocess"]["input_shape"]
            )
            got, _, _ = read_raster(tmp_path / "torch.tif")
            want, _, _ = read_raster(tmp_path / "jax.tif")
            # The bar of tests/test_torch_scene_tohr.py: 1e-4 m RMSE.
            assert float(np.sqrt(np.mean((got - want) ** 2))) <= 1e-4
        else:
            assert status_t in (400, 500)

    def test_tohr_many_and_get_endpoints(
        self, live_server, jax_server, synthetic_tohr_tiles, tmp_path
    ):
        good = {"in": str(synthetic_tohr_tiles["depth_lr_fp"]),
                "dem": str(synthetic_tohr_tiles["dem_fp"])}
        answers = {}
        for name, base in (("torch", live_server[0]), ("jax", jax_server)):
            answers[name] = _post_path(base, "/v1/tohr_many", {"jobs": [
                {**good, "out": str(tmp_path / f"{name}_1.tif")},
                {"in": str(tmp_path / "missing.tif"), "dem": good["dem"],
                 "out": str(tmp_path / f"{name}_bad.tif")},
            ]})
        (status_t, body_t), (status_j, body_j) = answers["torch"], answers["jax"]
        assert status_t == status_j == 200
        assert set(body_t) == set(body_j)
        for res_t, res_j in zip(body_t["results"], body_j["results"]):
            assert res_t["ok"] == res_j["ok"]
            assert set(res_t) == set(res_j)
        # healthz: the port adds the device it was started on, nothing else.
        _, health_t = _get(live_server[0], "/v1/healthz")
        _, health_j = _get(jax_server, "/v1/healthz")
        assert set(health_t) - set(health_j) == {"device"}
        assert set(health_j) <= set(health_t)
        with urllib.request.urlopen(live_server[0] + "/v1/metrics", timeout=60) as resp:
            names_t = {ln.split()[0] for ln in resp.read().decode().splitlines() if ln[:1] != "#"}
        with urllib.request.urlopen(jax_server + "/v1/metrics", timeout=60) as resp:
            names_j = {ln.split()[0] for ln in resp.read().decode().splitlines() if ln[:1] != "#"}
        assert names_t == names_j
