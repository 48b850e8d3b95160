"""The port's CLI: models, tohr arg semantics, doctor, cache, machine-json.

The cases of ``tests/test_cli.py`` that do not concern the mesh, run against
``python -m floodsr_tpu_torch.cli``'s ``main`` with ``--device cpu``; for the
same argv the port's exit code is held against the JAX package's CLI.
"""

import json
import hashlib
from pathlib import Path

import numpy as np
import pytest

from floodsr_tpu.cli import main as main_jax
from floodsr_tpu_torch import cli as cli_torch
from floodsr_tpu_torch.cli import _resolve_default_output_path
from floodsr_tpu_torch.io import read_raster

pytestmark = pytest.mark.e2e


def main(argv: list[str]) -> int:
    """The port's CLI; ``tohr`` runs on the CPU here (there is no card)."""
    if argv[:1] == ["tohr"]:
        argv = [*argv, "--device", "cpu"]
    return cli_torch.main(argv)


def _manifest_for_model(tmp_path: Path, model_fp: Path, version="ResUNet_16x_DEM") -> Path:
    sha = hashlib.sha256(model_fp.read_bytes()).hexdigest()
    manifest = {
        "models": {
            version: {
                "file_name": model_fp.name,
                "url": model_fp.as_uri(),
                "sha256": sha,
                "description": "test artifact",
            }
        }
    }
    fp = tmp_path / "models.json"
    fp.write_text(json.dumps(manifest), encoding="utf-8")
    return fp


class TestModelsCommands:
    def test_models_list(self, models_manifest_fp, capsys):
        assert main(["models", "list", "--manifest", str(models_manifest_fp)]) == 0
        out = capsys.readouterr().out
        assert "v-cli" in out and "model.fsrz" in out

    def test_models_fetch_and_cache_hit(self, models_manifest_fp, tmp_path, capsys):
        cache_dir = tmp_path / "cache"
        args = [
            "models", "fetch", "v-cli",
            "--manifest", str(models_manifest_fp),
            "--cache-dir", str(cache_dir),
        ]
        assert main(args) == 0
        printed = capsys.readouterr().out.strip()
        fetched = Path(printed)
        assert fetched.exists()
        assert fetched.parent.name == "v-cli"
        mtime = fetched.stat().st_mtime_ns
        assert main(args) == 0  # cache hit: no re-download
        assert Path(capsys.readouterr().out.strip()).stat().st_mtime_ns == mtime

    def test_models_fetch_unknown_version_fails(self, models_manifest_fp, tmp_path):
        assert (
            main(
                [
                    "models", "fetch", "nope",
                    "--manifest", str(models_manifest_fp),
                    "--cache-dir", str(tmp_path / "c"),
                ]
            )
            == 1
        )

    def test_checksum_mismatch_fails(self, tmp_path):
        blob = tmp_path / "m.fsrz"
        blob.write_bytes(b"model-bytes")
        manifest = {
            "models": {
                "v-bad": {
                    "file_name": "m.fsrz",
                    "url": blob.as_uri(),
                    "sha256": "0" * 64,
                    "description": "corrupt",
                }
            }
        }
        manifest_fp = tmp_path / "models.json"
        manifest_fp.write_text(json.dumps(manifest))
        assert (
            main(
                [
                    "models", "fetch", "v-bad",
                    "--manifest", str(manifest_fp),
                    "--cache-dir", str(tmp_path / "c"),
                ]
            )
            == 1
        )
        # No partial files left behind.
        leftovers = list((tmp_path / "c").rglob("*.part"))
        assert leftovers == []


class TestTohrCli:
    def test_tohr_with_model_path(self, tiny_model_fp, synthetic_tohr_tiles, tmp_path, capsys):
        out_fp = tmp_path / "cli_pred.tif"
        code = main(
            [
                "tohr",
                "--in", str(synthetic_tohr_tiles["depth_lr_fp"]),
                "--dem", str(synthetic_tohr_tiles["dem_fp"]),
                "--out", str(out_fp),
                "--model-path", str(tiny_model_fp),
                "--tile-overlap", "1",
            ]
        )
        assert code == 0
        assert capsys.readouterr().out.strip() == str(out_fp)
        pred, _, _ = read_raster(out_fp)
        assert pred.shape == synthetic_tohr_tiles["hr_shape"]

    def test_tohr_multi_input_streams_to_directory(
        self, tiny_model_fp, synthetic_tohr_tiles, tmp_path, capsys
    ):
        """Several --in rasters stream through one loaded model; --out is a
        directory and per-scene outputs use the default naming inside it."""
        import shutil

        lr2 = tmp_path / "scene2.tif"
        shutil.copy2(synthetic_tohr_tiles["depth_lr_fp"], lr2)
        out_dir = tmp_path / "preds"
        code = main(
            [
                "tohr",
                "--in", str(synthetic_tohr_tiles["depth_lr_fp"]), str(lr2),
                "--dem", str(synthetic_tohr_tiles["dem_fp"]),
                "--out", str(out_dir),
                "--model-path", str(tiny_model_fp),
                "--tile-overlap", "1",
            ]
        )
        assert code == 0
        printed = capsys.readouterr().out.strip().splitlines()
        assert len(printed) == 2
        outs = sorted(out_dir.glob("*.tif"))
        assert [str(p) for p in sorted(map(Path, printed))] == [str(p) for p in outs]
        a, _, _ = read_raster(outs[0])
        b, _, _ = read_raster(outs[1])
        np.testing.assert_array_equal(a, b)  # identical inputs → identical scenes

    def test_tohr_multi_input_rejects_file_out(
        self, tiny_model_fp, synthetic_tohr_tiles, tmp_path
    ):
        code = main(
            [
                "tohr",
                "--in",
                str(synthetic_tohr_tiles["depth_lr_fp"]),
                str(synthetic_tohr_tiles["depth_lr_fp"]),
                "--dem", str(synthetic_tohr_tiles["dem_fp"]),
                "--out", str(tmp_path / "single_file.tif"),
                "--model-path", str(tiny_model_fp),
            ]
        )
        assert code == 1

    def test_tohr_multi_input_rejects_output_collision(
        self, tiny_model_fp, synthetic_tohr_tiles, tmp_path
    ):
        """Same basename from two directories must not silently overwrite."""
        import shutil

        other_dir = tmp_path / "other"
        other_dir.mkdir()
        lr_name = Path(synthetic_tohr_tiles["depth_lr_fp"]).name
        twin = other_dir / lr_name
        shutil.copy2(synthetic_tohr_tiles["depth_lr_fp"], twin)
        code = main(
            [
                "tohr",
                "--in", str(synthetic_tohr_tiles["depth_lr_fp"]), str(twin),
                "--dem", str(synthetic_tohr_tiles["dem_fp"]),
                "--out", str(tmp_path / "preds"),
                "--model-path", str(tiny_model_fp),
            ]
        )
        assert code == 1

    def test_tohr_machine_json(self, tiny_model_fp, synthetic_tohr_tiles, tmp_path, capsys):
        out_fp = tmp_path / "mj_pred.tif"
        payload = {
            "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
            "dem": str(synthetic_tohr_tiles["dem_fp"]),
            "out": str(out_fp),
            "model_path": str(tiny_model_fp),
            "window_method": "hard",
        }
        mj = tmp_path / "machine.json"
        mj.write_text(json.dumps(payload))
        assert main(["tohr", "--machine-json", str(mj)]) == 0
        assert out_fp.exists()

    def test_tohr_machine_json_output_compress(
        self, tiny_model_fp, synthetic_tohr_tiles, tmp_path
    ):
        from floodsr_tpu_torch.io.geotiff import read_raster_header

        out_fp = tmp_path / "mj_none.tif"
        payload = {
            "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
            "dem": str(synthetic_tohr_tiles["dem_fp"]),
            "out": str(out_fp),
            "model_path": str(tiny_model_fp),
            "output_compress": "none",
        }
        mj = tmp_path / "machine.json"
        mj.write_text(json.dumps(payload))
        assert main(["tohr", "--machine-json", str(mj)]) == 0
        assert read_raster_header(out_fp).get("compress") is None

    def test_machine_json_cli_precedence(self, tiny_model_fp, synthetic_tohr_tiles, tmp_path):
        cli_out = tmp_path / "cli_wins.tif"
        json_out = tmp_path / "json_loses.tif"
        payload = {
            "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
            "dem": str(synthetic_tohr_tiles["dem_fp"]),
            "out": str(json_out),
            "model_path": str(tiny_model_fp),
        }
        mj = tmp_path / "machine.json"
        mj.write_text(json.dumps(payload))
        assert main(["tohr", "--machine-json", str(mj), "--out", str(cli_out)]) == 0
        assert cli_out.exists()
        assert not json_out.exists()

    def test_machine_json_nested_tohr_payload(self, tiny_model_fp, synthetic_tohr_tiles, tmp_path):
        out_fp = tmp_path / "nested.tif"
        payload = {
            "tohr": {
                "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
                "dem": str(synthetic_tohr_tiles["dem_fp"]),
                "out": str(out_fp),
                "model_path": str(tiny_model_fp),
            }
        }
        mj = tmp_path / "machine.json"
        mj.write_text(json.dumps(payload))
        assert main(["tohr", "--machine-json", str(mj)]) == 0
        assert out_fp.exists()

    def test_machine_json_unknown_key_fails(self, synthetic_tohr_tiles, tmp_path):
        payload = {
            "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
            "dem": str(synthetic_tohr_tiles["dem_fp"]),
            "bogus_key": 1,
        }
        mj = tmp_path / "machine.json"
        mj.write_text(json.dumps(payload))
        # Injection happens during argument parsing (before the CLI's
        # exception boundary), so the validation error propagates.
        with pytest.raises(ValueError, match="bogus_key"):
            main(["tohr", "--machine-json", str(mj)])

    def test_fetch_out_requires_fetch_hrdem(self, tiny_model_fp, synthetic_tohr_tiles, tmp_path):
        code = main(
            [
                "tohr",
                "--in", str(synthetic_tohr_tiles["depth_lr_fp"]),
                "--dem", str(synthetic_tohr_tiles["dem_fp"]),
                "--fetch-out", str(tmp_path / "d.tif"),
                "--model-path", str(tiny_model_fp),
            ]
        )
        assert code == 1

    def test_dem_and_fetch_mutually_exclusive(self, synthetic_tohr_tiles):
        with pytest.raises(SystemExit):
            main(
                [
                    "tohr",
                    "--in", str(synthetic_tohr_tiles["depth_lr_fp"]),
                    "--dem", str(synthetic_tohr_tiles["dem_fp"]),
                    "-f",
                ]
            )

    def test_model_version_resolution_via_manifest(
        self, tiny_model_fp, synthetic_tohr_tiles, tmp_path, capsys
    ):
        manifest_fp = _manifest_for_model(tmp_path, tiny_model_fp)
        out_fp = tmp_path / "mv.tif"
        code = main(
            [
                "tohr",
                "--in", str(synthetic_tohr_tiles["depth_lr_fp"]),
                "--dem", str(synthetic_tohr_tiles["dem_fp"]),
                "--out", str(out_fp),
                "--model-version", "ResUNet_16x_DEM",
                "--manifest", str(manifest_fp),
                "--cache-dir", str(tmp_path / "cache"),
            ]
        )
        assert code == 0
        assert out_fp.exists()

    def test_no_cached_model_fails_with_hint(self, synthetic_tohr_tiles, tmp_path):
        manifest = {
            "models": {
                "ResUNet_16x_DEM": {
                    "file_name": "nothere.fsrz",
                    "url": "file:///nonexistent/nothere.fsrz",
                    "sha256": "0" * 64,
                }
            }
        }
        manifest_fp = tmp_path / "models.json"
        manifest_fp.write_text(json.dumps(manifest))
        code = main(
            [
                "tohr",
                "--in", str(synthetic_tohr_tiles["depth_lr_fp"]),
                "--dem", str(synthetic_tohr_tiles["dem_fp"]),
                "--manifest", str(manifest_fp),
                "--cache-dir", str(tmp_path / "cache"),
            ]
        )
        assert code == 1

    def test_default_output_path(self):
        out = _resolve_default_output_path(Path("/data/scene.tif"))
        assert out.name == "scene_sr.tif"
        assert out.parent == Path.cwd().resolve()


class TestDoctorAndCache:
    def test_doctor_prints_runtime_keys(self, capsys):
        assert main(["doctor"]) == 0
        out = capsys.readouterr().out
        for key in (
            "torch_installed=",
            "torch_version=",
            "cuda_version=",
            "cuda_available=",
            "cuda_devices=",
            "cuda_capabilities=",
            "cuda_total_memory_bytes=",
            "nvcc_found=",
            "kernels_built=",
            "io_backend=",
            "io_native_codec=",
        ):
            assert key in out
        # No card here: a diagnosis says so and still exits 0.
        import torch

        if not torch.cuda.is_available():
            assert "cuda_available=False" in out

    def test_cache_info_and_purge(self, tmp_path, capsys):
        cache_dir = tmp_path / "cache"
        (cache_dir / "ns1").mkdir(parents=True)
        (cache_dir / "ns1" / "a.bin").write_bytes(b"x" * 100)
        (cache_dir / "ns2").mkdir()
        (cache_dir / "ns2" / "b.bin").write_bytes(b"y" * 50)

        assert main(["cache", "info", "--cache-dir", str(cache_dir)]) == 0
        out = capsys.readouterr().out
        assert "total_bytes=150" in out
        assert "namespace.ns1=" in out and "namespace.ns2=" in out

        assert main(
            ["cache", "purge", "--cache-dir", str(cache_dir), "--namespace", "ns1"]
        ) == 0
        out = capsys.readouterr().out
        assert "removed=ns1" in out and "freed_bytes=100" in out
        assert not (cache_dir / "ns1").exists()
        assert (cache_dir / "ns2").exists()

        # TTL-guarded purge keeps fresh namespaces.
        assert main(
            ["cache", "purge", "--cache-dir", str(cache_dir), "--older-than-days", "30"]
        ) == 0
        assert (cache_dir / "ns2").exists()

    def test_verbosity_resolution(self):
        import argparse
        import logging

        from floodsr_tpu_torch.cli import _resolve_log_level

        ns = argparse.Namespace(log_level=None, verbose=0, quiet=0)
        assert _resolve_log_level(ns) == logging.INFO
        ns = argparse.Namespace(log_level=None, verbose=2, quiet=0)
        assert _resolve_log_level(ns) == logging.DEBUG
        ns = argparse.Namespace(log_level=None, verbose=0, quiet=5)
        assert _resolve_log_level(ns) == logging.ERROR
        ns = argparse.Namespace(log_level="WARNING", verbose=3, quiet=0)
        assert _resolve_log_level(ns) == logging.WARNING


class TestDeviceOption:
    def _argv(self, tiles, model_fp, out_fp):
        return [
            "tohr",
            "--in", str(tiles["depth_lr_fp"]),
            "--dem", str(tiles["dem_fp"]),
            "--out", str(out_fp),
            "--model-path", str(model_fp),
        ]

    def test_default_device_is_cuda_and_fails_without_it(
        self, tiny_model_fp, synthetic_tohr_tiles, tmp_path, monkeypatch, caplog
    ):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        out_fp = tmp_path / "no_card.tif"
        args = cli_torch._parse_arguments(
            self._argv(synthetic_tohr_tiles, tiny_model_fp, out_fp)
        )
        assert args.device == "cuda"
        code = cli_torch.main(self._argv(synthetic_tohr_tiles, tiny_model_fp, out_fp))
        assert code == 1
        assert "CUDA is not available" in caplog.text
        assert not out_fp.exists()

    def test_machine_json_device_key(self, tiny_model_fp, synthetic_tohr_tiles, tmp_path):
        out_fp = tmp_path / "mj_device.tif"
        payload = {
            "in": str(synthetic_tohr_tiles["depth_lr_fp"]),
            "dem": str(synthetic_tohr_tiles["dem_fp"]),
            "out": str(out_fp),
            "model_path": str(tiny_model_fp),
            "device": "cpu",
        }
        mj = tmp_path / "machine.json"
        mj.write_text(json.dumps(payload))
        assert cli_torch.main(["tohr", "--machine-json", str(mj)]) == 0
        assert out_fp.exists()

    @pytest.mark.parametrize("extra", [
        ["--mesh", "auto"], ["--scene-mode", "banded"],
    ])
    def test_mesh_options_are_refused(
        self, tiny_model_fp, synthetic_tohr_tiles, tmp_path, caplog, extra
    ):
        """The port refused these options until it had a mesh; the same argv
        now gets what the JAX CLI gives it. ``--mesh auto`` (one CPU with
        ``--device cpu``) runs and equals the plain raster within one uint16
        step; ``--scene-mode`` without ``--mesh`` fails with the JAX CLI's
        exit code and message. Both are machine-json keys."""
        argv = self._argv(synthetic_tohr_tiles, tiny_model_fp, tmp_path / "port.tif")
        code_t = main(argv + extra)
        code_j = main_jax(
            self._argv(synthetic_tohr_tiles, tiny_model_fp, tmp_path / "jax.tif") + extra
        )
        assert code_t == code_j
        if extra[0] == "--mesh":
            assert code_t == 0
            assert main(self._argv(synthetic_tohr_tiles, tiny_model_fp, tmp_path / "plain.tif")) == 0
            got, want = read_raster(tmp_path / "port.tif")[0], read_raster(tmp_path / "plain.tif")[0]
            assert np.abs(got - want).max() <= 5.0 / 65535 + 1e-6
        else:
            assert code_t == 1
            assert caplog.text.count("--scene-mode requires --mesh") == 2
            assert not (tmp_path / "port.tif").exists()
        key = extra[0][2:].replace("-", "_")
        assert cli_torch._build_tohr_machine_cli_tokens({key: extra[1]}, []) == extra

    @pytest.mark.parametrize("dtype", ["bfloat16", "mixed"])
    def test_compute_dtype_from_the_config_runs(
        self, dtype, tiny_model_fp, synthetic_tohr_tiles, tmp_path, monkeypatch
    ):
        f32_fp, out_fp = tmp_path / "f32.tif", tmp_path / f"{dtype}.tif"
        assert main(self._argv(synthetic_tohr_tiles, tiny_model_fp, f32_fp)) == 0
        monkeypatch.setenv("FLOODSR_COMPUTE_DTYPE", dtype)
        assert main(self._argv(synthetic_tohr_tiles, tiny_model_fp, out_fp)) == 0
        got, want = read_raster(out_fp)[0], read_raster(f32_fp)[0]
        assert np.isfinite(got).all()
        # another arithmetic (bf16 keeps 8 bits), the same scene: the randomly
        # initialised model saturates, so single pixels move far, the scene does not
        rms = float(np.sqrt(np.mean((got - want) ** 2)))
        assert 0 < rms < 0.1 * float(np.sqrt(np.mean(want ** 2)))

    def test_parse_serve_device(self):
        args = cli_torch._parse_arguments(["serve", "--model-path", "m.fsrz"])
        assert args.device == "cuda"
        args = cli_torch._parse_arguments(
            ["serve", "--model-path", "m.fsrz", "--device", "cpu"]
        )
        assert args.device == "cpu"


class TestSameExitCodesAsTheJaxCli:
    """One argv to both CLIs (the port's with ``--device cpu``)."""

    @pytest.mark.parametrize("case", [
        "ok", "multi_file_out", "fetch_out_without_fetch", "missing_input",
        "bad_tile_overlap", "doctor", "models_fetch_unknown",
    ])
    def test_exit_codes(
        self, case, tiny_model_fp, synthetic_tohr_tiles, models_manifest_fp, tmp_path
    ):
        lr, dem = str(synthetic_tohr_tiles["depth_lr_fp"]), str(synthetic_tohr_tiles["dem_fp"])
        model = ["--model-path", str(tiny_model_fp)]

        def argv(name):
            out = str(tmp_path / f"{name}.tif")
            return {
                "ok": ["tohr", "--in", lr, "--dem", dem, "--out", out, *model,
                       "--window-method", "hard"],
                "multi_file_out": ["tohr", "--in", lr, lr, "--dem", dem, "--out", out, *model],
                "fetch_out_without_fetch": ["tohr", "--in", lr, "--dem", dem, *model,
                                            "--fetch-out", out],
                "missing_input": ["tohr", "--in", str(tmp_path / "nope.tif"), "--dem", dem,
                                  "--out", out, *model],
                "bad_tile_overlap": ["tohr", "--in", lr, "--dem", dem, "--out", out, *model,
                                     "--tile-overlap", "-1"],
                "doctor": ["doctor"],
                "models_fetch_unknown": ["models", "fetch", "nope", "--manifest",
                                         str(models_manifest_fp), "--cache-dir",
                                         str(tmp_path / "c")],
            }[case]

        code_t, code_j = main(argv("torch")), main_jax(argv("jax"))
        assert code_t == code_j
        assert code_t == (0 if case in ("ok", "doctor") else 1)
        if case == "ok":
            got, _, _ = read_raster(tmp_path / "torch.tif")
            want, _, _ = read_raster(tmp_path / "jax.tif")
            # The bar of tests/test_torch_scene_tohr.py: 1e-4 m RMSE.
            assert float(np.sqrt(np.mean((got - want) ** 2))) <= 1e-4
