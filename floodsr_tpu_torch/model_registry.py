"""Model weights manifest, artifact retrieval, and worker-module discovery.

Three concerns, one seam each (public surface mirrors the reference
``floodsr/model_registry.py`` so CLI flows and cached layouts carry over):

* **manifest** — ``models.json`` maps a version string to
  ``{file_name, url, sha256, description}``; :class:`ModelRecord` is the
  resolved row.
* **retrieval** — strategy objects keyed by URL scheme (or an explicit
  backend name): HTTP(S) with staged GitHub auth, local file copy, and an
  offline ``builtin:`` generator for parameter-only artifacts.
* **workers** — each model version maps to a module under
  ``floodsr_tpu_torch/models/`` exporting a ``ModelWorker`` class; discovery is a
  dynamic import so new models drop in without registry edits.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import os
import shutil
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import IO
from urllib.error import HTTPError, URLError
from urllib.parse import unquote, urlparse
from urllib.request import Request, urlopen

from floodsr_tpu_torch.cache_paths import get_model_cache_path
from floodsr_tpu_torch.checksums import assert_sha256, verify_sha256

log = logging.getLogger(__name__)

DEFAULT_MANIFEST_FP = Path(__file__).with_name("models.json")


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelRecord:
    """One resolved row of the weights manifest."""

    version: str
    file_name: str
    url: str
    sha256: str
    description: str = ""

    @classmethod
    def from_manifest(cls, version: str, payload: dict) -> "ModelRecord":
        return cls(
            version=version,
            file_name=payload["file_name"],
            url=payload["url"],
            sha256=payload["sha256"],
            description=payload.get("description", ""),
        )


def load_models_manifest(manifest_fp: str | Path | None = None) -> dict:
    """Parse a manifest file and return its ``models`` mapping."""
    path = Path(manifest_fp).expanduser().resolve() if manifest_fp else DEFAULT_MANIFEST_FP
    if not path.exists():
        raise FileNotFoundError(f"manifest does not exist: {path}")
    payload = json.loads(path.read_text(encoding="utf-8"))
    entries = payload.get("models", {})
    if not isinstance(entries, dict):
        raise ValueError("manifest field 'models' must be a dictionary")
    return entries


def list_models(manifest_fp: str | Path | None = None) -> list[ModelRecord]:
    """Every manifest entry as a :class:`ModelRecord`, version-sorted."""
    entries = load_models_manifest(manifest_fp)
    return [ModelRecord.from_manifest(v, entries[v]) for v in sorted(entries)]


def resolve_model(model_version: str, manifest_fp: str | Path | None = None) -> ModelRecord:
    """Look up a single version; ``KeyError`` lists what exists instead."""
    assert model_version, "model_version cannot be empty"
    entries = load_models_manifest(manifest_fp)
    try:
        payload = entries[model_version]
    except KeyError:
        known = ", ".join(sorted(entries))
        raise KeyError(f"model '{model_version}' not found. available: {known}") from None
    return ModelRecord.from_manifest(model_version, payload)


# ---------------------------------------------------------------------------
# retrieval backends
# ---------------------------------------------------------------------------

_GITHUB_TOKEN_VARS = ("FLOODSR_GITHUB_TOKEN", "GITHUB_TOKEN", "GH_TOKEN")


def get_github_auth_token(logger: logging.Logger | None = None) -> str | None:
    """Best-effort GitHub credential: env vars win, then ``gh auth token``."""
    logger = logger or log
    for var in _GITHUB_TOKEN_VARS:
        value = os.environ.get(var)
        if value:
            logger.debug("GitHub token sourced from $%s", var)
            return value
    if shutil.which("gh") is None:
        return None
    probe = subprocess.run(
        ["gh", "auth", "token"], capture_output=True, text=True, check=False
    )
    if probe.returncode != 0:
        logger.debug("gh auth token exited %d; continuing unauthenticated", probe.returncode)
        return None
    return probe.stdout.strip() or None


def _spool_to_file(body: IO[bytes], out_fp: Path, content_length: str | None) -> int:
    """Copy a response body to ``out_fp``, drawing a progress bar on TTYs."""
    try:
        expected = int(content_length) if content_length else 0
    except (TypeError, ValueError):
        expected = 0
    draw = expected > 0 and sys.stderr.isatty()
    done = 0
    with out_fp.open("wb") as sink:
        for block in iter(lambda: body.read(1 << 20), b""):
            sink.write(block)
            done += len(block)
            if draw:
                frac = min(done / expected, 1.0)
                cells = int(30 * frac)
                sys.stderr.write(
                    f"\r[{'#' * cells}{'-' * (30 - cells)}] {frac:7.2%} "
                    f"({done:,}/{expected:,} bytes)"
                )
                sys.stderr.flush()
    if draw:
        sys.stderr.write("\n")
        sys.stderr.flush()
    return done


class WeightsRetrievalBackend:
    """Strategy interface: move artifact bytes from ``source`` to ``destination``."""

    name = "base"

    def retrieve(self, source: str, destination: Path) -> Path:
        raise NotImplementedError


def _release_url_parts(url_parts) -> list[str] | None:
    """For ``github.com/<owner>/<repo>/releases/download/<tag>/<asset>`` URLs,
    the split path; ``None`` for anything else."""
    if url_parts.netloc.lower() != "github.com":
        return None
    segments = [s for s in url_parts.path.split("/") if s]
    if len(segments) >= 6 and segments[2:4] == ["releases", "download"]:
        return segments
    return None


class HttpRetrievalBackend(WeightsRetrievalBackend):
    """HTTP(S) download with escalating GitHub auth.

    Stage 1 goes out anonymous. On an HTTP error a discovered token is
    retried as a Bearer header. A 404 on a github.com release-download URL
    (how private release assets answer) escalates to the release REST API,
    resolving the asset id and streaming it with octet-stream accept.
    """

    name = "http"

    def _download(self, request: Request, destination: Path) -> Path:
        with urlopen(request) as response:  # nosec B310 — scheme gated below
            n = _spool_to_file(
                response, destination, response.headers.get("Content-Length")
            )
        log.debug("fetched %s bytes -> %s", f"{n:,}", destination)
        return destination

    def retrieve(self, source: str, destination: Path) -> Path:
        assert source, "source cannot be empty"
        assert isinstance(destination, Path), "destination must be a pathlib.Path"
        parts = urlparse(source)
        if parts.scheme.lower() not in ("http", "https"):
            raise ValueError(f"unsupported scheme for http backend: {parts.scheme}")
        release_parts = _release_url_parts(parts)
        destination.parent.mkdir(parents=True, exist_ok=True)

        log.info("downloading (anonymous):\n    %s", source)
        try:
            return self._download(Request(source), destination)
        except HTTPError as anon_err:
            log.info("anonymous download got HTTP %d; trying credentials", anon_err.code)
            first_error = anon_err
        except URLError as err:
            raise RuntimeError(f"failed to download model from '{source}' ({err})") from err

        token = get_github_auth_token(logger=log)
        if not token:
            hint = (
                ". If this is a private GitHub release asset, run 'gh auth login' "
                "or set FLOODSR_GITHUB_TOKEN/GITHUB_TOKEN."
                if release_parts
                else ""
            )
            raise RuntimeError(
                f"failed to download model from '{source}' "
                f"(HTTP {first_error.code}){hint}"
            ) from first_error

        log.info("retrying with bearer token:\n    %s", source)
        authed = Request(source, headers={"Authorization": f"Bearer {token}"})
        try:
            return self._download(authed, destination)
        except HTTPError as authed_err:
            if authed_err.code == 404 and release_parts:
                return self._fetch_release_asset(
                    release_parts, source, destination, token, authed_err
                )
            hint = (
                ". If this is a private GitHub release asset, set "
                "FLOODSR_GITHUB_TOKEN or GITHUB_TOKEN."
                if release_parts
                else ""
            )
            raise RuntimeError(
                f"failed to download model from '{source}' (HTTP {authed_err.code}){hint}"
            ) from authed_err
        except URLError as err:
            raise RuntimeError(f"failed to download model from '{source}' ({err})") from err

    def _fetch_release_asset(
        self,
        segments: list[str],
        source: str,
        destination: Path,
        token: str,
        cause: HTTPError,
    ) -> Path:
        owner, repo = segments[0], segments[1]
        tag = segments[4]
        wanted = "/".join(segments[5:])
        log.debug("resolving release asset via API: %s/%s@%s :: %s", owner, repo, tag, wanted)
        api = Request(
            f"https://api.github.com/repos/{owner}/{repo}/releases/tags/{tag}",
            headers={
                "Accept": "application/vnd.github+json",
                "Authorization": f"Bearer {token}",
            },
        )
        with urlopen(api) as response:  # nosec B310
            release = json.loads(response.read().decode("utf-8"))
        matches = [a["url"] for a in release.get("assets", []) if a.get("name") == wanted]
        if not matches:
            raise RuntimeError(
                f"release asset '{wanted}' not found for tag '{tag}' ({source})"
            ) from cause
        asset = Request(
            matches[0],
            headers={
                "Accept": "application/octet-stream",
                "Authorization": f"Bearer {token}",
            },
        )
        return self._download(asset, destination)


class FileRetrievalBackend(WeightsRetrievalBackend):
    """Copy from a local path or ``file://`` URI."""

    name = "file"

    def retrieve(self, source: str, destination: Path) -> Path:
        parts = urlparse(source)
        if parts.scheme.lower() not in ("", "file"):
            raise ValueError(f"unsupported scheme for file backend: {parts.scheme}")
        if parts.netloc:
            raw = Path(f"//{parts.netloc}{unquote(parts.path)}")
        else:
            raw = Path(unquote(parts.path) or source)
        src = raw.expanduser().resolve()
        if not src.exists():
            raise FileNotFoundError(f"source model not found: {src}")
        destination.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, destination)
        return destination


class BuiltinRetrievalBackend(WeightsRetrievalBackend):
    """Materialize small canonical parameter files offline (``builtin:`` URLs).

    Models whose "weights" are a handful of scalars (CostGrow) ship as
    in-package templates with pinned checksums — fetchable with no network.
    """

    name = "builtin"

    _ARTIFACTS = {
        "costgrow-params-v1": json.dumps(
            {
                "model_version": "CostGrow",
                "max_grow_coarse_pixels": 4,
                "terrain_penalty_scale": 1.0,
                "decay_per_meter": 0.0,
                "output_kind": "wse",
            },
            indent=2,
        )
        + "\n",
        "costgrow-pcraster-params-v1": json.dumps(
            {
                "model_version": "CostGrow_pcraster",
                "dp_coarse_pixel_max": 10,
                "decay_frac": 0.001,
                "terrain_penalty_scale": 1.0,
                "distance_metric": "chessboard",
                "output_kind": "wse",
            },
            indent=2,
        )
        + "\n",
    }

    def retrieve(self, source: str, destination: Path) -> Path:
        key = source.partition(":")[2] or source
        try:
            text = self._ARTIFACTS[key]
        except KeyError:
            raise ValueError(f"unknown builtin artifact '{key}'") from None
        destination.parent.mkdir(parents=True, exist_ok=True)
        destination.write_text(text, encoding="utf-8")
        return destination


_BACKENDS: dict[str, type[WeightsRetrievalBackend]] = {
    "http": HttpRetrievalBackend,
    "file": FileRetrievalBackend,
    "builtin": BuiltinRetrievalBackend,
}

_SCHEME_TO_BACKEND = {
    "http": "http",
    "https": "http",
    "file": "file",
    "": "file",
    "builtin": "builtin",
}


def get_retrieval_backend(
    source_url: str, backend_name: str | None = None
) -> WeightsRetrievalBackend:
    """Instantiate a backend by explicit name, else by URL scheme."""
    if backend_name is not None:
        try:
            return _BACKENDS[backend_name]()
        except KeyError:
            raise ValueError(f"unsupported backend '{backend_name}'") from None
    scheme = urlparse(source_url).scheme.lower()
    key = _SCHEME_TO_BACKEND.get(scheme)
    if key is None:
        raise ValueError(f"unable to select backend for URL scheme '{scheme}'")
    return _BACKENDS[key]()


def fetch_model(
    model_version: str,
    cache_dir: str | Path | None = None,
    manifest_fp: str | Path | None = None,
    backend_name: str | None = None,
    force: bool = False,
) -> Path:
    """Ensure a model artifact is cached and checksum-valid; return its path.

    Downloads land in a ``.part`` sibling, are digest-checked, then renamed
    atomically over the final path — a crashed fetch never poisons the cache.
    """
    record = resolve_model(model_version, manifest_fp=manifest_fp)
    final_fp = get_model_cache_path(record.version, record.file_name, cache_dir=cache_dir)
    if final_fp.exists() and not force and verify_sha256(final_fp, record.sha256):
        return final_fp

    staging_fp = final_fp.with_suffix(final_fp.suffix + ".part")
    staging_fp.unlink(missing_ok=True)
    backend = get_retrieval_backend(record.url, backend_name=backend_name)
    try:
        backend.retrieve(record.url, staging_fp)
        assert_sha256(staging_fp, record.sha256)
        staging_fp.replace(final_fp)
    finally:
        staging_fp.unlink(missing_ok=True)
    return final_fp


# ---------------------------------------------------------------------------
# worker discovery
# ---------------------------------------------------------------------------


def _model_version_to_worker_stem(model_version: str) -> str:
    """Filesystem-safe module stem for a version (non-word chars -> ``_``)."""
    assert model_version, "model_version cannot be empty"
    return "".join(c if c.isalnum() or c == "_" else "_" for c in model_version)


def get_model_worker_path(model_version: str) -> Path:
    """Path where the worker module for ``model_version`` is expected.

    The normalized stem is preferred; the raw version string is accepted as
    a fallback for versions that are already valid module names.
    """
    assert model_version, "model_version cannot be empty"
    models_dir = Path(__file__).with_name("models")
    candidate = models_dir / (_model_version_to_worker_stem(model_version) + ".py")
    return candidate if candidate.exists() else models_dir / (model_version + ".py")


def model_worker_exists(model_version: str) -> bool:
    """Whether a worker module ships for this version."""
    return get_model_worker_path(model_version).exists()


def list_runnable_model_versions(manifest_fp: str | Path | None = None) -> list[str]:
    """Manifest versions that can actually run (worker module present)."""
    return [v for v in load_models_manifest(manifest_fp) if model_worker_exists(v)]


def resolve_model_worker_class(model_version: str):
    """Import the worker module for a version and return its ``ModelWorker``."""
    worker_fp = get_model_worker_path(model_version)
    if not worker_fp.exists():
        raise FileNotFoundError(
            f"missing model worker module for '{model_version}': {worker_fp}"
        )
    alias = "floodsr_tpu_torch.models._worker_" + _model_version_to_worker_stem(model_version)
    spec = importlib.util.spec_from_file_location(alias, worker_fp)
    if spec is None or spec.loader is None:
        raise ImportError(f"unable to load worker module spec from: {worker_fp}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    from floodsr_tpu_torch.models.base import Model

    worker_class = getattr(module, "ModelWorker", None)
    if worker_class is None:
        raise AttributeError(f"worker module '{worker_fp}' must define `ModelWorker`")
    if not (isinstance(worker_class, type) and issubclass(worker_class, Model)):
        raise TypeError(
            f"`ModelWorker` in '{worker_fp}' must subclass floodsr_tpu_torch.models.base.Model"
        )
    return worker_class
