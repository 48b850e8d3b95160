"""Where downloaded model weights live on disk.

Layout (same as the reference, so a user's existing cache keeps working)::

    <user cache>/floodsr/<model_version>/<file_name>

with the platform user-cache root from ``platformdirs`` unless the caller
passes an explicit directory. TTL/purge policy on top of this layout lives in
:mod:`floodsr_tpu_torch.cache_policy` (the reference spec'd it in ADR-0012 but
never built it).
"""

from __future__ import annotations

from pathlib import Path

from platformdirs import user_cache_dir

APP_NAME = "floodsr"
APP_AUTHOR = "floodsr"


def _ensure_dir(path: Path) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    assert path.exists(), f"failed to create cache directory: {path}"
    return path


def get_cache_dir(cache_dir: str | Path | None = None) -> Path:
    """The cache root (explicit override or platform default), created."""
    if cache_dir is None:
        return _ensure_dir(Path(user_cache_dir(APP_NAME, APP_AUTHOR)))
    return _ensure_dir(Path(cache_dir).expanduser().resolve())


def get_model_cache_path(
    model_version: str,
    file_name: str,
    cache_dir: str | Path | None = None,
) -> Path:
    """Full path for one model file; the per-version subdirectory is created."""
    assert model_version, "a model_version is required to build a cache path"
    assert file_name, "a file_name is required to build a cache path"
    version_dir = _ensure_dir(get_cache_dir(cache_dir) / model_version)
    return version_dir / file_name
