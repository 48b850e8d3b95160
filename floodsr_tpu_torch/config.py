"""Typed runtime configuration with layered precedence.

Implements the reference's ADR-0011 design (spec'd as future work there,
reference: ``docs/dev/adr/0011-parameters.md:60-90``): a typed ``Config``
dataclass merged from sources with precedence

    CLI args > environment variables > user config file > package defaults

No implicit global state — ``load_config()`` returns a value that callers
pass explicitly. Environment variables are ``FLOODSR_<FIELD>`` (upper-case);
the user config file is JSON at ``<user config dir>/floodsr/config.json``
(overridable via ``FLOODSR_CONFIG_FILE``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path
from typing import Any

from platformdirs import user_config_dir

log = logging.getLogger(__name__)

_ENV_PREFIX = "FLOODSR_"


@dataclasses.dataclass(frozen=True)
class Config:
    """User-configurable runtime defaults."""

    default_model_version: str | None = None
    cache_dir: str | None = None
    manifest_fp: str | None = None
    log_level: str | None = None
    # Engine execution knobs (machine/user preference, not correctness).
    compute_dtype: str = "float32"       # "float32" | "bfloat16" | "mixed"
    # Output D2H encoding: "uint16" (default, step max_depth/65535), "uint12"
    # (the codes reduced to 12 bits and packed on the device, step
    # max_depth/4095, a quarter fewer bytes), "float32".
    output_transfer: str = "uint16"      # "uint16" | "uint12" | "float32"
    input_transfer: str = "uint16"       # "uint16" | "float32" (DEM upload encoding)
    max_batch: int = 8
    window_method: str = "feather"
    # Output GeoTIFF compression. "lzw" mirrors the reference's default
    # write profile (reference: floodsr/io/rasterio_io.py:4-14 — a default,
    # not a contract); "zstd"/"none" trade file size for host encode time.
    output_compress: str = "lzw"        # "lzw"|"zstd"|"deflate"|"packbits"|"none"


def _field_types() -> dict[str, type]:
    return {f.name: f.type for f in dataclasses.fields(Config)}


def default_config_path() -> Path:
    override = os.environ.get(_ENV_PREFIX + "CONFIG_FILE")
    if override:
        return Path(override).expanduser()
    return Path(user_config_dir("floodsr", "floodsr")) / "config.json"


def _coerce(name: str, value: Any) -> Any:
    if value is None:
        return None
    if name == "max_batch":
        return int(value)
    if name == "output_compress":
        return str(value).strip().lower()
    return str(value) if not isinstance(value, (int, float, bool)) else value


def load_config(
    cli_overrides: dict[str, Any] | None = None,
    *,
    config_fp: str | Path | None = None,
    environ: dict[str, str] | None = None,
) -> Config:
    """Merge config sources: CLI > env > user config file > defaults."""
    env = os.environ if environ is None else environ
    merged: dict[str, Any] = {}

    # 3) user config file
    path = Path(config_fp).expanduser() if config_fp else default_config_path()
    if path.exists():
        try:
            payload = json.loads(path.read_text(encoding="utf-8"))
            if not isinstance(payload, dict):
                raise ValueError("config file must contain a JSON object")
            unknown = set(payload) - set(_field_types())
            if unknown:
                raise ValueError(f"unknown config keys: {sorted(unknown)}")
            merged.update(payload)
        except (ValueError, OSError) as err:
            raise ValueError(f"invalid config file {path}: {err}") from err

    # 2) environment variables
    for name in _field_types():
        env_value = env.get(_ENV_PREFIX + name.upper())
        if env_value is not None and env_value != "":
            merged[name] = env_value

    # 1) CLI overrides (only explicitly-set values)
    for name, value in (cli_overrides or {}).items():
        if name not in _field_types():
            raise ValueError(f"unknown config override: {name}")
        if value is not None:
            merged[name] = value

    merged = {name: _coerce(name, value) for name, value in merged.items()}
    config = Config(**merged)
    if config.compute_dtype not in {"float32", "bfloat16", "mixed"}:
        raise ValueError(
            f"compute_dtype must be float32|bfloat16|mixed; got {config.compute_dtype}"
        )
    if config.output_transfer not in {"uint16", "uint12", "float32"}:
        raise ValueError(
            f"output_transfer must be uint16|uint12|float32; got {config.output_transfer}"
        )
    if config.input_transfer not in {"uint16", "float32"}:
        raise ValueError(f"input_transfer must be uint16|float32; got {config.input_transfer}")
    if config.window_method not in {"feather", "hard"}:
        raise ValueError(f"window_method must be feather|hard; got {config.window_method}")
    if config.output_compress not in {"lzw", "zstd", "deflate", "packbits", "none"}:
        raise ValueError(
            "output_compress must be lzw|zstd|deflate|packbits|none; "
            f"got {config.output_compress}"
        )
    if config.max_batch < 1:
        raise ValueError(f"max_batch must be >= 1; got {config.max_batch}")
    return config
