"""DEM provider catalog: maps a ``source_id`` to a fetch implementation.

Providers self-describe through :func:`register_dem_source`; lookup is lazy so
importing the catalog never drags in provider dependencies (the HRDEM STAC
client, geodesy tables) until a fetch actually runs. The dispatch surface —
``fetch_dem(source_id=..., depth_lr_fp=..., ...)`` — matches the reference's
catalog (``floodsr/dem_sources/catalog.py``).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable

from floodsr_tpu_torch.dem_sources.base import DemFetchResult

# source_id -> zero-arg importer returning the provider's fetch callable.
_PROVIDERS: dict[str, Callable[[], Callable[..., DemFetchResult]]] = {}


def register_dem_source(
    source_id: str, loader: Callable[[], Callable[..., DemFetchResult]]
) -> None:
    """Add (or replace) a provider under ``source_id`` (normalized lowercase)."""
    _PROVIDERS[source_id.strip().lower()] = loader


def list_dem_sources() -> list[str]:
    """Registered source ids, sorted."""
    return sorted(_PROVIDERS)


def _load_hrdem() -> Callable[..., DemFetchResult]:
    from floodsr_tpu_torch.dem_sources.hrdem_stac import fetch_hrdem_for_lowres_tile

    return fetch_hrdem_for_lowres_tile


register_dem_source("hrdem", _load_hrdem)


def fetch_dem(
    *,
    source_id: str,
    depth_lr_fp: str | Path,
    output_fp: str | Path | None = None,
    logger: logging.Logger | None = None,
    target_res: float | None = None,
) -> DemFetchResult:
    """Resolve a DEM covering ``depth_lr_fp``'s footprint via one provider.

    ``target_res``: coarsest acceptable DEM resolution (asset-CRS units);
    providers with overview-capable assets serve coarse targets from
    reduced-resolution levels, cutting remote bytes.
    """
    key = str(source_id).strip().lower()
    assert key in _PROVIDERS, (
        f"unsupported DEM source_id='{source_id}' (known: {list_dem_sources()})"
    )
    log = logger if logger is not None else logging.getLogger(__name__)
    log.debug("DEM fetch via provider %r", key)
    provider = _PROVIDERS[key]()
    kwargs = {}
    if target_res is not None:
        kwargs["target_res"] = float(target_res)
    return provider(
        depth_lr_fp=depth_lr_fp, output_fp=output_fp, logger=log, **kwargs
    )
