"""Shared types for pluggable DEM providers.

Every provider registered with the catalog resolves a low-resolution depth
footprint to a high-resolution DEM GeoTIFF on disk and reports provenance via
:class:`DemFetchResult` (field set matches the reference's fetch-result
contract in ``floodsr/dem_sources/base.py`` so downstream consumers are
interchangeable).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path


@dataclass(frozen=True, slots=True)
class DemFetchResult:
    """Provenance record for one resolved DEM.

    Attributes
    ----------
    source_id:    catalog key of the provider that produced the DEM
    dem_fp:       path of the written (or cache-hit) DEM GeoTIFF
    stac_url:     API endpoint queried
    collection:   remote collection the assets came from
    asset_key:    which asset per item was mosaicked
    item_ids:     remote item identifiers that contributed pixels
    """

    dem_fp: Path
    source_id: str
    stac_url: str = ""
    collection: str = ""
    asset_key: str = ""
    item_ids: list[str] = field(default_factory=list)
