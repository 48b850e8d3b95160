"""Coordinate-reference-system identity: EPSG-coded or opaque WKT.

GDAL/pyproj are not dependencies of this framework; the pipeline only needs
CRS *identity* (equality checks between depth and DEM rasters) and the
projected-vs-geographic distinction (reference guard at
``floodsr/preprocessing.py:304-324``). The reference accepts any
GDAL-readable CRS — including rasters whose GeoKeys carry only a WKT/ESRI
citation (user-defined code 32767) — so a :class:`CRS` is either

* **EPSG-coded** (``epsg`` set): equality compares codes; or
* **opaque WKT** (``epsg is None``, ``wkt`` set): equality compares the
  whitespace-normalized WKT text, and the projected flag comes from the
  GeoTIFF model-type key (or the WKT root keyword).

When a WKT carries a top-level ``AUTHORITY["EPSG", …]`` / ``ID["EPSG", …]``
node, the EPSG code is recovered and the CRS behaves as EPSG-coded (matching
GDAL, which resolves such WKTs to their authority code). Full datum math is
out of scope — the HRDEM fetcher (the one consumer of coordinate conversion)
carries its own projection formulas in the JAX package's ``dem_sources.geodesy``
and raises clearly for non-EPSG CRSs.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


# EPSG codes in [4000, 5000) are (with rare geocentric exceptions irrelevant
# here) geographic 2-D systems; everything else this pipeline encounters is a
# projected system (UTM 326xx/327xx, national grids like 3979/2169, etc.).
_GEOGRAPHIC_RANGE = range(4000, 5000)

# WKT1 + WKT2 root keywords (OGC 01-009 / ISO 19162). Used both to detect a
# WKT string in from_user_input and to infer projected-ness from the root
# node when no model-type key is available.
_WKT_PROJECTED_ROOTS = (
    "PROJCS", "PROJCRS", "PROJECTEDCRS", "COMPD_CS", "COMPOUNDCRS",
    "LOCAL_CS", "ENGCRS", "ENGINEERINGCRS", "BOUNDCRS",
)
_WKT_GEOGRAPHIC_ROOTS = ("GEOGCS", "GEOGCRS", "GEOGRAPHICCRS", "GEODCRS", "GEODETICCRS")
_WKT_ROOT_RE = re.compile(
    r"^\s*(" + "|".join(_WKT_PROJECTED_ROOTS + _WKT_GEOGRAPHIC_ROOTS) + r")\s*\[",
    re.IGNORECASE,
)

_AUTHORITY_RE = re.compile(
    r'\b(?:AUTHORITY|ID)\s*\[\s*"EPSG"\s*,\s*"?(\d+)"?', re.IGNORECASE
)


def _normalize_wkt(text: str) -> str:
    """Whitespace-collapsed WKT for identity comparison.

    Two serializations of the same definition that differ only in
    indentation/newlines (GDAL pretty-print vs single-line) compare equal;
    semantically different definitions stay different. This is *identity*
    normalization, not datum equivalence.
    """
    return " ".join(text.replace("\x00", " ").split())


def _epsg_from_wkt(text: str) -> int | None:
    """Recover the top-level EPSG authority code from a WKT string.

    Only ``AUTHORITY``/``ID`` nodes that are *direct children of the root*
    (bracket depth 1) name the CRS itself; deeper ones name components
    (datum, spheroid, unit — e.g. ``UNIT["metre",1,AUTHORITY["EPSG","9001"]]``)
    and must not be mistaken for the CRS code.
    """
    matches = list(_AUTHORITY_RE.finditer(text))
    if not matches:
        return None

    # Bracket depth at each candidate, ignoring brackets inside quotes.
    depth = 0
    in_quote = False
    depths: dict[int, int] = {}
    starts = {m.start(): m for m in matches}
    for i, ch in enumerate(text):
        if i in starts:
            depths[starts[i].start()] = depth
        if ch == '"':
            in_quote = not in_quote
        elif not in_quote and ch in "[(":
            depth += 1
        elif not in_quote and ch in "])":
            depth -= 1
    for m in matches:
        if depths.get(m.start()) == 1:
            return int(m.group(1))
    return None


@dataclass(frozen=True, eq=False)
class CRS:
    """A CRS identified by EPSG code, or by opaque (normalized) WKT text.

    At least one of ``epsg``/``wkt`` must be set. When ``epsg`` is set it is
    the identity; ``wkt`` is then informative only (kept so writes can
    preserve the citation). ``projected`` records the GeoTIFF model-type key
    for WKT-only CRSs; for EPSG-coded CRSs the code range decides.
    """

    epsg: int | None = None
    wkt: str | None = None
    projected: bool | None = None

    def __post_init__(self) -> None:
        if self.epsg is None and self.wkt is None:
            raise ValueError("CRS requires an EPSG code or WKT text")
        if self.wkt is not None:
            object.__setattr__(self, "wkt", _normalize_wkt(self.wkt))

    @staticmethod
    def from_user_input(value: "CRS | str | int | None") -> "CRS | None":
        if value is None:
            return None
        if isinstance(value, CRS):
            return value
        if isinstance(value, int):
            return CRS(epsg=value)
        text = str(value).strip()
        if _WKT_ROOT_RE.match(text):
            return CRS.from_wkt(text)
        if ":" in text:
            authority, _, code = text.rpartition(":")
            if authority.upper() not in {"EPSG", "URN:OGC:DEF:CRS:EPSG:"}:
                raise ValueError(f"unsupported CRS authority: {text}")
            return CRS(epsg=int(code))
        return CRS(epsg=int(text))

    @staticmethod
    def from_wkt(text: str) -> "CRS":
        """CRS from WKT: EPSG-coded when a root authority resolves, else opaque."""
        norm = _normalize_wkt(text)
        root = _WKT_ROOT_RE.match(norm)
        projected: bool | None = None
        if root is not None:
            projected = root.group(1).upper() in _WKT_PROJECTED_ROOTS
        return CRS(epsg=_epsg_from_wkt(norm), wkt=norm, projected=projected)

    @property
    def is_projected(self) -> bool:
        if self.epsg is not None:
            return self.epsg not in _GEOGRAPHIC_RANGE
        if self.projected is not None:
            return self.projected
        # WKT-only with no model-type information: assume projected so that
        # matching-CRS raster pairs flow through the pipeline (the reference
        # guard only rejects *known-geographic* systems).
        return True

    @property
    def is_geographic(self) -> bool:
        return not self.is_projected

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, CRS):
            return NotImplemented
        if self.epsg is not None or other.epsg is not None:
            return self.epsg == other.epsg
        return self.wkt == other.wkt

    def __hash__(self) -> int:
        if self.epsg is not None:
            return hash(("epsg", self.epsg))
        return hash(("wkt", self.wkt))

    def to_string(self) -> str:
        if self.epsg is not None:
            return f"EPSG:{self.epsg}"
        return self.wkt or ""

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        if self.epsg is not None:
            return self.to_string()
        wkt = self.wkt or ""
        return wkt if len(wkt) <= 80 else wkt[:77] + "..."
