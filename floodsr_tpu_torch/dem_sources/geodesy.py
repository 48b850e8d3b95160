"""Self-contained map-projection math for DEM-source coordinate queries.

The reference leans on pyproj/GDAL for CRS transforms in exactly one place:
converting the low-res raster footprint to EPSG:4326 for the STAC bbox query
(reference: ``floodsr/dem_sources/hrdem_stac.py:61-67``). pyproj is not
available in this stack, so the projections that actually occur in the HRDEM
workflow — plus the CRSs the reference's own test rasters use (EPSG:3979,
EPSG:2169) — are implemented directly (Snyder, *Map Projections — A Working
Manual*, USGS PP 1395):

- Transverse Mercator (UTM zones EPSG:326xx/327xx/269xx/258xx, plus
  parameterized national TM grids: Luxembourg 2169, OSGB 27700, Irish TM
  2157, NZTM 2193)
- Lambert Conformal Conic 2SP (EPSG:3978/3979 Canada Atlas/LCC)
- Web Mercator (EPSG:3857) and geographic passthrough (EPSG:4326/4269/4617)

Each projection carries its own reference ellipsoid and (when the datum is
not WGS84/GRS80-equivalent) a 7-parameter Helmert shift to WGS84
(position-vector convention, the EPSG ``towgs84`` values), applied through
geocentric coordinates in :func:`transform_points`. Accuracy is series-level
within a zone (sub-mm projection math; ~1 m for shifted datums) — far beyond
what a degree-resolution STAC bbox needs. Unknown EPSG codes raise with a
clear message instead of silently guessing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from floodsr_tpu_torch.io.crs import CRS


@dataclass(frozen=True)
class Ellipsoid:
    a: float
    inv_f: float

    @property
    def f(self) -> float:
        return 1.0 / self.inv_f

    @property
    def e2(self) -> float:
        return self.f * (2 - self.f)

    @property
    def e(self) -> float:
        return math.sqrt(self.e2)

    @property
    def ep2(self) -> float:
        return self.e2 / (1 - self.e2)


#: GRS80 (NAD83/ETRS89 family); WGS84 differs in f by ~1e-10 — equivalent here.
GRS80 = Ellipsoid(6378137.0, 298.257222101)
WGS84 = Ellipsoid(6378137.0, 298.257223563)
#: International 1924 (Hayford) — Luxembourg 1930, ED50, Belgian 72, ...
INTL1924 = Ellipsoid(6378388.0, 297.0)
#: Airy 1830 — Ordnance Survey GB.
AIRY1830 = Ellipsoid(6377563.396, 299.3249646)


@dataclass(frozen=True)
class DatumShift:
    """7-parameter Helmert transform to WGS84 (EPSG position-vector towgs84).

    ``dx/dy/dz`` meters, ``rx/ry/rz`` arc-seconds, ``s_ppm`` parts-per-million.
    The inverse uses negated parameters — exact to second order, i.e. well
    under the ~1 m accuracy class of published towgs84 values themselves.
    """

    dx: float = 0.0
    dy: float = 0.0
    dz: float = 0.0
    rx: float = 0.0
    ry: float = 0.0
    rz: float = 0.0
    s_ppm: float = 0.0

    def _apply(self, x, y, z, sign):
        arc = math.pi / (180.0 * 3600.0)
        rx, ry, rz = sign * self.rx * arc, sign * self.ry * arc, sign * self.rz * arc
        m = 1.0 + sign * self.s_ppm * 1e-6
        xp = sign * self.dx + m * (x - rz * y + ry * z)
        yp = sign * self.dy + m * (rz * x + y - rx * z)
        zp = sign * self.dz + m * (-ry * x + rx * y + z)
        return xp, yp, zp

    def geodetic_to_wgs84(self, lon_deg, lat_deg, ell: Ellipsoid):
        x, y, z = _geodetic_to_geocentric(lon_deg, lat_deg, ell)
        return _geocentric_to_geodetic(*self._apply(x, y, z, +1.0), WGS84)

    def wgs84_to_geodetic(self, lon_deg, lat_deg, ell: Ellipsoid):
        x, y, z = _geodetic_to_geocentric(lon_deg, lat_deg, WGS84)
        return _geocentric_to_geodetic(*self._apply(x, y, z, -1.0), ell)


def _geodetic_to_geocentric(lon_deg, lat_deg, ell: Ellipsoid, h: float = 0.0):
    lam, phi = math.radians(lon_deg), math.radians(lat_deg)
    sin_phi, cos_phi = math.sin(phi), math.cos(phi)
    n = ell.a / math.sqrt(1 - ell.e2 * sin_phi**2)
    x = (n + h) * cos_phi * math.cos(lam)
    y = (n + h) * cos_phi * math.sin(lam)
    z = (n * (1 - ell.e2) + h) * sin_phi
    return x, y, z


def _geocentric_to_geodetic(x, y, z, ell: Ellipsoid):
    """Bowring's method + 2 Newton refinements (µm-level convergence)."""
    lam = math.atan2(y, x)
    p = math.hypot(x, y)
    if p < 1e-9:
        return math.degrees(lam), math.copysign(90.0, z)
    b = ell.a * (1 - ell.f)
    theta = math.atan2(z * ell.a, p * b)
    ep2 = ell.ep2
    phi = math.atan2(
        z + ep2 * b * math.sin(theta) ** 3,
        p - ell.e2 * ell.a * math.cos(theta) ** 3,
    )
    for _ in range(2):
        sin_phi = math.sin(phi)
        n = ell.a / math.sqrt(1 - ell.e2 * sin_phi**2)
        phi = math.atan2(z + ell.e2 * n * sin_phi, p)
    return math.degrees(lam), math.degrees(phi)


_NO_SHIFT = DatumShift()


@dataclass(frozen=True)
class TransverseMercator:
    lon0_deg: float
    lat0_deg: float = 0.0
    k0: float = 0.9996
    false_easting: float = 500000.0
    false_northing: float = 0.0
    ellipsoid: Ellipsoid = GRS80
    datum: DatumShift = _NO_SHIFT

    def _m(self, phi: float) -> float:
        """Meridian arc length from the equator (Snyder eq. 3-21)."""
        e2 = self.ellipsoid.e2
        e4, e6 = e2**2, e2**3
        return self.ellipsoid.a * (
            (1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * phi
            - (3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * math.sin(2 * phi)
            + (15 * e4 / 256 + 45 * e6 / 1024) * math.sin(4 * phi)
            - (35 * e6 / 3072) * math.sin(6 * phi)
        )

    def forward(self, lon_deg: float, lat_deg: float) -> tuple[float, float]:
        ell = self.ellipsoid
        e2, ep2 = ell.e2, ell.ep2
        phi = math.radians(lat_deg)
        lam = math.radians(lon_deg)
        lam0 = math.radians(self.lon0_deg)
        sin_phi, cos_phi, tan_phi = math.sin(phi), math.cos(phi), math.tan(phi)
        n = ell.a / math.sqrt(1 - e2 * sin_phi**2)
        t = tan_phi**2
        c = ep2 * cos_phi**2
        a_ = (lam - lam0) * cos_phi
        m = self._m(phi)
        m0 = self._m(math.radians(self.lat0_deg))
        x = self.false_easting + self.k0 * n * (
            a_
            + (1 - t + c) * a_**3 / 6
            + (5 - 18 * t + t**2 + 72 * c - 58 * ep2) * a_**5 / 120
        )
        y = self.false_northing + self.k0 * (
            m
            - m0
            + n
            * tan_phi
            * (
                a_**2 / 2
                + (5 - t + 9 * c + 4 * c**2) * a_**4 / 24
                + (61 - 58 * t + t**2 + 600 * c - 330 * ep2) * a_**6 / 720
            )
        )
        return x, y

    def inverse(self, x: float, y: float) -> tuple[float, float]:
        ell = self.ellipsoid
        e2, ep2 = ell.e2, ell.ep2
        m0 = self._m(math.radians(self.lat0_deg))
        m = m0 + (y - self.false_northing) / self.k0
        mu = m / (ell.a * (1 - e2 / 4 - 3 * e2**2 / 64 - 5 * e2**3 / 256))
        e1 = (1 - math.sqrt(1 - e2)) / (1 + math.sqrt(1 - e2))
        phi1 = (
            mu
            + (3 * e1 / 2 - 27 * e1**3 / 32) * math.sin(2 * mu)
            + (21 * e1**2 / 16 - 55 * e1**4 / 32) * math.sin(4 * mu)
            + (151 * e1**3 / 96) * math.sin(6 * mu)
            + (1097 * e1**4 / 512) * math.sin(8 * mu)
        )
        sin1, cos1, tan1 = math.sin(phi1), math.cos(phi1), math.tan(phi1)
        c1 = ep2 * cos1**2
        t1 = tan1**2
        n1 = ell.a / math.sqrt(1 - e2 * sin1**2)
        r1 = ell.a * (1 - e2) / (1 - e2 * sin1**2) ** 1.5
        d = (x - self.false_easting) / (n1 * self.k0)
        phi = phi1 - (n1 * tan1 / r1) * (
            d**2 / 2
            - (5 + 3 * t1 + 10 * c1 - 4 * c1**2 - 9 * ep2) * d**4 / 24
            + (61 + 90 * t1 + 298 * c1 + 45 * t1**2 - 252 * ep2 - 3 * c1**2)
            * d**6
            / 720
        )
        lam = math.radians(self.lon0_deg) + (
            d
            - (1 + 2 * t1 + c1) * d**3 / 6
            + (5 - 2 * c1 + 28 * t1 - 3 * c1**2 + 8 * ep2 + 24 * t1**2) * d**5 / 120
        ) / cos1
        return math.degrees(lam), math.degrees(phi)


@dataclass(frozen=True)
class LambertConformalConic2SP:
    lat1_deg: float
    lat2_deg: float
    lat0_deg: float
    lon0_deg: float
    false_easting: float = 0.0
    false_northing: float = 0.0
    ellipsoid: Ellipsoid = GRS80
    datum: DatumShift = _NO_SHIFT

    def _mt(self, phi: float) -> tuple[float, float]:
        e, e2 = self.ellipsoid.e, self.ellipsoid.e2
        sin_phi = math.sin(phi)
        m = math.cos(phi) / math.sqrt(1 - e2 * sin_phi**2)
        t = math.tan(math.pi / 4 - phi / 2) / (
            ((1 - e * sin_phi) / (1 + e * sin_phi)) ** (e / 2)
        )
        return m, t

    def _constants(self) -> tuple[float, float, float]:
        phi1 = math.radians(self.lat1_deg)
        phi2 = math.radians(self.lat2_deg)
        phi0 = math.radians(self.lat0_deg)
        m1, t1 = self._mt(phi1)
        m2, t2 = self._mt(phi2)
        _, t0 = self._mt(phi0)
        if math.isclose(phi1, phi2):
            n = math.sin(phi1)
        else:
            n = (math.log(m1) - math.log(m2)) / (math.log(t1) - math.log(t2))
        f = m1 / (n * t1**n)
        rho0 = self.ellipsoid.a * f * t0**n
        return n, f, rho0

    def forward(self, lon_deg: float, lat_deg: float) -> tuple[float, float]:
        n, f, rho0 = self._constants()
        phi = math.radians(lat_deg)
        _, t = self._mt(phi)
        rho = self.ellipsoid.a * f * t**n
        theta = n * (math.radians(lon_deg) - math.radians(self.lon0_deg))
        x = self.false_easting + rho * math.sin(theta)
        y = self.false_northing + rho0 - rho * math.cos(theta)
        return x, y

    def inverse(self, x: float, y: float) -> tuple[float, float]:
        e = self.ellipsoid.e
        n, f, rho0 = self._constants()
        dx = x - self.false_easting
        dy = rho0 - (y - self.false_northing)
        rho = math.copysign(math.hypot(dx, dy), n)
        t = (rho / (self.ellipsoid.a * f)) ** (1 / n)
        # Snyder eq. 14-11: negate both components when n < 0 (south-facing
        # cones); the signs of dx/dy themselves must be preserved.
        sign = 1.0 if n >= 0 else -1.0
        theta = math.atan2(sign * dx, sign * dy)
        lam = theta / n + math.radians(self.lon0_deg)
        phi = math.pi / 2 - 2 * math.atan(t)
        for _ in range(8):
            sin_phi = math.sin(phi)
            phi = math.pi / 2 - 2 * math.atan(
                t * ((1 - e * sin_phi) / (1 + e * sin_phi)) ** (e / 2)
            )
        return math.degrees(lam), math.degrees(phi)


@dataclass(frozen=True)
class WebMercator:
    ellipsoid: Ellipsoid = WGS84
    datum: DatumShift = _NO_SHIFT

    def forward(self, lon_deg: float, lat_deg: float) -> tuple[float, float]:
        a = self.ellipsoid.a
        x = a * math.radians(lon_deg)
        y = a * math.log(math.tan(math.pi / 4 + math.radians(lat_deg) / 2))
        return x, y

    def inverse(self, x: float, y: float) -> tuple[float, float]:
        a = self.ellipsoid.a
        lon = math.degrees(x / a)
        lat = math.degrees(2 * math.atan(math.exp(y / a)) - math.pi / 2)
        return lon, lat


@dataclass(frozen=True)
class Geographic:
    ellipsoid: Ellipsoid = WGS84
    datum: DatumShift = _NO_SHIFT

    def forward(self, lon_deg: float, lat_deg: float) -> tuple[float, float]:
        return lon_deg, lat_deg

    def inverse(self, x: float, y: float) -> tuple[float, float]:
        return x, y


#: National grids by EPSG code. Datum-shift values are the published EPSG
#: ``towgs84`` position-vector parameters for each source datum.
_NATIONAL_GRIDS: dict[int, object] = {
    # Luxembourg 1930 / Gauss (LUREF) — the reference's rss_mersch_A /
    # rss_dudelange_A test rasters (International 1924 ellipsoid).
    2169: TransverseMercator(
        lon0_deg=6.166666666666667,
        lat0_deg=49.833333333333336,
        k0=1.0,
        false_easting=80000.0,
        false_northing=100000.0,
        ellipsoid=INTL1924,
        datum=DatumShift(-193.0, 13.7, -39.3, -0.41, -2.933, 2.688, 0.43),
    ),
    # OSGB 1936 / British National Grid (Airy 1830).
    27700: TransverseMercator(
        lon0_deg=-2.0,
        lat0_deg=49.0,
        k0=0.9996012717,
        false_easting=400000.0,
        false_northing=-100000.0,
        ellipsoid=AIRY1830,
        datum=DatumShift(446.448, -125.157, 542.06, 0.15, 0.247, 0.842, -20.489),
    ),
    # Irish Transverse Mercator (ETRS89/GRS80 — no shift).
    2157: TransverseMercator(
        lon0_deg=-8.0,
        lat0_deg=53.5,
        k0=0.99982,
        false_easting=600000.0,
        false_northing=750000.0,
    ),
    # NZGD2000 / New Zealand Transverse Mercator (GRS80 — no shift).
    2193: TransverseMercator(
        lon0_deg=173.0,
        lat0_deg=0.0,
        k0=0.9996,
        false_easting=1600000.0,
        false_northing=10000000.0,
    ),
}


# ---------------------------------------------------------------------------
# WKT projection-parameter fallback
# ---------------------------------------------------------------------------

import re as _re

_WKT_PARAM_RE = _re.compile(
    r'PARAMETER\s*\[\s*"([^"]+)"\s*,\s*([-+0-9.eE]+)', _re.IGNORECASE
)
_WKT_METHOD_RE = _re.compile(
    r'(?:PROJECTION|METHOD)\s*\[\s*"([^"]+)"', _re.IGNORECASE
)
_WKT_ELLIPSOID_RE = _re.compile(
    r'(?:SPHEROID|ELLIPSOID)\s*\[\s*"[^"]*"\s*,\s*([-+0-9.eE]+)\s*,\s*([-+0-9.eE]+)',
    _re.IGNORECASE,
)
_WKT_TOWGS84_RE = _re.compile(r"TOWGS84\s*\[([^\]]*)\]", _re.IGNORECASE)
_WKT_FOOT_UNIT_RE = _re.compile(r'UNIT\s*\[\s*"[^"]*foot', _re.IGNORECASE)

#: Normalized WKT parameter name -> canonical key.
_WKT_PARAM_KEYS = {
    "latitude of origin": "lat0",
    "latitude of natural origin": "lat0",
    "latitude of center": "lat0",
    "latitude of false origin": "lat0",
    "central meridian": "lon0",
    "longitude of natural origin": "lon0",
    "longitude of center": "lon0",
    "longitude of false origin": "lon0",
    "standard parallel 1": "lat1",
    "latitude of 1st standard parallel": "lat1",
    "standard parallel 2": "lat2",
    "latitude of 2nd standard parallel": "lat2",
    "scale factor": "k0",
    "scale factor at natural origin": "k0",
    "false easting": "fe",
    "easting at false origin": "fe",
    "false northing": "fn",
    "northing at false origin": "fn",
}


def _wkt_norm_name(name: str) -> str:
    return " ".join(name.replace("_", " ").split()).strip().lower()


def _projection_from_wkt(wkt: str, projected: bool | None):
    """Build a projection directly from WKT parameters (no EPSG resolution).

    Covers the methods this module implements (TM/UTM, LCC 2SP, Web
    Mercator, geographic), with the SPHEROID/ELLIPSOID node supplying the
    ellipsoid and a TOWGS84 node (when present) the Helmert datum shift —
    the reference gets the same breadth from rasterio accepting any CRS
    object (reference: ``floodsr/dem_sources/hrdem_stac.py:45-74``).
    Raises ``ValueError`` with a named reason for unsupported methods.
    """
    ell = GRS80
    m = _WKT_ELLIPSOID_RE.search(wkt)
    if m:
        a, inv_f = float(m.group(1)), float(m.group(2))
        # WKT encodes a sphere as inverse-flattening 0; represent it as an
        # (effectively) unflattened ellipsoid.
        ell = Ellipsoid(a, inv_f if inv_f > 0 else 1e12)
    datum = _NO_SHIFT
    m = _WKT_TOWGS84_RE.search(wkt)
    if m:
        vals = [float(v) for v in m.group(1).split(",") if v.strip()][:7]
        vals += [0.0] * (7 - len(vals))
        if any(vals):
            datum = DatumShift(*vals)

    method_match = _WKT_METHOD_RE.search(wkt)
    if method_match is None:
        if projected:
            raise ValueError("projected WKT carries no PROJECTION/METHOD node")
        return Geographic(ellipsoid=ell, datum=datum)
    method = _wkt_norm_name(method_match.group(1))

    params: dict[str, float] = {}
    for name, value in _WKT_PARAM_RE.findall(wkt):
        key = _WKT_PARAM_KEYS.get(_wkt_norm_name(name))
        if key is not None:
            params[key] = float(value)

    if _WKT_FOOT_UNIT_RE.search(wkt):
        raise ValueError(
            "projected WKT uses a foot-based unit; only metre grids are "
            "supported by the built-in projection math"
        )

    if method in (
        "transverse mercator",
        "gauss kruger",
        "gauss-kruger",
    ):
        return TransverseMercator(
            lon0_deg=params.get("lon0", 0.0),
            lat0_deg=params.get("lat0", 0.0),
            k0=params.get("k0", 1.0),
            false_easting=params.get("fe", 0.0),
            false_northing=params.get("fn", 0.0),
            ellipsoid=ell,
            datum=datum,
        )
    if method in (
        "lambert conformal conic 2sp",
        "lambert conic conformal (2sp)",
        "lambert conformal conic",
    ):
        if "lat1" not in params:
            raise ValueError(
                f"WKT LCC ({method!r}) carries no standard parallel parameters"
            )
        return LambertConformalConic2SP(
            lat1_deg=params["lat1"],
            lat2_deg=params.get("lat2", params["lat1"]),
            lat0_deg=params.get("lat0", 0.0),
            lon0_deg=params.get("lon0", 0.0),
            false_easting=params.get("fe", 0.0),
            false_northing=params.get("fn", 0.0),
            ellipsoid=ell,
            datum=datum,
        )
    if method in (
        "popular visualisation pseudo mercator",
        "popular visualisation pseudo-mercator",
        "mercator auxiliary sphere",
    ):
        return WebMercator()
    raise ValueError(
        f"unsupported WKT projection method: {method!r}. Supported from WKT "
        "parameters: Transverse Mercator, Lambert Conformal Conic (2SP), "
        "Popular Visualisation Pseudo Mercator, geographic."
    )


def projection_for(crs: CRS | str | int):
    """Projection for an EPSG code — or, failing that, from WKT parameters.

    Precedence: a recognized EPSG code wins (exact published grid
    definitions); a WKT-only CRS falls back to building the converter from
    its own PROJECTION/PARAMETER/SPHEROID/TOWGS84 nodes. Unsupported
    methods raise with a named reason rather than a parse error.
    """
    crs = CRS.from_user_input(crs)
    code = crs.epsg
    if code is None:
        if crs.wkt:
            try:
                return _projection_from_wkt(crs.wkt, crs.projected)
            except ValueError as err:
                raise ValueError(
                    "DEM-source coordinate transformation could not use this "
                    f"WKT-only CRS: {err}. Re-run with rasters whose CRS "
                    "carries an EPSG authority code or a supported "
                    "projection method, or provide the DEM directly."
                ) from None
        raise ValueError(
            "DEM-source coordinate transformation requires an EPSG-coded CRS "
            f"or projection WKT; got {crs}. Re-run with rasters whose CRS "
            "carries an EPSG authority code, or provide the DEM directly."
        )
    if code in (4326, 4269, 4617, 4258):
        return Geographic()
    if code == 3857:
        return WebMercator()
    if 32601 <= code <= 32660:  # UTM north (WGS84)
        return TransverseMercator(lon0_deg=(code - 32600) * 6 - 183)
    if 32701 <= code <= 32760:  # UTM south
        return TransverseMercator(
            lon0_deg=(code - 32700) * 6 - 183, false_northing=10_000_000.0
        )
    if 26901 <= code <= 26923:  # UTM north (NAD83)
        return TransverseMercator(lon0_deg=(code - 26900) * 6 - 183)
    if 25828 <= code <= 25838:  # UTM north (ETRS89)
        return TransverseMercator(lon0_deg=(code - 25800) * 6 - 183)
    if code in (3978, 3979):  # Canada Atlas Lambert (NAD83 / NAD83 CSRS)
        return LambertConformalConic2SP(
            lat1_deg=49.0, lat2_deg=77.0, lat0_deg=49.0, lon0_deg=-95.0
        )
    if code in _NATIONAL_GRIDS:
        return _NATIONAL_GRIDS[code]
    raise ValueError(
        f"unsupported CRS for coordinate transformation: EPSG:{code}. "
        "Supported: geographic (4326/4269/4617/4258), web mercator (3857), "
        "UTM (326xx/327xx/269xx/258xx), Canada Atlas Lambert (3978/3979), "
        f"national grids {sorted(_NATIONAL_GRIDS)}."
    )


def transform_points(
    src_crs: CRS | str | int,
    dst_crs: CRS | str | int,
    points: list[tuple[float, float]],
) -> list[tuple[float, float]]:
    """Transform (x, y) points from src to dst CRS via WGS84 geographic.

    Datum shifts apply only when a projection declares one (the GRS80/WGS84
    family is treated as coincident, standard at meter-level accuracy).
    """
    src = projection_for(src_crs)
    dst = projection_for(dst_crs)
    out = []
    for x, y in points:
        lon, lat = src.inverse(x, y)
        if src.datum is not _NO_SHIFT:
            lon, lat = src.datum.geodetic_to_wgs84(lon, lat, src.ellipsoid)
        if dst.datum is not _NO_SHIFT:
            lon, lat = dst.datum.wgs84_to_geodetic(lon, lat, dst.ellipsoid)
        out.append(dst.forward(lon, lat))
    return out


def transform_bounds(
    src_crs: CRS | str | int,
    dst_crs: CRS | str | int,
    left: float,
    bottom: float,
    right: float,
    top: float,
    densify_pts: int = 21,
) -> tuple[float, float, float, float]:
    """Transform bounds with edge densification (pyproj/rasterio convention)."""
    assert densify_pts >= 2, "densify_pts must be >= 2"
    points: list[tuple[float, float]] = []
    for i in range(densify_pts + 1):
        f = i / densify_pts
        x = left + f * (right - left)
        points.append((x, bottom))
        points.append((x, top))
        y = bottom + f * (top - bottom)
        points.append((left, y))
        points.append((right, y))
    transformed = transform_points(src_crs, dst_crs, points)
    xs = [p[0] for p in transformed]
    ys = [p[1] for p in transformed]
    return (min(xs), min(ys), max(xs), max(ys))
