"""The benchmark's own single-band float32 GeoTIFF reader and writer.

Strips, no predictor; the writer compresses with LZW (compression 5), the
reader takes LZW or none; north-up georeferencing
by ModelPixelScale and ModelTiepoint, a projected EPSG code in the
GeoKeyDirectory and GDAL's nodata tag. The writer makes the benchmark's
inputs; the reader reads the program's outputs for the comparison. LZW runs
in ``lzw.c``, built with the C compiler into ``perfbench/_build/`` at first
use. Nothing here imports the program.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).with_name("lzw.c")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LIB = BUILD_DIR / "libpblzw.so"
_lib = None
_lock = threading.Lock()

# Tags.
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS = 273, 277, 278, 279
PLANAR, PREDICTOR, TILE_WIDTH, SAMPLE_FORMAT = 284, 317, 322, 339
PIXEL_SCALE, TIEPOINT, GEOKEYS, GDAL_NODATA = 33550, 33922, 34735, 42113
_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 11: "f", 12: "d", 16: "Q"}
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 11: 4, 12: 8, 16: 8}


def codec() -> ctypes.CDLL:
    """The LZW library, built at its first use in a checkout."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f".libpblzw.{os.getpid()}.so"
            subprocess.run(
                ["cc", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                check=True, capture_output=True,
            )
            tmp.replace(_LIB)
        lib = ctypes.CDLL(str(_LIB))
        for name in ("pb_lzw_encode", "pb_lzw_decode"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_longlong
            fn.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
        _lib = lib
        return lib


def lzw_encode(data: bytes) -> bytes:
    cap = len(data) * 3 // 2 + 64
    out = ctypes.create_string_buffer(cap)
    n = codec().pb_lzw_encode(data, len(data), out, cap)
    if n < 0:
        raise RuntimeError("LZW encode overflowed its buffer")
    return out.raw[:n]


def lzw_decode(data: bytes, expected: int) -> bytes:
    out = ctypes.create_string_buffer(expected)
    n = codec().pb_lzw_decode(data, len(data), out, expected)
    if n != expected:
        raise ValueError(f"LZW strip decoded to {n} bytes, expected {expected}")
    return out.raw


def _geokeys(epsg: int) -> tuple[int, ...]:
    # version 1.1.0, three keys: projected model, pixel is area, the EPSG code
    return (1, 1, 0, 3, 1024, 0, 1, 1, 1025, 0, 1, 1, 3072, 0, 1, int(epsg))


def write_geotiff(
    fp: Path, arr: np.ndarray, *, west: float, north: float, res: float, epsg: int,
    nodata: float | None = -9999.0, rows_per_strip: int = 16,
) -> int:
    """Write ``arr`` (2-D float32) as an LZW north-up GeoTIFF; returns the bytes written."""
    arr = np.ascontiguousarray(arr, dtype="<f4")
    h, w = arr.shape
    strips = []
    for r in range(0, h, rows_per_strip):
        raw = arr[r : r + rows_per_strip].tobytes()
        strips.append(lzw_encode(raw))
    tags = [
        (WIDTH, 4, (w,)), (LENGTH, 4, (h,)), (BITS, 3, (32,)),
        (COMPRESSION, 3, (5,)), (PHOTOMETRIC, 3, (1,)),
        (STRIP_OFFSETS, 4, (0,) * len(strips)), (SAMPLES, 3, (1,)),
        (ROWS_PER_STRIP, 4, (rows_per_strip,)),
        (STRIP_COUNTS, 4, tuple(len(s) for s in strips)), (PLANAR, 3, (1,)),
        (SAMPLE_FORMAT, 3, (3,)), (PIXEL_SCALE, 12, (res, res, 0.0)),
        (TIEPOINT, 12, (0.0, 0.0, 0.0, west, north, 0.0)),
        (GEOKEYS, 3, _geokeys(epsg)),
    ]
    if nodata is not None:
        text = str(int(nodata)) if float(nodata).is_integer() else repr(float(nodata))
        tags.append((GDAL_NODATA, 2, text.encode() + b"\0"))
    tags.sort()
    # Layout: header, IFD, out-of-line tag values, strips.
    values_at = 8 + 2 + 12 * len(tags) + 4
    blobs, entries = [], []
    for tag, typ, vals in tags:
        payload = vals if typ == 2 else struct.pack(f"<{len(vals)}{_TYPES[typ]}", *vals)
        entries.append([tag, typ, len(vals), payload])
    strips_at = values_at + sum(len(e[3]) + (len(e[3]) & 1) for e in entries if len(e[3]) > 4)
    offsets, pos = [], strips_at
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    for e in entries:
        if e[0] == STRIP_OFFSETS:
            e[3] = struct.pack(f"<{len(offsets)}I", *offsets)
    out = bytearray(b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", len(entries)))
    cursor = values_at
    for tag, typ, count, payload in entries:
        if len(payload) <= 4:
            out += struct.pack("<HHI", tag, typ, count) + payload.ljust(4, b"\0")
        else:
            out += struct.pack("<HHII", tag, typ, count, cursor)
            blobs.append(payload + (b"\0" if len(payload) & 1 else b""))
            cursor += len(blobs[-1])
    out += struct.pack("<I", 0)
    for b in blobs:
        out += b
    assert len(out) == strips_at
    with open(fp, "wb") as f:
        f.write(out)
        for s in strips:
            f.write(s)
    return pos


def _tags(data: bytes) -> dict[int, tuple]:
    if data[:4] != b"II*\0":
        raise ValueError("not a little-endian classic TIFF")
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    tags = {}
    for i in range(n):
        tag, typ, count, raw = struct.unpack_from("<HHI4s", data, ifd + 2 + 12 * i)
        size = _SIZES[typ] * count
        blob = raw if size <= 4 else data[struct.unpack("<I", raw)[0] :][:size]
        if typ == 2:
            tags[tag] = (blob[:size].rstrip(b"\0").decode(),)
        else:
            n_vals = count * (2 if typ == 5 else 1)
            tags[tag] = struct.unpack_from(f"<{n_vals}{_TYPES[typ][0]}", blob)
    return tags


def read_geotiff(fp: Path) -> tuple[np.ndarray, dict]:
    """``(array, profile)``: the float32 raster and ``{height, width, west,
    north, res_x, res_y, epsg, nodata}``."""
    data = Path(fp).read_bytes()
    t = _tags(data)
    h, w = t[LENGTH][0], t[WIDTH][0]
    if t.get(SAMPLES, (1,))[0] != 1 or t[BITS][0] != 32 or t.get(SAMPLE_FORMAT, (1,))[0] != 3:
        raise ValueError("not a single-band float32 raster")
    if TILE_WIDTH in t or t.get(PREDICTOR, (1,))[0] != 1:
        raise ValueError("tiled layouts and predictors are not read here")
    comp = t.get(COMPRESSION, (1,))[0]
    rows = t.get(ROWS_PER_STRIP, (h,))[0]
    out = bytearray()
    for k, (off, cnt) in enumerate(zip(t[STRIP_OFFSETS], t[STRIP_COUNTS])):
        expected = min(rows, h - k * rows) * w * 4
        chunk = data[off : off + cnt]
        if comp == 5:
            out += lzw_decode(chunk, expected)
        elif comp == 1:
            out += chunk[:expected]
        else:
            raise ValueError(f"compression {comp} is not read here")
    arr = np.frombuffer(bytes(out), "<f4").reshape(h, w).astype(np.float32)
    keys = t.get(GEOKEYS, ())
    epsg = None
    for i in range(4, len(keys), 4):
        if keys[i] == 3072:
            epsg = keys[i + 3]
    sx, sy = t[PIXEL_SCALE][:2]
    _, _, _, x, y, _ = t[TIEPOINT][:6]
    nodata = float(t[GDAL_NODATA][0]) if GDAL_NODATA in t else None
    return arr, {
        "height": h, "width": w, "west": x, "north": y, "res_x": sx, "res_y": sy,
        "epsg": epsg, "nodata": nodata,
    }
