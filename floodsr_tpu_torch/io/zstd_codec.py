"""ZSTD (de)compression via a ctypes binding to the system ``libzstd``.

Modern GDAL COGs are commonly written with ``COMPRESS=ZSTD`` (TIFF
compression tag 50000) — including cloud DEM mosaics of the kind the HRDEM
fetcher reads remotely. CPython 3.12 has no stdlib zstd and this project
vendors no third-party wheels, but ``libzstd`` ships with the OS; one-shot
``ZSTD_compress``/``ZSTD_decompress`` through ctypes covers the TIFF-chunk
use case exactly (chunk sizes are known up front on both sides).

Degrades cleanly: :func:`available` is False when the shared library cannot
be loaded, and the TIFF codec then raises a targeted error naming the
missing capability instead of a generic unsupported-compression one.

Reference role: the reference gets ZSTD support for free through
rasterio/GDAL (``floodsr/io/rasterio_io.py:4-14`` rides GDAL's codec
table); this module is that capability's self-contained equivalent.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_lib = None
_load_failed = False


def _load():
    """Resolve libzstd lazily; cache the handle (or the failure)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    name = ctypes.util.find_library("zstd")
    candidates = [name] if name else []
    candidates += ["libzstd.so.1", "libzstd.so", "libzstd.dylib"]
    for cand in candidates:
        if not cand:
            continue
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        try:
            lib.ZSTD_compressBound.restype = ctypes.c_size_t
            lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            lib.ZSTD_compress.restype = ctypes.c_size_t
            lib.ZSTD_compress.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_int,
            ]
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t,
            ]
        except AttributeError:
            continue
        _lib = lib
        return _lib
    _load_failed = True
    return None


def available() -> bool:
    return _load() is not None


def compress(data: bytes, level: int = 9) -> bytes:
    """One-shot ZSTD frame compression (level 9 ≈ GDAL's ZSTD_LEVEL default)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libzstd is not available on this system")
    src = bytes(data)
    bound = lib.ZSTD_compressBound(len(src))
    dst = ctypes.create_string_buffer(bound)
    n = lib.ZSTD_compress(dst, bound, src, len(src), int(level))
    if lib.ZSTD_isError(n):
        raise ValueError(f"ZSTD_compress failed (code {n})")
    return dst.raw[:n]


def decompress(data: bytes, expected: int) -> bytes:
    """One-shot decompression of a frame whose decoded size is known.

    ``expected`` is the TIFF chunk's uncompressed byte count; a frame
    decoding to more than that is an error (corrupt stream), decoding to
    less returns the short result for the caller's existing short-chunk
    handling.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("libzstd is not available on this system")
    src = bytes(data)
    dst = ctypes.create_string_buffer(max(1, int(expected)))
    n = lib.ZSTD_decompress(dst, int(expected), src, len(src))
    if lib.ZSTD_isError(n):
        raise ValueError(f"ZSTD_decompress failed (corrupt or oversized frame, code {n})")
    return dst.raw[:n]
