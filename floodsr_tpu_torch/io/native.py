"""ctypes loader for the optional C++ TIFF codec fast path.

The native library (``floodsr_tpu_torch/io/_native/libfloodsr_tiff.so``) implements
TIFF-variant LZW encode/decode — the CPU-bound part of raster I/O that GDAL's
C++ core provides in the reference stack. When absent (not yet built on this
machine) the pure-Python codec in :mod:`floodsr_tpu_torch.io.tiff` is used instead.
Build with: ``python -m floodsr_tpu_torch.io.build_native`` (uses g++).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

_LIB_PATH = Path(__file__).parent / "_native" / "libfloodsr_tiff.so"
_lib: ctypes.CDLL | None = None
_load_failed = False   # terminal: the .so exists but dlopen rejected it
_build_failed = False  # non-terminal: skip re-running g++, still load if the .so appears


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    src = _LIB_PATH.parent / "tiff_codec.cc"
    if not _LIB_PATH.exists():
        # First use on a fresh checkout: build on demand when the source is
        # present (one g++ compile buys the native codec fast path —
        # without this, every fresh install silently runs the pure-Python
        # LZW encoder, far slower on a scene). A failed build is
        # NOT terminal for the process: the library may still appear later
        # (g++ installed, another worker builds it) and the exists() check
        # above will load it then — but don't re-run the multi-second g++
        # attempt on every call.
        global _build_failed
        if not src.exists():
            return None
        if _build_failed:
            return None
        from floodsr_tpu_torch.io.build_native import build

        if build(verbose=False, src_dir=_LIB_PATH.parent) is None:
            _build_failed = True
            return None
    if src.exists() and _LIB_PATH.stat().st_mtime < src.stat().st_mtime:
        # Stale binary (source newer than the build): rebuild rather than
        # load a library with potentially fixed bugs still in it. A rebuild
        # failure (no g++ at runtime, read-only install, or mere mtime skew
        # from copy ordering) is NOT terminal: the existing .so may be
        # perfectly valid, so fall through and load it — decode already has
        # a lenient-Python fallback for the one known stale-binary bug.
        from floodsr_tpu_torch.io.build_native import build

        build(verbose=False, src_dir=_LIB_PATH.parent)
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        c_ll = ctypes.c_longlong
        c_llp = ctypes.POINTER(ctypes.c_longlong)
        c_ubp = ctypes.POINTER(ctypes.c_ubyte)
        lib.fsr_lzw_decode.restype = c_ll
        lib.fsr_lzw_decode.argtypes = [ctypes.c_char_p, c_ll, ctypes.c_char_p, c_ll]
        lib.fsr_lzw_encode_bound.restype = c_ll
        lib.fsr_lzw_encode_bound.argtypes = [c_ll]
        lib.fsr_lzw_encode.restype = c_ll
        lib.fsr_lzw_encode.argtypes = [ctypes.c_char_p, c_ll, ctypes.c_char_p, c_ll]
        # Strip-batch + predictor entry points are absent from pre-round-4
        # builds; probe so a stale-but-valid library still serves the
        # one-chunk paths.
        try:
            lib.fsr_lzw_decode_strips.restype = c_ll
            lib.fsr_lzw_decode_strips.argtypes = [
                ctypes.c_char_p, c_ll, c_llp, c_llp, c_llp, c_ll,
                c_ll, ctypes.c_int, ctypes.c_int, c_ubp, c_ll, ctypes.c_int,
            ]
            lib.fsr_lzw_encode_strips.restype = c_ll
            lib.fsr_lzw_encode_strips.argtypes = [
                c_ubp, c_ll, c_ll, c_ll,
                c_ll, ctypes.c_int, ctypes.c_int, ctypes.c_char_p, c_ll, c_llp,
                ctypes.c_int,
            ]
            for name in ("fsr_predictor2_undo", "fsr_predictor2_apply"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [c_ubp, c_ll, c_ll, ctypes.c_int]
            for name in ("fsr_predictor3_undo", "fsr_predictor3_apply"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [c_ubp, c_ubp, c_ll, c_ll, ctypes.c_int]
            lib._fsr_has_strips = True
        except AttributeError:
            lib._fsr_has_strips = False
        # The one-pass dequant + encode is absent from earlier builds.
        try:
            lib.fsr_dequant_encode_begin.restype = ctypes.c_void_p
            lib.fsr_dequant_encode_begin.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, c_ll, c_ll, ctypes.c_float,
                c_ll, ctypes.c_int, ctypes.c_void_p, c_ll, c_ll, c_llp, ctypes.c_int,
            ]
            lib.fsr_dequant_encode_wait.restype = c_ll
            lib.fsr_dequant_encode_wait.argtypes = [ctypes.c_void_p, c_ll]
            lib.fsr_dequant_encode_end.restype = c_ll
            lib.fsr_dequant_encode_end.argtypes = [ctypes.c_void_p]
            lib._fsr_has_dequant_encode = True
        except AttributeError:
            lib._fsr_has_dequant_encode = False
        _lib = lib
    except OSError:
        _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


class NativeLzwOverflow(ValueError):
    """Native decode code -2: output exceeded the exact-size buffer.

    Distinct from corruption (code -1) so callers can fall back to the
    lenient Python decoder ONLY for the known legacy-encoder overflow case
    (one spurious code before EOI) while letting corrupt streams propagate.
    """


def lzw_decode(data: bytes, expected_size: int) -> bytes:
    lib = _load()
    assert lib is not None, "native codec not available"
    # expected_size is exact for interior chunks; final strips may decode to
    # exactly expected_size too (callers pass the true uncompressed size).
    out = ctypes.create_string_buffer(expected_size)
    n = lib.fsr_lzw_decode(data, len(data), out, expected_size)
    if n == -2:
        raise NativeLzwOverflow("native LZW decode overflowed the output buffer")
    if n < 0:
        raise ValueError(f"native LZW decode failed with code {n}")
    return out.raw[:n]


def lzw_encode(data: bytes) -> bytes:
    lib = _load()
    assert lib is not None, "native codec not available"
    bound = lib.fsr_lzw_encode_bound(len(data))
    out = ctypes.create_string_buffer(bound)
    n = lib.fsr_lzw_encode(data, len(data), out, bound)
    if n < 0:
        raise ValueError(f"native LZW encode failed with code {n}")
    return out.raw[:n]


def strips_available() -> bool:
    """Whether the loaded library has the strip-batch + predictor entries."""
    lib = _load()
    return lib is not None and getattr(lib, "_fsr_has_strips", False)


def dequant_encode_available() -> bool:
    """Whether the loaded library has the one-pass dequant + encode."""
    lib = _load()
    return lib is not None and getattr(lib, "_fsr_has_dequant_encode", False)


def default_codec_threads() -> int:
    """Worker threads for strip-batch codec calls.

    Strips are independent, so encode/decode parallelize across host cores
    (the C++ releases the GIL via ctypes). Single-core hosts stay on the
    sequential path. Override with FLOODSR_CODEC_THREADS.
    """
    import os

    env = os.environ.get("FLOODSR_CODEC_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(8, os.cpu_count() or 1))


def lzw_decode_strips(
    file_bytes,
    offsets,
    counts,
    out_bytes,
    *,
    cols: int,
    itemsize: int,
    predictor: int,
    dst,
    threads: int | None = None,
) -> None:
    """Decode a whole striped LZW image into ``dst`` (1-D uint8 view).

    One native call replaces the per-strip Python loop: LZW decode,
    predictor undo (2/3) and destination assembly all happen in C++.
    ``dst`` must be a C-contiguous writable uint8 array sized to the sum of
    ``out_bytes``. Sparse strips (count 0) zero-fill. Strips decode in
    parallel on multi-core hosts (disjoint destination regions).
    """
    import numpy as np

    lib = _load()
    assert lib is not None and lib._fsr_has_strips, "native strips not available"
    offsets = np.ascontiguousarray(offsets, np.int64)
    counts = np.ascontiguousarray(counts, np.int64)
    out_sizes = np.ascontiguousarray(out_bytes, np.int64)
    c_llp = ctypes.POINTER(ctypes.c_longlong)
    n = lib.fsr_lzw_decode_strips(
        file_bytes, len(file_bytes),
        offsets.ctypes.data_as(c_llp), counts.ctypes.data_as(c_llp),
        out_sizes.ctypes.data_as(c_llp), len(offsets),
        cols, itemsize, predictor,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), dst.nbytes,
        threads if threads is not None else default_codec_threads(),
    )
    if n == -2:
        raise NativeLzwOverflow("native strip decode over/underflowed a strip")
    if n < 0:
        raise ValueError(f"native strip decode failed with code {n}")
    if n != int(out_sizes.sum()):
        raise ValueError("native strip decode wrote unexpected byte count")


def lzw_encode_strips(
    src,
    *,
    strip_bytes: int,
    n_strips: int,
    cols: int,
    itemsize: int,
    predictor: int,
    threads: int | None = None,
) -> tuple[bytes, list[int]]:
    """Encode a contiguous array as LZW strips in one native call.

    ``src`` is a C-contiguous uint8 view of the sample data (little-endian).
    Returns the packed strip bytes and per-strip encoded sizes. Strips
    encode in parallel on multi-core hosts (byte-identical payloads —
    per-strip streams are deterministic).
    """
    import numpy as np

    lib = _load()
    assert lib is not None and lib._fsr_has_strips, "native strips not available"
    n_threads = threads if threads is not None else default_codec_threads()
    # The threaded path writes into bounded per-strip regions first.
    per_strip_bound = strip_bytes + (strip_bytes >> 1) + 64
    bound = max(
        lib.fsr_lzw_encode_bound(src.nbytes) + 64 * n_strips,
        per_strip_bound * n_strips,
    )
    # np.empty, NOT a ctypes string buffer: zero-filling ~1.5x the input
    # size per call measurably erased the batch path's win.
    out = np.empty(bound, np.uint8)
    sizes = np.zeros(n_strips, np.int64)
    n = lib.fsr_lzw_encode_strips(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), src.nbytes,
        strip_bytes, n_strips, cols, itemsize, predictor,
        out.ctypes.data_as(ctypes.c_char_p), bound,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        n_threads,
    )
    if n < 0:
        raise ValueError(f"native strip encode failed with code {n}")
    return out[:n], [int(v) for v in sizes]


class DequantEncodePass:
    """A whole image's uint16 codes dequantized and LZW-encoded in one native
    pass over the codec threads.

    Each of :func:`default_codec_threads` threads takes the next strip of
    ``rows_per_strip`` rows from a shared counter, writes ``float32(code) *
    float32(step)`` into ``dst`` for those rows (bit for bit
    ``codes.astype(np.float32) * np.float32(step)``), then applies
    ``predictor`` (1 or 3) and encodes them from ``dst``: strip ``s``'s payload
    equals :func:`lzw_encode_strips`'s for ``dst``. ``codes`` is a 2-D uint16
    array, ``dst`` a C-contiguous float32 array of its shape.

    The threads start on construction. :meth:`wait` blocks (the interpreter
    lock released) until the leading strips are encoded, :meth:`strip` is an
    encoded strip's payload, and :meth:`close` (or leaving the ``with``
    block) stops the threads and joins them. ``dst`` is complete only after a
    close that follows a :meth:`wait` for every strip.
    """

    def __init__(
        self,
        codes,
        step: float,
        dst,
        *,
        rows_per_strip: int,
        predictor: int = 1,
    ):
        import numpy as np

        lib = _load()
        assert lib is not None and lib._fsr_has_dequant_encode, (
            "native dequant + encode not available"
        )
        codes = np.ascontiguousarray(codes)
        if codes.ndim != 2 or codes.dtype != np.uint16:
            raise ValueError(f"codes must be 2-D uint16, got {codes.dtype} {codes.shape}")
        if (
            dst.dtype != np.float32
            or dst.shape != codes.shape
            or not dst.flags.c_contiguous
            or not dst.flags.writeable
        ):
            raise ValueError("dst must be a writable C-contiguous float32 array of codes' shape")
        if rows_per_strip < 1 or predictor not in (1, 3) or codes.size == 0:
            raise ValueError(
                f"bad pass: rows_per_strip={rows_per_strip} predictor={predictor} "
                f"shape={codes.shape}"
            )
        rows, cols = codes.shape
        self.n_strips = -(-rows // int(rows_per_strip))
        strip_bytes = int(rows_per_strip) * cols * 4
        self._strip_cap = strip_bytes + (strip_bytes >> 1) + 64  # LZW's bound
        self._lib = lib
        # the native threads read and write these until close()
        self._codes, self._dst = codes, dst
        self._out = np.empty(self.n_strips * self._strip_cap, np.uint8)
        self.counts = np.zeros(self.n_strips, np.int64)
        self._handle = lib.fsr_dequant_encode_begin(
            codes.ctypes.data, dst.ctypes.data, rows, cols,
            float(np.float32(step)), int(rows_per_strip), int(predictor),
            self._out.ctypes.data, self._out.nbytes, self._strip_cap,
            self.counts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            default_codec_threads(),
        )
        if not self._handle:
            raise ValueError("native dequant + encode rejected its arguments")

    def wait(self, k: int) -> int:
        """Block until strips ``0..k-1`` are encoded; returns how many leading
        strips are (``k`` or more). Raises when a strip failed."""
        n = self._lib.fsr_dequant_encode_wait(self._handle, int(k))
        if n < 0:
            raise ValueError(f"native dequant + encode failed with code {n}")
        return int(n)

    def strip(self, s: int):
        """Strip ``s``'s encoded payload (a uint8 view), once :meth:`wait`
        has covered it."""
        start = s * self._strip_cap
        return self._out[start : start + int(self.counts[s])]

    def close(self) -> None:
        """Stop and join the threads, and free the strips' buffer."""
        if self._handle:
            handle, self._handle = self._handle, None
            self._lib.fsr_dequant_encode_end(handle)
            self._out = None

    def __enter__(self) -> "DequantEncodePass":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


def _predictor_rows_args(arr):
    """(ptr, rows, cols, itemsize) for a 2-D [rows, cols*samples] view."""
    ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
    return ptr, arr.shape[0], arr.shape[1], arr.dtype.itemsize


def predictor2_undo(arr) -> None:
    """In-place horizontal-difference undo on [rows, cols] integer samples."""
    lib = _load()
    assert lib is not None and lib._fsr_has_strips
    rc = lib.fsr_predictor2_undo(*_predictor_rows_args(arr))
    if rc < 0:
        raise ValueError(f"native predictor2 undo failed with code {rc}")


def predictor2_apply(arr) -> None:
    lib = _load()
    assert lib is not None and lib._fsr_has_strips
    rc = lib.fsr_predictor2_apply(*_predictor_rows_args(arr))
    if rc < 0:
        raise ValueError(f"native predictor2 apply failed with code {rc}")


def predictor3_undo(src, dst) -> None:
    """Float predictor undo: plane bytes [rows, cols*itemsize] -> LE samples."""
    lib = _load()
    assert lib is not None and lib._fsr_has_strips
    ptr_in = src.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
    ptr_out = dst.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
    itemsize = dst.dtype.itemsize
    rows, cols = dst.shape[0], dst.shape[1]
    rc = lib.fsr_predictor3_undo(ptr_in, ptr_out, rows, cols, itemsize)
    if rc < 0:
        raise ValueError(f"native predictor3 undo failed with code {rc}")


def predictor3_apply(src, dst) -> None:
    """Float predictor apply: LE samples [rows, cols] -> plane-diff bytes."""
    lib = _load()
    assert lib is not None and lib._fsr_has_strips
    ptr_in = src.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
    ptr_out = dst.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
    itemsize = src.dtype.itemsize
    rows, cols = src.shape[0], src.shape[1]
    rc = lib.fsr_predictor3_apply(ptr_in, ptr_out, rows, cols, itemsize)
    if rc < 0:
        raise ValueError(f"native predictor3 apply failed with code {rc}")
