"""Self-contained TIFF codec (classic TIFF, single-IFD raster focus).

This replaces the role GDAL's C++ raster I/O plays in the reference
(reference: ``floodsr/io/rasterio_io.py``, ``floodsr/preprocessing.py:247-282``)
— the image does not ship rasterio, so floodsr-tpu carries its own codec:

- read: striped and tiled layouts; uncompressed, LZW, Deflate/zlib, PackBits,
  ZSTD (via :mod:`floodsr_tpu_torch.io.zstd_codec` when libzstd is present);
  horizontal (2) and floating-point (3) predictors; II/MM byte orders; all
  numeric sample formats; GDAL-style sparse chunks (zero byte count → zeros).
- write: little-endian, striped or tiled, uncompressed / LZW / Deflate /
  PackBits / ZSTD, optional predictors — horizontal (2, integer data) and
  floating-point byte-split (3, float data).

A C++ fast path for LZW + predictor lives in ``floodsr_tpu_torch/io/_native`` and is
used automatically when built (see :mod:`floodsr_tpu_torch.io.native`); this module
is the always-available pure-Python reference implementation.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from floodsr_tpu_torch.io import native as _native


# TIFF tag ids used by this codec.
TAG_NEW_SUBFILE_TYPE = 254  # bit 0: reduced-resolution (overview) page
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_PLANAR_CONFIG = 284
TAG_PREDICTOR = 317
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_SAMPLE_FORMAT = 339

COMPRESSION_NONE = 1
COMPRESSION_LZW = 5
COMPRESSION_DEFLATE_ADOBE = 8
COMPRESSION_DEFLATE_OLD = 32946
COMPRESSION_PACKBITS = 32773
COMPRESSION_ZSTD = 50000  # GDAL COMPRESS=ZSTD (libtiff registered code)

SAMPLEFORMAT_UINT = 1
SAMPLEFORMAT_INT = 2
SAMPLEFORMAT_IEEEFP = 3

# TIFF field types: id -> (struct char, size)
_FIELD_TYPES = {
    1: ("B", 1),   # BYTE
    2: ("s", 1),   # ASCII
    3: ("H", 2),   # SHORT
    4: ("I", 4),   # LONG
    5: ("II", 8),  # RATIONAL
    6: ("b", 1),   # SBYTE
    8: ("h", 2),   # SSHORT
    9: ("i", 4),   # SLONG
    11: ("f", 4),  # FLOAT
    12: ("d", 8),  # DOUBLE
    16: ("Q", 8),  # LONG8 (BigTIFF)
    17: ("q", 8),  # SLONG8 (BigTIFF)
    18: ("Q", 8),  # IFD8 (BigTIFF)
}

#: classic-TIFF offsets overflow past this; auto-switch to BigTIFF above it.
_CLASSIC_TIFF_LIMIT = (1 << 32) - (1 << 16)
# Hard ceiling for any 32-bit file offset in a classic container (close()
# checks real offsets against it; module-level so tests can shrink it).
_MAX_CLASSIC_OFFSET = (1 << 32) - 1

_LZW_CLEAR = 256
_LZW_EOI = 257


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


def lzw_decode(data: bytes) -> bytes:
    """Decode a TIFF-variant LZW stream (MSB-first codes, early width change)."""
    out = bytearray()
    nbits = len(data) * 8
    bitpos = 0
    width = 9
    table: list[bytes] = []
    prev: bytes | None = None

    base = [bytes([i]) for i in range(256)] + [b"", b""]

    def reset() -> None:
        nonlocal table, width
        table = list(base)
        width = 9

    reset()
    while bitpos + width <= nbits:
        byte_idx = bitpos >> 3
        chunk = int.from_bytes(data[byte_idx : byte_idx + 4].ljust(4, b"\0"), "big")
        code = (chunk >> (32 - (bitpos & 7) - width)) & ((1 << width) - 1)
        bitpos += width
        if code == _LZW_EOI:
            break
        if code == _LZW_CLEAR:
            reset()
            prev = None
            continue
        if prev is None:
            if code >= len(table):
                raise ValueError(
                    f"corrupt LZW stream: code {code} beyond table {len(table)}"
                )
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"corrupt LZW stream: code {code} beyond table {len(table)}")
        out += entry
        prev = entry
        # TIFF early change (libtiff/GDAL/PIL convention): decoder widens as
        # soon as the table reaches 2^width - 1 entries.
        if len(table) == (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def lzw_encode(data: bytes) -> bytes:
    """Encode bytes as a TIFF-variant LZW stream."""
    out = bytearray()
    bitbuf = 0
    bitcnt = 0

    def emit(code: int, width: int) -> None:
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << width) | code
        bitcnt += width
        while bitcnt >= 8:
            bitcnt -= 8
            out.append((bitbuf >> bitcnt) & 0xFF)

    table: dict[tuple[int, int], int] = {}
    next_code = 258
    width = 9
    emit(_LZW_CLEAR, width)
    w = -1
    for b in data:
        if w < 0:
            w = b
            continue
        key = (w, b)
        code = table.get(key)
        if code is not None:
            w = code
            continue
        emit(w, width)
        table[key] = next_code
        next_code += 1
        # Encoder runs one table entry ahead of the decoder, so it widens at
        # 2^width (decoder widens at 2^width - 1): both flip before the same code.
        if next_code == (1 << width) and width < 12:
            width += 1
        if next_code == 4094:
            emit(_LZW_CLEAR, width)
            table.clear()
            next_code = 258
            width = 9
        w = b
    if w >= 0:
        emit(w, width)
        # Endgame early-change: on receiving this final code the decoder adds
        # its deferred table entry (catching up to next_code) and widens when
        # that lands on 2^width - 1 — EOI must then be emitted at the NEW
        # width or the decoder misreads a spurious code before EOI (found by
        # the window-reader differential fuzz on a 2048-byte tile whose last
        # code pushed the decoder to 2047 entries).
        if next_code == (1 << width) - 1 and width < 12:
            width += 1
    emit(_LZW_EOI, width)
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def packbits_decode(data: bytes) -> bytes:
    """Decode PackBits run-length encoding (read-only support)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        header = data[i]
        i += 1
        if header < 128:
            count = header + 1
            out += data[i : i + count]
            i += count
        elif header > 128:
            count = 257 - header
            out += data[i : i + 1] * count
            i += 1
        # header == 128: no-op
    return bytes(out)


def packbits_encode(data: bytes, row_bytes: int | None = None) -> bytes:
    """Encode PackBits run-length encoding (TIFF 6.0 §9).

    Rows are packed independently (``row_bytes`` = uncompressed bytes per
    row) as the spec requires; ``None`` packs the whole buffer as one row
    (the stream is self-delimiting, so decoders — including ours — accept
    either). Replicate runs are emitted at length >= 3; 2-byte runs fold
    into literals (the spec's own recommendation). Compatibility codec, not
    a throughput path — LZW/ZSTD are the performance writers.
    """
    if row_bytes is None or row_bytes <= 0:
        row_bytes = len(data)
    arr = np.frombuffer(data, np.uint8)
    out = bytearray()

    def emit_literals(row_b: bytes, s: int, e: int) -> None:
        while s < e:
            take = min(e - s, 128)
            out.append(take - 1)
            out.extend(row_b[s : s + take])
            s += take

    for r0 in range(0, len(arr), row_bytes):
        row = arr[r0 : r0 + row_bytes]
        n = len(row)
        if n == 0:
            continue
        row_b = row.tobytes()
        change = np.flatnonzero(row[1:] != row[:-1]) + 1
        starts = np.concatenate(([0], change))
        ends = np.concatenate((change, [n]))
        runs = ends - starts
        big = np.flatnonzero(runs >= 3)
        cursor = 0
        for k in big:
            s, e = int(starts[k]), int(ends[k])
            if cursor < s:
                emit_literals(row_b, cursor, s)
            count = e - s
            value = row_b[s]
            while count > 0:
                take = min(count, 128)
                if take == 1:  # 1-byte tail: literal (header 0), not a run
                    out.append(0)
                else:
                    out.append((257 - take) & 0xFF)
                out.append(value)
                count -= take
            cursor = e
        if cursor < n:
            emit_literals(row_b, cursor, n)
    return bytes(out)


def _apply_predictor_decode(raw: np.ndarray, predictor: int) -> np.ndarray:
    """Undo TIFF predictor on a decoded [rows, cols, samples] chunk."""
    if predictor == 1:
        return raw
    if predictor == 2:
        acc_dtype = raw.dtype
        return np.cumsum(raw.astype(np.int64), axis=1).astype(acc_dtype)
    if predictor == 3:
        # Floating-point predictor: bytes were split into per-position planes
        # (big-endian order) and horizontally differenced.
        rows, cols, samples = raw.shape
        itemsize = raw.dtype.itemsize
        b = raw.view(np.uint8).reshape(rows, cols * samples * itemsize)
        b = np.cumsum(b.astype(np.uint16), axis=1).astype(np.uint8)
        planes = b.reshape(rows, itemsize, cols * samples)
        interleaved = np.transpose(planes, (0, 2, 1)).copy()  # big-endian bytes
        be = np.dtype(raw.dtype).newbyteorder(">")
        return (
            interleaved.reshape(rows, cols * samples * itemsize)
            .view(be)
            .astype(raw.dtype)
            .reshape(rows, cols, samples)
        )
    raise ValueError(f"unsupported TIFF predictor: {predictor}")


def _apply_predictor_encode(chunk: np.ndarray, predictor: int) -> np.ndarray:
    """Apply TIFF predictor before compression on [rows, cols, samples]."""
    if predictor == 1:
        return chunk
    if predictor == 2:
        if chunk.dtype.kind not in "ui":
            # Decode reverses predictor 2 with an integer cumsum; float data
            # would round-trip lossily. The spec pairs 2 with integers.
            raise ValueError("TIFF predictor 2 requires integer samples")
        out = chunk.copy()
        out[:, 1:] = chunk[:, 1:] - chunk[:, :-1]
        return out
    if predictor == 3:
        if chunk.dtype.kind != "f":
            raise ValueError("TIFF predictor 3 requires floating-point samples")
        # Inverse of the decode path: split each row's samples into
        # per-byte-position planes (big-endian order), then horizontally
        # difference the plane bytes (mod 256). Returned as uint8 rows whose
        # tobytes() is the predicted stream.
        rows, cols, samples = chunk.shape
        itemsize = chunk.dtype.itemsize
        be = np.dtype(chunk.dtype).newbyteorder(">")
        b = np.ascontiguousarray(chunk).astype(be).view(np.uint8)
        b = b.reshape(rows, cols * samples, itemsize)
        planes = np.transpose(b, (0, 2, 1)).reshape(rows, itemsize * cols * samples)
        out = planes.copy()
        out[:, 1:] = planes[:, 1:] - planes[:, :-1]
        return out
    raise ValueError(f"unsupported TIFF write predictor: {predictor}")


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------


@dataclass
class TiffPage:
    """Decoded metadata for the first IFD of a TIFF file."""

    width: int
    height: int
    samples_per_pixel: int
    dtype: np.dtype
    compression: int
    predictor: int
    tags: dict[int, object] = field(default_factory=dict)
    # layout
    tile_width: int | None = None
    tile_height: int | None = None
    rows_per_strip: int | None = None
    chunk_offsets: list[int] = field(default_factory=list)
    chunk_byte_counts: list[int] = field(default_factory=list)


def _dtype_from_format(bits: int, sample_format: int, byteorder: str) -> np.dtype:
    kind = {SAMPLEFORMAT_UINT: "u", SAMPLEFORMAT_INT: "i", SAMPLEFORMAT_IEEEFP: "f"}.get(
        sample_format
    )
    if kind is None:
        raise ValueError(f"unsupported TIFF sample format: {sample_format}")
    if bits % 8 != 0:
        raise ValueError(f"unsupported bits per sample: {bits}")
    return np.dtype(f"{byteorder}{kind}{bits // 8}")


def _read_ifd(data: bytes, order: str) -> TiffPage:
    endian = "<" if order == "II" else ">"
    (ifd_offset,) = struct.unpack_from(endian + "I", data, 4)
    (num_entries,) = struct.unpack_from(endian + "H", data, ifd_offset)
    tags: dict[int, object] = {}
    pos = ifd_offset + 2
    for _ in range(num_entries):
        tag, ftype, count = struct.unpack_from(endian + "HHI", data, pos)
        if ftype not in _FIELD_TYPES:
            pos += 12
            continue
        ch, size = _FIELD_TYPES[ftype]
        total = size * count
        if total <= 4:
            value_bytes = data[pos + 8 : pos + 8 + total]
        else:
            (offset,) = struct.unpack_from(endian + "I", data, pos + 8)
            value_bytes = data[offset : offset + total]
        if ftype == 2:  # ASCII
            tags[tag] = value_bytes.rstrip(b"\0").decode("ascii", "replace")
        elif ftype == 5:  # RATIONAL
            vals = struct.unpack(endian + "I" * (2 * count), value_bytes)
            tags[tag] = tuple(
                vals[i] / vals[i + 1] if vals[i + 1] else 0.0 for i in range(0, len(vals), 2)
            )
        else:
            vals = struct.unpack(endian + ch * count, value_bytes)
            tags[tag] = vals if count > 1 else vals[0]
        pos += 12

    def tag_list(t: int) -> list[int]:
        v = tags.get(t)
        if v is None:
            return []
        return list(v) if isinstance(v, tuple) else [int(v)]

    width = int(tags[TAG_IMAGE_WIDTH])
    height = int(tags[TAG_IMAGE_LENGTH])
    spp = int(tags.get(TAG_SAMPLES_PER_PIXEL, 1))
    bits_raw = tags.get(TAG_BITS_PER_SAMPLE, 1)
    bits = int(bits_raw[0] if isinstance(bits_raw, tuple) else bits_raw)
    fmt_raw = tags.get(TAG_SAMPLE_FORMAT, SAMPLEFORMAT_UINT)
    fmt = int(fmt_raw[0] if isinstance(fmt_raw, tuple) else fmt_raw)
    if int(tags.get(TAG_PLANAR_CONFIG, 1)) != 1:
        raise ValueError("only chunky (PlanarConfiguration=1) TIFFs are supported")

    page = TiffPage(
        width=width,
        height=height,
        samples_per_pixel=spp,
        dtype=_dtype_from_format(bits, fmt, endian),
        compression=int(tags.get(TAG_COMPRESSION, COMPRESSION_NONE)),
        predictor=int(tags.get(TAG_PREDICTOR, 1)),
        tags=tags,
    )
    if TAG_TILE_OFFSETS in tags:
        page.tile_width = int(tags[TAG_TILE_WIDTH])
        page.tile_height = int(tags[TAG_TILE_LENGTH])
        page.chunk_offsets = tag_list(TAG_TILE_OFFSETS)
        page.chunk_byte_counts = tag_list(TAG_TILE_BYTE_COUNTS)
    else:
        page.rows_per_strip = int(tags.get(TAG_ROWS_PER_STRIP, height))
        page.chunk_offsets = tag_list(TAG_STRIP_OFFSETS)
        page.chunk_byte_counts = tag_list(TAG_STRIP_BYTE_COUNTS)
    return page


def _decompress_chunk(raw: bytes, compression: int, expected: int) -> bytes:
    if compression == COMPRESSION_NONE:
        return raw
    if compression == COMPRESSION_LZW:
        if _native.available():
            try:
                return _native.lzw_decode(raw, expected)
            except _native.NativeLzwOverflow:
                # Files written by the pre-fix encoder can carry one spurious
                # code before EOI (endgame early-change bug), overflowing the
                # exact-size native buffer. The Python decoder is lenient and
                # callers truncate to `expected`. Corrupt-stream errors
                # (native code -1) propagate — the lenient decoder would
                # mask them.
                return lzw_decode(raw)
        return lzw_decode(raw)
    if compression in (COMPRESSION_DEFLATE_ADOBE, COMPRESSION_DEFLATE_OLD):
        return zlib.decompress(raw)
    if compression == COMPRESSION_PACKBITS:
        return packbits_decode(raw)
    if compression == COMPRESSION_ZSTD:
        from floodsr_tpu_torch.io import zstd_codec

        if not zstd_codec.available():
            raise ValueError(
                "TIFF uses ZSTD compression but libzstd is not available "
                "on this system"
            )
        return zstd_codec.decompress(raw, expected)
    raise ValueError(f"unsupported TIFF compression: {compression}")


def _strip_batch_native_ok(page: "TiffPage", samples: int) -> bool:
    """Whether the one-call native strip decode can serve this page.

    Gated to the layout the C++ implements: little-endian striped LZW with
    predictor 1/2/3 on power-of-two sample widths; predictor 2 with multiple
    samples per pixel needs per-channel differencing the flat C++ row loop
    does not do.
    """
    return (
        page.compression == COMPRESSION_LZW
        and _native.strips_available()
        and np.dtype(page.dtype).byteorder in ("<", "=", "|")
        and page.dtype.itemsize in (1, 2, 4, 8)
        and (
            page.predictor == 1
            or (page.predictor == 2 and samples == 1)
            or (page.predictor == 3 and page.dtype.itemsize in (2, 4, 8))
        )
    )


def _decode_strips_native(
    data: bytes, page: "TiffPage", out: np.ndarray, rps: int
) -> None:
    """One native call: LZW + predictor + assembly for every strip.

    Replaces the per-strip Python loop on the hot read path (the reference
    delegates this to GDAL's C++ core; reference
    ``floodsr/preprocessing.py:247-282``). Falls back to the lenient
    per-strip path only for the legacy-encoder overflow case.
    """
    h, w, s = page.height, page.width, page.samples_per_pixel
    itemsize = page.dtype.itemsize
    out_bytes = []
    row = 0
    for _ in page.chunk_offsets:
        nrows = min(rps, h - row)
        out_bytes.append(nrows * w * s * itemsize)
        row += nrows
    if row != h:
        raise ValueError(f"TIFF strip rows {row} do not cover height {h}")
    try:
        _native.lzw_decode_strips(
            data,
            page.chunk_offsets,
            page.chunk_byte_counts,
            out_bytes,
            cols=w * s,
            itemsize=itemsize,
            predictor=page.predictor,
            dst=out.reshape(-1).view(np.uint8),
        )
    except _native.NativeLzwOverflow:
        # Legacy pre-fix encoder streams can carry one spurious code before
        # EOI; re-run those through the lenient per-strip path.
        row = 0
        for off, cnt in zip(page.chunk_offsets, page.chunk_byte_counts):
            nrows = min(rps, h - row)
            if cnt == 0:
                out[row : row + nrows] = 0
            else:
                expected = nrows * w * s * itemsize
                decoded = _decompress_chunk(
                    data[off : off + cnt], page.compression, expected
                )
                chunk = np.frombuffer(decoded[:expected], dtype=page.dtype).reshape(
                    nrows, w, s
                )
                out[row : row + nrows] = _apply_predictor_decode(
                    chunk, page.predictor
                )
            row += nrows


#: Known raster-format signatures → human-readable name. Used to turn a
#: non-TIFF input into a NAMED capability error instead of a parse error
#: (the reference reads these through GDAL; this build's I/O boundary is
#: the TIFF family — reference breadth: floodsr/preprocessing.py:247-282).
_KNOWN_RASTER_MAGICS: list[tuple[bytes, str]] = [
    (b"\x89PNG\r\n\x1a\n", "PNG"),
    (b"\xff\xd8\xff", "JPEG"),
    (b"GIF8", "GIF"),
    (b"BM", "BMP"),
    (b"EHFA_HEADER_TAG", "ERDAS Imagine (.img)"),
    (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"),
    (b"\x89HDF\r\n\x1a\n", "HDF5/netCDF-4"),
    (b"CDF\x01", "netCDF (classic)"),
    (b"CDF\x02", "netCDF (64-bit offset)"),
    (b"DSAA", "Surfer ASCII grid"),
    (b"DSBB", "Surfer binary grid"),
    (b"P5", "PGM"),
    (b"P6", "PPM"),
]


def sniff_raster_format(head: bytes) -> str | None:
    """Name a known non-TIFF raster format from its leading bytes, else None."""
    for magic, name in _KNOWN_RASTER_MAGICS:
        if head[: len(magic)] == magic:
            return name
    stripped = head.lstrip()
    if stripped[:6].lower() in (b"ncols ", b"ncols\t"):
        return "ESRI ASCII grid"
    return None


def _not_a_tiff(head: bytes, detail: str) -> ValueError:
    name = sniff_raster_format(head)
    if name in ("ESRI ASCII grid", "Surfer ASCII grid"):
        # Supported as full-raster reads (floodsr_tpu_torch.io.read_raster
        # dispatches to floodsr_tpu_torch.io.ascii_grid); only this streaming
        # TIFF codec path cannot serve them.
        return ValueError(
            f"{name} is a text grid: it is readable via "
            "floodsr_tpu_torch.io.read_raster (and tohr inputs), but cannot be "
            "streamed through the windowed TIFF codec."
        )
    if name is not None:
        return ValueError(
            f"unsupported raster format: {name}. This build reads the TIFF "
            "family (GeoTIFF, BigTIFF, COG) plus ESRI/Surfer ASCII grids; "
            "convert the input with e.g. `gdal_translate -of GTiff` first."
        )
    return ValueError(f"not a TIFF file: {detail}")


def decode_tiff(data: bytes) -> tuple[np.ndarray, dict[int, object]]:
    """Decode the first IFD into ``[H, W]`` or ``[H, W, S]`` plus raw tags."""
    if len(data) < 8:
        raise _not_a_tiff(data, "too short")
    order = data[:2].decode("ascii", "replace")
    if order not in ("II", "MM"):
        raise _not_a_tiff(data, f"bad byte order {order!r}")
    endian = "<" if order == "II" else ">"
    (magic,) = struct.unpack_from(endian + "H", data, 2)
    if magic == 43:
        # BigTIFF: delegate to the window reader's 8-byte-offset IFD parser.
        from floodsr_tpu_torch.io.tiff_window import MemoryByteSource, TiffWindowReader

        reader = TiffWindowReader(MemoryByteSource(data))
        return reader.read_full(), reader.page.tags
    if magic != 42:
        raise _not_a_tiff(data, f"bad magic {magic}")

    page = _read_ifd(data, order)
    h, w, s = page.height, page.width, page.samples_per_pixel
    itemsize = page.dtype.itemsize
    out = np.empty((h, w, s), dtype=page.dtype.newbyteorder("="))

    if page.tile_width is not None:
        tw, th = page.tile_width, page.tile_height
        tiles_across = -(-w // tw)
        tiles_down = -(-h // th)
        expected = th * tw * s * itemsize
        for idx, (off, cnt) in enumerate(zip(page.chunk_offsets, page.chunk_byte_counts)):
            ty, tx = divmod(idx, tiles_across)
            if ty >= tiles_down:
                break
            y0, x0 = ty * th, tx * tw
            ny, nx = min(th, h - y0), min(tw, w - x0)
            if cnt == 0:
                # Sparse chunk (GDAL SPARSE_OK / libtiff convention): a zero
                # byte count marks a block with no data — read as zeros.
                out[y0 : y0 + ny, x0 : x0 + nx] = 0
                continue
            decoded = _decompress_chunk(data[off : off + cnt], page.compression, expected)
            chunk = np.frombuffer(decoded[:expected], dtype=page.dtype).reshape(th, tw, s)
            chunk = _apply_predictor_decode(chunk, page.predictor)
            out[y0 : y0 + ny, x0 : x0 + nx] = chunk[:ny, :nx]
    else:
        rps = page.rows_per_strip or h
        if _strip_batch_native_ok(page, s):
            _decode_strips_native(data, page, out, rps)
        else:
            row = 0
            for off, cnt in zip(page.chunk_offsets, page.chunk_byte_counts):
                nrows = min(rps, h - row)
                if cnt == 0:
                    out[row : row + nrows] = 0  # sparse strip: no data → zeros
                    row += nrows
                    continue
                expected = nrows * w * s * itemsize
                decoded = _decompress_chunk(
                    data[off : off + cnt], page.compression, expected
                )
                chunk = np.frombuffer(decoded[:expected], dtype=page.dtype).reshape(
                    nrows, w, s
                )
                out[row : row + nrows] = _apply_predictor_decode(chunk, page.predictor)
                row += nrows
            if row != h:
                raise ValueError(f"TIFF strip rows {row} do not cover height {h}")

    if s == 1:
        out = out[:, :, 0]
    return out, page.tags


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _sample_format_for(dtype: np.dtype) -> int:
    return {"u": SAMPLEFORMAT_UINT, "i": SAMPLEFORMAT_INT, "f": SAMPLEFORMAT_IEEEFP}[dtype.kind]


def _compress_chunk(raw: bytes, compression: int, row_bytes: int | None = None) -> bytes:
    if compression == COMPRESSION_NONE:
        return raw
    if compression == COMPRESSION_LZW:
        if _native.available():
            return _native.lzw_encode(raw)
        return lzw_encode(raw)
    if compression == COMPRESSION_DEFLATE_ADOBE:
        return zlib.compress(raw, 6)
    if compression == COMPRESSION_PACKBITS:
        return packbits_encode(raw, row_bytes)
    if compression == COMPRESSION_ZSTD:
        from floodsr_tpu_torch.io import zstd_codec

        if not zstd_codec.available():
            raise ValueError(
                "ZSTD write requested but libzstd is not available on this system"
            )
        # Level 1: zstd is the speed option here, LZW the compatibility
        # default.
        return zstd_codec.compress(raw, level=1)
    raise ValueError(f"unsupported TIFF write compression: {compression}")


def encode_tiff(
    array: np.ndarray,
    extra_tags: list[tuple[int, int, object]] | None = None,
    compression: int = COMPRESSION_LZW,
    predictor: int | None = None,
    rows_per_strip: int | None = None,
    tile: tuple[int, int] | None = None,
    bigtiff: bool | None = None,
) -> bytes:
    """Encode an array as a little-endian TIFF (striped, or tiled via ``tile``).

    ``extra_tags`` entries are ``(tag, field_type, value)`` where value is a
    tuple of numbers or an ASCII string; they are emitted in ascending tag
    order as TIFF requires. ``tile=(tile_height, tile_width)`` writes a tiled
    layout (dimensions must be multiples of 16 per the TIFF spec — the
    COG-style layout whose chunks a windowed reader can range-fetch).
    ``bigtiff``: force the 8-byte-offset BigTIFF container; ``None`` switches
    automatically when the projected size approaches the classic 4 GiB limit
    (the capability GDAL gives the reference for arbitrary-size rasters).
    """
    prep = _prepare_page(
        array, extra_tags, compression, predictor, rows_per_strip, tile
    )
    if bigtiff is None:
        # Auto: projected container size decides (chunk data dominates).
        projected = (
            sum(len(sb) + 1 for sb in prep["chunks"])
            + 4096
            + 16 * len(prep["chunks"])
        )
        bigtiff = projected > _CLASSIC_TIFF_LIMIT
    header_size = 16 if bigtiff else 8
    out = bytearray()
    if bigtiff:
        out += struct.pack("<2sHHHQ", b"II", 43, 8, 0, 16)
    else:
        out += struct.pack("<2sHI", b"II", 42, 8)
    out += _emit_page(prep, bigtiff=bigtiff, base=header_size, next_ifd=0)
    return bytes(out)


def _prepare_page(
    array: np.ndarray,
    extra_tags,
    compression: int,
    predictor: int | None,
    rows_per_strip: int | None,
    tile: tuple[int, int] | None,
) -> dict:
    """Chunk data + offset-free tag list for one page (IFD) of a TIFF."""
    if array.ndim == 2:
        array = array[:, :, None]
    if array.ndim != 3:
        raise ValueError(f"array must be 2D or 3D; got shape {array.shape}")
    arr = np.ascontiguousarray(array)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    h, w, s = arr.shape
    itemsize = arr.dtype.itemsize

    if predictor is None:
        # Predictors pair with LZW/Deflate/ZSTD only; PackBits readers
        # (GDAL included) do not expect a predictor tag.
        predictor = 2 if (
            compression not in (COMPRESSION_NONE, COMPRESSION_PACKBITS)
            and arr.dtype.kind in "ui"
        ) else 1

    chunks: list[bytes] = []
    if tile is not None:
        th, tw = int(tile[0]), int(tile[1])
        if th % 16 or tw % 16 or th <= 0 or tw <= 0:
            raise ValueError(f"tile dims must be positive multiples of 16; got {tile}")
        for row in range(0, h, th):
            for col in range(0, w, tw):
                block = arr[row : row + th, col : col + tw]
                # TIFF tiles are always full-size; pad edge tiles.
                if block.shape[0] != th or block.shape[1] != tw:
                    pad = ((0, th - block.shape[0]), (0, tw - block.shape[1]), (0, 0))
                    block = np.pad(block, pad, mode="edge")
                block = _apply_predictor_encode(block, predictor)
                chunks.append(
                    _compress_chunk(block.tobytes(), compression, tw * s * itemsize)
                )
    else:
        if rows_per_strip is None:
            target = 1 << 18  # ~256 KiB strips
            rows_per_strip = max(1, min(h, target // max(1, w * s * itemsize)))
        for row in range(0, h, rows_per_strip):
            chunk = arr[row : row + rows_per_strip]
            chunk = _apply_predictor_encode(chunk, predictor)
            chunks.append(
                _compress_chunk(chunk.tobytes(), compression, w * s * itemsize)
            )

    tags: list[tuple[int, int, tuple | str]] = [
        (TAG_IMAGE_WIDTH, 4, (w,)),
        (TAG_IMAGE_LENGTH, 4, (h,)),
        (TAG_BITS_PER_SAMPLE, 3, (itemsize * 8,) * s),
        (TAG_COMPRESSION, 3, (compression,)),
        (TAG_PHOTOMETRIC, 3, (1,)),
        (TAG_SAMPLES_PER_PIXEL, 3, (s,)),
        (TAG_PLANAR_CONFIG, 3, (1,)),
        (TAG_SAMPLE_FORMAT, 3, (_sample_format_for(arr.dtype),) * s),
    ]
    if tile is not None:
        tags.append((TAG_TILE_WIDTH, 4, (tw,)))
        tags.append((TAG_TILE_LENGTH, 4, (th,)))
        offsets_tag, counts_tag = TAG_TILE_OFFSETS, TAG_TILE_BYTE_COUNTS
    else:
        tags.append((TAG_ROWS_PER_STRIP, 4, (rows_per_strip,)))
        offsets_tag, counts_tag = TAG_STRIP_OFFSETS, TAG_STRIP_BYTE_COUNTS
    if predictor != 1:
        tags.append((TAG_PREDICTOR, 3, (predictor,)))
    for tag, ftype, value in extra_tags or []:
        tags.append((tag, ftype, value))
    return {"tags": tags, "chunks": chunks, "offsets_tag": offsets_tag,
            "counts_tag": counts_tag}


def _page_size(prep: dict, bigtiff: bool) -> int:
    """Exact byte length :func:`_emit_page` will produce (offset-free)."""
    off_ftype = 16 if bigtiff else 4
    n = len(prep["chunks"])
    tags = list(prep["tags"])
    tags.append((prep["offsets_tag"], off_ftype, (0,) * n))
    tags.append((prep["counts_tag"], off_ftype, (0,) * n))
    size = _ifd_size(tags, bigtiff) + _payloads_size(tags, bigtiff)
    size += size % 2  # data alignment pad
    for sb in prep["chunks"]:
        size += len(sb) + (len(sb) % 2)
    return size


def _emit_page(prep: dict, *, bigtiff: bool, base: int, next_ifd: int) -> bytes:
    """Serialize one page (IFD | payloads | chunk data) at absolute ``base``."""
    strips = prep["chunks"]
    off_ftype = 16 if bigtiff else 4
    tags = list(prep["tags"])
    tags.append((prep["offsets_tag"], off_ftype, (0,) * len(strips)))
    tags.append((prep["counts_tag"], off_ftype, tuple(len(sb) for sb in strips)))
    tags.sort(key=lambda t: t[0])

    # Fixed layout: IFD | tag payloads | chunk data. Payload sizes are
    # value-independent, so chunk offsets are computable up front and the
    # offsets tag gets its real values before serialization.
    extra_offset = base + _ifd_size(tags, bigtiff)
    data_offset = extra_offset + _payloads_size(tags, bigtiff)
    if data_offset % 2:
        data_offset += 1

    strip_offsets = []
    pos = data_offset
    for sb in strips:
        strip_offsets.append(pos)
        pos += len(sb) + (len(sb) % 2)
    if not bigtiff and pos > (1 << 32) - 1:
        raise ValueError(
            f"container size {pos} overflows classic TIFF; pass bigtiff=True"
        )
    tags = [
        (t, ft, tuple(strip_offsets) if t == prep["offsets_tag"] else v)
        for (t, ft, v) in tags
    ]
    out = bytearray()
    ifd, payloads = _serialize_ifd(
        tags, bigtiff=bigtiff, payload_base=extra_offset, next_ifd=next_ifd
    )
    out += ifd
    out += payloads
    while base + len(out) < data_offset:
        out += b"\0"
    for sb in strips:
        out += sb
        if len(sb) % 2:
            out += b"\0"
    return bytes(out)


def decimate_for_overview(arr: np.ndarray, factor: int) -> np.ndarray:
    """Average-pooled ``factor``x decimation (GDAL ``AVERAGE`` overview
    semantics for continuous rasters); edge remainders are edge-padded so
    the overview covers the full extent (``ceil(dim/factor)``)."""
    a = np.asarray(arr)
    squeeze = a.ndim == 2
    if squeeze:
        a = a[:, :, None]
    h, w, s = a.shape
    ph, pw = -h % factor, -w % factor
    if ph or pw:
        a = np.pad(a, ((0, ph), (0, pw), (0, 0)), mode="edge")
    hh, ww = a.shape[0] // factor, a.shape[1] // factor
    pooled = a.reshape(hh, factor, ww, factor, s).astype(np.float64).mean((1, 3))
    if np.issubdtype(arr.dtype, np.integer):
        pooled = np.round(pooled)
    pooled = pooled.astype(arr.dtype)
    return pooled[:, :, 0] if squeeze else pooled


def encode_tiff_overviews(
    array: np.ndarray,
    extra_tags: list[tuple[int, int, object]] | None = None,
    *,
    overview_levels: tuple[int, ...] = (2, 4, 8),
    min_size: int = 64,
    compression: int = COMPRESSION_LZW,
    predictor: int | None = None,
    rows_per_strip: int | None = None,
    tile: tuple[int, int] | None = None,
    bigtiff: bool = False,
) -> bytes:
    """Encode a TIFF whose IFD chain carries reduced-resolution overviews.

    The COG layout GDAL builds with internal overviews (reference role:
    overview-aware windowed reads inside
    ``/root/reference/floodsr/dem_sources/hrdem_stac.py:117-219``): page 0
    is the full raster; each following page is an average-pooled
    ``level``x decimation flagged ``NewSubfileType=1``
    (reduced-resolution). Levels that would shrink below ``min_size`` in
    both axes are dropped. Geo tags (``extra_tags``) land on page 0 only,
    as GDAL does.
    """
    preps = [
        _prepare_page(array, extra_tags, compression, predictor,
                      rows_per_strip, tile)
    ]
    for level in overview_levels:
        ov = decimate_for_overview(array, int(level))
        oh = ov.shape[0]
        owd = ov.shape[1]
        if max(oh, owd) < int(min_size):
            break
        preps.append(
            _prepare_page(
                ov, [(TAG_NEW_SUBFILE_TYPE, 4, (1,))], compression,
                predictor, rows_per_strip, tile,
            )
        )
    header_size = 16 if bigtiff else 8
    bases = [header_size]
    for prep in preps[:-1]:
        bases.append(bases[-1] + _page_size(prep, bigtiff))
    out = bytearray()
    if bigtiff:
        out += struct.pack("<2sHHHQ", b"II", 43, 8, 0, 16)
    else:
        out += struct.pack("<2sHI", b"II", 42, 8)
    for k, prep in enumerate(preps):
        next_ifd = bases[k + 1] if k + 1 < len(preps) else 0
        page = _emit_page(prep, bigtiff=bigtiff, base=bases[k], next_ifd=next_ifd)
        assert len(page) == _page_size(prep, bigtiff), "page size plan mismatch"
        out += page
    return bytes(out)


def _tag_raw(tag: int, ftype: int, value, endian: str = "<") -> tuple[bytes, int]:
    """Serialized tag value bytes + logical count.

    RATIONAL (type 5) values are ``(numerator, denominator)`` pairs — each
    logical value packs TWO longs, so the struct format repeats per logical
    value (``'II'`` already encodes both) and the count stays the number of
    rationals, not of longs.
    """
    ch, _size = _FIELD_TYPES[ftype]
    if ftype == 2:
        raw = str(value).encode("ascii") + b"\0"
        return raw, len(raw)
    vals = tuple(value)
    if ftype == 5:
        pairs = (
            tuple(vals)
            if vals and isinstance(vals[0], (tuple, list))
            else tuple(zip(vals[0::2], vals[1::2]))
        )
        assert pairs and all(len(p) == 2 for p in pairs), (
            f"RATIONAL tag {tag} needs (numerator, denominator) pairs; got {value!r}"
        )
        flat = [int(x) for p in pairs for x in p]
        return struct.pack(endian + "II" * len(pairs), *flat), len(pairs)
    return struct.pack(endian + ch * len(vals), *vals), len(vals)


def _ifd_size(tags, bigtiff: bool) -> int:
    entry = 20 if bigtiff else 12
    return (8 if bigtiff else 2) + len(tags) * entry + (8 if bigtiff else 4)


def _payloads_size(tags, bigtiff: bool) -> int:
    cap = 8 if bigtiff else 4
    total = 0
    for tag, ftype, value in tags:
        raw, _ = _tag_raw(tag, ftype, value)
        if len(raw) > cap:
            total += len(raw) + (len(raw) % 2)
    return total


def _serialize_ifd(
    tags, *, bigtiff: bool, payload_base: int, endian: str = "<",
    next_ifd: int = 0,
) -> tuple[bytes, bytes]:
    """IFD table + out-of-line payload blob for FINAL tag values.

    ``payload_base`` is the absolute file offset where the payload blob will
    land (immediately after the IFD in both writers). ``next_ifd`` chains
    additional pages (overview IFDs); 0 terminates the chain.
    """
    cap = 8 if bigtiff else 4
    count_fmt = "Q" if bigtiff else "I"
    entries: list[bytes] = []
    payloads = bytearray()
    for tag, ftype, value in tags:
        raw, count = _tag_raw(tag, ftype, value, endian)
        if len(raw) <= cap:
            entries.append(
                struct.pack(endian + "HH" + count_fmt, tag, ftype, count)
                + raw.ljust(cap, b"\0")
            )
        else:
            entries.append(
                struct.pack(
                    endian + "HH" + count_fmt + count_fmt,
                    tag, ftype, count, payload_base + len(payloads),
                )
                if bigtiff
                else struct.pack(
                    endian + "HHII", tag, ftype, count, payload_base + len(payloads)
                )
            )
            payloads += raw
            if len(raw) % 2:
                payloads += b"\0"
    ifd = bytearray()
    if bigtiff:
        ifd += struct.pack(endian + "Q", len(entries))
    else:
        ifd += struct.pack(endian + "H", len(entries))
    for e in entries:
        ifd += e
    ifd += struct.pack(endian + ("Q" if bigtiff else "I"), next_ifd)
    return bytes(ifd), bytes(payloads)


class StripStreamWriter:
    """Incremental striped-TIFF writer: feed row bands, strips hit disk as
    they compress.

    Layout: header (IFD pointer backpatched at close) → strip data → IFD +
    out-of-line tag payloads. Readers follow the pointer, so IFD-at-end is
    fully conformant. This is the output half of the pipelined device→host
    path: each row band is LZW-encoded and written while the next band is
    still in flight from the device.
    """

    def __init__(
        self,
        fp,
        height: int,
        width: int,
        dtype,
        extra_tags: list[tuple[int, int, object]] | None = None,
        compression: int = COMPRESSION_LZW,
        rows_per_strip: int | None = None,
        bigtiff: bool | None = None,
        predictor: int | None = None,
    ):
        self._handle = open(fp, "wb")
        self._height = int(height)
        self._width = int(width)
        self._dtype = np.dtype(dtype)
        if self._dtype.byteorder == ">":
            raise ValueError("StripStreamWriter is little-endian only")
        self._compression = compression
        self._extra_tags = list(extra_tags or [])
        if predictor is None:
            predictor = (
                2
                if (
                    compression not in (COMPRESSION_NONE, COMPRESSION_PACKBITS)
                    and self._dtype.kind in "ui"
                )
                else 1
            )
        self._predictor = int(predictor)
        itemsize = self._dtype.itemsize
        if bigtiff is None:
            # Compressed strips can't be sized up front; the uncompressed
            # bound decides (conservative — a BigTIFF container is always
            # readable back, a classic one that overflows is not writable).
            # LZW can EXPAND incompressible data (9-12-bit codes for 8-bit
            # bytes, ≤1.5×), so the bound carries that factor — mirroring
            # GDAL's BIGTIFF=IF_SAFER. close() still hard-checks the real
            # offsets.
            expansion = 1.5 if compression != COMPRESSION_NONE else 1.0
            bigtiff = (
                self._height * self._width * itemsize * expansion + (1 << 20)
                > _CLASSIC_TIFF_LIMIT
            )
        self._bigtiff = bool(bigtiff)
        if rows_per_strip is None:
            target = 1 << 18
            rows_per_strip = max(1, min(self._height, target // max(1, width * itemsize)))
            # Round down to a power of two: callers stream power-of-two row
            # bands (the engine's 512-row D2H bands), and a divisor strip
            # height lets write_rows flush every band with zero carry-over —
            # no vstack copy of the pending remainder per band (~one full
            # extra pass over the scene on the 1-core host budget).
            rows_per_strip = 1 << (int(rows_per_strip).bit_length() - 1)
        self._rps = int(rows_per_strip)
        self._pending = np.empty((0, self._width), self._dtype)
        self._rows_done = 0
        self._offsets: list[int] = []
        self._counts: list[int] = []
        # Header with IFD pointer placeholder (backpatched in close()).
        if self._bigtiff:
            self._handle.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, 0))
        else:
            self._handle.write(struct.pack("<2sHI", b"II", 42, 0))

    def _flush_strips_native(self, flush_all: bool) -> bool:
        """Batch-encode every flushable strip in ONE native call.

        Predictor + LZW + per-strip packing all happen in C++; Python only
        records offsets and writes the packed bytes (byte-identical file to
        the per-strip path — same deterministic per-strip streams, same
        odd-length pad bytes). Returns False when the layout is not native-
        eligible and the caller should use the per-strip path.
        """
        if not (
            self._compression == COMPRESSION_LZW
            and _native.strips_available()
            and self._dtype.itemsize in (1, 2, 4, 8)
            and (
                self._predictor == 1
                or (self._predictor == 2 and self._dtype.kind in "ui")
                or (
                    self._predictor == 3
                    and self._dtype.kind == "f"
                    and self._dtype.itemsize in (2, 4, 8)
                )
            )
        ):
            return False
        n_rows = self._pending.shape[0]
        n_full = n_rows // self._rps
        rows_take = n_rows if flush_all else n_full * self._rps
        if rows_take == 0:
            return True
        n_strips = -(-rows_take // self._rps)
        src = np.ascontiguousarray(self._pending[:rows_take])
        self._pending = self._pending[rows_take:]
        blob, counts = _native.lzw_encode_strips(
            src.reshape(-1).view(np.uint8),
            strip_bytes=self._rps * self._width * self._dtype.itemsize,
            n_strips=n_strips,
            cols=self._width,
            itemsize=self._dtype.itemsize,
            predictor=self._predictor,
        )
        pos = 0
        for cnt in counts:
            self._offsets.append(self._handle.tell())
            self._counts.append(cnt)
            self._handle.write(blob[pos : pos + cnt])
            if cnt % 2:
                self._handle.write(b"\0")
            pos += cnt
        return True

    def write_rows(self, band: np.ndarray) -> None:
        band = np.ascontiguousarray(band, self._dtype)
        assert band.ndim == 2 and band.shape[1] == self._width, band.shape
        self._pending = (
            band if self._pending.size == 0 else np.vstack([self._pending, band])
        )
        self._rows_done += band.shape[0]
        assert self._rows_done <= self._height, "more rows than declared height"
        flush_all = self._rows_done == self._height
        if self._flush_strips_native(flush_all):
            return
        while self._pending.shape[0] >= self._rps or (
            flush_all and self._pending.shape[0] > 0
        ):
            chunk = self._pending[: self._rps]
            self._pending = self._pending[self._rps :]
            enc = _apply_predictor_encode(chunk[:, :, None], self._predictor)
            blob = _compress_chunk(
                enc.tobytes(), self._compression, self._width * self._dtype.itemsize
            )
            self._offsets.append(self._handle.tell())
            self._counts.append(len(blob))
            self._handle.write(blob)
            if len(blob) % 2:
                self._handle.write(b"\0")

    def close(self) -> None:
        assert self._rows_done == self._height, (
            f"wrote {self._rows_done} of {self._height} rows"
        )
        endian = "<"
        bigtiff = self._bigtiff
        off_ftype = 16 if bigtiff else 4
        tags: list[tuple[int, int, tuple | str]] = [
            (TAG_IMAGE_WIDTH, 4, (self._width,)),
            (TAG_IMAGE_LENGTH, 4, (self._height,)),
            (TAG_BITS_PER_SAMPLE, 3, (self._dtype.itemsize * 8,)),
            (TAG_COMPRESSION, 3, (self._compression,)),
            (TAG_PHOTOMETRIC, 3, (1,)),
            (TAG_STRIP_OFFSETS, off_ftype, tuple(self._offsets)),
            (TAG_SAMPLES_PER_PIXEL, 3, (1,)),
            (TAG_ROWS_PER_STRIP, 4, (self._rps,)),
            (TAG_STRIP_BYTE_COUNTS, off_ftype, tuple(self._counts)),
            (TAG_PLANAR_CONFIG, 3, (1,)),
            (TAG_SAMPLE_FORMAT, 3, (_sample_format_for(self._dtype),)),
        ]
        if self._predictor != 1:
            tags.append((TAG_PREDICTOR, 3, (self._predictor,)))
        tags.extend(self._extra_tags)
        tags.sort(key=lambda t: t[0])

        if self._handle.tell() % 2:
            self._handle.write(b"\0")
        ifd_offset = self._handle.tell()
        payload_base = ifd_offset + _ifd_size(tags, bigtiff)
        # Classic-TIFF overflow must cover EVERY 32-bit offset the file will
        # contain — strip offsets, the IFD pointer, and the IFD's
        # out-of-line payload offsets (which sit past payload_base, i.e.
        # after all strip data) — not just the last strip; and it must fail
        # as a clean exception BEFORE any IFD byte lands, never a corrupt
        # file. struct.error surfaces any offset _ifd_size's estimate
        # missed.
        try:
            if not bigtiff and payload_base > _MAX_CLASSIC_OFFSET:
                raise ValueError(
                    "file offsets overflow classic TIFF (4 GiB); construct "
                    "with bigtiff=True"
                )
            ifd, payloads = _serialize_ifd(
                tags, bigtiff=bigtiff, payload_base=payload_base
            )
            if not bigtiff and payload_base + len(payloads) > _MAX_CLASSIC_OFFSET:
                raise ValueError(
                    "file offsets overflow classic TIFF (4 GiB); construct "
                    "with bigtiff=True"
                )
        except (ValueError, struct.error) as err:
            self._handle.close()
            raise ValueError(
                f"cannot finalize classic TIFF past the 4 GiB offset limit "
                f"(use bigtiff=True): {err}"
            ) from None
        self._handle.write(ifd)
        self._handle.write(payloads)
        # Backpatch the header's IFD pointer.
        if bigtiff:
            self._handle.seek(8)
            self._handle.write(struct.pack(endian + "Q", ifd_offset))
        else:
            self._handle.seek(4)
            self._handle.write(struct.pack(endian + "I", ifd_offset))
        self._handle.close()

    def __enter__(self) -> "StripStreamWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.close()
        else:
            self._handle.close()
        return False
