"""Host-side allocator tuning for large raster buffers.

Host-only copy of the JAX package's ``hostmem.py``. The tohr pipeline churns
through large transient host arrays (decoded GeoTIFF rasters,
prepared/aligned grids, mosaic outputs, encode staging — tens to hundreds of
MB each). With glibc defaults every allocation above ``M_MMAP_THRESHOLD``
(128 KiB, dynamically adjusted) is served by a private ``mmap`` and returned
to the kernel on ``free``, so each scene re-faults every page of every large
buffer. On bare metal that is cheap; on virtualized hosts a first-touch fault
can cost orders of magnitude more, and then page faults, not decoding,
dominate the host stages of a scene.

The fix is standard allocator tuning, applied once per process:

- raise ``M_MMAP_THRESHOLD`` so multi-MB raster buffers come from the main
  heap instead of per-allocation ``mmap``/``munmap`` pairs, and
- raise ``M_TRIM_THRESHOLD`` so ``free`` keeps those heap pages instead of
  returning them to the kernel.

After tuning, the first large allocation still pays the fault cost, but
every later buffer of any size reuses warm pages.

Opt out with ``FLOODSR_HOST_MALLOC_TUNE=0``. The only cost of the tuning is
steady-state RSS up to roughly the high-water mark of concurrently live
raster buffers, which is what long-lived serving processes want anyway.
"""

from __future__ import annotations

import ctypes
import logging
import os
import sys

logger = logging.getLogger(__name__)

# glibc mallopt parameter codes (malloc.h).
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_DEFAULT_MMAP_THRESHOLD = 256 * 1024 * 1024
_DEFAULT_TRIM_THRESHOLD = 512 * 1024 * 1024

_applied: bool | None = None


def tune_malloc(
    mmap_threshold: int = _DEFAULT_MMAP_THRESHOLD,
    trim_threshold: int = _DEFAULT_TRIM_THRESHOLD,
) -> bool:
    """Apply the large-buffer allocator tuning once per process.

    Returns True if the tuning is in effect (now or from an earlier call),
    False when disabled, unavailable (non-glibc), or rejected by mallopt.
    Idempotent and safe to call from every entry point.
    """
    global _applied
    if _applied is not None:
        return _applied
    if os.environ.get("FLOODSR_HOST_MALLOC_TUNE", "1") == "0":
        _applied = False
        return False
    if not sys.platform.startswith("linux"):
        _applied = False
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        mallopt = libc.mallopt
        mallopt.restype = ctypes.c_int
        mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    except (OSError, AttributeError):
        _applied = False
        return False
    ok = bool(mallopt(_M_MMAP_THRESHOLD, mmap_threshold))
    # Trim second: with a high mmap threshold the heap now holds the large
    # buffers, and a low trim threshold would hand them straight back.
    ok = bool(mallopt(_M_TRIM_THRESHOLD, trim_threshold)) and ok
    if not ok:
        logger.debug("mallopt tuning rejected by the allocator")
    _applied = ok
    return ok
