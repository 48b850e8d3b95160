"""Build the native TIFF codec shared library with g++.

Usage: ``python -m floodsr_tpu_torch.io.build_native``
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path


def build(verbose: bool = True, retries: int = 1) -> Path | None:
    src_dir = Path(__file__).parent / "_native"
    src = src_dir / "tiff_codec.cc"
    out = src_dir / "libfloodsr_tiff.so"
    # Compile to a process-unique temp name, then atomically rename: a
    # half-written .so must never be visible to concurrent loaders (dlopen
    # of a truncated file fails hard).
    tmp = src_dir / f".libfloodsr_tiff.{os.getpid()}.so.tmp"
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
    # -march policy (FLOODSR_NATIVE_MARCH): "native" (default) is safe and
    # ~10% faster on the LZW encode core (A-B-A, real bench corpus) when
    # the library is built on the host that runs it — the on-demand build
    # in io/native.py. BUILD-ONCE-DEPLOY-ELSEWHERE builds (container image
    # stages) must set FLOODSR_NATIVE_MARCH=portable: a .so compiled with
    # the builder's ISA extensions (e.g. AVX-512) SIGILLs at RUNTIME on a
    # narrower CPU — the no-march fallback below only covers compile-time
    # flag rejection. Any other value passes through as -march=<value>.
    march = os.environ.get("FLOODSR_NATIVE_MARCH", "native").strip().lower()
    if march in ("portable", "baseline", "none", ""):
        flag_sets = [base]
    else:
        flag_sets = [base + [f"-march={march}"], base]
    last_err = ""
    for attempt in range(retries + 1):
        for flags in flag_sets:
            cmd = flags + ["-o", str(tmp), str(src)]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True)
                tmp.replace(out)
                if verbose:
                    print(f"built {out}")
                return out
            except (subprocess.CalledProcessError, FileNotFoundError, OSError) as err:
                last_err = getattr(err, "stderr", "") or str(err)
                tmp.unlink(missing_ok=True)
        if attempt < retries:
            time.sleep(1.0)  # transient (e.g. memory pressure): retry once
    if verbose:
        print(f"native codec build failed: {last_err}", file=sys.stderr)
    return None


if __name__ == "__main__":
    raise SystemExit(0 if build() else 1)
