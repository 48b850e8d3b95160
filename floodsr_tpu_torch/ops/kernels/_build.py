"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into its own shared
library with a plain C interface under ``floodsr_tpu_torch/_build/`` (listed
in ``.gitignore``), loaded with ``ctypes``. A library is rebuilt when its
source, or a file under ``csrc/`` that the source includes, is newer. The
kernels need the CUDA runtime alone: the bf16 route of ``hr_tail`` encodes its
TMA tensor maps with ``cuTensorMapEncodeTiled``, which it looks up at run
time with ``cudaGetDriverEntryPoint``, so nothing links ``-lcuda``; no
CUTLASS header. A missing ``nvcc`` or a failed build raises: there is no
fallback. This module is imported only by the kernel wrappers when they
launch on a CUDA tensor, so the CPU path never touches it.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, "
            "PATH): the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every file under ``csrc/`` it includes, directly or not."""
    found: list[Path] = []
    todo = [SRC_DIR / f"{name}.cu"]
    while todo:
        fp = todo.pop()
        if fp in found or not fp.exists() or SRC_DIR not in fp.parents:
            continue
        found.append(fp)
        todo += [(fp.parent / inc).resolve() for inc in _INCLUDE.findall(fp.read_text())]
    return found


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(built < fp.stat().st_mtime for fp in source_files(name))


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    src = SRC_DIR / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"missing kernel source: {src}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, BUILD_DIR / f"{name}.log"


def build(names: "list[str] | tuple[str, ...]") -> dict[str, str]:
    """Build the stale libraries among ``names``, one ``nvcc`` each, all at once.

    Returns ``{name: compiler output}`` for the sources that were built
    (``-Xptxas -v`` reports registers, shared memory and spills per kernel).
    Raises if any build fails.
    """
    with _lock:
        started = {n: _start(n) for n in names if _stale(n)}
        logs = {}
        failed = []
        for name, (proc, tmp, log_fp) in started.items():
            output, _ = proc.communicate()
            log_fp.write_text(output)
            logs[name] = output
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}:\n{output}")
            else:
                tmp.replace(library_path(name))
        if failed:
            raise RuntimeError("nvcc build failed for " + "\n".join(failed))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
    return lib


def current_stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an int for ctypes."""
    import torch

    return int(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
