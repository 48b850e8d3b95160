"""Library entrypoint for one ToHR (to-high-resolution) pass.

``tohr()`` is the importable API the CLI's ``tohr`` verb wraps (reference
surface: ``floodsr/tohr.py``): resolve the worker class for a model version,
instantiate it on a local artifact, and drive a single super-resolution run
through the worker's context-managed lifecycle. The returned diagnostics dict
is the worker's own (runtime, output size, preprocess config, tile stats).

``tohr_many()`` drives a stream of scenes through ONE worker lifecycle.

Port of the JAX package's ``tohr.py``: the worker runs on the GPU unless the
caller passes ``device="cpu"``, and raises when CUDA is absent.
"""

from __future__ import annotations

import inspect
import logging
from pathlib import Path
from typing import Any

from floodsr_tpu_torch.model_registry import resolve_model_worker_class

_RUN_KEYS = (
    "depth_lr_fp",
    "dem_hr_fp",
    "output_fp",
    "max_depth",
    "dem_pct_clip",
    "window_method",
    "tile_overlap",
    "tile_size",
    "input_kind",
    "buildings_fp",
    "output_compress",
)


def filter_engine_options(worker_class, engine_options: dict | None) -> dict:
    """Keep only the engine options the worker's __init__ declares.

    Shared by :func:`tohr`, :func:`tohr_many`, and the serving daemon so the
    option surface cannot silently diverge between entry points; workers opt
    in per-option by declaring the parameter.
    """
    init_params = inspect.signature(worker_class.__init__).parameters
    return {
        key: value
        for key, value in (engine_options or {}).items()
        if key in init_params
    }


def tohr(
    *,
    model_version: str,
    model_fp: str | Path,
    depth_lr_fp: str | Path,
    dem_hr_fp: str | Path,
    output_fp: str | Path,
    max_depth: float | None = None,
    dem_pct_clip: float | None = None,
    window_method: str = "feather",
    tile_overlap: int | None = None,
    tile_size: int | None = None,
    input_kind: str | None = None,
    buildings_fp: str | Path | None = None,
    output_compress: str | None = None,
    logger: logging.Logger | None = None,
    engine_options: dict | None = None,
    device: str = "cuda",
) -> dict[str, object]:
    """Super-resolve one depth raster and return the worker diagnostics.

    ``output_compress`` picks the output GeoTIFF compression
    (``lzw``/``zstd``/``deflate``/``packbits``/``none``; default ``lzw``,
    the reference's write profile).

    ``engine_options`` carries engine knobs (``compute_dtype``,
    ``max_batch``, ``output_transfer``, ... — see :mod:`floodsr_tpu_torch.config`);
    each is forwarded to the worker constructor only when its signature
    declares the parameter, so workers opt in per-option.

    ``device`` is where the model runs: ``"cuda"`` (the default; raises when
    CUDA is absent) or ``"cpu"``.
    """
    if not model_version:
        raise AssertionError("model_version cannot be empty")
    artifact = Path(model_fp).expanduser().resolve()
    if not artifact.exists():
        raise AssertionError(f"model file does not exist: {artifact}")
    log = logger if logger is not None else logging.getLogger(__name__)

    worker_class = resolve_model_worker_class(model_version)
    extra = filter_engine_options(worker_class, engine_options)
    extra["device"] = device

    run_args = dict(
        zip(
            _RUN_KEYS,
            (
                depth_lr_fp,
                dem_hr_fp,
                output_fp,
                max_depth,
                dem_pct_clip,
                window_method,
                tile_overlap,
                tile_size,
                input_kind,
                buildings_fp,
                output_compress,
            ),
        )
    )
    with worker_class(model_fp=artifact, logger=log, **extra) as worker:
        return worker.run(**run_args)


def tohr_many(
    *,
    model_version: str,
    model_fp: str | Path,
    jobs: list[dict],
    max_depth: float | None = None,
    dem_pct_clip: float | None = None,
    window_method: str = "feather",
    tile_overlap: int | None = None,
    tile_size: int | None = None,
    input_kind: str | None = None,
    buildings_fp: str | Path | None = None,
    output_compress: str | None = None,
    logger: logging.Logger | None = None,
    engine_options: dict | None = None,
    device: str = "cuda",
) -> list[dict[str, object]]:
    """Super-resolve a stream of scenes through ONE worker lifecycle.

    Serving extension of :func:`tohr`: the model loads onto the device once,
    every scene reuses the engine and the device-resident DEM cache, and each
    next scene's DEM decodes/uploads in a background thread while the current
    scene computes (``ModelWorker.run_many``). ``jobs`` entries carry
    ``depth_lr_fp``, ``dem_hr_fp``, ``output_fp`` plus optional per-job
    overrides of the shared run keywords. A worker without ``run_many`` (the
    CostGrow workers) runs the jobs in a loop. ``device`` as in :func:`tohr`.
    Returns per-job diagnostics dicts in order.
    """
    if not model_version:
        raise AssertionError("model_version cannot be empty")
    if not jobs:
        raise AssertionError("jobs cannot be empty")
    artifact = Path(model_fp).expanduser().resolve()
    if not artifact.exists():
        raise AssertionError(f"model file does not exist: {artifact}")
    log = logger if logger is not None else logging.getLogger(__name__)

    worker_class = resolve_model_worker_class(model_version)
    extra = filter_engine_options(worker_class, engine_options)
    extra["device"] = device
    shared = dict(
        max_depth=max_depth,
        dem_pct_clip=dem_pct_clip,
        window_method=window_method,
        tile_overlap=tile_overlap,
        tile_size=tile_size,
        input_kind=input_kind,
        buildings_fp=buildings_fp,
        output_compress=output_compress,
    )
    with worker_class(model_fp=artifact, logger=log, **extra) as worker:
        if hasattr(worker, "run_many"):
            return worker.run_many(jobs, **shared)
        return [worker.run(**{**shared, **job}) for job in jobs]
