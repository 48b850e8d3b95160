"""Worker contract shared by every model module under ``floodsr_tpu_torch/models/``.

A *worker* is the per-model-version orchestrator the registry discovers by
module name (see ``model_registry.load_worker_class``). Each worker module
exports a ``ModelWorker`` subclass of :class:`Model`; the pipeline drives it
through the context-manager lifecycle::

    with ModelWorker(artifact_path, logger=log) as worker:
        diagnostics = worker.run(depth_lr_fp=..., dem_hr_fp=..., ...)

Engine/device resources are acquired in ``__enter__`` and released in
``__exit__``; ``run`` performs the model-specific ToHR flow and returns a
diagnostics dict. Behavior mirrors the reference worker base
(``floodsr/models/base.py``) while the engine underneath is PyTorch/CUDA.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any


class Model:
    """Lifecycle + validation shell that concrete ``ModelWorker``s extend.

    Class attribute ``model_version`` names the registry entry a worker
    serves; the constructor cross-checks it against the caller's requested
    version so a worker never silently runs a foreign artifact.
    """

    #: registry version string served by this worker ("" in the base class)
    model_version = ""

    def __init__(
        self,
        model_fp: str | Path,
        *,
        model_version: str | None = None,
        logger: logging.Logger | None = None,
    ):
        path = Path(model_fp).expanduser().resolve()
        assert path.exists(), f"no model artifact at {path}"
        self.model_fp = path
        self.log = logger if logger is not None else logging.getLogger(type(self).__module__)
        if model_version is None:
            return
        assert model_version, "requested model_version must be a non-empty string"
        declared = type(self).model_version
        if not declared:
            # Base-class instantiation with an explicit version: adopt it.
            self.model_version = model_version
        else:
            assert model_version == declared, (
                f"version mismatch: this worker serves '{declared}', "
                f"caller asked for '{model_version}'"
            )

    @classmethod
    def is_valid(cls, model_fp: str | Path) -> bool:
        """Cheap artifact pre-check used by the CLI before committing to a run."""
        try:
            return Path(model_fp).expanduser().resolve().exists()
        except OSError:
            return False

    # -- lifecycle ----------------------------------------------------------
    # Subclasses acquire their engine in __enter__ and drop it in __exit__.

    def __enter__(self) -> "Model":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False  # never swallow exceptions

    # -- work ---------------------------------------------------------------

    def run(self, **kwargs: Any) -> dict[str, Any]:
        """Execute the worker's ToHR flow; concrete workers must override."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement run(); "
            "every ModelWorker subclass must"
        )
