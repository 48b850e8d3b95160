"""Engine seam: what a model worker may assume about an inference backend.

The abstract method set matches the reference engine ABC
(``floodsr/engine/base.py``) so worker code and contract tests carry over
between backends; the torch engine layers ``run_tiles`` (batched) and
``run_scene`` (fused whole-scene) on top, with ``run_tile`` as the N=1 case.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np


@dataclass(frozen=True)
class ModelIOContract:
    """Tensor names + static spatial dims an engine commits to at load time.

    The reference resolves the equivalent record from ONNX session metadata
    (``floodsr/engine/ort.py``); the JAX engine resolves it from the artifact
    manifest. ``scale`` is the integer HR/LR edge ratio.
    """

    depth_input_name: str
    dem_input_name: str
    output_name: str
    depth_lr_hwc: tuple[int, int, int]
    dem_hr_hwc: tuple[int, int, int]
    output_hwc: tuple[int, int, int]
    scale: int


class EngineBase(ABC):
    """Minimal backend interface workers program against."""

    @abstractmethod
    def load(self) -> None:
        """Acquire model resources (weights, compiled functions, sessions)."""

    @abstractmethod
    def run_tile(
        self, depth_lr_m: np.ndarray, dem_hr_m: np.ndarray, **kwargs: Any
    ) -> dict[str, Any]:
        """Infer one HR depth tile from an (LR depth, HR DEM) pair in meters."""

    @abstractmethod
    def model_path(self) -> Path:
        """The artifact this engine was constructed over."""
