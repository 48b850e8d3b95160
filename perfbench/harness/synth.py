"""The benchmark's terrain and flood scenarios, drawn from the seed (numpy).

``make_terrain`` is a frozen copy of ``floodsr_tpu_torch/train/synth.py``'s
(the family the flagship artifact was trained on): a ramp, two integrated
noise fields and a winding channel. A scenario is a tilted water surface over
that terrain, as ``make_truth`` draws it, box-averaged to the LR grid.
"""

from __future__ import annotations

import numpy as np


def make_terrain(shape, seed, relief=40.0):
    rng = np.random.default_rng(np.random.Philox(seed))
    yy = np.linspace(0, relief, shape[0], dtype=np.float32)[:, None]
    xx = np.linspace(0, relief * 0.7, shape[1], dtype=np.float32)[None, :]
    rough = np.cumsum(rng.normal(0, 0.15, shape).astype(np.float32), axis=1)
    rough -= rough.mean(axis=1, keepdims=True)
    rough2 = np.cumsum(rng.normal(0, 0.15, shape).astype(np.float32), axis=0)
    rough2 -= rough2.mean(axis=0, keepdims=True)
    t = np.linspace(0, 2 * np.pi, shape[1], dtype=np.float32)
    center = shape[0] * (0.5 + 0.25 * np.sin(t + rng.uniform(0, 6.3)))
    dist = np.abs(np.arange(shape[0], dtype=np.float32)[:, None] - center[None, :])
    channel = -6.0 * np.exp(-((dist / (shape[0] * 0.08)) ** 2))
    return (250.0 + yy + xx + rough + rough2 + channel).astype(np.float32)


def depth_lr(dem: np.ndarray, base: float, offset: float, tilt: float, lr_shape,
             max_depth: float) -> np.ndarray:
    """LR depth of a water surface ``base + offset + tilt * x`` (x from -1 to 1
    across the scene) over ``dem``, clipped to ``[0, max_depth]`` at HR and
    box-averaged to ``lr_shape`` (HR shape a whole multiple of it)."""
    h, w = dem.shape
    wse = np.float32(base + offset) + np.linspace(-tilt, tilt, w, dtype=np.float32)[None, :]
    truth = np.clip(wse - dem, 0.0, max_depth)
    kh, kw = h // lr_shape[0], w // lr_shape[1]
    return truth.reshape(lr_shape[0], kh, lr_shape[1], kw).mean(axis=(1, 3)).astype(np.float32)
