"""Synthetic flood-scene family the flagship was trained on.

Copy of the JAX package's ``floodsr_tpu/train/synth.py`` (numpy only): the
same seed gives the same bits, so the port trains on the distribution the
shipped weights saw (``bin/train_flagship.py``, the committed golden case
``tests/data/synth_flagship``). Terrain = ramp + two integrated-noise
roughness fields + a winding carved channel; truth = a tilted water surface
clipped to [0, 5] m depth.
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
    # A channel: carve a winding low path.
    t = np.linspace(0, 2 * np.pi, shape[1], dtype=np.float32)
    center = shape[0] * (0.5 + 0.25 * np.sin(t + rng.uniform(0, 6.3)))
    dist = np.abs(np.arange(shape[0], dtype=np.float32)[:, None] - center[None, :])
    channel = -6.0 * np.exp(-((dist / (shape[0] * 0.08)) ** 2))
    return 250.0 + yy + xx + rough + rough2 + channel


def make_truth(dem, seed, offset=3.0):
    rng = np.random.default_rng(np.random.Philox(seed + 1))
    wse = (
        np.quantile(dem, 0.25)
        + offset
        + np.linspace(-1.5, 1.5, dem.shape[1], dtype=np.float32)[None, :]
        + rng.uniform(-0.5, 0.5)
    )
    return np.clip(wse - dem, 0.0, 5.0).astype(np.float32)


def box_mean(arr, k):
    h, w = arr.shape
    return arr.reshape(h // k, k, w // k, k).mean(axis=(1, 3)).astype(np.float32)
