"""Training data pipeline: deterministic splits, augmentation, batching.

Copy of the JAX package's ``floodsr_tpu/train/data.py`` (numpy only, on the
port's own normalization helpers): deterministic index splitting, optional
flip/rot90 augmentation applied to training only, and repeat+batch as a
numpy generator feeding the train step (the host side of
:func:`floodsr_tpu_torch.parallel.streaming.prefetch_to_device`). The same
seeds give the same batches, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from floodsr_tpu_torch.ops.normalize import normalize_dem, scale_depth_log1p_np


def split_indices(
    n: int, val_fraction: float = 0.1, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic train/val index split (stable across runs and hosts)."""
    assert 0.0 <= val_fraction < 1.0
    rng = np.random.default_rng(np.random.Philox(seed))
    order = rng.permutation(n)
    n_val = int(round(n * val_fraction))
    return np.sort(order[n_val:]), np.sort(order[:n_val])


def _augment(depth_lr, dem_hr, target_hr, k_rot: int, flip: bool):
    """Apply the same rot90/flip to all three aligned patches."""
    arrays = [depth_lr, dem_hr, target_hr]
    if k_rot:
        arrays = [np.rot90(a, k=k_rot, axes=(0, 1)) for a in arrays]
    if flip:
        arrays = [a[:, ::-1] for a in arrays]
    return tuple(np.ascontiguousarray(a) for a in arrays)


@dataclass
class PatchDataset:
    """Aligned (depth_lr, dem_hr, target_hr) patches with normalized outputs.

    ``depth_lr``/``target_hr`` are meter-domain; ``dem_hr`` raw elevations.
    Iteration yields normalized batches ready for the train step.
    """

    depth_lr: np.ndarray  # [N, h, w]
    dem_hr: np.ndarray    # [N, H, W]
    target_hr: np.ndarray  # [N, H, W]
    max_depth: float = 5.0
    dem_pct_clip: float = 95.0

    def __post_init__(self):
        assert self.depth_lr.ndim == 3 and self.dem_hr.ndim == 3 and self.target_hr.ndim == 3
        n = self.depth_lr.shape[0]
        assert self.dem_hr.shape[0] == n and self.target_hr.shape[0] == n
        assert self.dem_hr.shape[1:] == self.target_hr.shape[1:]

    def __len__(self) -> int:
        return int(self.depth_lr.shape[0])

    def _normalized_example(self, idx: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        depth = scale_depth_log1p_np(self.depth_lr[idx], self.max_depth)
        target = scale_depth_log1p_np(self.target_hr[idx], self.max_depth)
        dem, _ = normalize_dem(self.dem_hr[idx], pct_clip=self.dem_pct_clip)
        return depth, dem, target

    def batches(
        self,
        indices: np.ndarray,
        batch_size: int,
        *,
        seed: int = 0,
        augment: bool = False,
        repeat: bool = True,
        steps: int | None = None,
    ):
        """Yield normalized batches; shuffles and augments deterministically."""
        rng = np.random.default_rng(np.random.Philox(seed))
        emitted = 0
        while True:
            order = rng.permutation(indices)
            for start in range(0, len(order) - batch_size + 1, batch_size):
                take = order[start : start + batch_size]
                depth_b, dem_b, target_b = [], [], []
                for idx in take:
                    depth, dem, target = self._normalized_example(int(idx))
                    if augment:
                        k_rot = int(rng.integers(0, 4))
                        flip = bool(rng.integers(0, 2))
                        depth, dem, target = _augment(depth, dem, target, k_rot, flip)
                    depth_b.append(depth)
                    dem_b.append(dem)
                    target_b.append(target)
                yield {
                    "depth_lr": np.stack(depth_b),
                    "dem_hr": np.stack(dem_b),
                    "target_hr": np.stack(target_b),
                }
                emitted += 1
                if steps is not None and emitted >= steps:
                    return
            if not repeat:
                return
