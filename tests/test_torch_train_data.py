"""The port's training data path vs the JAX package's, on the CPU.

``synth``, ``split_indices``, ``PatchDataset.batches`` and
``stage_dataset_to_device`` are numpy on both sides and are held bit for bit;
the resident augmentation (``torch.rot90(k, dims=(1, 2))`` then a flip of the
last axis) bit for bit against ``jnp.rot90(x, k, axes=(1, 2))`` then
``x[:, :, ::-1]``; ``prefetch_to_device`` for order and values.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from floodsr_tpu.parallel.streaming import prefetch_to_device as prefetch_jax
from floodsr_tpu.train import PatchDataset as PatchDatasetJax
from floodsr_tpu.train import split_indices as split_indices_jax
from floodsr_tpu.train import synth as synth_jax
from floodsr_tpu.train.trainer import stage_dataset_to_device as stage_jax
from floodsr_tpu_torch.parallel.streaming import prefetch_to_device
from floodsr_tpu_torch.train import PatchDataset, split_indices, synth
from floodsr_tpu_torch.train.trainer import augment_batch, stage_dataset_to_device

pytestmark = pytest.mark.unit


def _arrays(n=6, lr=8, scale=4, seed=0):
    rng = np.random.default_rng(seed)
    hr = lr * scale
    return dict(
        depth_lr=rng.uniform(0, 5, (n, lr, lr)).astype(np.float32),
        dem_hr=rng.uniform(100, 300, (n, hr, hr)).astype(np.float32),
        target_hr=rng.uniform(0, 5, (n, hr, hr)).astype(np.float32),
    )


def _equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_synth_scenes_are_bit_equal():
    for seed in (0, 31000, 31007):
        dem = synth.make_terrain((64, 96), seed)
        assert _equal(dem, synth_jax.make_terrain((64, 96), seed))
        truth = synth.make_truth(dem, seed)
        assert _equal(truth, synth_jax.make_truth(dem, seed))
        assert _equal(synth.box_mean(truth, 16), synth_jax.box_mean(truth, 16))


def test_split_indices_is_bit_equal():
    for n, frac, seed in ((100, 0.2, 5), (24, 0.08, 0), (7, 0.0, 3)):
        got, want = split_indices(n, frac, seed), split_indices_jax(n, frac, seed)
        assert all(_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("augment", [False, True])
def test_batches_are_bit_equal(augment):
    arrays = _arrays()
    got = PatchDataset(**arrays).batches(np.arange(6), 2, seed=9, augment=augment, steps=5)
    want = PatchDatasetJax(**arrays).batches(np.arange(6), 2, seed=9, augment=augment, steps=5)
    pairs = list(zip(got, want))
    assert len(pairs) == 5
    for g, w in pairs:
        assert sorted(g) == sorted(w)
        assert all(_equal(g[k], w[k]) for k in w)


def test_stage_dataset_to_device_is_bit_equal():
    arrays = _arrays(n=5)
    idx = np.array([4, 0, 2])
    got = stage_dataset_to_device(PatchDataset(**arrays), idx, device="cpu")
    want = stage_jax(PatchDatasetJax(**arrays), idx)
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor) and _equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("k_rot", [0, 1, 2, 3])
def test_resident_rot90_and_flip_match_jnp(k_rot):
    rng = np.random.default_rng(k_rot)
    data = {
        "depth_lr": rng.normal(size=(5, 4, 6)).astype(np.float32),
        "dem_hr": rng.normal(size=(5, 16, 24)).astype(np.float32),
    }
    idx = np.array([3, 0, 3])
    for flip in (False, True):
        got = augment_batch({k: torch.from_numpy(v) for k, v in data.items()},
                            torch.from_numpy(idx), k_rot, flip)
        for key, value in data.items():
            want = jnp.rot90(jnp.asarray(value)[idx], k_rot, axes=(1, 2))
            if flip:
                want = want[:, :, ::-1]
            assert _equal(got[key].numpy(), want), (key, k_rot, flip)


def test_prefetch_keeps_order_and_values():
    batches = [
        {"a": np.full((4,), i, np.float32), "b": [np.arange(i + 1, dtype=np.int32)]}
        for i in range(7)
    ]
    got = list(prefetch_to_device(iter(batches), buffer_size=3, device="cpu"))
    want = list(prefetch_jax(iter(batches), buffer_size=3))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert isinstance(g["a"], torch.Tensor)
        assert _equal(g["a"].numpy(), w["a"]) and _equal(g["b"][0].numpy(), w["b"][0])


def test_prefetch_short_and_empty_iterators():
    got = list(prefetch_to_device(iter([np.ones(2)]), buffer_size=4, device="cpu"))
    assert len(got) == len(list(prefetch_jax(iter([np.ones(2)]), buffer_size=4))) == 1
    assert _equal(got[0].numpy(), np.ones(2))
    assert list(prefetch_to_device(iter([]), buffer_size=2, device="cpu")) == []
    with pytest.raises(AssertionError):
        list(prefetch_to_device(iter([np.ones(2)]), buffer_size=0, device="cpu"))
