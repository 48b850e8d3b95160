"""The port's resident train step, loop and eval step vs ``floodsr_tpu.train``.

The resident step and loop are fed the draws the JAX package's
``_resident_step_body`` makes from a ``jax.random`` key (recomputed here from
the key: ``split(key, 3)`` → batch indices, rotation, flip; the loop splits
its key into one per step), so both sides train on the same batches.
Tolerances as in ``test_torch_train_step.py``: loss rtol 1e-5 per step;
each parameter within 1e-3 of its leaf's max displacement from init, at most
0.1% of a leaf's elements (at least one) excepted and held to Adam's bound
``3.2 · Σ lr``, the ``conv1.b`` leaves (zero true gradient) to that bound
alone. Eval metrics on the same weights: rtol 1e-4 (``psnr`` and ``ssim``
1e-4 abs).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from floodsr_tpu.nn.resunet import ResUNetConfig as ResUNetConfigJax
from floodsr_tpu.nn.resunet import init_resunet as init_resunet_jax
from floodsr_tpu.train import trainer as tj
from floodsr_tpu_torch.nn.checkpoint import params_from_jax, params_to_jax
from floodsr_tpu_torch.nn.resunet import ResUNetConfig
from floodsr_tpu_torch.train import trainer as tt

pytestmark = pytest.mark.unit

TINY = dict(
    base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
    fuse_filters=8, fuse_blocks=1, scale=4, lr_tile=8,
)
NARROW = dict(TINY, fuse_blocks=2, hr_s2d=2)
TCFG = dict(total_steps=100, base_lr=1e-3)
BATCH = 3


def _data(cfg: dict, n: int = 6, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    lr, hr = cfg["lr_tile"], cfg["lr_tile"] * cfg["scale"]
    return {
        "depth_lr": rng.uniform(0, 1, (n, lr, lr)).astype(np.float32),
        "dem_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
        "target_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
    }


def _draws(key, n: int) -> tuple[torch.Tensor, int, bool]:
    """The draws ``_resident_step_body`` makes from ``key``."""
    ki, kr, kf = jax.random.split(key, 3)
    idx = jax.random.randint(ki, (BATCH,), 0, n)
    k_rot = jax.random.randint(kr, (), 0, 4)
    flip = jax.random.bernoulli(kf)
    return torch.from_numpy(np.asarray(idx).astype(np.int64)), int(k_rot), bool(flip)


def _paths(tree) -> dict[str, np.ndarray]:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def _check_params(state_t, state_j, cfg: dict, steps: int) -> None:
    init = _paths(init_resunet_jax(0, ResUNetConfigJax(**cfg))[0])
    got = _paths(params_to_jax(state_t.model.state_dict())[0])
    bound = 3.2 * TCFG["base_lr"] * steps
    for key, w in _paths(state_j.params).items():
        g = got[key]
        assert np.abs(g - init[key]).max() <= bound, key
        if key.endswith("['conv1']['b']"):
            continue
        off = np.abs(g - w) > 1e-3 * np.abs(w - init[key]).max()
        assert off.sum() <= max(1, 1e-3 * off.size), (key, off.sum())


def _states(cfg: dict):
    state_j = tj.init_train_state(0, ResUNetConfigJax(**cfg), tj.TrainConfig(**TCFG))
    state_t = tt.init_train_state(0, ResUNetConfig(**cfg), tt.TrainConfig(**TCFG), device="cpu")
    return state_j, state_t


def test_resident_step_matches_jax_on_its_draws():
    cfg = TINY
    data = _data(cfg)
    state_j, state_t = _states(cfg)
    step_j = tj.make_resident_train_step(
        ResUNetConfigJax(**cfg), tj.TrainConfig(**TCFG), batch_size=BATCH
    )
    step_t = tt.make_resident_train_step(
        ResUNetConfig(**cfg), tt.TrainConfig(**TCFG), batch_size=BATCH
    )
    staged = {k: torch.from_numpy(v) for k, v in data.items()}
    data_j = {k: jnp.asarray(v) for k, v in data.items()}
    root = jax.random.key(11)
    for i in range(2):
        key = jax.random.fold_in(root, i)
        draws = _draws(key, len(data["depth_lr"]))
        state_j, mj = step_j(state_j, data_j, key)
        state_t, mt = step_t(state_t, staged, draws)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-5)
    assert state_t.step == int(state_j.step) == 2
    _check_params(state_t, state_j, cfg, 2)


def test_resident_loop_matches_jax_on_its_draws():
    cfg = TINY
    data = _data(cfg, seed=1)
    state_j, state_t = _states(cfg)
    steps = 3
    loop_j = tj.make_resident_train_loop(
        ResUNetConfigJax(**cfg), tj.TrainConfig(**TCFG), batch_size=BATCH, steps_per_call=steps
    )
    loop_t = tt.make_resident_train_loop(
        ResUNetConfig(**cfg), tt.TrainConfig(**TCFG), batch_size=BATCH, steps_per_call=steps
    )
    key = jax.random.key(5)
    draws = [_draws(k, len(data["depth_lr"])) for k in jax.random.split(key, steps)]
    state_j, losses_j = loop_j(state_j, {k: jnp.asarray(v) for k, v in data.items()}, key)
    state_t, losses_t = loop_t(state_t, {k: torch.from_numpy(v) for k, v in data.items()}, draws)
    assert isinstance(losses_t, torch.Tensor) and losses_t.shape == (steps,)
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=1e-5)
    assert state_t.step == int(state_j.step) == steps
    _check_params(state_t, state_j, cfg, steps)
    with pytest.raises(ValueError):
        loop_t(state_t, {k: torch.from_numpy(v) for k, v in data.items()}, draws[:2])


def test_resident_rng_draws_on_the_given_generators():
    staged = {k: torch.from_numpy(v) for k, v in _data(TINY).items()}
    state = tt.init_train_state(0, ResUNetConfig(**TINY), tt.TrainConfig(**TCFG), device="cpu")
    loop = tt.make_resident_train_loop(
        ResUNetConfig(**TINY), tt.TrainConfig(**TCFG), batch_size=BATCH, steps_per_call=2
    )
    rng = tt.ResidentRng.from_seed(3, device="cpu")
    state, losses = loop(state, staged, rng)
    assert state.step == 2 and torch.isfinite(losses).all()
    a, b = tt.ResidentRng.from_seed(3, "cpu"), tt.ResidentRng.from_seed(3, "cpu")
    for _ in range(4):
        da, db = a.draw(6, BATCH), b.draw(6, BATCH)
        assert torch.equal(da[0], db[0]) and da[1:] == db[1:]
        assert 0 <= da[1] < 4 and int(da[0].max()) < 6


@pytest.mark.parametrize("name", ["tiny", "narrow"])
def test_eval_step_metrics_match_jax(name):
    # narrow: the port's inference forward takes the fused tail (its plain
    # version on the CPU); the JAX eval leaves its Pallas tail off
    cfg = {"tiny": TINY, "narrow": NARROW}[name]
    state_j, state_t = _states(cfg)
    b = _data(cfg, n=4, seed=2)
    # one step first, so the running stats are no longer the init's
    state_j, _ = tj.make_train_step(ResUNetConfigJax(**cfg), tj.TrainConfig(**TCFG),
                                    donate=False)(state_j, b)
    state_t, _ = tt.make_train_step(ResUNetConfig(**cfg), tt.TrainConfig(**TCFG))(state_t, b)
    # evaluate both on the JAX package's weights, so only the eval path differs
    state_t.model.load_state_dict(params_from_jax(
        jax.tree.map(np.array, state_j.params), jax.tree.map(np.array, state_j.model_state),
    ))
    batch = _data(cfg, n=3, seed=3)
    want = tj.make_eval_step(ResUNetConfigJax(**cfg), tj.TrainConfig(**TCFG))(state_j, batch)
    got = tt.make_eval_step(ResUNetConfig(**cfg), tt.TrainConfig(**TCFG))(state_t, batch)
    assert sorted(got) == sorted(want)
    for key in want:
        w, g = float(want[key]), float(got[key])
        if key in ("psnr", "ssim"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7, err_msg=key)
