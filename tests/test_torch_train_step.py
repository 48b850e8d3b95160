"""The port's train step vs the JAX package's ``floodsr_tpu.train`` on the CPU.

Same seeded numpy inputs through both. Tolerances:

- ``init_resunet``: bit for bit.
- train forward: output within 1e-5 of max |output| (f32 convolutions sum in
  another order: XLA's CPU conv vs oneDNN), new BN stats within 1e-5 abs.
- loss rtol 1e-5; ``grad_norm`` rtol 1e-5; each gradient leaf within 1e-4 of
  that leaf's max |g|. The bias of every block's first conv (``conv1.b``)
  feeds a batch norm alone, so its true gradient is 0 and both sides return
  rounding noise: it is held to 1e-4 of the largest gradient instead.
- after one and three optimizer steps: each Adam moment within 1e-3 of that
  leaf's max |moment|, counts exactly, and each parameter within 1e-3 of that
  leaf's max displacement from init. Adam divides every element by its own
  ``sqrt(nu)``, so an element whose gradient is at the rounding noise moves
  by up to ``lr`` either way: at most 0.1% of a leaf's elements (at least
  one) may miss the 1e-3, none may move more than Adam's own bound, ``3.2 ·
  Σ lr``, and the ``conv1.b`` leaves are held to that bound alone (their
  moments to 1e-3 of the largest moment). The running stats within 1e-5
  abs; ``bn2.mean`` sees ``conv1.b`` through its batch mean, so it may differ
  by ``(1 − momentum) · 2 · 3.2 · Σ lr`` more.
- ``bfloat16``: the train forward and its BN stats against eager
  ``resunet_apply(train=True, compute_dtype=bfloat16)`` (both round after
  every operation) to 1e-5 of max |output| and 1e-5 abs; the JAX package
  cannot differentiate that forward (see the test), so the bf16 loss and
  gradients are held to the f32 ones within the policy's own distance: loss
  and global gradient norm rtol 1e-2, cosine of the gradients > 0.99.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from floodsr_tpu.nn.resunet import ResUNetConfig as ResUNetConfigJax
from floodsr_tpu.nn.resunet import count_params as count_params_jax
from floodsr_tpu.nn.resunet import init_resunet as init_resunet_jax
from floodsr_tpu.nn.resunet import resunet_apply
from floodsr_tpu.train import trainer as tj
from floodsr_tpu_torch.nn.checkpoint import params_from_jax, params_to_jax
from floodsr_tpu_torch.nn.resunet import ResUNet, ResUNetConfig, count_params, init_resunet
from floodsr_tpu_torch.train import trainer as tt

pytestmark = pytest.mark.unit

TINY = dict(
    base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
    fuse_filters=8, fuse_blocks=1, scale=4, lr_tile=8,
)
# two fuse blocks, the first with a projection: the eval forward's fused tail
NARROW = dict(TINY, fuse_blocks=2, hr_s2d=2)
CONFIGS = {"tiny": TINY, "narrow": NARROW}
FLAGSHIP = dict(
    base_filters=32, levels=4, enc_blocks=2, dec_blocks=2, fuse_filters=32,
    fuse_blocks=2, scale=16, lr_tile=32, hr_s2d=4,
)


def _batch(cfg: dict, n: int = 4, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    lr, hr = cfg["lr_tile"], cfg["lr_tile"] * cfg["scale"]
    return {
        "depth_lr": rng.uniform(0, 1, (n, lr, lr)).astype(np.float32),
        "dem_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
        "target_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
    }


def _paths(tree) -> dict[str, np.ndarray]:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def _noise_leaf(path: str) -> bool:
    # conv1.b feeds the block's second batch norm alone: zero true gradient
    return path.endswith("['conv1']['b']")


def _model(cfg: dict, seed: int = 0) -> ResUNet:
    params, state = init_resunet(seed, ResUNetConfig(**cfg))
    model = ResUNet(ResUNetConfig(**cfg))
    model.load_state_dict(params_from_jax(params, state), strict=True)
    for p in model.parameters():
        p.requires_grad_(True)
    return model


@pytest.mark.parametrize("name", ["tiny", "narrow", "flagship"])
def test_init_resunet_is_bit_equal(name):
    cfg = FLAGSHIP if name == "flagship" else CONFIGS[name]
    pj, sj = init_resunet_jax(7, ResUNetConfigJax(**cfg))
    pt, st = init_resunet(7, ResUNetConfig(**cfg))
    for want, got in ((pj, pt), (sj, st)):
        w, g = _paths(want), _paths(got)
        assert list(w) == list(g)
        for key in w:
            assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key
    assert count_params(pt) == count_params_jax(pj)
    if name == "flagship":
        assert count_params(pt) == 16_661_616


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_forward_and_bn_stats_match_jax(name):
    cfg = CONFIGS[name]
    params, state = init_resunet_jax(3, ResUNetConfigJax(**cfg))
    b = _batch(cfg, seed=1)
    want, want_state = resunet_apply(
        params, state, jnp.asarray(b["depth_lr"])[..., None],
        jnp.asarray(b["dem_hr"])[..., None], ResUNetConfigJax(**cfg), train=True,
    )
    model = _model(cfg, seed=3)
    got, new_stats = model.forward_train(
        torch.from_numpy(b["depth_lr"])[..., None], torch.from_numpy(b["dem_hr"])[..., None]
    )
    assert got.requires_grad and got.shape == tuple(want.shape)
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    _, got_state = params_to_jax(new_stats)
    w, g = _paths(want_state), _paths(got_state)
    assert list(w) == list(g)
    for key in w:
        np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-5, err_msg=key)
    # the module's own buffers are left for the trainer to write
    assert torch.equal(model.enc[0][0].bn1.mean, torch.zeros_like(model.enc[0][0].bn1.mean))


def _check_grads(got: dict, want: dict, rel: float) -> None:
    top = max(np.abs(v).max() for v in want.values())
    for key, w in want.items():
        scale = top if _noise_leaf(key) else np.abs(w).max()
        np.testing.assert_allclose(got[key], w, rtol=0, atol=rel * scale, err_msg=key)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_gradients_and_grad_norm_match_jax(name):
    cfg = CONFIGS[name]
    cj = ResUNetConfigJax(**cfg)
    params, state = init_resunet_jax(5, cj)
    b = _batch(cfg, seed=2)
    (loss_j, _), grads_j = jax.value_and_grad(tj.mae_loss, has_aux=True)(
        params, state, *(jnp.asarray(b[k]) for k in ("depth_lr", "dem_hr", "target_hr")), cj,
    )
    model = _model(cfg, seed=5)
    loss_t, _ = tt.mae_loss(model, *(torch.from_numpy(b[k]) for k in ("depth_lr", "dem_hr", "target_hr")))
    loss_t.backward()
    grads_t = params_to_jax({k: p.grad for k, p in model.named_parameters()})[0]
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    _check_grads(_paths(grads_t), _paths(grads_j), 1e-4)
    # grad_norm as the optimizer reports it, on the raw gradients
    state_t = tt.init_train_state(5, ResUNetConfig(**cfg), tt.TrainConfig(), device="cpu")
    _, metrics = tt.make_train_step(ResUNetConfig(**cfg), tt.TrainConfig())(state_t, b)
    np.testing.assert_allclose(
        float(metrics["grad_norm"]), float(jax.tree_util.tree_reduce(
            lambda a, x: a + jnp.sum(x * x), grads_j, 0.0) ** 0.5), rtol=1e-5,
    )


STEP_CASES = {
    # the first step's raw gradient norm here is ~10: clipnorm 1 clips
    "clip": dict(total_steps=100, base_lr=1e-3),
    "noclip": dict(total_steps=100, base_lr=1e-3, clipnorm=1e3),
    "decay": dict(total_steps=100, base_lr=1e-3, weight_decay=0.05),
    # lr switches to second_lr at the schedule's count 2 (the third step)
    "lr_switch": dict(total_steps=4, base_lr=1e-3, second_lr=2.5e-4),
}


def _opt_paths(opt_state_np) -> tuple[int, dict, dict, int]:
    (count, mu, nu), (sched,) = opt_state_np[-1]
    return int(count), _paths(mu), _paths(nu), int(sched)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_steps_match_make_train_step(case):
    cfg = TINY
    tcfg = STEP_CASES[case]
    cj, ct = ResUNetConfigJax(**cfg), ResUNetConfig(**cfg)
    state_j = tj.init_train_state(0, cj, tj.TrainConfig(**tcfg))
    step_j = tj.make_train_step(cj, tj.TrainConfig(**tcfg), donate=False)
    state_t = tt.init_train_state(0, ct, tt.TrainConfig(**tcfg), device="cpu")
    step_t = tt.make_train_step(ct, tt.TrainConfig(**tcfg))
    init = _paths(init_resunet_jax(0, cj)[0])
    lrs = []
    for i in range(3):
        b = _batch(cfg, seed=10 + i)
        state_j, mj = step_j(state_j, b)
        state_t, mt = step_t(state_t, b)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-5)
        if case == "clip":
            assert float(mj["grad_norm"]) > 1.0
        if case == "noclip":
            assert float(mj["grad_norm"]) < 1e3
        lrs.append(tcfg["base_lr"] if i < tcfg["total_steps"] // 2 else tcfg.get("second_lr", 5e-5))
        if i not in (0, 2):
            continue
        assert state_t.step == int(state_j.step) == i + 1
        got_p, got_s = params_to_jax(state_t.model.state_dict())
        want_p = _paths(state_j.params)
        bound = 3.2 * sum(lrs)
        for key, w in want_p.items():
            g = _paths(got_p)[key]
            assert np.abs(g - init[key]).max() <= bound, key
            if _noise_leaf(key):
                continue
            move = np.abs(w - init[key]).max()
            off = np.abs(g - w) > 1e-3 * move
            assert off.sum() <= max(1, 1e-3 * off.size), (key, off.sum(), np.abs(g - w).max(), move)
        for key, w in _paths(state_j.model_state).items():
            # bn2's batch mean carries conv1.b, whose two sides may differ by 2 · bound
            atol = 1e-5 + (0.02 * bound if key.endswith("['bn2']['mean']") else 0.0)
            np.testing.assert_allclose(_paths(got_s)[key], w, rtol=0, atol=atol, err_msg=key)
        cj_, mu_j, nu_j, sj_ = _opt_paths(jax.tree.map(np.asarray, state_j.opt_state))
        ct_, mu_t, nu_t, st_ = _opt_paths(tt.opt_state_to_numpy(state_t.opt_state))
        assert ct_ == cj_ == i + 1 and st_ == sj_ == i + 1
        for want, got in ((mu_j, mu_t), (nu_j, nu_t)):
            top = max(np.abs(v).max() for v in want.values())
            for key, w in want.items():
                scale = top if _noise_leaf(key) else np.abs(w).max()
                np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-3 * scale, err_msg=key)


def test_bfloat16_train_forward_matches_eager_jax_and_its_gradients_stay_near_f32():
    # The JAX package cannot differentiate its own bf16 forward (its
    # transposed conv gets a float32 cotangent for a bfloat16 operand and
    # raises TypeError, jitted or eager), so the bf16 step is held to the
    # eager bf16 forward tightly and to the f32 gradients within the policy's
    # own distance.
    cfg = NARROW
    cj = ResUNetConfigJax(**cfg)
    params, state = init_resunet_jax(2, cj)
    b = _batch(cfg, seed=4)
    with jax.disable_jit():
        want, want_state = resunet_apply(
            params, state, jnp.asarray(b["depth_lr"])[..., None],
            jnp.asarray(b["dem_hr"])[..., None], cj, train=True, compute_dtype=jnp.bfloat16,
        )
    model = _model(cfg, seed=2)
    got, new_stats = model.forward_train(
        torch.from_numpy(b["depth_lr"])[..., None], torch.from_numpy(b["dem_hr"])[..., None],
        "bf16",
    )
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    w, g = _paths(want_state), _paths(params_to_jax(new_stats)[1])
    for key in w:
        np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-5, err_msg=key)

    args = [b[k] for k in ("depth_lr", "dem_hr", "target_hr")]
    (loss_j, _), grads_j = jax.value_and_grad(tj.mae_loss, has_aux=True)(
        params, state, *(jnp.asarray(a) for a in args), cj,
    )
    model.zero_grad()
    loss_t, _ = tt.mae_loss(model, *(torch.from_numpy(a) for a in args), compute_dtype=torch.bfloat16)
    loss_t.backward()
    gt = _paths(params_to_jax({k: p.grad for k, p in model.named_parameters()})[0])
    gj = _paths(grads_j)
    flat_t = np.concatenate([gt[k].ravel() for k in gj])
    flat_j = np.concatenate([gj[k].ravel() for k in gj])
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-2)
    np.testing.assert_allclose(np.linalg.norm(flat_t), np.linalg.norm(flat_j), rtol=1e-2)
    assert flat_t @ flat_j / (np.linalg.norm(flat_t) * np.linalg.norm(flat_j)) > 0.99
