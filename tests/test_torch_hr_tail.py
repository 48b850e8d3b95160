"""K1 (hr_tail): the port's plain version vs the JAX tail, and its wrapper.

Tolerance atol/rtol 2e-5, as the JAX package's own kernel test uses: both
sides compute in f32, but the five convolutions sum in different orders
(oneDNN here, XLA's CPU conv and the interpret-mode Pallas dots there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from floodsr_tpu.nn.resunet import ResUNetConfig as ResUNetConfigJax
from floodsr_tpu.nn.resunet import _conv, _res_block, init_resunet
from floodsr_tpu.ops.pallas.hr_tail import hr_tail_pallas
from floodsr_tpu.ops.pallas.hr_tail import pack_hr_tail_weights as pack_jax
from floodsr_tpu_torch.nn.checkpoint import params_from_jax
from floodsr_tpu_torch.nn.resunet import ResUNet, ResUNetConfig, hr_tail_eligible
from floodsr_tpu_torch.ops.kernels import hr_tail as ht

pytestmark = pytest.mark.unit

TOL = dict(atol=2e-5, rtol=2e-5)


def _setup(f=8, seed=4):
    """The JAX kernel test's tiny config (two fuse blocks, s2d 2)."""
    cfg = ResUNetConfigJax(
        base_filters=f, levels=2, enc_blocks=1, dec_blocks=1,
        fuse_filters=f, fuse_blocks=2, scale=4, lr_tile=16, hr_s2d=2,
    )
    params, state = init_resunet(seed, cfg)
    # Nontrivial BN statistics, so a mistake in the folding shows.
    rng = np.random.default_rng(seed)
    for blk_p, blk_s in zip(params["fuse"], state["fuse"]):
        for bn in ("bn1", "bn2"):
            c = blk_p[bn]["scale"].shape[0]
            blk_p[bn]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            blk_p[bn]["offset"] = rng.normal(0, 0.1, c).astype(np.float32)
            blk_s[bn]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            blk_s[bn]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    model = ResUNet(ResUNetConfig.from_dict(cfg.to_dict()))
    model.load_state_dict(params_from_jax(params, state), strict=True)
    return cfg, params, state, model.eval()


def _features(cfg, b, h, w, seed):
    rng = np.random.default_rng(seed)
    sr = rng.normal(0, 1, (b, h, w, cfg.base_filters * cfg.hr_s2d)).astype(np.float32)
    dem = rng.normal(0, 1, (b, h, w, cfg.fuse_filters)).astype(np.float32)
    return sr, dem


def _unfused_jax(cfg, params, state, sr, dem):
    x = jnp.concatenate([jnp.asarray(sr), jnp.asarray(dem)], axis=-1)
    for bp, bs in zip(params["fuse"], state["fuse"]):
        x, _ = _res_block(bp, bs, x, cfg, train=False)
    return np.asarray(_conv(params["head"], x.astype(jnp.float32)))


def _jax_weights(cfg, params, state):
    f1 = {"params": params["fuse"][0], "state": state["fuse"][0]}
    f2 = {"params": params["fuse"][1], "state": state["fuse"][1]}
    return pack_jax(f1, f2, params["head"], bn_eps=cfg.bn_eps)


def _torch_weights(cfg, model):
    return ht.pack_hr_tail_weights(model.fuse[0], model.fuse[1], model.head, bn_eps=cfg.bn_eps)


def test_packed_weights_match_jax():
    # Same BN fold (rsqrt, then products) in f32: equal to a few ulps.
    cfg, params, state, model = _setup()
    for key, got, want in zip(
        ht.WEIGHT_KEYS, _torch_weights(cfg, model), _jax_weights(cfg, params, state)
    ):
        assert tuple(got.shape) == tuple(want.shape), key
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7, err_msg=key)


# (b, h, w, band): two bands with interior halos; one band covering the
# whole height, where the halo rows are all image edge.
@pytest.mark.parametrize("b,h,w,band", [(2, 32, 64, 16), (2, 32, 64, 32)])
def test_plain_version_matches_pallas_interpret_and_unfused_chain(b, h, w, band):
    cfg, params, state, model = _setup()
    sr, dem = _features(cfg, b, h, w, seed=band)
    got = ht.hr_tail_reference(
        torch.from_numpy(sr), torch.from_numpy(dem), *_torch_weights(cfg, model)
    ).numpy()
    pallas = np.asarray(
        hr_tail_pallas(
            jnp.asarray(sr), jnp.asarray(dem), *_jax_weights(cfg, params, state),
            band=band, interpret=True, mode="f32",
        )
    )
    chain = _unfused_jax(cfg, params, state, sr, dem)
    assert got.shape == pallas.shape == chain.shape == (b, h, w, cfg.hr_s2d**2)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, chain, **TOL)


def test_image_edge_rows_see_zero_padding_after_the_activation():
    # SAME padding falls on each post-activation tensor: with a large BN
    # offset, relu(a*0 + c) != 0 would leak into the edge rows if the pad
    # were applied before the affine. The plain version must match the JAX
    # chain on the edge rows and columns exactly as inside.
    cfg, params, state, model = _setup(seed=6)
    for blk_p in params["fuse"]:
        blk_p["bn1"]["offset"] = np.full_like(blk_p["bn1"]["offset"], 2.0)
    model.load_state_dict(params_from_jax(params, state), strict=True)
    sr, dem = _features(cfg, 1, 16, 32, seed=11)
    got = ht.hr_tail_reference(
        torch.from_numpy(sr), torch.from_numpy(dem), *_torch_weights(cfg, model)
    ).numpy()
    chain = _unfused_jax(cfg, params, state, sr, dem)
    for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert np.isfinite(edge).all()
    np.testing.assert_allclose(got[:, [0, -1]], chain[:, [0, -1]], **TOL)
    np.testing.assert_allclose(got[:, :, [0, -1]], chain[:, :, [0, -1]], **TOL)


def test_model_tail_dispatches_to_hr_tail_on_an_eligible_config(monkeypatch):
    # fuse_blocks=2 (proj on the first block, identity on the second) is
    # eligible: the tail runs through hr_tail, which on the CPU is the plain
    # version, and agrees with the unfused block chain.
    cfg, params, state, model = _setup()
    assert hr_tail_eligible(model)
    rng = np.random.default_rng(2)
    feat = torch.from_numpy(rng.normal(0, 1, (2, 16, 16, cfg.base_filters)).astype(np.float32))
    dem = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 1)).astype(np.float32))
    calls = []
    original = ht.hr_tail

    def spy(*args):
        calls.append(args[0].shape)
        return original(*args)

    monkeypatch.setattr(ht, "hr_tail", spy)
    out = model.tail(feat, dem)
    assert calls == [(2, 32, 32, cfg.base_filters * cfg.hr_s2d)]
    from floodsr_tpu.nn.resunet import resunet_tail_apply

    want, _ = resunet_tail_apply(
        params, state, jnp.asarray(feat.numpy()), jnp.asarray(dem.numpy()), cfg,
        pallas_tail=False,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_wrapper_input_checks():
    cfg, _, _, model = _setup()
    weights = _torch_weights(cfg, model)
    sr = torch.zeros(1, 8, 8, cfg.base_filters * cfg.hr_s2d)
    dem = torch.zeros(1, 8, 8, cfg.fuse_filters)
    with pytest.raises(ValueError, match="CUDA"):
        ht.hr_tail_cuda(sr, dem, *weights)
    with pytest.raises(ValueError, match="unsupported device"):
        ht.hr_tail(sr.to("meta"), dem.to("meta"), *weights)
    ht.launches = 0
    out = ht.hr_tail(sr, dem, *weights)
    assert out.shape == (1, 8, 8, cfg.hr_s2d**2)
    assert ht.launches == 0  # the plain version is no launch

