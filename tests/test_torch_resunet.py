"""ResUNet trunk/tail: the port vs the JAX package on the CPU.

Tolerance atol/rtol 1e-5: both sides compute in f32, but the convolutions
sum in a different order (XLA's CPU conv vs oneDNN).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from floodsr_tpu.nn.checkpoint import load_artifact as load_artifact_jax
from floodsr_tpu.nn.resunet import ResUNetConfig as ResUNetConfigJax
from floodsr_tpu.nn.resunet import (
    _conv,
    _conv_transpose,
    _res_block,
    init_resunet,
    resunet_tail_apply,
    resunet_trunk_apply,
)
from floodsr_tpu_torch.nn.checkpoint import params_from_jax
from floodsr_tpu_torch.nn.resunet import (
    Conv,
    ResBlock,
    ResUNet,
    ResUNetConfig,
    conv2d_same,
    conv_transpose_nhwc,
    hr_tail_eligible,
    resolve_precision_policy,
    same_pads,
)

pytestmark = pytest.mark.unit

TOL = dict(atol=1e-5, rtol=1e-5)
ARTIFACTS = Path(__file__).parent / "data" / "_artifacts"

TINY_FUSE2 = dict(
    base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
    fuse_filters=8, fuse_blocks=2, scale=4, lr_tile=16, hr_s2d=2,
)


def _model(cfg_dict, params, state):
    model = ResUNet(ResUNetConfig.from_dict(cfg_dict))
    model.load_state_dict(params_from_jax(params, state), strict=True)
    return model.eval()


def _artifact(name):
    a = load_artifact_jax(ARTIFACTS / name)
    return a["config"], a["params"], a["state"]


def _tiny():
    cfg = ResUNetConfigJax(**TINY_FUSE2)
    params, state = init_resunet(4, cfg)
    return cfg, params, state


CASES = {
    "test_artifact": lambda: _artifact("model_infer_test.fsrz"),
    "tiny_fuse2": _tiny,
}


def _inputs(cfg, n=2, seed=0):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0, 1, (n, cfg.lr_tile, cfg.lr_tile, 1)).astype(np.float32)
    dem = rng.uniform(0, 1, (n, cfg.hr_tile, cfg.hr_tile, 1)).astype(np.float32)
    return depth, dem


@pytest.mark.parametrize("case", sorted(CASES))
def test_trunk_and_tail_match_jax(case):
    cfg, params, state = CASES[case]()
    model = _model(cfg.to_dict(), params, state)
    depth, dem = _inputs(cfg)
    feat_j, _ = resunet_trunk_apply(params, state, jnp.asarray(depth), jnp.asarray(dem), cfg)
    feat_t = model.trunk(torch.from_numpy(depth), torch.from_numpy(dem))
    np.testing.assert_allclose(feat_t.numpy(), np.asarray(feat_j), **TOL)

    # Tail on the SAME features (so the check isolates the tail).
    out_j, _ = resunet_tail_apply(
        params, state, feat_j, jnp.asarray(dem), cfg, pallas_tail=False
    )
    out_t = model.tail(torch.from_numpy(np.asarray(feat_j)), torch.from_numpy(dem))
    assert out_t.shape == tuple(out_j.shape)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    # The fused-tail dispatch is a property of the configuration.
    assert hr_tail_eligible(model) == (cfg.fuse_blocks == 2)


def test_tail_repacks_fused_weights_after_a_reload():
    # The packed hr_tail weights are cached on the module; loading other
    # weights into the same module must be seen by the next tail call.
    cfg, params, state = _tiny()
    params2, state2 = init_resunet(5, cfg)
    model = _model(cfg.to_dict(), params, state)
    depth, dem = _inputs(cfg)
    feat = torch.from_numpy(np.asarray(
        resunet_trunk_apply(params2, state2, jnp.asarray(depth), jnp.asarray(dem), cfg)[0]
    ))
    model.tail(feat, torch.from_numpy(dem))
    model.load_state_dict(params_from_jax(params2, state2), strict=True)
    out_j, _ = resunet_tail_apply(
        params2, state2, jnp.asarray(feat.numpy()), jnp.asarray(dem), cfg, pallas_tail=False
    )
    np.testing.assert_allclose(
        model.tail(feat, torch.from_numpy(dem)).numpy(), np.asarray(out_j), **TOL
    )


def test_flagship_trunk_matches_jax():
    cfg, params, state = _artifact("model_infer_flagship.fsrz")
    model = _model(cfg.to_dict(), params, state)
    depth, dem = _inputs(cfg, n=1, seed=3)
    feat_j, _ = resunet_trunk_apply(params, state, jnp.asarray(depth), jnp.asarray(dem), cfg)
    feat_t = model.trunk(torch.from_numpy(depth), torch.from_numpy(dem))
    want = np.asarray(feat_j)
    # The flagship's deep trunk reaches features of ~1e4; an f32 sum in
    # another order errs by a few ulps of the layer's magnitude, not of each
    # element's, so the absolute tolerance scales with max |features|.
    np.testing.assert_allclose(
        feat_t.numpy(), want, atol=1e-5 * float(np.abs(want).max()), rtol=1e-5
    )


def test_same_pads_follow_xla():
    assert same_pads(16, 3, 1) == (1, 1)
    assert same_pads(16, 3, 2) == (0, 1)   # even input: nothing before, one after
    assert same_pads(15, 3, 2) == (1, 1)
    assert same_pads(16, 1, 2) == (0, 0)
    assert same_pads(8, 2, 2) == (0, 0)


@pytest.mark.parametrize("size", [16, 15])
@pytest.mark.parametrize("kernel", [3, 1])
def test_stride2_same_conv_matches_jax(size, kernel):
    rng = np.random.default_rng(size * 10 + kernel)
    cin, cout = 5, 7
    w = rng.normal(0, 1, (kernel, kernel, cin, cout)).astype(np.float32)
    b = rng.normal(0, 1, (cout,)).astype(np.float32)
    x = rng.normal(0, 1, (2, size, size, cin)).astype(np.float32)
    want = np.asarray(_conv({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), stride=2))
    conv = Conv(kernel, kernel, cin, cout)
    conv.w.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    conv.b.data = torch.from_numpy(b)
    got = conv2d_same(torch.from_numpy(x).permute(0, 3, 1, 2), conv, stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    if kernel == 3 and size % 2 == 0:
        # The trap: symmetric padding=1 samples a shifted grid on even inputs.
        naive = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), conv.w, conv.b, 2, 1)
        assert not np.allclose(naive.permute(0, 2, 3, 1).numpy(), want, atol=1e-3)


@pytest.mark.parametrize("stride", [2, 1])
def test_conv_transpose_matches_jax(stride):
    rng = np.random.default_rng(stride)
    w = rng.normal(0, 1, (stride, stride, 6, 4)).astype(np.float32)
    b = rng.normal(0, 1, (4,)).astype(np.float32)
    x = rng.normal(0, 1, (2, 5, 7, 6)).astype(np.float32)
    want = np.asarray(_conv_transpose({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), stride))
    conv = Conv(stride, stride, 6, 4)
    conv.w.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    conv.b.data = torch.from_numpy(b)
    got = conv_transpose_nhwc(torch.from_numpy(x), conv, stride)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("cin,cout,stride", [(6, 6, 2), (6, 8, 2), (8, 8, 1)])
def test_res_block_matches_jax(cin, cout, stride):
    # (6, 6, 2) has no proj: the strided-slice shortcut.
    from floodsr_tpu.nn.resunet import _res_block_init

    rng = np.random.default_rng(cin + cout + stride)
    p, s = _res_block_init(rng, cin, cout)
    for bn in ("bn1", "bn2"):
        c = p[bn]["scale"].shape[0]
        p[bn]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        p[bn]["offset"] = rng.normal(0, 0.1, c).astype(np.float32)
        s[bn]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        s[bn]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    x = rng.normal(0, 1, (2, 10, 12, cin)).astype(np.float32)
    cfg = ResUNetConfigJax()
    want, _ = _res_block(p, s, jnp.asarray(x), cfg, stride=stride)
    block = ResBlock(cin, cout)
    block.load_state_dict(params_from_jax(p, s), strict=True)
    got = block(torch.from_numpy(x).permute(0, 3, 1, 2), cfg.bn_eps, stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_only_the_f32_policy_runs():
    # ... unless another is asked for: no policy means every stage in f32.
    assert set(resolve_precision_policy(None).values()) == {torch.float32}
    assert resolve_precision_policy(None) == resolve_precision_policy("f32")
    for policy in ("bf16", "mixed"):
        assert resolve_precision_policy(policy)["trunk"] == torch.bfloat16
