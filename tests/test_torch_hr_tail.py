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

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        # narrow widths: no tensor-core pack; no policy asked for: the f32 arithmetic
        assert kwargs == {"tc_pack": None, "mode": "f32"}
        return original(*args, **kwargs)

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



# ---------------------------------------------------------------------------
# the tensor-core route's arithmetic (3xTF32) and its weight pack, in plain torch
# ---------------------------------------------------------------------------


def _mantissa_low_bits(t):
    return t.contiguous().view(torch.int32) & 0x1FFF


def test_split_tf32_halves():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(0, 1, 4000), rng.normal(0, 1e4, 4000), rng.normal(0, 1e-4, 4000),
        [0.0, -0.0, 1.0, -1.0, 3.0e38, -3.0e38],
    ]).astype(np.float32)
    x = torch.from_numpy(x)
    hi, lo = ht.split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32
    # hi and lo are TF32 values: the low 13 mantissa bits are zero
    assert not _mantissa_low_bits(hi).any() and not _mantissa_low_bits(lo).any()
    # hi + lo carries 21-22 mantissa bits of x
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= 2.0**-21 * x.double().abs()).all())
    assert bool(((x.double() - hi.double()).abs() <= 2.0**-11 * x.double().abs()).all())
    # zeros and signs survive
    zeros = ht.split_tf32(torch.tensor([0.0, -0.0]))
    for part in zeros:
        assert part.tolist() == [0.0, 0.0]
    assert torch.signbit(zeros[0]).tolist() == [False, True]
    assert bool((torch.sign(hi) == torch.sign(x)).all())
    # inf and NaN pass through hi
    odd = ht.split_tf32(torch.tensor([float("inf"), float("-inf"), float("nan")]))[0]
    assert odd[0] == float("inf") and odd[1] == float("-inf") and torch.isnan(odd[2])


def test_split_tf32_rounds_ties_away_from_zero():
    # 1 + 2^-11 lies halfway between the TF32 neighbours 1 and 1 + 2^-10:
    # cvt.rna takes the one further from zero (ties-to-even would take 1).
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-10 + 2.0**-11, 1.0 + 2.0**-12])
    hi, lo = ht.split_tf32(x)
    assert hi.tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0 + 2.0**-9, 1.0]
    assert lo.tolist() == [-(2.0**-11), 2.0**-11, -(2.0**-11), 2.0**-12]


def _wide_weights(ca, cb, cm, ch, seed=0):
    rng = np.random.default_rng(seed)
    cin = ca + cb
    shapes = {
        "f1_a1": (cin,), "f1_c1": (cin,), "f1_w1": (3, 3, cin, cm), "f1_b1": (cm,),
        "f1_a2": (cm,), "f1_c2": (cm,), "f1_w2": (3, 3, cm, cm), "f1_b2": (cm,),
        "f1_pw": (cin, cm), "f1_pb": (cm,),
        "f2_a1": (cm,), "f2_c1": (cm,), "f2_w1": (3, 3, cm, cm), "f2_b1": (cm,),
        "f2_a2": (cm,), "f2_c2": (cm,), "f2_w2": (3, 3, cm, cm), "f2_b2": (cm,),
        "head_w": (cm, ch), "head_b": (ch,),
    }
    out = []
    for key in ht.WEIGHT_KEYS:
        shape = shapes[key]
        if key.endswith(("_a1", "_a2")):
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) > 1:
            v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        out.append(torch.from_numpy(v.astype(np.float32)))
    return out


def test_3xtf32_chain_stays_at_f32_level_where_one_tf32_product_does_not():
    # A narrow width with features of order 1e4, the flagship's magnitude.
    # Three split products hold 1e-5 of the output's range; one TF32 product
    # (hi * Whi alone) keeps about three decimal digits and misses it, which
    # is why the tensor-core route computes 3xTF32.
    ca, cb, cm, ch = 16, 16, 16, 4
    weights = _wide_weights(ca, cb, cm, ch, seed=3)
    rng = np.random.default_rng(4)
    sr = torch.from_numpy(np.abs(rng.normal(0, 1e4, (2, 12, 20, ca))).astype(np.float32))
    dem = torch.from_numpy(np.abs(rng.normal(0, 1e4, (2, 12, 20, cb))).astype(np.float32))
    want = ht.hr_tail_reference(sr, dem, *weights)
    scale = float(want.abs().max())
    assert scale > 1e3
    for accumulate in (torch.float32, torch.float64):
        three = ht.hr_tail_reference_3xtf32(sr, dem, *weights, accumulate=accumulate)
        assert three.shape == want.shape and three.dtype == torch.float32
        assert float((three - want).abs().max()) <= 1e-5 * scale
    one = ht.hr_tail_reference_3xtf32(sr, dem, *weights, products=1)
    assert float((one - want).abs().max()) > 1e-5 * scale
    with pytest.raises(ValueError, match="products"):
        ht.hr_tail_reference_3xtf32(sr, dem, *weights, products=2)


def test_tensor_core_pack_layout_and_round_trip():
    ca, cb, cm, ch = 128, 32, 128, 16
    cin = ca + cb
    assert ht.tc_eligible(ca, cb, cm, ch)
    weights = _wide_weights(ca, cb, cm, ch, seed=5)
    w = dict(zip(ht.WEIGHT_KEYS, weights))
    pack = ht.pack_hr_tail_tc(weights)
    assert len(pack) == len(ht.TC_PACK_KEYS) == 5
    # slabs: chunks x taps of each matrix; the projection rides behind f1.conv2
    want_slabs = [cin // 16 * 9, cm // 16 * 9 + cin // 16, cm // 16 * 9, cm // 16 * 9, cm // 16]
    for t, slabs, keys in zip(pack, want_slabs, ht.TC_PACK_KEYS):
        cout = ch if keys == ("head_w",) else cm
        assert tuple(t.shape) == (slabs, 2, 4, cout, 4) and t.dtype == torch.float32
        assert t.is_contiguous()
        assert not _mantissa_low_bits(t).any()  # every entry is a TF32 value

    def entry(t, first, taps, chunk, tap, ci, co):
        slab = t[first + chunk * taps + tap]  # [hi|lo][quad][cout][4]
        return slab[:, ci // 4, co, ci % 4]

    rng = np.random.default_rng(6)
    for _ in range(50):
        tap, ci, co = int(rng.integers(9)), int(rng.integers(cin)), int(rng.integers(cm))
        value = w["f1_w1"].reshape(9, cin, cm)[tap, ci, co]
        hi, lo = entry(pack[0], 0, 9, ci // 16, tap, ci % 16, co)
        assert hi == ht.split_tf32(value)[0] and float(hi) + float(lo) == pytest.approx(float(value), rel=2.0**-21)
        # the projection's slabs follow the 72 of f1.conv2
        value = w["f1_pw"][ci, co]
        hi, lo = entry(pack[1], (cm // 16) * 9, 1, ci // 16, 0, ci % 16, co)
        assert float(hi) + float(lo) == pytest.approx(float(value), rel=2.0**-21)
        ci2 = ci % cm
        value = w["f1_w2"].reshape(9, cm, cm)[tap, ci2, co]
        hi, lo = entry(pack[1], 0, 9, ci2 // 16, tap, ci2 % 16, co)
        assert float(hi) + float(lo) == pytest.approx(float(value), rel=2.0**-21)
        value = w["head_w"][ci2, co % ch]
        hi, lo = entry(pack[4], 0, 1, ci2 // 16, 0, ci2 % 16, co % ch)
        assert float(hi) + float(lo) == pytest.approx(float(value), rel=2.0**-21)


# The instantiated (Cm, Ch) pairs are the JAX package's three HR layouts at
# base and fuse width 32: hr_s2d 4 (the flagship), 2 and 1.
@pytest.mark.parametrize(
    "ca,cb,cm,ch,ok",
    [
        (128, 32, 128, 16, True), (64, 16, 128, 16, True), (16, 8, 16, 4, False),
        (128, 32, 128, 4, False), (126, 34, 128, 16, False), (128, 24, 128, 16, False),
        (128, 0, 128, 16, True), (64, 32, 64, 4, True), (32, 32, 32, 1, True),
    ],
)
def test_tensor_core_route_takes_the_instantiated_widths_only(ca, cb, cm, ch, ok):
    assert ht.tc_eligible(ca, cb, cm, ch) is ok


def test_model_tail_builds_the_tensor_core_pack_once_per_set_of_weights(monkeypatch):
    # The flagship's tail widths (128 + 32 -> 128 -> 16) on a shallow trunk.
    cfg = ResUNetConfig(
        base_filters=32, levels=1, enc_blocks=1, dec_blocks=1, fuse_filters=32,
        fuse_blocks=2, scale=16, lr_tile=2, hr_s2d=4,
    )
    model = ResUNet(cfg).eval()
    rng = np.random.default_rng(8)
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.from_numpy(rng.normal(0, 0.05, tuple(prm.shape)).astype(np.float32)))
    built, built_bf16 = [], []
    original, original_bf16 = ht.pack_hr_tail_tc, ht.pack_hr_tail_bf16
    monkeypatch.setattr(ht, "pack_hr_tail_tc", lambda ws: built.append(1) or original(ws))
    monkeypatch.setattr(
        ht, "pack_hr_tail_bf16", lambda ws: built_bf16.append(1) or original_bf16(ws)
    )
    passed = []
    original_tail = ht.hr_tail

    def spy(*args, tc_pack=None, mode="f32"):
        passed.append(tc_pack)
        return original_tail(*args, tc_pack=tc_pack, mode=mode)

    monkeypatch.setattr(ht, "hr_tail", spy)
    feat = torch.from_numpy(rng.normal(0, 1, (1, 2, 2, 32)).astype(np.float32))
    dem = torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, 1)).astype(np.float32))
    out1 = model.tail(feat, dem)
    out2 = model.tail(feat, dem)
    assert out1.shape == (1, 32, 32, 1) and torch.equal(out1, out2)
    assert len(built) == 1 and passed[0] is passed[1] and len(passed[0]) == 5
    # new weights (in-place load bumps the tensors' versions): a new pack
    model.load_state_dict(model.state_dict())
    model.tail(feat, dem)
    assert len(built) == 2 and passed[2] is not passed[0]
    # a bf16 tail gets the bf16 pack, built once beside the TF32 one and only
    # when a bf16 tail first runs
    assert built_bf16 == []
    model.tail(feat, dem, "bf16")
    model.tail(feat, dem, {"tail": "bf16"})
    model.tail(feat, dem, "mixed")  # an f32 tail again
    assert len(built_bf16) == 1 and len(built) == 2
    assert passed[3] is passed[4] and passed[3][0].dtype == torch.bfloat16
    assert passed[5] is passed[2]


def test_route_counters_reset_with_the_launch_counts():
    from floodsr_tpu_torch.ops import kernels

    ht.launches = 4
    ht.route_launches.update(tensor=1, direct=1, bf16=1, bf16_band=1, bf16_direct=1)
    kernels.reset_launch_counts()
    zeros = {"tensor": 0, "direct": 0, "bf16": 0, "bf16_band": 0, "bf16_direct": 0}
    assert ht.launches == 0 and ht.route_launches == zeros
    assert kernels.route_counts()["hr_tail"] == zeros


def test_kernel_library_is_stale_when_an_included_source_is_newer(tmp_path, monkeypatch):
    import os

    from floodsr_tpu_torch.ops.kernels import _build

    src, out = tmp_path / "csrc", tmp_path / "_build"
    src.mkdir()
    out.mkdir()
    (src / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    (src / "a.cuh").write_text('  #  include "sub/b.cuh"\n')
    (src / "sub").mkdir()
    (src / "sub" / "b.cuh").write_text('#include "../a.cuh"\n#include "../../outside.cuh"\n')
    (tmp_path / "outside.cuh").write_text("")
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    # the source, what it includes under csrc/ (directly or not), nothing else
    assert sorted(_build.source_files("k")) == sorted([src / "k.cu", src / "a.cuh", src / "sub" / "b.cuh"])
    assert _build._stale("k")  # no library yet
    lib = _build.library_path("k")
    lib.write_bytes(b"")
    for fp in _build.source_files("k"):
        os.utime(fp, (1000, 1000))
    os.utime(lib, (2000, 2000))
    assert not _build._stale("k")
    os.utime(src / "sub" / "b.cuh", (3000, 3000))
    assert _build._stale("k")
    # the kernels of this package include nothing of their own
    monkeypatch.undo()
    for name in ("hr_tail", "tile_stats", "relax_step"):
        assert _build.source_files(name) == [_build.SRC_DIR / f"{name}.cu"]
