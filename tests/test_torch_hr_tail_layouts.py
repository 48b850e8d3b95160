"""K1 (hr_tail) at the JAX package's other two HR layouts, on the CPU.

``ResUNetConfig.hr_s2d`` 2 and 1 at the flagship's base and fuse widths (32)
give the tail 64 + 32 -> 64 -> 4 and 32 + 32 -> 32 -> 1, the widths the
tensor-core routes are instantiated for beside the flagship's 128 + 32 -> 128
-> 16. Here: their weight packs (the head padded to the wgmma's 8 columns),
the plain versions against the Pallas kernel in interpret mode at those
widths (f32 at the JAX kernel test's 2e-5, bf16 up to flipped roundings, as
``tests/test_torch_precision.py`` holds the flagship's), ``ResUNet.tail``
taking K1 with the pack built once, and ``tohr`` against the JAX package's.
The kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from floodsr_tpu.nn import ResUNetConfig as ResUNetConfigJax
from floodsr_tpu.nn import init_resunet
from floodsr_tpu.nn.checkpoint import save_artifact
from floodsr_tpu.ops.pallas.hr_tail import hr_tail_pallas
from floodsr_tpu.ops.pallas.hr_tail import pack_hr_tail_weights as pack_jax
from floodsr_tpu.tohr import tohr as tohr_jax
from floodsr_tpu_torch.io import from_origin, read_raster, write_raster
from floodsr_tpu_torch.nn.checkpoint import params_from_jax
from floodsr_tpu_torch.nn.resunet import ResUNet, ResUNetConfig
from floodsr_tpu_torch.ops.kernels import hr_tail as ht
from floodsr_tpu_torch.tohr import tohr as tohr_torch

pytestmark = pytest.mark.unit

TOL = dict(atol=2e-5, rtol=2e-5)
#: share of the output's range a flipped bf16 rounding may move it by (as
#: tests/test_torch_precision.py)
FLIP = 4e-3
#: hr_s2d -> (Ca, Cb, Cm, Ch) at base and fuse width 32
LAYOUTS = {2: (64, 32, 64, 4), 1: (32, 32, 32, 1)}


def _config(s2d, **kw):
    """The layout's full tail widths on a shallow trunk (levels 2, 8² LR tiles)."""
    base = dict(
        base_filters=32, levels=2, enc_blocks=1, dec_blocks=1, fuse_filters=32,
        fuse_blocks=2, scale=16, lr_tile=8, hr_s2d=s2d,
    )
    return ResUNetConfigJax(**{**base, **kw})


def _setup(s2d, seed):
    """JAX trees and the port's model of one layout, with nontrivial BN statistics."""
    cfg = _config(s2d)
    params, state = init_resunet(seed, cfg)
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


def _weights(cfg, params, state, model):
    f1 = {"params": params["fuse"][0], "state": state["fuse"][0]}
    f2 = {"params": params["fuse"][1], "state": state["fuse"][1]}
    jax_w = pack_jax(f1, f2, params["head"], bn_eps=cfg.bn_eps)
    torch_w = ht.pack_hr_tail_weights(model.fuse[0], model.fuse[1], model.head, bn_eps=cfg.bn_eps)
    return jax_w, torch_w


def _features(s2d, seed, b=1, h=32, w=64):
    ca, cb, _, _ = LAYOUTS[s2d]
    rng = np.random.default_rng(seed)
    sr = np.abs(rng.normal(0, 1, (b, h, w, ca))).astype(np.float32)
    dem = np.abs(rng.normal(0, 1, (b, h, w, cb))).astype(np.float32)
    return sr, dem


def _random_weights(s2d, seed):
    ca, cb, cm, ch = LAYOUTS[s2d]
    cin = ca + cb
    shapes = {
        "f1_a1": (cin,), "f1_c1": (cin,), "f1_w1": (3, 3, cin, cm), "f1_b1": (cm,),
        "f1_a2": (cm,), "f1_c2": (cm,), "f1_w2": (3, 3, cm, cm), "f1_b2": (cm,),
        "f1_pw": (cin, cm), "f1_pb": (cm,),
        "f2_a1": (cm,), "f2_c1": (cm,), "f2_w1": (3, 3, cm, cm), "f2_b1": (cm,),
        "f2_a2": (cm,), "f2_c2": (cm,), "f2_w2": (3, 3, cm, cm), "f2_b2": (cm,),
        "head_w": (cm, ch), "head_b": (ch,),
    }
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.normal(0.0, 0.2, shapes[key]).astype(np.float32))
        for key in ht.WEIGHT_KEYS
    ]


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


# ---------------------------------------------------------------------------
# the packs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s2d", [2, 1])
def test_tensor_core_pack_layout_round_trip_and_padded_head(s2d):
    ca, cb, cm, ch = LAYOUTS[s2d]
    cin = ca + cb
    assert ht.tc_eligible(ca, cb, cm, ch) and ht.head_columns(ch) == 8
    weights = _random_weights(s2d, seed=10 + s2d)
    w = dict(zip(ht.WEIGHT_KEYS, weights))
    pack = ht.pack_hr_tail_tc(weights)
    want_slabs = [cin // 16 * 9, cm // 16 * 9 + cin // 16, cm // 16 * 9, cm // 16 * 9, cm // 16]
    for t, slabs, keys in zip(pack, want_slabs, ht.TC_PACK_KEYS):
        cout = 8 if keys == ("head_w",) else cm
        assert tuple(t.shape) == (slabs, 2, 4, cout, 4) and t.dtype == torch.float32
        assert t.is_contiguous()
        assert not (t.view(torch.int32) & 0x1FFF).any()  # every entry a TF32 value
    assert [s for s, _ in ht._pack_shapes("tensor", w)] == [tuple(t.shape) for t in pack]
    # the head's columns beyond Ch are zeros in both halves
    assert not pack[4][:, :, :, ch:, :].any()

    def entry(t, first, taps, ci, tap, co, transposed=True):
        # [hi|lo][quad][cout][4]; the small widths' convolution slabs hold
        # chunk channel 4i + q at [q][.][i] (A from registers), the head 4q + i
        slab = t[first + (ci // 16) * taps + tap]
        q, i = (ci % 4, (ci % 16) // 4) if transposed else ((ci % 16) // 4, ci % 4)
        return slab[:, q, co, i]

    rng = np.random.default_rng(s2d)
    for _ in range(40):
        tap, ci, co = int(rng.integers(9)), int(rng.integers(cin)), int(rng.integers(cm))
        cases = [
            (w["f1_w1"].reshape(9, cin, cm)[tap, ci, co], entry(pack[0], 0, 9, ci, tap, co)),
            (w["f1_pw"][ci, co], entry(pack[1], (cm // 16) * 9, 1, ci, 0, co)),
            (w["f2_w2"].reshape(9, cm, cm)[tap, ci % cm, co],
             entry(pack[3], 0, 9, ci % cm, tap, co)),
            (w["head_w"][ci % cm, co % ch],
             entry(pack[4], 0, 1, ci % cm, 0, co % ch, transposed=False)),
        ]
        for value, (hi, lo) in cases:
            assert hi == ht.split_tf32(value)[0]
            assert float(hi) + float(lo) == pytest.approx(float(value), rel=2.0**-21, abs=1e-30)


@pytest.mark.parametrize("s2d", [2, 1])
def test_bf16_pack_layout_and_padded_head(s2d):
    ca, cb, cm, ch = LAYOUTS[s2d]
    cin = ca + cb
    weights = _random_weights(s2d, seed=20 + s2d)
    w = dict(zip(ht.WEIGHT_KEYS, weights))
    pack = ht.pack_hr_tail_bf16(weights)
    assert [t.dtype for t in pack] == [torch.bfloat16] * 4 + [torch.float32]
    assert tuple(pack[0].shape) == (9 * cin // 16, 2, cm, 8)
    assert tuple(pack[1].shape) == (9 * cm // 16 + cin // 16, 2, cm, 8)
    assert [s for s, _ in ht._pack_shapes("bf16", w)] == [tuple(t.shape) for t in pack]
    # slab (chunk c, tap t): [octet o][cout][k] is bf16(w[tap, 16 c + 8 o + k, cout])
    w1 = ht.round_bf16(w["f1_w1"].reshape(9, cin, cm))
    slabs = pack[0].float().reshape(cin // 16, 9, 2, cm, 8)
    assert torch.equal(slabs.permute(1, 0, 2, 4, 3).reshape(9, cin, cm), w1)
    w2 = ht.round_bf16(w["f1_w2"].reshape(9, cm, cm))
    conv2 = pack[1][: 9 * cm // 16].float().reshape(cm // 16, 9, 2, cm, 8)
    assert torch.equal(conv2.permute(1, 0, 2, 4, 3).reshape(9, cm, cm), w2)
    proj = pack[1][9 * cm // 16:].float().reshape(cin // 16, 2, cm, 8)
    assert torch.equal(proj.permute(0, 1, 3, 2).reshape(cin, cm), ht.round_bf16(w["f1_pw"]))
    # the head: the tensor-core route's hi/lo TF32 slabs, zeros beyond Ch
    assert torch.equal(pack[4], ht.pack_hr_tail_tc(weights)[4])
    assert tuple(pack[4].shape) == (cm // 16, 2, 4, 8, 4) and not pack[4][:, :, :, ch:].any()


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s2d", [2, 1])
def test_plain_version_matches_pallas_interpret_at_the_layout_widths(s2d):
    cfg, params, state, model = _setup(s2d, seed=30 + s2d)
    jax_w, torch_w = _weights(cfg, params, state, model)
    sr, dem = _features(s2d, seed=31)
    got = ht.hr_tail_reference(torch.from_numpy(sr), torch.from_numpy(dem), *torch_w).numpy()
    want = np.asarray(hr_tail_pallas(
        jnp.asarray(sr), jnp.asarray(dem), *jax_w, band=16, interpret=True, mode="f32",
    ))
    assert got.shape == want.shape == (1, 32, 64, s2d * s2d)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("s2d", [2, 1])
def test_plain_bf16_version_matches_pallas_bf16_mode_at_the_layout_widths(s2d):
    cfg, params, state, model = _setup(s2d, seed=40 + s2d)
    jax_w, torch_w = _weights(cfg, params, state, model)
    sr, dem = _features(s2d, seed=41)
    want = np.asarray(hr_tail_pallas(
        jnp.asarray(sr), jnp.asarray(dem), *jax_w, band=16, interpret=True, mode="bf16",
    ))
    sr_t, dem_t = torch.from_numpy(sr), torch.from_numpy(dem)
    got = ht.hr_tail(sr_t, dem_t, *torch_w, mode="bf16").numpy()
    f32 = ht.hr_tail(sr_t, dem_t, *torch_w).numpy()
    # the same bf16 arithmetic: equal up to rare flipped roundings, each a
    # small share of the range, their rms far under the distance to f32
    scale = float(np.abs(want).max())
    err, gap = float(np.abs(got - want).max()), float(np.abs(want - f32).max())
    assert gap > 1e-3 * scale  # the mode really rounds
    assert err <= FLIP * scale, (err, scale)
    assert _rms(got - want) < 0.25 * _rms(want - f32), (_rms(got - want), _rms(want - f32))


# ---------------------------------------------------------------------------
# the model's tail and tohr
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s2d", [2, 1])
def test_model_tail_takes_k1_with_the_pack_built_once(s2d, monkeypatch):
    ca, cb, cm, ch = LAYOUTS[s2d]
    cfg = ResUNetConfig.from_dict(_config(s2d, levels=1, lr_tile=2).to_dict())
    model = ResUNet(cfg).eval()
    rng = np.random.default_rng(50 + s2d)
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.from_numpy(rng.normal(0, 0.05, tuple(prm.shape)).astype(np.float32)))
    built, built_bf16 = [], []
    original, original_bf16 = ht.pack_hr_tail_tc, ht.pack_hr_tail_bf16
    monkeypatch.setattr(ht, "pack_hr_tail_tc", lambda ws: built.append(1) or original(ws))
    monkeypatch.setattr(
        ht, "pack_hr_tail_bf16", lambda ws: built_bf16.append(1) or original_bf16(ws)
    )
    calls = []
    original_tail = ht.hr_tail

    def spy(*args, tc_pack=None, mode="f32"):
        calls.append((tuple(args[0].shape), tuple(args[1].shape), tc_pack, mode))
        return original_tail(*args, tc_pack=tc_pack, mode=mode)

    monkeypatch.setattr(ht, "hr_tail", spy)
    feat = torch.from_numpy(rng.normal(0, 1, (1, 2, 2, 32)).astype(np.float32))
    dem = torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, 1)).astype(np.float32))
    out1, out2 = model.tail(feat, dem), model.tail(feat, dem)
    out16 = model.tail(feat, dem, "bf16")
    model.tail(feat, dem, "bf16")
    assert out1.shape == out16.shape == (1, 32, 32, 1) and torch.equal(out1, out2)
    hw = 32 // s2d
    assert [c[:2] for c in calls] == [((1, hw, hw, ca), (1, hw, hw, cb))] * 4
    assert [c[3] for c in calls] == ["f32", "f32", "bf16", "bf16"]
    assert len(built) == 1 and len(built_bf16) == 1
    tc_pack, bf_pack = calls[0][2], calls[2][2]
    assert calls[1][2] is tc_pack and calls[3][2] is bf_pack
    assert tuple(tc_pack[4].shape) == tuple(bf_pack[4].shape) == (cm // 16, 2, 4, 8, 4)
    assert bf_pack[0].dtype == torch.bfloat16


def _scene(tmp_path, seed, hr=256, scale=16):
    """A seeded HR DEM and LR depth as GeoTIFFs."""
    rng = np.random.default_rng(seed)
    lr = hr // scale
    dem = (
        300.0 + np.cumsum(rng.normal(0, 0.3, (hr, hr)), axis=1)
        + np.linspace(0, 60, hr)[:, None]
    ).astype(np.float32)
    depth = np.clip(rng.gamma(1.5, 0.6, (lr, lr)) - 0.4, 0.0, 5.0).astype(np.float32)

    def profile(n, res):
        return {
            "height": n, "width": n, "count": 1, "dtype": "float32", "crs": "EPSG:32633",
            "nodata": -9999.0, "compress": "LZW",
            "transform": from_origin(500000.0, 4000000.0 + hr * 2.0, res, res),
        }

    dem_fp, depth_fp = tmp_path / "dem.tif", tmp_path / "depth.tif"
    write_raster(dem_fp, dem, profile(hr, 2.0))
    write_raster(depth_fp, depth, profile(lr, 2.0 * scale))
    return dem_fp, depth_fp


@pytest.mark.parametrize("s2d", [2, 1])
def test_tohr_at_the_layout_matches_jax_tohr(s2d, tmp_path):
    # The layout's full tail widths through the whole path: the port's tail
    # goes through hr_tail (its plain version on the CPU), the JAX package's
    # through its unfused chain. Both quantize to uint16 codes of 7.6e-5 m;
    # f32 sums in another order move a few codes by one.
    cfg = _config(s2d)
    model_fp = tmp_path / f"s2d{s2d}.fsrz"
    save_artifact(model_fp, cfg, *init_resunet(60 + s2d, cfg), {"seed": 60 + s2d})
    dem_fp, depth_fp = _scene(tmp_path, seed=61)
    kw = dict(
        model_version="ResUNet_16x_DEM", model_fp=model_fp, depth_lr_fp=depth_fp, dem_hr_fp=dem_fp,
    )
    out_t, out_j = tmp_path / "torch.tif", tmp_path / "jax.tif"
    tohr_torch(output_fp=out_t, device="cpu", **kw)
    tohr_jax(output_fp=out_j, **kw)
    pred_t, _, _ = read_raster(out_t)
    pred_j, _, _ = read_raster(out_j)
    assert pred_t.shape == pred_j.shape == (256, 256) and pred_t.dtype == np.float32
    assert pred_j.max() > 0.0
    d = np.abs(pred_t.astype(np.float64) - pred_j)
    assert float(np.sqrt(np.mean(d**2))) <= 1e-4 and d.max() <= 2e-4
