"""The bf16 and mixed precision policies: the port vs the JAX package on the CPU.

The same numpy-seeded inputs go through both. Where the JAX function reaches
the Pallas tail it runs in interpret mode (``mode="bf16"`` for a bf16 tail),
as the JAX package's own tests run it off the TPU; the port on ``device="cpu"``
runs the kernel's plain version (``hr_tail_reference_bf16``). This file holds
the kernel's plain version, the weight pack, the policy resolution and the
hazards of a bf16 stage; ``tests/test_torch_precision_policy.py`` the network
under each policy, ``tests/test_torch_precision_engine.py`` the engine, ``tohr``
and the CLI.

Tolerances. Products of bf16 values are exact in f32 on both sides, so the
two differ only where f32 sums taken in another order land on the two sides of
a bf16 tie: one operand among hundreds then differs by 2^-9 of its value. Such
flips are rare, so the root mean square of the difference stays some ten
times under that of the distance between the bf16 result and the f32 one,
which is what every test here holds them to (at most ``FLIP`` of the output's
range anywhere, and under a quarter of the gap to f32 in the root mean square).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from floodsr_tpu.ops.pallas.hr_tail import hr_tail_pallas
from floodsr_tpu_torch import cli as cli_torch
from floodsr_tpu_torch.device import set_strict_f32
from floodsr_tpu_torch.nn.resunet import (
    PRECISION_POLICIES,
    PRECISION_STAGES,
    Conv,
    bf16_products,
    conv2d_same,
    conv_transpose_nhwc,
    resolve_precision_policy,
)
from floodsr_tpu_torch.ops.kernels import hr_tail as ht

from test_torch_resunet import CASES, _inputs, _model

pytestmark = pytest.mark.unit

#: share of the output's range a flipped bf16 rounding may move it by
FLIP = 4e-3


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _assert_flips_only(got, want, f32, min_gap):
    """``got`` is ``want`` but for rare flipped roundings, and ``want`` is not ``f32``."""
    scale = float(np.abs(want).max())
    err, gap = float(np.abs(got - want).max()), float(np.abs(want - f32).max())
    assert gap > min_gap * scale  # the mode really rounds
    assert err <= FLIP * scale, (err, scale)
    assert _rms(got - want) < 0.25 * _rms(want - f32), (_rms(got - want), _rms(want - f32))


def _tail_weights(ca, cb, cm, ch, seed=0):
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
            v = rng.normal(0.0, 1.0 / np.sqrt(int(np.prod(shape[:-1]))), shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        out.append(v.astype(np.float32))
    return out


# (a) the plain bf16 version against the Pallas kernel in interpret mode


@pytest.mark.parametrize(
    "b,h,w,ca,cb,cm,ch",
    [(2, 16, 24, 16, 8, 16, 4), (1, 16, 16, 128, 32, 128, 16)],
    ids=["narrow", "flagship_widths"],
)
def test_hr_tail_reference_bf16_matches_the_pallas_kernel_in_bf16_mode(b, h, w, ca, cb, cm, ch):
    rng = np.random.default_rng(1)
    sr = np.abs(rng.normal(0, 1, (b, h, w, ca))).astype(np.float32)
    dem = np.abs(rng.normal(0, 1, (b, h, w, cb))).astype(np.float32)
    weights = _tail_weights(ca, cb, cm, ch)
    want = np.asarray(hr_tail_pallas(
        jnp.asarray(sr), jnp.asarray(dem), *[jnp.asarray(v) for v in weights],
        band=8, interpret=True, mode="bf16",
    ))
    tw = [torch.from_numpy(v) for v in weights]
    got = ht.hr_tail(torch.from_numpy(sr), torch.from_numpy(dem), *tw, mode="bf16").numpy()
    f32 = ht.hr_tail(torch.from_numpy(sr), torch.from_numpy(dem), *tw).numpy()
    _assert_flips_only(got, want, f32, min_gap=1e-3)


def test_hr_tail_reference_bf16_rounds_operands_and_keeps_the_rest_f32():
    ca, cb, cm, ch = 16, 8, 16, 4
    weights = [torch.from_numpy(v) for v in _tail_weights(ca, cb, cm, ch, seed=3)]
    rng = np.random.default_rng(3)
    sr = torch.from_numpy(np.abs(rng.normal(0, 1, (1, 8, 8, ca))).astype(np.float32))
    dem = torch.from_numpy(np.abs(rng.normal(0, 1, (1, 8, 8, cb))).astype(np.float32))
    want = ht.hr_tail_reference_bf16(sr, dem, *weights)
    assert want.dtype == torch.float32 and not torch.equal(want, ht.hr_tail_reference(sr, dem, *weights))
    # rounding the inputs and the matmul weights beforehand changes nothing
    # (the mode rounds them anyway) ...
    w = dict(zip(ht.WEIGHT_KEYS, weights))
    pre = [ht.round_bf16(w[k]) if k in ("f1_w1", "f1_pw") else w[k] for k in ht.WEIGHT_KEYS]
    same = ht.hr_tail_reference_bf16(sr, dem, *pre)
    assert torch.equal(same, want)
    # ... rounding a bias or an affine does: those stay f32 in the mode
    for key in ("f1_b1", "f1_a2", "f1_pb", "head_b"):
        moved = [ht.round_bf16(w[k]) if k == key else w[k] for k in ht.WEIGHT_KEYS]
        assert not torch.equal(ht.hr_tail_reference_bf16(sr, dem, *moved), want), key
    x = torch.tensor([1.2345678, -3.1415927e3, 1e-20])
    hi, lo = ht.split_bf16(x)
    assert torch.equal(hi, ht.round_bf16(hi)) and torch.equal(lo, ht.round_bf16(lo))
    assert float(((hi + lo - x) / x).abs().max()) < 2.0 ** -15  # 16 bits of the value
    with pytest.raises(ValueError, match="mode must be"):
        ht.hr_tail(sr, dem, *weights, mode="fp8")


@pytest.mark.parametrize("ca,cb", [(128, 32), (64, 16)])
def test_bf16_pack_layout(ca, cb):
    cm, ch = 128, 16
    weights = [torch.from_numpy(v) for v in _tail_weights(ca, cb, cm, ch, seed=5)]
    w = dict(zip(ht.WEIGHT_KEYS, weights))
    pack = ht.pack_hr_tail_bf16(weights)
    assert [t.dtype for t in pack] == [torch.bfloat16] * 4 + [torch.float32]
    cin = ca + cb
    assert tuple(pack[0].shape) == (9 * cin // 16, 2, cm, 8)
    assert tuple(pack[1].shape) == (9 * cm // 16 + cin // 16, 2, cm, 8)
    # slab (chunk c, tap t): [octet o][cout][k] is w[tap, 16 c + 8 o + k, cout]
    w1 = w["f1_w1"].reshape(9, cin, cm).to(torch.bfloat16)
    for c, t, o, co, k in [(0, 0, 0, 0, 0), (3, 5, 1, 77, 6), (cin // 16 - 1, 8, 1, 127, 7)]:
        assert pack[0][c * 9 + t, o, co, k] == w1[t, c * 16 + o * 8 + k, co]
    # the projection's slabs follow f1.conv2's, one tap each
    pw = w["f1_pw"].to(torch.bfloat16)
    assert pack[1][9 * cm // 16 + 2, 1, 5, 3] == pw[2 * 16 + 8 + 3, 5]
    # the head keeps the tensor-core route's hi/lo TF32 slabs
    assert torch.equal(pack[4], ht.pack_hr_tail_tc(weights)[4])
    assert [s for s, _ in ht._pack_shapes("bf16", w)] == [tuple(t.shape) for t in pack]
    assert set(ht.route_launches) == {"tensor", "direct", "bf16", "bf16_band", "bf16_direct"}


# (b) the policies, their stages and their hazards


def test_resolve_named_and_dict():
    f32 = resolve_precision_policy("f32")
    assert tuple(f32) == PRECISION_STAGES
    assert all(dt == torch.float32 for dt in f32.values())
    mixed = resolve_precision_policy("mixed")
    assert mixed["trunk"] == torch.bfloat16
    assert mixed["sr_up"] == torch.bfloat16
    assert mixed["tail"] == torch.float32
    assert mixed["head"] == torch.float32
    bf16 = resolve_precision_policy("bf16")
    assert [bf16[s] for s in PRECISION_STAGES] == [torch.bfloat16] * 3 + [torch.float32]
    # dict spec: unnamed stages default to f32
    partial = resolve_precision_policy({"trunk": "bf16"})
    assert partial["trunk"] == torch.bfloat16
    assert partial["tail"] == torch.float32
    # derive from compute_dtype when policy is None
    assert resolve_precision_policy(None, torch.bfloat16)["trunk"] == torch.bfloat16
    assert resolve_precision_policy(None, torch.float32)["trunk"] == torch.float32
    # a resolved policy resolves to itself
    assert resolve_precision_policy(mixed) == mixed
    assert sorted(PRECISION_POLICIES) == ["bf16", "f32", "mixed"]


@pytest.mark.parametrize(
    "spec", ["fp8", {"not_a_stage": "bf16"}, {"head": "bf16"}, {"trunk": "f16"}],
    ids=["unknown_name", "unknown_stage", "head_bf16", "unknown_dtype"],
)
def test_resolve_rejects_bad_specs(spec):
    with pytest.raises(AssertionError):
        resolve_precision_policy(spec)


def test_the_dem_re_enters_the_tail_unrounded_and_features_keep_the_stage_dtype():
    cfg, params, state = CASES["tiny_fuse2"]()
    model = _model(cfg.to_dict(), params, state)
    depth, dem = (torch.from_numpy(a) for a in _inputs(cfg, n=1, seed=2))
    assert model.trunk(depth, dem, "mixed").dtype == torch.bfloat16
    assert model.trunk(depth, dem, "f32").dtype == torch.float32
    assert model.trunk(depth, dem).dtype == torch.float32
    feat = model.trunk(depth, dem, "mixed")
    # mixed: the tail is f32 and reads the f32 DEM; a DEM rounded to bf16 first
    # gives another answer
    a = model.tail(feat, dem, "mixed")
    b = model.tail(feat, dem.to(torch.bfloat16).to(torch.float32), "mixed")
    assert a.dtype == torch.float32 and not torch.equal(a, b)
    # bf16 tail: the DEM is rounded on entry, so the two agree exactly
    a = model.tail(feat, dem, "bf16")
    b = model.tail(feat, dem.to(torch.bfloat16).to(torch.float32), "bf16")
    assert torch.equal(a, b)
    # one weight pack per arithmetic, kept beside the folded weights
    assert set(model._tail_pack[2]) == {"f32", "bf16"}


def test_a_bf16_conv_adds_its_bias_in_f32_and_rounds_once():
    rng = np.random.default_rng(4)
    conv = Conv(3, 3, 8, 8)
    conv.w.copy_(torch.from_numpy(rng.normal(0, 0.3, (8, 8, 3, 3)).astype(np.float32)))
    conv.b.copy_(torch.from_numpy(rng.normal(0, 1.0, 8).astype(np.float32)))
    x = torch.from_numpy(rng.normal(0, 1, (1, 8, 12, 12)).astype(np.float32)).to(torch.bfloat16)
    got = conv2d_same(x, conv)
    assert got.dtype == torch.bfloat16
    # exact products in f64, the f32 bias, one rounding
    acc = torch.nn.functional.conv2d(
        x.to(torch.float64), conv.w.to(torch.bfloat16).to(torch.float64), None, 1, 1
    )
    once = (acc + conv.b.to(torch.float64)[None, :, None, None]).to(torch.float32).to(torch.bfloat16)
    twice = acc.to(torch.float32).to(torch.bfloat16) + conv.b.to(torch.bfloat16)[None, :, None, None]
    assert float((got.float() - once.float()).abs().max()) <= float(once.float().abs().max()) * 2**-8
    assert (got == once).float().mean() > 0.99  # f32 vs f64 sums: a rare tie
    assert (got == twice).float().mean() < (got == once).float().mean()
    # the transposed conv's matmul does the same
    up = Conv(2, 2, 8, 4)
    up.w.copy_(torch.from_numpy(rng.normal(0, 0.3, (4, 8, 2, 2)).astype(np.float32)))
    up.b.copy_(torch.from_numpy(rng.normal(0, 1.0, 4).astype(np.float32)))
    xt = x.permute(0, 2, 3, 1)
    got = conv_transpose_nhwc(xt, up, 2)
    want = conv_transpose_nhwc(
        xt.to(torch.float64), _as64(up, rounded=True), 2
    ).to(torch.float32).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert (got == want).float().mean() > 0.99


def _as64(conv, rounded):
    out = Conv(conv.w.shape[2], conv.w.shape[3], conv.w.shape[1], conv.w.shape[0]).to(torch.float64)
    w = conv.w.to(torch.bfloat16) if rounded else conv.w
    out.w.copy_(w.to(torch.float64))
    out.b.copy_(conv.b.to(torch.float64))
    return out


def test_bf16_products_leaves_the_f32_stages_strict():
    before = (
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
    )
    try:
        set_strict_f32()
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        # a bf16 matmul would accumulate in f32
        assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        with bf16_products(True):
            assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
            with bf16_products(False):  # an f32 stage inside changes nothing
                assert torch.backends.cudnn.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        with pytest.raises(RuntimeError, match="boom"):
            with bf16_products(True):
                raise RuntimeError("boom")
        assert not torch.backends.cudnn.allow_tf32  # put back on the way out of an error too
        with bf16_products(False):  # off the GPU: untouched
            assert not torch.backends.cudnn.allow_tf32
    finally:
        (
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
        ) = before


def test_doctor_reports_whether_the_bf16_route_is_built(tmp_path, monkeypatch, capsys):
    from floodsr_tpu_torch.engine import providers
    from floodsr_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert providers.doctor_info()["hr_tail_bf16_built"] is False  # nothing built
    # a library built before the route existed, then one that holds it
    (tmp_path / "libhr_tail.so").write_bytes(b"\x7fELF..hr_tail_launch\x00hr_tail_tc_launch\x00")
    info = providers.doctor_info()
    assert info["kernels_built"] == ["hr_tail"] and info["hr_tail_bf16_built"] is False
    (tmp_path / "libhr_tail.so").write_bytes(b"\x7fELF..hr_tail_tc_launch\x00hr_tail_bf16_launch\x00")
    assert providers.doctor_info()["hr_tail_bf16_built"] is True
    assert cli_torch.main(["doctor"]) == 0
    assert "hr_tail_bf16_built=True" in capsys.readouterr().out.splitlines()
