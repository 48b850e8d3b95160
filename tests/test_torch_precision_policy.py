"""The network under each precision policy: the port vs the JAX package on the CPU.

``ResUNet`` under ``bf16``, ``mixed`` and per-stage dicts against eager
``resunet_apply`` (the Pallas tail in interpret mode where the configuration is
eligible, the unfused blocks where it is not), and which stages switch TF32 on.
Tolerances as in ``tests/test_torch_precision.py``: flipped bf16 roundings only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from floodsr_tpu.nn.resunet import _pallas_tail_eligible, resunet_apply
from floodsr_tpu_torch.nn import resunet as rn

from test_torch_precision import _assert_flips_only
from test_torch_resunet import CASES, _inputs, _model

pytestmark = pytest.mark.unit

POLICIES = {
    "bf16": "bf16",
    "mixed": "mixed",
    "trunk_only": {"trunk": "bf16"},
    "tail_only": {"tail": "bf16"},
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_resunet_under_a_policy_matches_jax(case, policy):
    cfg, params, state = CASES[case]()
    # Two fuse blocks (tiny_fuse2): the port runs hr_tail's plain version, JAX
    # the Pallas kernel in interpret mode. One (the test artifact): the tail is
    # not eligible and both run the unfused blocks, the fallback.
    fused = _pallas_tail_eligible(params, cfg, cfg.hr_tile // cfg.hr_s2d, False)
    assert fused == (case == "tiny_fuse2")
    spec = POLICIES[policy]
    depth, dem = _inputs(cfg, n=2, seed=1)
    want, _ = resunet_apply(
        params, state, jnp.asarray(depth), jnp.asarray(dem), cfg,
        precision=spec, pallas_tail=fused,
    )
    want = np.asarray(want)
    model = _model(cfg.to_dict(), params, state)
    td, tm = torch.from_numpy(depth), torch.from_numpy(dem)
    got = model(td, tm, precision=spec).numpy()
    f32 = model(td, tm).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    _assert_flips_only(got, want, f32, min_gap=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mixed_allows_tf32_for_the_bf16_stages_only(case, monkeypatch):
    # Which stages of a forward that believes it is on the GPU switch TF32 on:
    # the trunk and the SR upsample of 'mixed', never its f32 tail (DEM
    # features, fuse blocks, head), whether the tail is fused or not.
    cfg, params, state = CASES[case]()
    model = _model(cfg.to_dict(), params, state)
    depth, dem = (torch.from_numpy(a) for a in _inputs(cfg, n=1, seed=2))
    real_products = rn.bf16_products
    calls = []

    def spy(flag):
        calls.append(bool(flag))
        return real_products(False)

    monkeypatch.setattr(rn, "bf16_products", spy)

    class OnCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    d, m = depth.as_subclass(OnCuda), dem.as_subclass(OnCuda)
    feat = model.trunk(d, m, "mixed")
    assert calls == [True]  # the bf16 trunk
    calls.clear()
    model.tail(feat.as_subclass(OnCuda), m, "mixed")
    assert calls == [True, False]  # the bf16 SR upsample, then the f32 tail
    calls.clear()
    model.tail(feat.as_subclass(OnCuda), m, "bf16")
    assert calls == [True, True]
    calls.clear()
    feat = model.trunk(d, m, "f32")
    model.tail(feat.as_subclass(OnCuda), m, {"trunk": "bf16"})
    assert calls == [False, False, False]
