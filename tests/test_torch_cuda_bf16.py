"""K1's bf16 routes against their plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel has
no CPU mode. The file imports no JAX; run it beside the other CUDA-only tests:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
tests/test_torch_cuda_bf16.py``.
"""

import numpy as np
import pytest
import torch

from floodsr_tpu_torch.ops.kernels import hr_tail as ht

from test_torch_cuda_kernels import (  # noqa: F401  (cuda_device is a fixture)
    _reset_routes,
    _routes,
    _tail_inputs,
    _tail_weights,
    cuda_device,
)

pytestmark = pytest.mark.cuda


# The bf16 arithmetic (the TPU kernel's mode="bf16"): the flagship's widths
# take the wgmma bf16 route, the narrow config the direct kernels with the
# operands rounded in registers. Ragged heights and widths, a chunk that holds
# channels of both inputs, one full 128x128 tile.
@pytest.mark.parametrize(
    "b,h,w,ca,cb,cm,ch,route",
    [
        (2, 20, 48, 128, 32, 128, 16, "bf16"),
        (1, 13, 70, 16, 8, 16, 4, "bf16_direct"),
        (1, 128, 128, 128, 32, 128, 16, "bf16"),
        (3, 33, 131, 128, 32, 128, 16, "bf16"),
        (1, 5, 3, 64, 16, 128, 16, "bf16"),
        (1, 9, 70, 68, 12, 128, 16, "bf16"),
    ],
)
def test_hr_tail_bf16_routes_match_the_plain_bf16_version(
    cuda_device, b, h, w, ca, cb, cm, ch, route
):
    sr, dem = _tail_inputs(b, h, w, ca, cb, cuda_device)
    weights = _tail_weights(ca, cb, cm, ch, cuda_device)
    want = ht.hr_tail_reference_bf16(sr, dem, *weights)
    pack = ht.pack_hr_tail_bf16(weights) if route == "bf16" else None
    _reset_routes()
    for _ in range(2):  # twice: a missing fence gives wrong sums only sometimes
        got = ht.hr_tail(sr, dem, *weights, tc_pack=pack, mode="bf16")
        torch.cuda.synchronize()
        assert got.shape == want.shape == (b, h, w, ch)
        # The products are exact in f32 on both sides; the sums run in another
        # order, and an activation that lands within an f32 rounding of a bf16
        # tie rounds the other way (2^-9 of that value, one term among
        # hundreds). Held at 2e-3 of the output's range, against the 0.15
        # that separates bf16 from f32 at all.
        err = float((got - want).abs().max())
        assert err <= 2e-3 * float(want.abs().max()), err
    assert ht.launches == 2
    assert ht.route_launches == _routes(**{route: 2})


def test_hr_tail_bf16_route_is_the_bf16_arithmetic_and_not_f32(cuda_device):
    # The bf16 routes must differ from the f32 chain by bf16-rounding level
    # (else the rounding was skipped) and agree with each other far closer.
    b, h, w, ca, cb, cm, ch = 2, 24, 72, 128, 32, 128, 16
    sr, dem = _tail_inputs(b, h, w, ca, cb, cuda_device, seed=3)
    weights = _tail_weights(ca, cb, cm, ch, cuda_device, seed=2)
    for key in ("f1_c1", "f1_c2", "f2_c1", "f2_c2"):
        weights[ht.WEIGHT_KEYS.index(key)].fill_(2.0)  # relu(c) != 0 at the padding
    f32 = ht.hr_tail_reference(sr, dem, *weights)
    want = ht.hr_tail_reference_bf16(sr, dem, *weights)
    _reset_routes()
    tensor = ht.hr_tail_cuda(
        sr, dem, *weights, tc_pack=ht.pack_hr_tail_bf16(weights), route="bf16"
    )
    direct = ht.hr_tail_cuda(sr, dem, *weights, route="bf16_direct")
    torch.cuda.synchronize()
    assert ht.route_launches == _routes(bf16=1, bf16_direct=1)
    scale = float(want.abs().max())
    gap = float((want - f32).abs().max())
    assert gap > 1e-3 * scale  # bf16 really is coarser than f32 here
    for got in (tensor, direct):
        assert float((got - want).abs().max()) <= 2e-3 * scale
        assert float((got - want).abs().max()) < 0.5 * gap
        for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
            assert float((got[edge] - want[edge]).abs().max()) <= 2e-3 * scale


def test_hr_tail_bf16_route_rejects_the_other_routes_pack(cuda_device):
    wide = _tail_weights(128, 32, 128, 16, cuda_device)
    sr = torch.zeros(1, 8, 8, 128, device=cuda_device)
    dem = torch.zeros(1, 8, 8, 32, device=cuda_device)
    with pytest.raises(ValueError, match="needs tc_pack=pack_hr_tail_bf16"):
        ht.hr_tail(sr, dem, *wide, mode="bf16")
    with pytest.raises(ValueError, match="packed weight f1_w1 must be torch.bfloat16"):
        ht.hr_tail(sr, dem, *wide, tc_pack=ht.pack_hr_tail_tc(wide), mode="bf16")
    with pytest.raises(ValueError, match="packed weight f1_w1 must be torch.float32"):
        ht.hr_tail(sr, dem, *wide, tc_pack=ht.pack_hr_tail_bf16(wide))
    narrow = _tail_weights(16, 8, 16, 4, cuda_device)
    with pytest.raises(ValueError, match="bf16 route takes"):
        ht.hr_tail_cuda(
            torch.zeros(1, 8, 8, 16, device=cuda_device),
            torch.zeros(1, 8, 8, 8, device=cuda_device), *narrow, route="bf16",
        )
    with pytest.raises(ValueError, match="mode must be"):
        ht.hr_tail(sr, dem, *wide, mode="fp8")


# The scene's calls (8 tiles of 128x128, and the last call of one tile) and
# two ragged sizes (H and W not multiples of the 2 x 64 block), so TMA's zero
# fill is read at every image edge.
@pytest.mark.parametrize(
    "b,h,w", [(8, 128, 128), (1, 128, 128), (2, 70, 100), (8, 69, 100)],
    ids=["eight_tiles", "one_tile", "ragged", "ragged_odd_rows"],
)
def test_hr_tail_bf16_route_at_the_scene_sizes(cuda_device, b, h, w):
    ca, cb, cm, ch = 128, 32, 128, 16
    sr, dem = _tail_inputs(b, h, w, ca, cb, cuda_device, seed=7)
    weights = _tail_weights(ca, cb, cm, ch, cuda_device, seed=8)
    for key in ("f1_c1", "f1_c2", "f2_c1", "f2_c2"):
        weights[ht.WEIGHT_KEYS.index(key)].fill_(0.5)  # relu(c) != 0 at the padding
    want = ht.hr_tail_reference_bf16(sr, dem, *weights)
    pack = ht.pack_hr_tail_bf16(weights)
    _reset_routes()
    got = ht.hr_tail(sr, dem, *weights, tc_pack=pack, mode="bf16")
    again = ht.hr_tail(sr, dem, *weights, tc_pack=pack, mode="bf16")
    torch.cuda.synchronize()
    assert ht.launches == 2
    assert ht.route_launches == _routes(bf16=2)
    assert torch.equal(got, again)  # deterministic: no atomics, a fixed order of sums
    # as in test_hr_tail_bf16_routes_match_the_plain_bf16_version: flipped
    # bf16 roundings of single operands, at most 2e-3 of the output's range
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-3 * scale
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert float((got[edge] - want[edge]).abs().max()) <= 2e-3 * scale


def test_hr_tail_bf16_route_refuses_inputs_off_16_byte_alignment(cuda_device):
    wide = _tail_weights(128, 32, 128, 16, cuda_device)
    pack = ht.pack_hr_tail_bf16(wide)
    dem = torch.zeros(1, 8, 8, 32, device=cuda_device)
    store = torch.zeros(8 * 8 * 128 + 1, device=cuda_device)
    _reset_routes()
    with pytest.raises(ValueError, match="sr must start on a 16-byte boundary for the bf16 route"):
        ht.hr_tail(store[1:].view(1, 8, 8, 128), dem, *wide, tc_pack=pack, mode="bf16")
    sr = torch.zeros(1, 8, 8, 128, device=cuda_device)
    store = torch.zeros(8 * 8 * 32 + 2, device=cuda_device)
    with pytest.raises(ValueError, match="dem must start on a 16-byte boundary"):
        ht.hr_tail(sr, store[2:].view(1, 8, 8, 32), *wide, tc_pack=pack, mode="bf16")
    assert ht.route_launches == _routes()
