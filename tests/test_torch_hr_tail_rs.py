"""K1's tensor-core pack at the small widths (Cm 64 and 32), on the CPU.

At ``hr_s2d`` 2 and 1 the tensor-core route takes its A operand from
registers (``conv_tc_rs_kernel`` in ``csrc/hr_tail.cu``): a consumer thread
(lane ``l``, ``t = l % 4``) loads one pixel's channels ``4t .. 4t + 3`` of a
16-channel chunk with one 16-byte load and holds them as its fragment at k
columns ``t`` and ``t + 4`` of the chunk's two k8 steps (step 0: channels
``4t``, ``4t + 1``; step 1: ``4t + 2``, ``4t + 3``). The weight pack must put
each channel's weights at the k row the fragment gives that channel. Here the
fragment is stated as the kernel's ``split_frag`` builds it, independently of
the pack, and the pack's slabs are held against it: entry by entry, and as
the chunk's product summed over the emulated k8 steps. The kernels run only
on the card (``tests/test_torch_cuda_kernels.py``).
"""

import ctypes

import numpy as np
import pytest
import torch

from floodsr_tpu_torch.ops.kernels import hr_tail as ht

pytestmark = pytest.mark.unit

#: hr_s2d -> (Ca, Cb, Cm, Ch) at base and fuse width 32, and the flagship's
LAYOUTS = {2: (64, 32, 64, 4), 1: (32, 32, 32, 1), 4: (128, 32, 128, 16)}
#: (entry of TC_PACK_KEYS, weight key, input channels of that weight)
CONVS = ((0, "f1_w1", "cin"), (1, "f1_w2", "cm"), (2, "f2_w1", "cm"), (3, "f2_w2", "cm"))


def _weights(s2d, seed):
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
        torch.from_numpy(rng.normal(0.0, 0.3, shapes[key]).astype(np.float32))
        for key in ht.WEIGHT_KEYS
    ]


def fragment_channel(kk: int, k: int) -> int:
    """The chunk channel a consumer's register fragment holds at k column ``k``
    of k8 step ``kk``: thread ``t = k % 4`` loaded channels ``4t .. 4t + 3``."""
    return 4 * (k % 4) + 2 * kk + k // 4


def b_operand(slab: torch.Tensor, kk: int) -> torch.Tensor:
    """``[2, 8, Cout]``: the hi and lo B operand of k8 step ``kk`` as ``wgmma``
    reads a no-swizzle K-major slab ``[hi|lo][quad][Cout][4]``: k rows 0-3 from
    quad ``2 kk``, 4-7 from quad ``2 kk + 1`` (the leading byte offset)."""
    return slab[:, 2 * kk: 2 * kk + 2].permute(0, 1, 3, 2).reshape(2, 8, -1)


@pytest.mark.parametrize("s2d", [2, 1])
def test_small_widths_take_a_from_registers_and_the_flagship_does_not(s2d):
    cm = LAYOUTS[s2d][2]
    assert ht.a_from_registers(cm) and not ht.a_from_registers(LAYOUTS[4][2])
    # the fragment's map covers each chunk channel once
    assert sorted(fragment_channel(kk, k) for kk in (0, 1) for k in range(8)) == list(range(16))


@pytest.mark.parametrize("s2d", [2, 1])
def test_each_slab_holds_a_channel_at_the_k_row_of_its_fragment(s2d):
    ca, cb, cm, _ = LAYOUTS[s2d]
    dims = {"cin": ca + cb, "cm": cm}
    weights = _weights(s2d, seed=30 + s2d)
    w = dict(zip(ht.WEIGHT_KEYS, weights))
    pack = ht.pack_hr_tail_tc(weights)
    rng = np.random.default_rng(40 + s2d)
    for entry, key, cin_key in CONVS:
        cin = dims[cin_key]
        taps = w[key].reshape(9, cin, cm)
        for _ in range(12):
            chunk, tap = int(rng.integers(cin // 16)), int(rng.integers(9))
            kk = int(rng.integers(2))
            b = b_operand(pack[entry][chunk * 9 + tap], kk)
            for k in range(8):
                want = taps[tap, 16 * chunk + fragment_channel(kk, k)]
                hi, lo = ht.split_tf32(want)
                assert torch.equal(b[0, k], hi) and torch.equal(b[1, k], lo)
    # the projection's slabs, one a chunk after f1.conv2's, in the same order
    cin = dims["cin"]
    proj = pack[1][9 * cm // 16:]
    for chunk in range(cin // 16):
        for kk in (0, 1):
            b = b_operand(proj[chunk], kk)
            rows = [16 * chunk + fragment_channel(kk, k) for k in range(8)]
            assert torch.equal(b[0] + b[1], sum(ht.split_tf32(w["f1_pw"][rows])))


@pytest.mark.parametrize("s2d", [2, 1])
def test_emulated_register_fragments_times_the_pack_give_the_chunk_product(s2d):
    # One 64-pixel GEMM tile of one chunk and tap: each lane's fragment built
    # from its 16-byte loads as split_frag does, the three products lo*Whi +
    # hi*Wlo + hi*Whi over the two k8 steps in float64, against x @ w.
    ca, cb, cm, _ = LAYOUTS[s2d]
    cin = ca + cb
    weights = _weights(s2d, seed=50 + s2d)
    w = dict(zip(ht.WEIGHT_KEYS, weights))
    pack = ht.pack_hr_tail_tc(weights)
    rng = np.random.default_rng(60 + s2d)
    x = torch.from_numpy(np.abs(rng.normal(0, 1, (64, cin))).astype(np.float32))
    chunk, tap = cin // 16 - 1, 4
    got = torch.zeros(64, cm, dtype=torch.float64)
    for kk in (0, 1):
        a = torch.empty(64, 8)
        for lane in range(32):
            t = lane % 4
            for row in (lane // 4, lane // 4 + 8):  # and the same in each warp's 16 rows
                for r in range(row, 64, 16):
                    load = x[r, 16 * chunk + 4 * t: 16 * chunk + 4 * t + 4]  # one 16-byte load
                    a[r, t], a[r, t + 4] = load[2 * kk], load[2 * kk + 1]
        a_hi, a_lo = (v.double() for v in ht.split_tf32(a))
        b_hi, b_lo = (v.double() for v in b_operand(pack[0][chunk * 9 + tap], kk))
        got += (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
    xs = x[:, 16 * chunk: 16 * chunk + 16].double()
    want = xs @ w["f1_w1"].reshape(9, cin, cm)[tap, 16 * chunk: 16 * chunk + 16].double()
    # the split keeps 21-22 mantissa bits of each operand; the lo*lo term is dropped
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    assert float((got - want).abs().max()) > 0.0


@pytest.mark.parametrize("s2d", [2, 1, 4])
def test_the_head_and_the_flagship_keep_the_natural_channel_order(s2d):
    weights = _weights(s2d, seed=70 + s2d)
    w = dict(zip(ht.WEIGHT_KEYS, weights))
    pack = ht.pack_hr_tail_tc(weights)
    head = ht._tc_slabs(ht._padded_head(w["head_w"]))
    assert torch.equal(pack[4], head)
    # the bf16 route's head is the same slabs
    assert torch.equal(ht.pack_hr_tail_bf16(weights)[4], head)
    transposed = ht.a_from_registers(LAYOUTS[s2d][2])
    assert torch.equal(pack[0], ht._tc_slabs(w["f1_w1"], transposed))
    assert torch.equal(pack[0], ht._tc_slabs(w["f1_w1"])) is not transposed


class _FakeLibrary:
    """Stands for the built ``libhr_tail.so``: its launchers return 0 and its
    ``hr_tail_tc_a_from_registers`` answers as ``kernels_choose(cm)``."""

    class _Fn:
        def __init__(self, answer):
            self.restype, self.argtypes, self._answer = ctypes.c_int, None, answer

        def __call__(self, *args):
            return self._answer(*args)

    def __init__(self, kernels_choose):
        self.hr_tail_tc_a_from_registers = self._Fn(lambda cm, ch: int(kernels_choose(cm)))

    def __getattr__(self, name):
        fn = self._Fn(lambda *args: 0)
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("kernels_choose", ["same", "every_width", "no_width"])
def test_the_library_is_refused_where_its_kernels_and_the_pack_disagree(monkeypatch, kernels_choose):
    # The pack's order (a_from_registers) is held, when the library loads,
    # against the launcher's own choice of kernel at each of TC_WIDTHS.
    from floodsr_tpu_torch.ops.kernels import _build

    choose = {
        "same": ht.a_from_registers, "every_width": lambda cm: True, "no_width": lambda cm: False,
    }[kernels_choose]
    lib = _FakeLibrary(choose)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    if kernels_choose == "same":
        assert ht._lib() is lib and lib.hr_tail_tc_a_from_registers.argtypes is not None
    else:
        with pytest.raises(RuntimeError, match="A from registers at Cm="):
            ht._lib()
