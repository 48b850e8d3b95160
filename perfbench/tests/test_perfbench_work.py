"""The yardstick's operation counts against PyTorch's own FLOP counter on the
plain reference, at a small window of the flagship's widths and of its
layout at each HR space-to-depth factor (``hr_s2d`` 4, 2 and 1)."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.harness import spec, weights, work
from perfbench.reference.model import Reference


HR_S2D = [4, 2, 1]


def _arch(hr_s2d: int) -> dict:
    """The flagship's architecture at ``hr_s2d``, one 256x256 window."""
    return dict(spec.config("resunet16x_flagship")["architecture"], lr_tile=16, hr_s2d=hr_s2d)


def _reference(arch: dict) -> Reference:
    params, state = weights.draw(arch, {"head_gain": 1.0, "head_bias": 0.0}, 5, "cpu")
    return Reference(arch, {**params, **state}, "cpu")


@pytest.mark.parametrize("hr_s2d", HR_S2D)
def test_window_flops_match_the_flop_counter(hr_s2d):
    arch = _arch(hr_s2d)
    ref = _reference(arch)
    tile = arch["lr_tile"] * arch["scale"]
    with FlopCounterMode(display=False) as counter:
        ref.forward(torch.rand(1, 16, 16), torch.rand(1, tile, tile))
    assert counter.get_total_flops() == work.window_flops(arch)


@pytest.mark.parametrize("hr_s2d", HR_S2D)
def test_hr_tail_flops_match_the_flop_counter(hr_s2d):
    arch = _arch(hr_s2d)
    ref = _reference(arch)
    s2d, hr_w = arch["hr_s2d"], arch["base_filters"] * arch["hr_s2d"]
    side = arch["lr_tile"] * arch["scale"] // s2d
    y = torch.rand(1, hr_w + arch["fuse_filters"], side, side)
    with FlopCounterMode(display=False) as counter:
        for b in range(arch["fuse_blocks"]):
            y = ref.block(y, f"fuse.{b}")
        ref.conv(y, "head")
    assert counter.get_total_flops() == work.hr_tail_flops(arch)


def test_counts_at_the_cells_sizes():
    flagship = spec.config("resunet16x_flagship")["architecture"]
    s2d1 = dict(flagship, hr_s2d=1)
    assert work.window_flops(flagship) == pytest.approx(22.32e9, rel=1e-3)
    assert 8 * work.hr_tail_flops(flagship) == pytest.approx(170.19e9, rel=1e-3)
    assert work.window_flops(s2d1) == pytest.approx(26.73e9, rel=1e-3)
    assert work.n_windows(flagship, (256, 256)) == 121
    assert work.n_windows(flagship, (64, 64)) == 9


def test_parameter_count():
    cfg = spec.config("resunet16x_flagship")
    params, _ = weights.draw(cfg["architecture"], {"head_gain": 1.0, "head_bias": 0.0}, 1, "cpu")
    assert sum(int(np.prod(a.shape)) for a in params.values()) == cfg["parameters"]
