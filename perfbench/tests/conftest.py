"""Small configurations and mixes for the benchmark's CPU tests."""

from __future__ import annotations

import pytest

#: The flagship's structure at narrow widths: fast on the CPU.
TINY = dict(base_filters=8, levels=2, enc_blocks=1, dec_blocks=1, fuse_filters=8,
            fuse_blocks=2, scale=16, lr_tile=8, bn_eps=1e-3, bn_momentum=0.99, hr_s2d=4)


@pytest.fixture
def tiny_cell():
    """A cell of a configuration and a traffic mix, with a drawn tiny network
    and 240x240 scenes."""
    from perfbench.harness import spec

    def make(config: str, traffic: str, name: str | None = None, hr_s2d: int | None = None):
        entry = {"name": name or f"{config}.{traffic}", "config": config, "traffic": traffic,
                 "chips": 1}
        cfg, mix = spec.config(config), spec.traffic(traffic)
        hr_s2d = hr_s2d or cfg["architecture"]["hr_s2d"]
        cfg = dict(cfg, architecture=dict(TINY, hr_s2d=hr_s2d),
                   weights={"draw": {"seed": 7, "head_gain": 0.02, "head_bias": 0.0}})
        mix = dict(mix, lr_shape=[16, 16], hr_shape=[240, 240], judged_among=4,
                   warmup_calls=1)
        return entry, cfg, mix

    return make
