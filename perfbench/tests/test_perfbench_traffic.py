"""The one traffic generator: the same seed gives the same inputs, a new seed
the same sizes and flood levels in another order, and each job its own DEM
path where the mix asks for it."""

from __future__ import annotations

from functools import partial

import numpy as np
import pytest

from perfbench.harness import spec, traffic

SEED = 2**33 + 11


def _mix(name: str) -> dict:
    mix = spec.traffic(name)
    return dict(mix, lr_shape=[16, 16], hr_shape=[240, 240])


def _lr_raster():
    """The flagship family's LR depth (``max_depth`` 5 m)."""
    cfg = spec.config("resunet16x_flagship")
    return partial(spec.family(cfg).lr_raster, cfg)


@pytest.mark.parametrize("name", ["resident", "new_terrain"])
def test_same_seed_same_inputs(tmp_path, name):
    a = traffic.build(_mix(name), SEED, tmp_path / "a", _lr_raster())
    b = traffic.build(_mix(name), SEED, tmp_path / "b", _lr_raster())
    c = traffic.build(_mix(name), SEED + 1, tmp_path / "c", _lr_raster())
    for x, y in zip(a.areas, b.areas):
        assert np.array_equal(x.dem, y.dem)
        assert x.dem_path.read_bytes() == (tmp_path / "b" / x.dem_path.name).read_bytes()
    for x, y in zip(a.scenarios, b.scenarios):
        assert np.array_equal(x.lr, y.lr)
    assert list(a.order) == list(b.order) and a.judged == b.judged
    assert not np.array_equal(a.areas[0].dem, c.areas[0].dem)
    # the same spread of flood levels, in another order
    assert sorted(s.offset_m for s in a.scenarios) == pytest.approx(sorted(s.offset_m for s in c.scenarios))
    assert len(a.scenarios) == len(c.scenarios) == a.mix["scenarios"]


@pytest.mark.parametrize("name,fresh", [("resident", False), ("new_terrain", True)])
def test_dem_paths(tmp_path, name, fresh):
    plan = traffic.build(_mix(name), SEED, tmp_path, _lr_raster())
    jobs = [plan.job(i) for i in range(6)]
    paths = [j.dem_path for j in jobs]
    if fresh:
        assert len(set(paths)) == len(paths)
        assert all(p.samefile(plan.areas[plan.scenarios[j.scenario].area].dem_path)
                   for p, j in zip(paths, jobs))
        plan.release(jobs)
        assert not any(p.exists() for p in paths)
    else:
        assert len(set(paths)) == 1
    payload = spec.module("fronts", plan.mix["front"]).body(
        [plan.body(j) for j in jobs[: plan.jobs_per_call]])
    assert ("jobs" in payload) == (plan.jobs_per_call > 1)
    for body in payload.get("jobs", [payload]):
        assert set(body) == {"in", "dem", "out"}


def test_judged_jobs_keep_their_outputs(tmp_path):
    plan = traffic.build(_mix("new_terrain"), SEED, tmp_path, _lr_raster())
    jobs = [plan.job(i) for i in range(plan.mix["judged_among"])]
    judged = [j for j in jobs if j.judged]
    assert {j.index for j in judged} == plan.judged and len(judged) == plan.mix["judged"]
    assert len({j.out_path for j in judged}) == len(judged)
    assert all(j.out_path.parent.name == "judged" for j in judged)
