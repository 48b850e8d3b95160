"""The separable sample plan of ``floodsr_tpu_torch/ops/resample.py``.

Between axis-aligned grids ``_dst_center_coords_in_src`` returns a ``[H, 1]``
column and a ``[1, W]`` row in place of two ``[H, W]`` grids. Every consumer
(the host bilinear warp, the device 4-tap gather, the nearest-neighbour mask)
must give the same bits as from the full grids. On the CPU the yardstick is
the JAX package's host path (``floodsr_tpu.ops.resample``), which builds the
full grids: its ``reproject_bilinear`` and ``reproject_nearest``, and its
coordinate function swapped in for the port's under the device gather. A
sheared or rotated transform still takes the full grids.

The last case needs an NVIDIA GPU and skips without one. It imports no JAX,
so it holds the card against ``_full_grid_coords``, a private copy of the
full-grid coordinate function:
``python -m pytest --noconftest -m cuda tests/test_torch_resample_separable.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from floodsr_tpu_torch import tracing
from floodsr_tpu_torch.io.affine import Affine, from_origin
from floodsr_tpu_torch.ops import resample

NODATA = -9999.0


# name: (source shape, source transform, destination shape, destination transform)
GEOMETRIES = {
    # the cell's 30 m -> 2 m, ratio 15, one origin
    "ratio_15": ((16, 16), from_origin(500000.0, 4000480.0, 30.0, 30.0),
                 (240, 240), from_origin(500000.0, 4000480.0, 2.0, 2.0)),
    "non_integer_ratio": ((21, 17), from_origin(500000.0, 4000630.0, 30.0, 30.0),
                          (90, 72), from_origin(500003.5, 4000626.0, 7.0, 7.0)),
    # the window starts west of and north of the source and ends inside it
    "offset_partly_outside": ((20, 20), from_origin(1000.0, 2600.0, 30.0, 30.0),
                              (160, 160), from_origin(871.0, 2723.0, 3.0, 3.0)),
    "south_up": ((18, 14), Affine(25.0, 0.0, 300.0, 0.0, 25.0, -150.0),
                 (81, 70), Affine(5.0, 0.0, 310.0, 0.0, 5.5, -160.0)),
    "non_square": ((12, 30), from_origin(0.0, 360.0, 30.0, 30.0),
                   (50, 210), from_origin(-12.0, 350.0, 4.5, 7.0)),
    "one_pixel_wide": ((24, 1), from_origin(100.0, 720.0, 30.0, 30.0),
                       (96, 9), from_origin(95.0, 722.0, 4.0, 7.5)),
    # signed zeros in b and d, world x and y exactly 0 at a column and a row, and
    # sample coordinates exactly on the source's edges (-0.5 and n - 0.5)
    "signed_zeros_and_edges": ((8, 8), Affine(1.0, -0.0, -4.0, -0.0, -1.0, 4.0),
                               (18, 18), Affine(0.5, -0.0, -4.25, 0.0, -0.5, 4.25)),
    # sheared and rotated: the full grids, as before
    "sheared": ((20, 24), Affine(30.0, 4.0, 1000.0, -3.0, -30.0, 2000.0),
                (70, 80), Affine(7.5, 1.0, 1010.0, -0.75, -7.5, 1990.0)),
    "rotated": ((16, 16), Affine(21.2132, 21.2132, 0.0, 21.2132, -21.2132, 600.0),
                (60, 60), from_origin(20.0, 580.0, 5.0, 5.0)),
}
AXIS_ALIGNED = {"sheared": False, "rotated": False}


def _source(seed, shape):
    """A surface with the sentinel and NaN live in it, and a validity mask."""
    rng = np.random.default_rng(seed)
    src = (100.0 + np.cumsum(rng.normal(0.0, 0.7, shape), axis=1)).astype(np.float32)
    dry = rng.random(shape) < 0.3
    src[dry] = NODATA
    src[rng.random(shape) < 0.05] = np.nan
    return src, (~dry & np.isfinite(src)).astype(np.uint8)


def _consumers(src, mask, src_t, dst_shape, dst_t, host=resample):
    """Each consumer of the plan, on this geometry (the numpy warps from ``host``)."""
    return {
        "bilinear": host.reproject_bilinear(
            src, src_t, dst_shape, dst_t, src_nodata=NODATA, dst_nodata=np.nan),
        "bilinear_torch": resample.reproject_bilinear_torch(
            torch.from_numpy(src), src_t, dst_shape, dst_t, src_nodata=NODATA,
            dst_nodata=np.nan).numpy(),
        "nearest": host.reproject_nearest(mask, src_t, dst_shape, dst_t, fill=0),
        "nearest_float": host.reproject_nearest(src, src_t, dst_shape, dst_t,
                                                fill=np.float32(-1.0)),
    }


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_the_plan_gives_the_full_grids_bits(name, monkeypatch):
    from floodsr_tpu.ops import resample as reference

    src_shape, src_t, dst_shape, dst_t = GEOMETRIES[name]
    separable = AXIS_ALIGNED.get(name, True)
    h, w = dst_shape

    v, u = resample._dst_center_coords_in_src(dst_shape, dst_t, src_t, np)
    want_v, want_u = reference._dst_center_coords_in_src(dst_shape, dst_t, src_t, np)
    assert (v.shape, u.shape) == (((h, 1), (1, w)) if separable else ((h, w), (h, w)))
    assert np.array_equal(_bits(np.broadcast_to(v, (h, w))), _bits(want_v))
    assert np.array_equal(_bits(np.broadcast_to(u, (h, w))), _bits(want_u))

    src, mask = _source(sum(map(ord, name)), src_shape)
    with tracing.request() as trace, tracing.span("warps") as s:
        got = _consumers(src, mask, src_t, dst_shape, dst_t)
    assert s.counters == {"resample.separable" if separable else "resample.full_grid": 4.0}
    assert trace.spans == [s]

    monkeypatch.setattr(resample, "_dst_center_coords_in_src",
                        reference._dst_center_coords_in_src)
    want = _consumers(src, mask, src_t, dst_shape, dst_t, host=reference)
    for key, out in got.items():
        assert out.shape == dst_shape and out.dtype == want[key].dtype, key
        assert np.array_equal(_bits(out), _bits(want[key])), key
    # the geometry reaches both sides of the mask, and the sentinel stays out
    assert 0 < got["nearest"].sum() < h * w
    assert np.isfinite(got["bilinear"]).any() and not (got["bilinear"] == NODATA).any()


def test_the_plan_counts_nothing_outside_a_request():
    src_shape, src_t, dst_shape, dst_t = GEOMETRIES["ratio_15"]
    with tracing.span("alone") as s:
        resample.reproject_nearest(np.ones(src_shape, np.uint8), src_t, dst_shape, dst_t)
    assert s.counters is None


def _full_grid_coords(dst_shape, dst_transform, src_transform, xp):
    """The full-grid coordinates, as the JAX package's host path makes them."""
    h, w = dst_shape
    rows = xp.arange(h, dtype=xp.float64) + 0.5
    cols = xp.arange(w, dtype=xp.float64) + 0.5
    cgrid, rgrid = xp.meshgrid(cols, rows)
    x = dst_transform.a * cgrid + dst_transform.b * rgrid + dst_transform.c
    y = dst_transform.d * cgrid + dst_transform.e * rgrid + dst_transform.f
    inv = src_transform.invert()
    src_col = inv.a * x + inv.b * y + inv.c
    src_row = inv.d * x + inv.e * y + inv.f
    return src_row - 0.5, src_col - 0.5


@pytest.mark.cuda
def test_the_cells_warp_on_the_card_gives_the_full_grids_bits(monkeypatch):
    """The cell's 256² WSE at 30 m onto 3840² at 2 m, dry cells on the sentinel:
    the card's gather (``reproject_bilinear_auto`` takes it for a live sentinel)
    and the nearest mask from the plan equal those from the full grids."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the warp under test runs on the card")
    src_t = from_origin(500000.0, 4007680.0, 30.0, 30.0)
    dst_t = from_origin(500000.0, 4007680.0, 2.0, 2.0)
    dst_shape = (3840, 3840)
    rng = np.random.default_rng(21)
    wse = (250.0 + np.cumsum(rng.normal(0.0, 0.3, (256, 256)), axis=1)).astype(np.float32)
    wse[rng.random((256, 256)) < 0.4] = NODATA
    valid = (wse != NODATA).astype(np.uint8)

    def run():
        with tracing.request(), tracing.span("warps") as s:
            warped = resample.reproject_bilinear_auto(
                wse, src_t, dst_shape, dst_t, src_nodata=NODATA, dst_nodata=np.nan,
                device="cuda")
            mask = resample.reproject_nearest(valid, src_t, dst_shape, dst_t, fill=0)
        return warped, mask, s.counters

    warped, mask, counters = run()
    assert counters == {"resample.separable": 2.0}
    monkeypatch.setattr(resample, "_dst_center_coords_in_src", _full_grid_coords)
    want_warped, want_mask, _ = run()
    assert np.array_equal(_bits(warped), _bits(want_warped))
    assert np.array_equal(mask, want_mask)
    assert np.isnan(warped).any() and np.isfinite(warped).mean() > 0.3
