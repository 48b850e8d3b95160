"""Affine bilinear resampling — the same-CRS reproject GDAL provides upstream.

The reference delegates grid-to-grid resampling to ``rasterio.warp.reproject``
with bilinear resampling (reference: ``floodsr/preprocessing.py:376-387``,
``floodsr/models/ResUNet_16x_DEM.py:561-571``). The pipeline only ever warps
between grids in the SAME projected CRS (CRS equality is asserted upstream),
so the warp reduces to an affine coordinate change + bilinear sampling at
destination pixel centers, with nodata-aware weight renormalization.

The numpy functions give the JAX package's host path's values, bit for bit
(between axis-aligned grids from 1-D sample plans that broadcast). The torch
functions warp on the device: rectilinear grids as two dense f32 matmuls
with the separable interpolation matrices (``Ry @ src @ Rx.T``), others as a
4-tap gather.
"""

from __future__ import annotations

import numpy as np
import torch

from floodsr_tpu_torch import tracing
from floodsr_tpu_torch.device import set_strict_f32
from floodsr_tpu_torch.io.affine import Affine


def _dst_center_coords_in_src(
    dst_shape: tuple[int, int],
    dst_transform: Affine,
    src_transform: Affine,
    xp,
):
    """Fractional src pixel-center coords (row, col) for each dst pixel center.

    Between axis-aligned grids (``b == d == 0`` in the destination transform
    and in the source's inverse) a destination row's source row depends on
    the row alone and a column's source column on the column alone: the
    coordinates come back as a ``[H, 1]`` column and a ``[1, W]`` row that
    broadcast to the full grids, the same values bit for bit (each term the
    general form adds is an exact zero, and a zero's sign is lost in the
    ``- 0.5``). Otherwise both are ``[H, W]`` grids. Counts
    ``resample.separable`` or ``resample.full_grid`` on the open span, so a
    job's ``scene_timings["trace"]["counters"]`` show which plan its warps took.
    """
    h, w = dst_shape
    rows = xp.arange(h, dtype=xp.float64) + 0.5
    cols = xp.arange(w, dtype=xp.float64) + 0.5
    inv = src_transform.invert()
    if dst_transform.is_rectilinear() and inv.is_rectilinear():
        tracing.count("resample.separable")
        x = dst_transform.a * cols[None, :] + dst_transform.c
        y = dst_transform.e * rows[:, None] + dst_transform.f
        return inv.e * y + inv.f - 0.5, inv.a * x + inv.c - 0.5
    tracing.count("resample.full_grid")
    cgrid, rgrid = xp.meshgrid(cols, rows)
    x = dst_transform.a * cgrid + dst_transform.b * rgrid + dst_transform.c
    y = dst_transform.d * cgrid + dst_transform.e * rgrid + dst_transform.f
    src_col = inv.a * x + inv.b * y + inv.c
    src_row = inv.d * x + inv.e * y + inv.f
    # Shift to pixel-center sample space.
    return src_row - 0.5, src_col - 0.5


def reproject_bilinear(
    source: np.ndarray,
    src_transform: Affine,
    dst_shape: tuple[int, int],
    dst_transform: Affine,
    src_nodata: float | None = None,
    dst_nodata: float | None = None,
) -> np.ndarray:
    """Bilinear-resample ``source`` onto the destination grid (numpy, host).

    Nodata source pixels are excluded with weight renormalization; destination
    pixels with no valid contribution (or falling outside the source) receive
    ``dst_nodata`` (or 0.0 when None, matching the pipeline's downstream
    nodata→0 policy).
    """
    if source.ndim != 2:
        raise AssertionError(f"source must be 2D; got {source.shape}")
    src = np.asarray(source, dtype=np.float64)
    h_s, w_s = src.shape
    fill = 0.0 if dst_nodata is None else float(dst_nodata)

    v, u = _dst_center_coords_in_src(dst_shape, dst_transform, src_transform, np)
    r0 = np.floor(v).astype(np.int64)
    c0 = np.floor(u).astype(np.int64)
    fr = v - r0
    fc = u - c0

    inside = (v >= -0.5) & (v <= h_s - 0.5) & (u >= -0.5) & (u <= w_s - 0.5)

    valid_src = np.isfinite(src)
    if src_nodata is not None:
        valid_src &= ~np.isclose(src, src_nodata)

    acc = np.zeros(dst_shape, np.float64)
    wacc = np.zeros(dst_shape, np.float64)
    for dr, dc, weight in (
        (0, 0, (1 - fr) * (1 - fc)),
        (0, 1, (1 - fr) * fc),
        (1, 0, fr * (1 - fc)),
        (1, 1, fr * fc),
    ):
        rr = np.clip(r0 + dr, 0, h_s - 1)
        cc = np.clip(c0 + dc, 0, w_s - 1)
        vals = src[rr, cc]
        ok = valid_src[rr, cc]
        w_eff = np.where(ok, weight, 0.0)
        acc += np.where(ok, vals, 0.0) * w_eff
        wacc += w_eff

    out = np.where((wacc > 0) & inside, acc / np.maximum(wacc, 1e-12), fill)
    return out.astype(np.float32)


def bilinear_axis_matrix(
    src_size: int,
    src_origin: float,
    src_step: float,
    dst_size: int,
    dst_origin: float,
    dst_step: float,
) -> np.ndarray:
    """Dense 1-D bilinear interpolation matrix ``[dst_size, src_size]``.

    For rectilinear (axis-aligned) transforms, 2-D bilinear resampling
    factorizes into ``Ry @ src @ Rx.T`` — two dense matmuls instead of an
    element-wise gather. Sample positions follow the pixel-center convention
    with clamp-to-edge, matching :func:`reproject_bilinear` inside bounds.
    """
    dst_centers = dst_origin + (np.arange(dst_size, dtype=np.float64) + 0.5) * dst_step
    src_coords = (dst_centers - src_origin) / src_step - 0.5
    i0 = np.floor(src_coords).astype(np.int64)
    frac = (src_coords - i0).astype(np.float64)
    i0c = np.clip(i0, 0, src_size - 1)
    i1c = np.clip(i0 + 1, 0, src_size - 1)
    matrix = np.zeros((dst_size, src_size), np.float32)
    rows = np.arange(dst_size)
    # Accumulate (i0 and i1 coincide at clamped edges).
    np.add.at(matrix, (rows, i0c), (1.0 - frac).astype(np.float32))
    np.add.at(matrix, (rows, i1c), frac.astype(np.float32))
    return matrix


def _axis_interp_indices(
    src_size: int, src_origin: float, src_step: float,
    dst_size: int, dst_origin: float, dst_step: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(i0, i1, frac) 1-D bilinear sample plan (pixel centers, clamp-to-edge)."""
    dst_centers = dst_origin + (np.arange(dst_size, dtype=np.float64) + 0.5) * dst_step
    src_coords = (dst_centers - src_origin) / src_step - 0.5
    i0 = np.floor(src_coords).astype(np.int64)
    frac = (src_coords - i0).astype(np.float32)
    return np.clip(i0, 0, src_size - 1), np.clip(i0 + 1, 0, src_size - 1), frac


def separable_resample_np(
    source: np.ndarray,
    src_transform: Affine,
    dst_shape: tuple[int, int],
    dst_transform: Affine,
) -> np.ndarray:
    """Host-side separable bilinear resample for rectilinear transforms.

    The 1-D sample plan of :func:`_axis_interp_indices` (the one the engine's
    device postprocess uses), applied as a row gather and lerp, then a column
    gather and lerp, in float32: O(H·W), no dense matrices. The engine's
    post-inference resample onto the raw DEM grid where the host resamples
    (under a mesh).
    """
    if not (src_transform.is_rectilinear() and dst_transform.is_rectilinear()):
        raise ValueError("separable resampling requires rectilinear transforms")
    src = np.asarray(source, np.float32)
    r0, r1, fr = _axis_interp_indices(
        src.shape[0], src_transform.f, src_transform.e,
        dst_shape[0], dst_transform.f, dst_transform.e,
    )
    c0, c1, fc = _axis_interp_indices(
        src.shape[1], src_transform.c, src_transform.a,
        dst_shape[1], dst_transform.c, dst_transform.a,
    )
    rows = src[r0, :] * (1.0 - fr)[:, None] + src[r1, :] * fr[:, None]
    return rows[:, c0] * (1.0 - fc)[None, :] + rows[:, c1] * fc[None, :]


def separable_resample_matrices(
    src_shape: tuple[int, int],
    src_transform: Affine,
    dst_shape: tuple[int, int],
    dst_transform: Affine,
) -> tuple[np.ndarray, np.ndarray]:
    """(Ry, Rx) for :func:`bilinear_axis_matrix`-based separable resampling."""
    if not (src_transform.is_rectilinear() and dst_transform.is_rectilinear()):
        raise ValueError("separable resampling requires rectilinear transforms")
    ry = bilinear_axis_matrix(
        src_shape[0], src_transform.f, src_transform.e,
        dst_shape[0], dst_transform.f, dst_transform.e,
    )
    rx = bilinear_axis_matrix(
        src_shape[1], src_transform.c, src_transform.a,
        dst_shape[1], dst_transform.c, dst_transform.a,
    )
    return ry, rx


def reproject_nearest(
    source: np.ndarray,
    src_transform: Affine,
    dst_shape: tuple[int, int],
    dst_transform: Affine,
    fill=0,
) -> np.ndarray:
    """Nearest-neighbor resample (used for validity masks, GDAL convention)."""
    if source.ndim != 2:
        raise AssertionError(f"source must be 2D; got {source.shape}")
    h_s, w_s = source.shape
    v, u = _dst_center_coords_in_src(dst_shape, dst_transform, src_transform, np)
    r = np.round(v).astype(np.int64)
    c = np.round(u).astype(np.int64)
    inside = (r >= 0) & (r < h_s) & (c >= 0) & (c < w_s)
    rr = np.clip(r, 0, h_s - 1)
    cc = np.clip(c, 0, w_s - 1)
    if rr.shape == cc.shape:
        vals = source[rr, cc]
    else:
        # A [H, 1] and a [1, W] plan: a row take, then a column take. The same
        # bits as the broadcast index ``source[rr, cc]``, in 18 ms against 70 ms
        # a call at 3840² (medians of 7, an H100 machine's host CPU).
        vals = source.take(rr[:, 0], axis=0).take(cc[0], axis=1)
    out = np.where(inside, vals, fill)
    return out.astype(source.dtype)


_DEVICE_WARP_THRESHOLD = 1 << 22  # ~4.2M destination pixels


def reproject_bilinear_torch(
    source: torch.Tensor,
    src_transform: Affine,
    dst_shape: tuple[int, int],
    dst_transform: Affine,
    src_nodata: float | None = None,
    dst_nodata: float | None = None,
) -> torch.Tensor:
    """Device twin of :func:`reproject_bilinear` (f32 4-tap gather).

    Between axis-aligned grids the sample plan is a ``[H, 1]`` column and a
    ``[1, W]`` row (:func:`_dst_center_coords_in_src`): only those go to the
    device, and the weights and gathers broadcast to ``[H, W]``.
    """
    src = source.to(torch.float32)
    dev = src.device
    h_s, w_s = src.shape
    fill = 0.0 if dst_nodata is None else float(dst_nodata)

    v, u = _dst_center_coords_in_src(dst_shape, dst_transform, src_transform, np)
    v = torch.from_numpy(v.astype(np.float32)).to(dev)
    u = torch.from_numpy(u.astype(np.float32)).to(dev)
    r0 = torch.floor(v).to(torch.int64)
    c0 = torch.floor(u).to(torch.int64)
    fr = v - r0
    fc = u - c0
    inside = (v >= -0.5) & (v <= h_s - 0.5) & (u >= -0.5) & (u <= w_s - 0.5)

    valid_src = torch.isfinite(src)
    if src_nodata is not None:
        valid_src &= ~torch.isclose(src, torch.tensor(float(src_nodata), device=dev))

    acc = torch.zeros(dst_shape, dtype=torch.float32, device=dev)
    wacc = torch.zeros(dst_shape, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for dr, dc, weight in (
        (0, 0, (1 - fr) * (1 - fc)),
        (0, 1, (1 - fr) * fc),
        (1, 0, fr * (1 - fc)),
        (1, 1, fr * fc),
    ):
        rr = torch.clamp(r0 + dr, 0, h_s - 1)
        cc = torch.clamp(c0 + dc, 0, w_s - 1)
        vals = src[rr, cc]
        ok = valid_src[rr, cc]
        w_eff = torch.where(ok, weight, zero)
        acc = acc + torch.where(ok, vals, zero) * w_eff
        wacc = wacc + w_eff
    out = acc / torch.clamp_min(wacc, 1e-12)
    return torch.where((wacc > 0) & inside, out, torch.full_like(out, fill))


def _interp_matrix(
    i0: np.ndarray, i1: np.ndarray, frac: np.ndarray, n_src: int, device
) -> torch.Tensor:
    """Dense ``[n_dst, n_src]`` bilinear matrix from a 1-D sample plan.

    Same entries as the JAX package's device-built matrices
    (``warp_bucketed_device``): ``(1 - frac)`` and ``frac`` in f32 at the
    clamped indices, summed where the two coincide at an edge.
    """
    i0 = torch.from_numpy(np.asarray(i0, np.int64)).to(device)
    i1 = torch.from_numpy(np.asarray(i1, np.int64)).to(device)
    fr = torch.from_numpy(np.asarray(frac, np.float32)).to(device)
    iota = torch.arange(n_src, device=device)
    return (
        (i0[:, None] == iota[None, :]) * (1.0 - fr)[:, None]
        + (i1[:, None] == iota[None, :]) * fr[:, None]
    ).to(torch.float32)


def _separable_matmul(src: torch.Tensor, ry: torch.Tensor, rx_t: torch.Tensor) -> torch.Tensor:
    if src.device.type == "cuda":
        set_strict_f32()  # full f32: TF32 costs meters on elevation-scale values
    return torch.matmul(torch.matmul(ry, src.to(torch.float32)), rx_t)


def warp_separable_device(
    source: torch.Tensor,
    src_transform: Affine,
    dst_shape: tuple[int, int],
    dst_transform: Affine,
) -> torch.Tensor:
    """Separable bilinear warp on ``source``'s device (rectilinear transforms).

    Port of the JAX package's ``warp_bucketed_device`` without the shape
    buckets (PyTorch runs eagerly and has no compile to amortize). Requires a
    nodata-free source (the pipeline replaces nodata→0 before warping).
    """
    assert src_transform.is_rectilinear() and dst_transform.is_rectilinear()
    src_h, src_w = int(source.shape[0]), int(source.shape[1])
    r0, r1, fr = _axis_interp_indices(
        src_h, src_transform.f, src_transform.e,
        int(dst_shape[0]), dst_transform.f, dst_transform.e,
    )
    c0, c1, fc = _axis_interp_indices(
        src_w, src_transform.c, src_transform.a,
        int(dst_shape[1]), dst_transform.c, dst_transform.a,
    )
    ry = _interp_matrix(r0, r1, fr, src_h, source.device)
    rx_t = _interp_matrix(c0, c1, fc, src_w, source.device).T
    return _separable_matmul(source, ry, rx_t)


def reproject_bilinear_auto(
    source: np.ndarray,
    src_transform: Affine,
    dst_shape: tuple[int, int],
    dst_transform: Affine,
    src_nodata: float | None = None,
    dst_nodata: float | None = None,
    *,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """Warp a large grid on ``device``, a small one on the host.

    Small grids (under ~4.2M destination pixels) stay in numpy, by size, as
    in the JAX package. A large rectilinear warp with no live nodata sentinel
    runs as two f32 matmuls with :func:`separable_resample_matrices` on the
    device; any other large warp as the device 4-tap gather.

    A sentinel is live when a source cell matches ``src_nodata`` or is not
    finite. The JAX package decides by the sentinel's value alone (any
    nonzero ``src_nodata`` takes the matmuls, which cannot skip a cell) and
    so blends a live nonzero sentinel into its neighbours on a large grid;
    here the data decide, and a live sentinel takes the nodata-aware gather,
    as the host path does at every size.
    """
    if int(dst_shape[0]) * int(dst_shape[1]) < _DEVICE_WARP_THRESHOLD:
        return reproject_bilinear(
            source, src_transform, dst_shape, dst_transform, src_nodata, dst_nodata
        )
    device = torch.device(device)
    src = torch.from_numpy(np.ascontiguousarray(source, np.float32)).to(device)
    live_nodata = src_nodata is not None and bool(
        (
            ~torch.isfinite(src)
            | torch.isclose(src, torch.tensor(float(src_nodata), device=device))
        ).any()
    )
    if (
        src_transform.is_rectilinear()
        and dst_transform.is_rectilinear()
        and not live_nodata
    ):
        ry, rx = separable_resample_matrices(
            tuple(source.shape), src_transform, dst_shape, dst_transform
        )
        out = _separable_matmul(
            src,
            torch.from_numpy(ry).to(device),
            torch.from_numpy(np.ascontiguousarray(rx.T)).to(device),
        )
    else:
        out = reproject_bilinear_torch(
            src, src_transform, dst_shape, dst_transform, src_nodata, dst_nodata
        )
    return out.cpu().numpy()


def pad_to_multiple(
    arr: np.ndarray, multiple: int, constant: float = 0.0
) -> np.ndarray:
    """Zero-pad trailing edges so both dims are multiples of ``multiple``."""
    h, w = arr.shape
    pad_h = (-h) % multiple
    pad_w = (-w) % multiple
    if pad_h == 0 and pad_w == 0:
        return arr
    return np.pad(arr, ((0, pad_h), (0, pad_w)), constant_values=constant)
