"""Host→device DEM upload, uint16-encoded and dequantized on the device.

Port of the JAX package's ``ops/transfer.py::device_put_dem_quantized``. The
DEM is the pipeline's one big upload (a 4096² float32 scene is 67 MB), so it
ships as uint16 fixed point — half the bytes — and is dequantized on the
device:

- valid values map to codes ``0..65534`` over the valid min/max range, so the
  quantization step is ``range/65534`` (≈1.6 mm for 100 m of relief);
- code ``65535`` is reserved for nodata when a nodata value exists, so
  nodata round-trips EXACTLY and downstream ``isclose`` masking still fires.

Small arrays (< ``_MIN_BYTES``) and degenerate ranges skip the encoding and
upload float32 directly, so test-sized scenes are bit-identical either way.

A background thread (the worker's DEM prefetch) passes a CUDA ``stream`` of its
own: the copy and the dequantization are enqueued there, so they do not queue
behind a running scene on the default stream, and the stream is synchronized
before the tensor is returned, so it is complete and any stream may read it.
Its memory belongs to that stream's pool in the caching allocator: a reader on
another stream calls ``Tensor.record_stream`` (the worker does, on a cache
hit).
"""

from __future__ import annotations

import numpy as np
import torch

from floodsr_tpu_torch.ops.normalize import nodata_mask

_MIN_BYTES = 8 * 1024 * 1024  # below this, encoding overhead beats the savings
_MAX_CODE = 65534.0


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=device.type == "cuda")


def device_put_dem_quantized(
    arr: np.ndarray,
    nodata: float | None = None,
    *,
    enabled: bool = True,
    device: "str | torch.device" = "cuda",
    stream: "torch.cuda.Stream | None" = None,
) -> torch.Tensor:
    """Upload ``arr`` (2-D float raster) to ``device``, uint16-encoded when large.

    Returns a float32 tensor equal to ``arr`` up to the quantization step
    (exact on nodata cells). Uploads float32 directly when disabled, small,
    non-finite-ranged, or constant. With ``stream`` (CUDA only) the device
    work runs on that stream, which is synchronized before returning.
    """
    device = torch.device(device)
    if stream is None:
        return _put_dem_quantized(arr, nodata, enabled, device)
    with torch.cuda.stream(stream):
        x = _put_dem_quantized(arr, nodata, enabled, device)
    stream.synchronize()
    return x


def _put_dem_quantized(
    arr: np.ndarray, nodata: "float | None", enabled: bool, device: torch.device
) -> torch.Tensor:
    arr32 = np.ascontiguousarray(arr, dtype=np.float32)
    if not enabled or arr32.nbytes < _MIN_BYTES:
        return _upload(arr32, device)

    if nodata is not None:
        valid = ~nodata_mask(arr32, float(nodata))
        if not valid.any():
            return _upload(arr32, device)
        vals = arr32[valid]
        vmin = float(vals.min())
        vmax = float(vals.max())
    else:
        vmin = float(arr32.min())
        vmax = float(arr32.max())
    if not (np.isfinite(vmin) and np.isfinite(vmax)) or vmax <= vmin:
        return _upload(arr32, device)

    scale = (vmax - vmin) / _MAX_CODE
    codes = np.round((arr32 - vmin) * (1.0 / scale))
    codes = np.clip(codes, 0.0, _MAX_CODE).astype(np.uint16)
    if nodata is not None:
        codes = np.where(valid, codes, np.uint16(65535))
    # uint16 tensors support few ops: widen once on the device.
    q = _upload(codes, device).to(torch.int32)

    def f32(v: float) -> torch.Tensor:
        return torch.tensor(float(v), dtype=torch.float32, device=device)

    x = q.to(torch.float32) * f32(scale) + f32(vmin)
    if nodata is not None:
        x = torch.where(q == 65535, f32(nodata), x)
    return x
