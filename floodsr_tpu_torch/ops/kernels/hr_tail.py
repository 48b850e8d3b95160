"""The ResUNet HR tail: the ``hr_tail`` CUDA kernels (K1).

Replaces the TPU kernel ``floodsr_tpu/ops/pallas/hr_tail.py::hr_tail_pallas``
(pallas_call at :594, kernel ``_hr_tail_kernel`` :385-447): concat(SR
features, DEM features) → residual block with a 1×1 projection shortcut →
residual block with an identity shortcut → 1×1 head, NHWC f32, BN folded to
per-channel affines (:func:`pack_hr_tail_weights`, after the JAX package's
:450-478).

Source: ``floodsr_tpu_torch/csrc/hr_tail.cu`` (its header says what bounds it
on the card and what its design does about that). :func:`hr_tail` dispatches
a CPU tensor to :func:`hr_tail_reference`, the unfused chain with
``F.conv2d``; a CUDA tensor launches the hand-written kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Packed weight order (the CUDA launcher indexes the same list).
WEIGHT_KEYS = (
    "f1_a1", "f1_c1", "f1_w1", "f1_b1", "f1_a2", "f1_c2", "f1_w2", "f1_b2",
    "f1_pw", "f1_pb",
    "f2_a1", "f2_c1", "f2_w1", "f2_b1", "f2_a2", "f2_c2", "f2_w2", "f2_b2",
    "head_w", "head_b",
)

#: hr_tail calls that launched the kernels since the last reset
#: (ops.kernels.reset_launch_counts); each call is six kernel launches
launches = 0


def pack_hr_tail_weights(f1, f2, head, *, bn_eps: float) -> list[torch.Tensor]:
    """Fold BN stats and order the fuse/head parameters for the kernel.

    ``f1``/``f2`` are :class:`floodsr_tpu_torch.nn.resunet.ResBlock` modules
    (``f1`` with a ``proj``), ``head`` the 1×1 :class:`Conv`. Returns float32
    contiguous tensors in :data:`WEIGHT_KEYS` order, in the JAX package's
    layouts: 3×3 kernels HWIO ``[3, 3, Cin, Cout]``, 1×1 kernels ``[Cin, Cout]``.
    """

    def hwio(w):
        return w.permute(2, 3, 1, 0).contiguous()

    def block(blk, with_proj):
        a1, c1 = blk.bn1.folded(bn_eps)
        a2, c2 = blk.bn2.folded(bn_eps)
        out = [
            a1, c1, hwio(blk.conv1.w), blk.conv1.b,
            a2, c2, hwio(blk.conv2.w), blk.conv2.b,
        ]
        if with_proj:
            out += [hwio(blk.proj.w)[0, 0], blk.proj.b]
        return out

    ws = block(f1, True) + block(f2, False) + [hwio(head.w)[0, 0], head.b]
    return [w.to(torch.float32).contiguous() for w in ws]


def _affine_relu(x: torch.Tensor, a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.relu(x * a[None, :, None, None] + c[None, :, None, None])


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NCHW conv with an HWIO kernel (3×3 pads 1 each side, as SAME does)."""
    if w.ndim == 2:
        w = w[None, None]
    pad = (w.shape[0] - 1) // 2
    return F.conv2d(x, w.permute(3, 2, 0, 1), None, 1, pad) + b[None, :, None, None]


def hr_tail_reference(sr: torch.Tensor, dem: torch.Tensor, *weights) -> torch.Tensor:
    """Plain torch version: the unfused chain. NHWC in, ``[B, H, W, Ch]`` out."""
    w = dict(zip(WEIGHT_KEYS, weights))
    x = torch.cat([sr, dem], dim=-1).permute(0, 3, 1, 2).to(torch.float32)
    y = _conv(_affine_relu(x, w["f1_a1"], w["f1_c1"]), w["f1_w1"], w["f1_b1"])
    y = _conv(_affine_relu(y, w["f1_a2"], w["f1_c2"]), w["f1_w2"], w["f1_b2"])
    y1 = y + _conv(x, w["f1_pw"], w["f1_pb"])
    y = _conv(_affine_relu(y1, w["f2_a1"], w["f2_c1"]), w["f2_w1"], w["f2_b1"])
    y = _conv(_affine_relu(y, w["f2_a2"], w["f2_c2"]), w["f2_w2"], w["f2_b2"])
    y2 = y + y1
    return _conv(y2, w["head_w"], w["head_b"]).permute(0, 2, 3, 1)


def _check_weights(weights, cin: int, cm: int, ch: int, device) -> None:
    if len(weights) != len(WEIGHT_KEYS):
        raise ValueError(f"expected {len(WEIGHT_KEYS)} weights; got {len(weights)}")
    want = {
        "f1_a1": (cin,), "f1_c1": (cin,), "f1_w1": (3, 3, cin, cm), "f1_b1": (cm,),
        "f1_a2": (cm,), "f1_c2": (cm,), "f1_w2": (3, 3, cm, cm), "f1_b2": (cm,),
        "f1_pw": (cin, cm), "f1_pb": (cm,),
        "f2_a1": (cm,), "f2_c1": (cm,), "f2_w1": (3, 3, cm, cm), "f2_b1": (cm,),
        "f2_a2": (cm,), "f2_c2": (cm,), "f2_w2": (3, 3, cm, cm), "f2_b2": (cm,),
        "head_w": (cm, ch), "head_b": (ch,),
    }
    for key, t in zip(WEIGHT_KEYS, weights):
        if tuple(t.shape) != want[key]:
            raise ValueError(f"weight {key}: shape {tuple(t.shape)} != {want[key]}")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
            raise ValueError(
                f"weight {key} must be float32, contiguous and on {device}; "
                f"got {t.dtype} on {t.device}"
            )


def _lib():
    from floodsr_tpu_torch.ops.kernels import _build

    lib = _build.load("hr_tail")
    fn = lib.hr_tail_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
    return fn


def hr_tail_cuda(sr: torch.Tensor, dem: torch.Tensor, *weights) -> torch.Tensor:
    """Launch the hand-written kernels: NHWC f32 contiguous CUDA tensors."""
    global launches
    from floodsr_tpu_torch.ops.kernels import _build

    for name, t in (("sr", sr), ("dem", dem)):
        if t.device.type != "cuda":
            raise ValueError(f"hr_tail_cuda needs CUDA tensors; {name} is on {t.device}")
        if t.ndim != 4 or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 [B, H, W, C] tensor; got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if sr.shape[:3] != dem.shape[:3] or sr.device != dem.device:
        raise ValueError(
            f"sr {tuple(sr.shape)} and dem {tuple(dem.shape)} must share "
            "batch, height, width and device"
        )
    b, h, w, ca = (int(v) for v in sr.shape)
    cb = int(dem.shape[3])
    cm = int(weights[WEIGHT_KEYS.index("f1_b1")].shape[0])
    ch = int(weights[WEIGHT_KEYS.index("head_b")].shape[0])
    _check_weights(weights, ca + cb, cm, ch, sr.device)
    if b * h * w * max(ca + cb, cm) >= 2**31 or b * ((cm + 31) // 32) > 65535:
        raise ValueError(f"batch {tuple(sr.shape)} exceeds the kernel's index range")
    if (h + 7) // 8 > 65535:
        raise ValueError(f"height {h} exceeds the kernel's grid")

    buf_p = torch.empty((b, h, w, cm), dtype=torch.float32, device=sr.device)
    buf_y = torch.empty_like(buf_p)
    out = torch.empty((b, h, w, ch), dtype=torch.float32, device=sr.device)
    ptrs = (ctypes.c_void_p * len(weights))(*[t.data_ptr() for t in weights])
    fn = _lib()
    with torch.cuda.device(sr.device):
        rc = fn(
            sr.data_ptr(), dem.data_ptr(), b, h, w, ca, cb, cm, ch,
            ctypes.cast(ptrs, ctypes.c_void_p), buf_p.data_ptr(), buf_y.data_ptr(),
            out.data_ptr(), _build.current_stream_ptr(sr.device),
        )
    _build.check(rc, "hr_tail")
    launches += 1
    return out


def hr_tail(sr: torch.Tensor, dem: torch.Tensor, *weights) -> torch.Tensor:
    """Fused tail ``[B,H,W,Ca] + [B,H,W,Cb] → [B,H,W,Ch]``: kernel on CUDA, plain on CPU."""
    if sr.device.type == "cuda":
        return hr_tail_cuda(sr, dem, *weights)
    if sr.device.type != "cpu":
        raise ValueError(f"unsupported device {sr.device}")
    return hr_tail_reference(sr, dem, *weights)
