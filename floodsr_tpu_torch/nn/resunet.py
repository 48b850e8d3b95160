"""DEM-conditioned 16× ResUNet as a PyTorch ``nn.Module``.

Port of the JAX package's functional network (``floodsr_tpu/nn/resunet.py``):

- inputs ``depth_lr [N,h,w,1]`` and ``dem_hr [N,h*s,w*s,1]``, NHWC float;
- ``dem_hr`` box-mean pooled to LR and concatenated with ``depth_lr`` as the
  encoder input;
- a UNet encoder/decoder of pre-activation residual blocks with channel
  widths ``f,2f,4f,...``;
- two transposed-conv upsamples back towards HR, then (with ``hr_s2d > 1``)
  the HR stages at ``(H/s2d)²`` with the DEM packed by space-to-depth;
- the HR feature map re-fused with DEM features through residual blocks and
  a 1×1 head, unpacked by depth-to-space.

The public functions keep NHWC, as the JAX package does, so the tests compare
like with like; the convolutions run NCHW inside. Parameters carry the JAX
tree's names (``enc.1.0.conv1.w``), so :func:`floodsr_tpu_torch.nn.checkpoint.
params_from_jax` loads an artifact with ``load_state_dict(strict=True)``.

Numerics follow the JAX package: XLA "SAME" padding computed per
convolution (a 3×3/stride-2 conv on an even input pads 0 before and 1
after), inference batch norm folded with the config's ``bn_eps``,
kernel == stride transposed convs as one matmul with the spatially flipped
kernel plus depth-to-space. On the GPU the HR fuse blocks + head run through
the hand-written ``hr_tail`` CUDA kernel whenever the configuration is
eligible (:func:`hr_tail_eligible`); the trunk convolutions stay
``F.conv2d``, as the JAX package leaves them to XLA.

Precision policies (:func:`resolve_precision_policy`) give each stage
(``trunk``, ``sr_up``, ``tail``, ``head``) a dtype, ``torch.float32`` or
``torch.bfloat16``; activations are cast at the stage boundaries. A bf16 stage
computes what the JAX package's does: activations, weights and the BN affine
are bf16 (every elementwise operation rounds to bf16), and a convolution or
matmul multiplies bf16 values, accumulates in f32, adds its f32 bias and
rounds ONCE to bf16. The product runs on the operands upcast to f32, which is
exact (a product of two bf16 values has 16 significant bits), so the bias can
be added before the one rounding and the CPU computes the same arithmetic; on
the GPU these products alone may run as TF32 on the tensor cores
(:func:`bf16_products`), which is exact for bf16-valued operands too, while
the f32 stages stay strict f32. A bf16 tail runs the ``hr_tail`` kernel's bf16
route; the head stays f32 under every policy.

Training (:meth:`ResUNet.forward_train`) runs with autograd and batch
statistics in every batch norm, as the JAX package's ``train=True`` does:
mean and biased variance over N, H and W, the gradient flowing through both,
the new running stats returned (not written) as ``momentum·old + (1 −
momentum)·batch``, and the tail unfused (the ``hr_tail`` kernel has no
backward). :func:`init_resunet` draws the JAX package's initial weights from
the same numpy generator, bit for bit; :func:`floodsr_tpu_torch.nn.
checkpoint.params_from_jax` loads them. :func:`forward_train_mesh` is the
training forward over a ``(dp, tp)`` mesh: batch norm over the global batch
(:func:`batch_norm_across`), convolutions split by output channel over ``tp``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from floodsr_tpu_torch.parallel.mesh import all_gather, broadcast, psum, to_device

PRECISION_STAGES = ("trunk", "sr_up", "tail", "head")

#: Named policies; the head stays f32 in every one (it anchors the
#: meter-domain output). ``f32`` is the default and the only one the JAX
#: package holds to its parity gate; ``bf16`` runs the body in single-pass
#: bf16, ``mixed`` the trunk and the SR upsample only.
PRECISION_POLICIES: dict[str, dict[str, str]] = {
    "f32": {"trunk": "f32", "sr_up": "f32", "tail": "f32", "head": "f32"},
    "bf16": {"trunk": "bf16", "sr_up": "bf16", "tail": "bf16", "head": "f32"},
    "mixed": {"trunk": "bf16", "sr_up": "bf16", "tail": "f32", "head": "f32"},
}

_STAGE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ResUNetConfig:
    """Architecture hyperparameters, serialized into model artifacts."""

    base_filters: int = 32
    levels: int = 4              # downsampling stages after stage 0
    enc_blocks: int = 2          # residual blocks per encoder stage
    dec_blocks: int = 2          # residual blocks per decoder stage
    fuse_filters: int = 32       # channels of the DEM feature conv at HR
    fuse_blocks: int = 2         # residual blocks after DEM re-fusion
    scale: int = 16              # HR/LR ratio
    lr_tile: int = 32            # LR tile edge the artifact was trained for
    bn_eps: float = 1e-3         # Keras default, matching reference training
    bn_momentum: float = 0.99
    hr_s2d: int = 4              # HR-stage space-to-depth factor

    @property
    def hr_tile(self) -> int:
        return self.lr_tile * self.scale

    @property
    def widths(self) -> tuple[int, ...]:
        f = self.base_filters
        return tuple(f * (2**i) for i in range(self.levels + 1))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(payload: dict) -> "ResUNetConfig":
        fields = {f.name for f in dataclasses.fields(ResUNetConfig)}
        return ResUNetConfig(**{k: v for k, v in payload.items() if k in fields})


def split_scale(scale: int) -> tuple[int, int]:
    """Split an integer upsampling factor into two transposed-conv strides."""
    root = int(round(math.sqrt(scale)))
    if root * root == scale:
        return root, root
    for a in range(root + 1, scale + 1):
        if scale % a == 0:
            return a, scale // a
    return scale, 1


# ---------------------------------------------------------------------------
# initialization (numpy trees in the JAX package's layout)
# ---------------------------------------------------------------------------


def _he_conv(rng: np.random.Generator, kh, kw, cin, cout) -> dict:
    fan_in = kh * kw * cin
    std = math.sqrt(2.0 / fan_in)
    w = (rng.standard_normal((kh, kw, cin, cout)) * std).astype(np.float32)
    return {"w": w, "b": np.zeros((cout,), np.float32)}


def _bn_init(c: int) -> tuple[dict, dict]:
    params = {"scale": np.ones((c,), np.float32), "offset": np.zeros((c,), np.float32)}
    state = {"mean": np.zeros((c,), np.float32), "var": np.ones((c,), np.float32)}
    return params, state


def _res_block_init(rng: np.random.Generator, cin: int, cout: int) -> tuple[dict, dict]:
    bn1_p, bn1_s = _bn_init(cin)
    bn2_p, bn2_s = _bn_init(cout)
    params = {
        "bn1": bn1_p,
        "conv1": _he_conv(rng, 3, 3, cin, cout),
        "bn2": bn2_p,
        "conv2": _he_conv(rng, 3, 3, cout, cout),
    }
    state = {"bn1": bn1_s, "bn2": bn2_s}
    if cin != cout:
        params["proj"] = _he_conv(rng, 1, 1, cin, cout)
    return params, state


def init_resunet(seed: int, cfg: ResUNetConfig) -> tuple[dict, dict]:
    """Initial ``(params, state)`` numpy trees, equal to the JAX package's.

    He-normal convolution kernels (HWIO) and zero biases, BN scale 1 and
    offset 0, running mean 0 and variance 1, drawn from
    ``np.random.default_rng(np.random.Philox(seed))`` in the JAX package's
    order. Load them with :func:`floodsr_tpu_torch.nn.checkpoint.params_from_jax`.
    """
    rng = np.random.default_rng(np.random.Philox(int(seed)))
    params: dict = {"stem": _he_conv(rng, 3, 3, 2, cfg.base_filters)}
    state: dict = {}

    enc_p, enc_s = [], []
    cin = cfg.base_filters
    for w in cfg.widths:
        blocks_p, blocks_s = [], []
        for _ in range(cfg.enc_blocks):
            bp, bs = _res_block_init(rng, cin, w)
            blocks_p.append(bp)
            blocks_s.append(bs)
            cin = w
        enc_p.append(blocks_p)
        enc_s.append(blocks_s)
    params["enc"], state["enc"] = enc_p, enc_s

    dec_p, dec_s = [], []
    for w in reversed(cfg.widths[:-1]):
        stage_p: dict = {"up": _he_conv(rng, 2, 2, cin, w)}
        cin = 2 * w  # skip concat
        blocks_p, blocks_s = [], []
        for _ in range(cfg.dec_blocks):
            bp, bs = _res_block_init(rng, cin, w)
            blocks_p.append(bp)
            blocks_s.append(bs)
            cin = w
        stage_p["blocks"] = blocks_p
        dec_p.append(stage_p)
        dec_s.append({"blocks": blocks_s})
    params["dec"], state["dec"] = dec_p, dec_s

    s2d = int(cfg.hr_s2d)
    assert cfg.scale % s2d == 0, f"hr_s2d={s2d} must divide scale={cfg.scale}"
    s0, s1 = split_scale(cfg.scale // s2d)
    hr_width = cfg.base_filters * s2d
    params["sr_up1"] = _he_conv(rng, s0, s0, cin, cfg.base_filters)
    params["sr_up2"] = _he_conv(rng, s1, s1, cfg.base_filters, hr_width)

    params["dem_feat"] = _he_conv(rng, 3, 3, s2d * s2d, cfg.fuse_filters)
    fuse_p, fuse_s = [], []
    cin = hr_width + cfg.fuse_filters
    for _ in range(cfg.fuse_blocks):
        bp, bs = _res_block_init(rng, cin, hr_width)
        fuse_p.append(bp)
        fuse_s.append(bs)
        cin = hr_width
    params["fuse"], state["fuse"] = fuse_p, fuse_s

    params["head"] = _he_conv(rng, 1, 1, hr_width, s2d * s2d)
    return params, state


def count_params(params: Any) -> int:
    """Number of values in a numpy parameter tree."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(np.prod(np.shape(params)))


def resolve_precision_policy(
    policy: "str | dict | None" = None, compute_dtype=None
) -> dict[str, torch.dtype]:
    """Normalize a policy spec into ``{stage: torch dtype}``.

    ``policy`` may be a named policy, a ``{stage: "bf16"|"f32"}`` dict (missing
    stages default to the ``f32`` policy), an already resolved dict of torch
    dtypes, or ``None``, in which case ``compute_dtype`` (``torch.bfloat16``
    or anything else) picks the matching uniform policy.
    """
    if policy is None:
        policy = "bf16" if compute_dtype == torch.bfloat16 else "f32"
    if isinstance(policy, str):
        assert policy in PRECISION_POLICIES, (
            f"unknown precision policy '{policy}'; "
            f"known: {sorted(PRECISION_POLICIES)}"
        )
        spec = PRECISION_POLICIES[policy]
    else:
        unknown = set(policy) - set(PRECISION_STAGES)
        assert not unknown, f"unknown precision stages {sorted(unknown)}"
        spec = {**PRECISION_POLICIES["f32"], **policy}
    names = {dtype: name for name, dtype in _STAGE_DTYPES.items()}
    out = {}
    for stage in PRECISION_STAGES:
        v = names.get(spec[stage], spec[stage])
        assert v in _STAGE_DTYPES, f"stage '{stage}': dtype must be bf16|f32, got {v!r}"
        out[stage] = _STAGE_DTYPES[v]
    assert out["head"] == torch.float32, "head stage must stay float32"
    return out


@contextlib.contextmanager
def bf16_products(on_cuda: bool):
    """Let the products of a bf16 stage run on the GPU's tensor cores.

    A bf16 stage multiplies bf16 values held in f32 tensors. TF32 keeps 10
    mantissa bits, bf16 has 7, so with TF32 allowed cuDNN and cuBLAS form
    these products exactly and still accumulate in f32. The two switches are
    global, so they are set for the stage only and put back on the way out:
    the f32 stages before and after stay strict f32
    (:func:`floodsr_tpu_torch.device.set_strict_f32`). A no-op off the GPU.
    """
    if not on_cuda:
        yield
        return
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA "SAME" padding ``(before, after)`` for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class Conv(nn.Module):
    """Conv weights ``w`` (OIHW) and bias ``b``; no forward of its own."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cout, cin, kh, kw), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(cout), requires_grad=False)


class BatchNorm(nn.Module):
    """Inference batch norm: ``scale``/``offset`` params, ``mean``/``var`` stats."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c), requires_grad=False)
        self.offset = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def folded(self, eps: float, dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-channel ``(a, c)`` with ``bn(x) == x * a + c``, folded in f32
        and cast to the stage ``dtype``."""
        inv = torch.rsqrt(self.var + eps)
        a = self.scale * inv
        c = self.offset - self.scale * self.mean * inv
        return a.to(dtype), c.to(dtype)

    def batch_affine(
        self, x: torch.Tensor, eps: float, momentum: float
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training batch norm of NCHW ``x``: ``(y, new_mean, new_var)``.

        The batch mean and biased variance over N, H and W, computed in f32
        and rounded to the dtype of ``x`` (``jnp.mean``/``jnp.var`` of a bf16
        array), normalize ``x`` through the same folded affine as
        :meth:`folded`; the gradient flows through both. The new running
        stats, ``momentum·old + (1 − momentum)·batch`` in f32, are detached.
        """
        var, mean = torch.var_mean(x.to(torch.float32), dim=(0, 2, 3), correction=0)
        mean, var = mean.to(x.dtype).to(torch.float32), var.to(x.dtype).to(torch.float32)
        new_mean = momentum * self.mean + (1 - momentum) * mean.detach()
        new_var = momentum * self.var + (1 - momentum) * var.detach()
        inv = torch.rsqrt(var + eps)
        a = (self.scale * inv).to(x.dtype)
        c = (self.offset - self.scale * mean * inv).to(x.dtype)
        return x * a[None, :, None, None] + c[None, :, None, None], new_mean, new_var


def _bf16_valued(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, held in f32 (a no-op upcast for a bf16 tensor)."""
    return t.to(torch.bfloat16).to(torch.float32)


def conv2d_same(x: torch.Tensor, conv: Conv, stride: int = 1) -> torch.Tensor:
    """NCHW conv with XLA "SAME" padding, bias added after the product.

    The dtype of ``x`` is the stage dtype. For bf16: bf16 operands, f32
    accumulation, the f32 bias added in f32, one rounding to bf16.
    """
    kh, kw = conv.w.shape[2], conv.w.shape[3]
    top, bottom = same_pads(x.shape[2], kh, stride)
    left, right = same_pads(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    if x.dtype == torch.bfloat16:
        out = F.conv2d(x.to(torch.float32), _bf16_valued(conv.w), None, stride)
        return (out + conv.b[None, :, None, None]).to(torch.bfloat16)
    return F.conv2d(x, conv.w, None, stride) + conv.b[None, :, None, None]


def conv_transpose_nhwc(x: torch.Tensor, conv: Conv, stride: int) -> torch.Tensor:
    """Transposed conv with kernel == stride on NHWC: one matmul + depth-to-space.

    ``out[n, y·s+dy, x·s+dx, co] = Σ_ci x[n,y,x,ci] · w[s-1-dy, s-1-dx, ci, co]``
    (HWIO indexing; ``lax.conv_transpose`` stamps the kernel spatially flipped).
    """
    co, ci, kh, kw = conv.w.shape
    if kh != stride or kw != stride:
        raise NotImplementedError(
            f"transposed conv with kernel {kh}x{kw} != stride {stride}: the "
            "network's upsamples always have kernel == stride"
        )
    n, h, w, _ = x.shape
    hwio = conv.w.permute(2, 3, 1, 0)
    wm = hwio.flip(0, 1).permute(2, 0, 1, 3).reshape(ci, stride * stride * co)
    bf16 = x.dtype == torch.bfloat16
    if bf16:  # as conv2d_same: exact products in f32, one rounding after the bias
        x, wm = x.to(torch.float32), _bf16_valued(wm)
    out = torch.matmul(x.reshape(n * h * w, ci), wm)
    out = (
        out.reshape(n, h, w, stride, stride, co)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(n, h * stride, w * stride, co)
    )
    out = out + conv.b
    return out.to(torch.bfloat16) if bf16 else out


class ResBlock(nn.Module):
    """Pre-activation residual block (BN-ReLU-conv ×2 + shortcut)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn1 = BatchNorm(cin)
        self.conv1 = Conv(3, 3, cin, cout)
        self.bn2 = BatchNorm(cout)
        self.conv2 = Conv(3, 3, cout, cout)
        self.proj = Conv(1, 1, cin, cout) if cin != cout else None

    def forward(
        self, x: torch.Tensor, eps: float, stride: int = 1,
        stats: "dict | None" = None, momentum: float = 0.99,
    ) -> torch.Tensor:
        """Inference batch norm from the running stats; with ``stats`` (a dict)
        training batch norm, each :class:`BatchNorm`'s new running stats
        stored in ``stats`` under the module."""
        y = self._bn(self.bn1, x, eps, stats, momentum)
        y = conv2d_same(torch.relu(y), self.conv1, stride)
        y = self._bn(self.bn2, y, eps, stats, momentum)
        y = conv2d_same(torch.relu(y), self.conv2)
        if self.proj is not None:
            shortcut = conv2d_same(x, self.proj, stride)
        elif stride != 1:
            shortcut = x[:, :, ::stride, ::stride]
        else:
            shortcut = x
        return y + shortcut

    @staticmethod
    def _bn(bn: BatchNorm, x: torch.Tensor, eps: float, stats, momentum: float) -> torch.Tensor:
        if stats is None:
            a, c = bn.folded(eps, x.dtype)
            return x * a[None, :, None, None] + c[None, :, None, None]
        y, new_mean, new_var = bn.batch_affine(x, eps, momentum)
        stats[bn] = (new_mean, new_var)
        return y


class DecoderStage(nn.Module):
    def __init__(self, cin: int, width: int, n_blocks: int):
        super().__init__()
        self.up = Conv(2, 2, cin, width)
        cin = 2 * width  # skip concat
        blocks = []
        for _ in range(n_blocks):
            blocks.append(ResBlock(cin, width))
            cin = width
        self.blocks = nn.ModuleList(blocks)


def check_inputs(cfg: ResUNetConfig, depth_lr: torch.Tensor, dem_hr: torch.Tensor) -> None:
    """The trunk's input checks: rank-4 NHWC, LR dims divisible by 2^levels."""
    if depth_lr.ndim != 4 or dem_hr.ndim != 4:
        raise AssertionError(
            f"inputs must be rank-4 NHWC; got {tuple(depth_lr.shape)} and "
            f"{tuple(dem_hr.shape)}"
        )
    divisor = 2**cfg.levels
    if depth_lr.shape[1] % divisor or depth_lr.shape[2] % divisor:
        raise AssertionError(
            f"LR spatial dims {tuple(depth_lr.shape[1:3])} must be divisible by "
            f"2^levels={divisor} for the UNet skip shapes to line up"
        )


def hr_tail_eligible(model: "ResUNet") -> bool:
    """Whether the hand-written ``hr_tail`` kernel covers this configuration.

    Structural conditions of the fused tail (two fuse blocks, the first with
    a projection shortcut, the second with an identity one), as in the JAX
    package's ``_pallas_tail_eligible``. The CUDA kernel itself takes any
    spatial size and channel count, so the TPU band limits on ``h`` do not
    carry over.
    """
    fuse = model.fuse
    return (
        len(fuse) == 2
        and fuse[0].proj is not None
        and fuse[1].proj is None
    )


class ResUNet(nn.Module):
    """The network, split into :meth:`trunk` (LR) and :meth:`tail` (HR)."""

    def __init__(self, cfg: ResUNetConfig):
        super().__init__()
        self.cfg = cfg
        f = cfg.base_filters
        self.stem = Conv(3, 3, 2, f)
        enc = []
        cin = f
        for w in cfg.widths:
            blocks = []
            for _ in range(cfg.enc_blocks):
                blocks.append(ResBlock(cin, w))
                cin = w
            enc.append(nn.ModuleList(blocks))
        self.enc = nn.ModuleList(enc)
        dec = []
        for w in reversed(cfg.widths[:-1]):
            dec.append(DecoderStage(cin, w, cfg.dec_blocks))
            cin = w
        self.dec = nn.ModuleList(dec)

        s2d = int(cfg.hr_s2d)
        assert cfg.scale % s2d == 0, f"hr_s2d={s2d} must divide scale={cfg.scale}"
        s0, s1 = split_scale(cfg.scale // s2d)
        hr_width = f * s2d
        self.sr_up1 = Conv(s0, s0, cin, f)
        self.sr_up2 = Conv(s1, s1, f, hr_width)
        self.dem_feat = Conv(3, 3, s2d * s2d, cfg.fuse_filters)
        fuse = []
        cin = hr_width + cfg.fuse_filters
        for _ in range(cfg.fuse_blocks):
            fuse.append(ResBlock(cin, hr_width))
            cin = hr_width
        self.fuse = nn.ModuleList(fuse)
        self.head = Conv(1, 1, hr_width, s2d * s2d)
        # (weights key, hr_tail weights, {mode: tensor-core pack or None})
        self._tail_pack = None

    # -- trunk --------------------------------------------------------------

    @torch.no_grad()
    def trunk(
        self, depth_lr: torch.Tensor, dem_hr: torch.Tensor, precision=None
    ) -> torch.Tensor:
        """Stem + UNet encoder/decoder: NHWC inputs → ``[N,h,w,f]`` NHWC features
        in the trunk stage's dtype (``precision``: a policy name, dict or
        resolved policy; ``None`` is ``f32``)."""
        return self._trunk(depth_lr, dem_hr, resolve_precision_policy(precision))

    def _trunk(
        self, depth_lr: torch.Tensor, dem_hr: torch.Tensor, stage: dict, stats=None
    ) -> torch.Tensor:
        check_inputs(self.cfg, depth_lr, dem_hr)
        x_dtype = stage["trunk"]
        with bf16_products(x_dtype == torch.bfloat16 and depth_lr.is_cuda):
            return self._trunk_body(depth_lr.to(x_dtype), dem_hr.to(x_dtype), stats)

    def _trunk_body(self, depth_lr: torch.Tensor, dem_hr: torch.Tensor, stats) -> torch.Tensor:
        cfg = self.cfg
        bn = dict(eps=cfg.bn_eps, stats=stats, momentum=cfg.bn_momentum)
        s = cfg.scale
        n, hh, ww, c = dem_hr.shape
        dem_lr = dem_hr.reshape(n, hh // s, s, ww // s, s, c).mean(dim=(2, 4))
        x = torch.cat([depth_lr, dem_lr], dim=-1).permute(0, 3, 1, 2)
        x = conv2d_same(x, self.stem)

        skips = []
        for stage, blocks in enumerate(self.enc):
            for bi, block in enumerate(blocks):
                stride = 2 if (stage > 0 and bi == 0) else 1
                x = block(x, stride=stride, **bn)
            if stage < len(self.enc) - 1:
                skips.append(x)

        for stage, skip in zip(self.dec, reversed(skips)):
            x = conv_transpose_nhwc(x.permute(0, 2, 3, 1), stage.up, 2)
            x = torch.cat([x.permute(0, 3, 1, 2), skip], dim=1)
            for block in stage.blocks:
                x = block(x, **bn)
        return x.permute(0, 2, 3, 1).contiguous()

    # -- tail ---------------------------------------------------------------

    @torch.no_grad()
    def tail(self, trunk_feat: torch.Tensor, dem_hr: torch.Tensor, precision=None) -> torch.Tensor:
        """SR upsample + DEM re-fusion + head: → ``[N,H,W,1]`` NHWC f32 prediction.

        ``dem_hr`` is the same normalized HR DEM the trunk saw; it re-enters
        here at the tail's precision, taken from the un-rounded f32 input, so
        a bf16 trunk does not degrade the tail's DEM conditioning. On an
        eligible configuration the fuse blocks and head run as one ``hr_tail``
        call (the CUDA kernel for a CUDA tensor), on its bf16 route when the
        tail stage is bf16; any other configuration runs the unfused blocks in
        the tail's dtype and the head in f32.
        """
        return self._tail(trunk_feat, dem_hr, resolve_precision_policy(precision))

    def _tail(
        self, trunk_feat: torch.Tensor, dem_hr: torch.Tensor, stage: dict, stats=None
    ) -> torch.Tensor:
        sr_dtype, tail_dtype = stage["sr_up"], stage["tail"]
        on_cuda = trunk_feat.is_cuda
        cfg = self.cfg
        s2d = int(cfg.hr_s2d)
        s0, s1 = split_scale(cfg.scale // s2d)
        x = trunk_feat.to(sr_dtype)
        with bf16_products(sr_dtype == torch.bfloat16 and on_cuda):
            x = torch.relu(conv_transpose_nhwc(x, self.sr_up1, s0))
            x = torch.relu(conv_transpose_nhwc(x, self.sr_up2, s1))
        x = x.to(tail_dtype)
        with bf16_products(tail_dtype == torch.bfloat16 and on_cuda):
            out, with_head = self._fuse(x, dem_hr.to(tail_dtype), stats)
        if not with_head:
            # the unfused blocks leave the head to the f32 stage
            out = conv2d_same(
                out.to(torch.float32).permute(0, 3, 1, 2), self.head
            ).permute(0, 2, 3, 1)
        if s2d > 1:
            # depth-to-space back to full HR resolution, single channel.
            n, hh, ww, _ = out.shape
            out = (
                out.reshape(n, hh, ww, s2d, s2d, 1)
                .permute(0, 1, 3, 2, 4, 5)
                .reshape(n, hh * s2d, ww * s2d, 1)
            )
        return out.to(torch.float32)

    def _fuse(self, x: torch.Tensor, dem: torch.Tensor, stats=None):
        """DEM features + fuse blocks in the dtype of ``x`` (the tail stage's).

        Returns ``(out, with_head)``: the head's NHWC f32 output and ``True``
        when the fused ``hr_tail`` ran, else the last fuse block's NHWC output
        and ``False`` (the caller's f32 head finishes it). Training
        (``stats`` given) always runs the unfused blocks.
        """
        cfg = self.cfg
        s2d = int(cfg.hr_s2d)
        tail_dtype = x.dtype
        n, hh, ww, _ = dem.shape
        if s2d > 1:
            # HR stages at (H/s2d)² with s2d²-packed DEM channels.
            dem = (
                dem.reshape(n, hh // s2d, s2d, ww // s2d, s2d, 1)
                .permute(0, 1, 3, 2, 4, 5)
                .reshape(n, hh // s2d, ww // s2d, s2d * s2d)
            )
        dem_feat = torch.relu(conv2d_same(dem.permute(0, 3, 1, 2), self.dem_feat))

        if stats is None and hr_tail_eligible(self):
            from floodsr_tpu_torch.ops.kernels.hr_tail import (
                hr_tail,
                pack_hr_tail_bf16,
                pack_hr_tail_tc,
                pack_hr_tail_weights,
                tc_eligible,
            )

            # Pack (fold BN, reorder) once per set of weights, not per call:
            # the key changes when a tensor is replaced (``.to``) or written
            # in place (``load_state_dict``, an optimizer step and the BN stats'
            # ``copy_`` bump ``_version``). At the widths
            # the tensor-core kernels take, the weight pack of the route in
            # use (hi/lo TF32 halves, or bf16) is built at its first call and
            # kept beside it.
            tensors = [*self.fuse.parameters(), *self.fuse.buffers(), *self.head.parameters()]
            key = tuple((t.data_ptr(), t._version) for t in tensors)
            if self._tail_pack is None or self._tail_pack[0] != key:
                weights = pack_hr_tail_weights(
                    self.fuse[0], self.fuse[1], self.head, bn_eps=cfg.bn_eps
                )
                self._tail_pack = (key, weights, {})
            _, weights, packs = self._tail_pack
            mode = "bf16" if tail_dtype == torch.bfloat16 else "f32"
            if mode not in packs:
                cm, ch = int(self.head.w.shape[1]), int(self.head.w.shape[0])
                eligible = tc_eligible(int(x.shape[-1]), int(dem_feat.shape[1]), cm, ch)
                packer = pack_hr_tail_bf16 if mode == "bf16" else pack_hr_tail_tc
                packs[mode] = packer(weights) if eligible else None
            # The kernel takes f32 tensors; bf16 activations upcast exactly.
            out = hr_tail(
                x.to(torch.float32).contiguous(),
                dem_feat.permute(0, 2, 3, 1).to(torch.float32).contiguous(),
                *weights,
                tc_pack=packs[mode],
                mode=mode,
            )
            return out, True
        y = torch.cat([x.permute(0, 3, 1, 2), dem_feat], dim=1)
        for block in self.fuse:
            y = block(y, cfg.bn_eps, stats=stats, momentum=cfg.bn_momentum)
        return y.permute(0, 2, 3, 1), False

    @torch.no_grad()
    def forward(
        self, depth_lr: torch.Tensor, dem_hr: torch.Tensor, precision=None
    ) -> torch.Tensor:
        stage = resolve_precision_policy(precision)
        return self.tail(self.trunk(depth_lr, dem_hr, stage), dem_hr, stage)

    def forward_train(
        self, depth_lr: torch.Tensor, dem_hr: torch.Tensor, precision=None
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Training forward with autograd: ``(pred [N,H,W,1] f32, new_stats)``.

        Every batch norm normalizes by its batch statistics
        (:meth:`BatchNorm.batch_affine`) and the tail runs unfused, as the
        JAX package's ``resunet_apply(train=True)``. ``new_stats`` maps each
        running-stat buffer's ``state_dict`` key (``enc.0.0.bn1.mean``) to its
        new value; the buffers themselves are left as they are, for the
        caller to write after the step.
        """
        stage = resolve_precision_policy(precision)
        stats: dict = {}
        with torch.enable_grad():
            feat = self._trunk(depth_lr, dem_hr, stage, stats)
            pred = self._tail(feat, dem_hr, stage, stats)
        new_stats = {}
        for name, module in self.named_modules():
            if module in stats:
                new_stats[f"{name}.mean"], new_stats[f"{name}.var"] = stats[module]
        return pred, new_stats


# ---------------------------------------------------------------------------
# training on a mesh
# ---------------------------------------------------------------------------


def batch_norm_across(
    xs: list[torch.Tensor], scales: list[torch.Tensor], offsets: list[torch.Tensor], eps: float
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Training batch norm of NCHW shards by the statistics of the whole batch.

    ``xs[i]`` is row ``i``'s shard, on its device, normalized with that row's
    copies ``scales[i]``/``offsets[i]``. Two passes, as ``jnp.var``: the
    shards' f32 sums, added on the first shard's device (:func:`psum`), over
    the N·H·W of every shard give the mean; it goes back to each shard
    (:func:`broadcast`), whose f32 sums of ``(x − mean)²`` are added the same
    way for the biased variance (a one-pass ``E[x²] − E[x]²`` cancels on
    features of ~1e4). Both round to the dtype of ``xs``, as
    :meth:`BatchNorm.batch_affine` does. The gradient flows through the sums
    and the copies, so the backward reduces ``dy`` and ``dy·x̂`` over every
    shard as well. Returns the normalized shards and the batch ``(mean,
    var)`` in f32 on the first shard's device.
    """
    devices = [x.device for x in xs]
    dtype = xs[0].dtype
    count = sum(x.shape[0] * x.shape[2] * x.shape[3] for x in xs)
    xf = [x.to(torch.float32) for x in xs]
    mean = psum([x.sum(dim=(0, 2, 3)) for x in xf], devices[0]) / count
    means = broadcast(mean, devices)
    var = psum(
        [torch.square(x - m[None, :, None, None]).sum(dim=(0, 2, 3)) for x, m in zip(xf, means)],
        devices[0],
    ) / count
    ys = []
    for x, m, v, scale, offset in zip(xs, means, broadcast(var, devices), scales, offsets):
        m, v = m.to(dtype).to(torch.float32), v.to(dtype).to(torch.float32)
        inv = torch.rsqrt(v + eps)
        a = (scale * inv).to(dtype)
        c = (offset - scale * m * inv).to(dtype)
        ys.append(x * a[None, :, None, None] + c[None, :, None, None])
    return ys, mean.to(dtype).to(torch.float32), var.to(dtype).to(torch.float32)


@dataclasses.dataclass
class _Act:
    """An NCHW activation on the mesh: ``parts[i][j]`` on entry ``(i, j)``,
    holding channel piece ``j`` when ``split``, else every channel."""

    parts: list
    split: bool


@dataclasses.dataclass
class _ConvPiece:
    """What :func:`conv2d_same` reads of a :class:`Conv`: ``w`` (OIHW), ``b``."""

    w: torch.Tensor
    b: torch.Tensor


class _MeshForward:
    """:func:`forward_train_mesh`'s state: the entries' tensors, the new stats."""

    def __init__(self, cfg: ResUNetConfig, tensors: np.ndarray, split, devices: np.ndarray,
                 stage: dict):
        self.cfg, self.t, self.split, self.stage, self.devices = cfg, tensors, split, stage, devices
        self.dp, self.tp = devices.shape
        self.on_cuda = devices[0, 0].type == "cuda"
        self.stats: dict[str, torch.Tensor] = {}

    def _map(self, fn, *grids) -> list:
        return [[fn(*(g[i][j] for g in grids)) for j in range(self.tp)] for i in range(self.dp)]

    def _local(self, x: _Act, fn) -> _Act:
        """An operation on each entry's own part (elementwise, a strided view)."""
        return _Act(self._map(fn, x.parts), x.split)

    def _layout(self, x: _Act, split: bool) -> list:
        """``x``'s parts as channel pieces (a slice of a whole part) or whole
        (the pieces gathered over the row)."""
        if split == x.split:
            return x.parts
        if split:
            return [
                [torch.chunk(p, self.tp, dim=1)[j] for j, p in enumerate(row)] for row in x.parts
            ]
        return [all_gather(row, dim=1) for row in x.parts]

    def _cat(self, xs: list[_Act]) -> _Act:
        grids = [self._layout(x, False) for x in xs]
        return _Act(self._map(lambda *ps: torch.cat(ps, dim=1), *grids), False)

    def _conv(self, x: _Act, name: str, stride: int = 1, transpose: bool = False) -> _Act:
        """Entry ``(i, j)`` convolves its whole input with the weights it holds:
        output piece ``j`` of a split convolution, else every channel."""

        def conv(t: dict, xij: torch.Tensor) -> torch.Tensor:
            piece = _ConvPiece(t[f"{name}.w"], t[f"{name}.b"])
            if transpose:
                y = conv_transpose_nhwc(xij.permute(0, 2, 3, 1), piece, stride)
                return y.permute(0, 3, 1, 2)
            return conv2d_same(xij, piece, stride)

        return _Act(self._map(conv, self.t, self._layout(x, False)), f"{name}.w" in self.split)

    def _bn(self, x: _Act, name: str) -> _Act:
        """Batch norm of each ``tp`` column over the rows, by the global batch's
        statistics; the new running stats kept for the trainer."""
        cfg = self.cfg
        split = f"{name}.scale" in self.split
        xs = self._layout(x, split)
        out = [[None] * self.tp for _ in range(self.dp)]
        for j in range(self.tp):
            col = [self.t[i, j] for i in range(self.dp)]
            ys, mean, var = batch_norm_across(
                [xs[i][j] for i in range(self.dp)],
                [t[f"{name}.scale"] for t in col], [t[f"{name}.offset"] for t in col], cfg.bn_eps,
            )
            for i, y in enumerate(ys):
                out[i][j] = y
            m = cfg.bn_momentum
            self.stats.setdefault(f"{name}.mean", []).append(
                m * col[0][f"{name}.mean"] + (1 - m) * mean.detach()
            )
            self.stats.setdefault(f"{name}.var", []).append(
                m * col[0][f"{name}.var"] + (1 - m) * var.detach()
            )
        return _Act(out, split)

    def _block(self, x: _Act, name: str, stride: int = 1) -> _Act:
        """:meth:`ResBlock.forward` with training batch norm."""
        y = self._local(self._bn(x, f"{name}.bn1"), torch.relu)
        y = self._conv(y, f"{name}.conv1", stride)
        y = self._local(self._bn(y, f"{name}.bn2"), torch.relu)
        y = self._conv(y, f"{name}.conv2")
        if f"{name}.proj.w" in self.t[0, 0]:
            shortcut = self._conv(x, f"{name}.proj", stride)
        elif stride != 1:
            shortcut = self._local(x, lambda p: p[:, :, ::stride, ::stride])
        else:
            shortcut = x
        return _Act(self._map(torch.add, y.parts, self._layout(shortcut, y.split)), y.split)

    def trunk(self, depth_lr: list, dem_hr: list) -> _Act:
        """:meth:`ResUNet._trunk_body`, its output left NCHW."""
        cfg, dtype, s = self.cfg, self.stage["trunk"], self.cfg.scale

        def stem_input(depth: torch.Tensor, dem: torch.Tensor) -> torch.Tensor:
            depth, dem = depth.to(dtype), dem.to(dtype)
            n, hh, ww, c = dem.shape
            dem_lr = dem.reshape(n, hh // s, s, ww // s, s, c).mean(dim=(2, 4))
            return torch.cat([depth, dem_lr], dim=-1).permute(0, 3, 1, 2)

        with bf16_products(dtype == torch.bfloat16 and self.on_cuda):
            x = self._conv(_Act(self._map(stem_input, depth_lr, dem_hr), False), "stem")
            skips = []
            for stage in range(len(cfg.widths)):
                for bi in range(cfg.enc_blocks):
                    x = self._block(x, f"enc.{stage}.{bi}", 2 if (stage > 0 and bi == 0) else 1)
                if stage < len(cfg.widths) - 1:
                    skips.append(x)
            for stage, skip in enumerate(reversed(skips)):
                x = self._cat([self._conv(x, f"dec.{stage}.up", 2, transpose=True), skip])
                for bi in range(cfg.dec_blocks):
                    x = self._block(x, f"dec.{stage}.blocks.{bi}")
        return x

    def tail(self, feat: _Act, dem_hr: list) -> list[torch.Tensor]:
        """:meth:`ResUNet._tail` with the unfused blocks; the head's pieces
        gathered on each row's first entry."""
        cfg = self.cfg
        sr_dtype, tail_dtype = self.stage["sr_up"], self.stage["tail"]
        s2d = int(cfg.hr_s2d)
        s0, s1 = split_scale(cfg.scale // s2d)
        x = self._local(feat, lambda p: p.to(sr_dtype))
        with bf16_products(sr_dtype == torch.bfloat16 and self.on_cuda):
            x = self._local(self._conv(x, "sr_up1", s0, transpose=True), torch.relu)
            x = self._local(self._conv(x, "sr_up2", s1, transpose=True), torch.relu)
        x = self._local(x, lambda p: p.to(tail_dtype))

        def dem_input(dem: torch.Tensor) -> torch.Tensor:
            dem = dem.to(tail_dtype)
            n, hh, ww, _ = dem.shape
            if s2d > 1:
                dem = (
                    dem.reshape(n, hh // s2d, s2d, ww // s2d, s2d, 1)
                    .permute(0, 1, 3, 2, 4, 5)
                    .reshape(n, hh // s2d, ww // s2d, s2d * s2d)
                )
            return dem.permute(0, 3, 1, 2)

        with bf16_products(tail_dtype == torch.bfloat16 and self.on_cuda):
            dem_feat = self._conv(_Act(self._map(dem_input, dem_hr), False), "dem_feat")
            y = self._cat([x, self._local(dem_feat, torch.relu)])
            for k in range(cfg.fuse_blocks):
                y = self._block(y, f"fuse.{k}")
        out = self._conv(self._local(y, lambda p: p.to(torch.float32)), "head")
        preds = []
        for i, row in enumerate(out.parts):
            dev = self.devices[i, 0]
            head = torch.cat([to_device(p, dev) for p in row], dim=1) if out.split else row[0]
            head = head.permute(0, 2, 3, 1)
            if s2d > 1:
                n, hh, ww, _ = head.shape
                head = (
                    head.reshape(n, hh, ww, s2d, s2d, 1)
                    .permute(0, 1, 3, 2, 4, 5)
                    .reshape(n, hh * s2d, ww * s2d, 1)
                )
            preds.append(head.to(torch.float32))
        return preds


def forward_train_mesh(
    cfg: ResUNetConfig,
    tensors: np.ndarray,
    split,
    devices: np.ndarray,
    depth_lr: list,
    dem_hr: list,
    precision=None,
) -> tuple[list[torch.Tensor], dict[str, list[torch.Tensor]]]:
    """:meth:`ResUNet.forward_train` over a ``(dp, tp)`` mesh of ``devices``.

    Row ``i`` runs its ``dp`` shard of the batch (``depth_lr[i][j]``,
    ``dem_hr[i][j]``: NHWC, on entry ``(i, j)``'s device) and every batch
    norm normalizes by the statistics of the global batch
    (:func:`batch_norm_across`, for each channel piece over the rows of its
    ``tp`` column). Entry ``(i, j)`` holds ``tensors[i, j]``, its parameters
    and running stats by ``state_dict`` key: the keys in ``split`` as their
    ``tp`` piece ``j`` along dimension 0 (a convolution's output channels, a
    vector's only dimension), the others whole. A split convolution computes
    output piece ``j`` on entry ``(i, j)`` from its whole input, transposed
    convolutions included; a split batch norm normalizes that piece; the row
    gathers the pieces (:func:`all_gather`) where a convolution or a
    concatenation takes every channel. A leaf held whole is computed alike on
    each entry of the row, from the entry's own copy. The autograd graph spans
    the devices, so a backward gives each copy of a leaf its share of the
    gradient: the leaf's gradient is the sum over its copies.

    Returns ``(preds, new_stats)``: each row's ``[n_i,H,W,1]`` f32 prediction
    on its first entry's device, and each running stat's new value
    (``momentum·old + (1 − momentum)·batch``) per ``tp`` column, on the
    column's first device (whole, for a stat held whole).
    """
    run = _MeshForward(cfg, tensors, split, devices, resolve_precision_policy(precision))
    for row_depth, row_dem in zip(depth_lr, dem_hr):
        check_inputs(cfg, row_depth[0], row_dem[0])
    with torch.enable_grad():
        preds = run.tail(run.trunk(depth_lr, dem_hr), dem_hr)
    return preds, run.stats
