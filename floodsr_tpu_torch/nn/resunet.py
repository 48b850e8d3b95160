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

Numerics follow the JAX package's f32 policy: XLA "SAME" padding computed
per convolution (a 3×3/stride-2 conv on an even input pads 0 before and 1
after), inference batch norm folded with the config's ``bn_eps``,
kernel == stride transposed convs as one matmul with the spatially flipped
kernel plus depth-to-space. On the GPU the HR fuse blocks + head run through
the hand-written ``hr_tail`` CUDA kernel whenever the configuration is
eligible (:func:`hr_tail_eligible`); the trunk convolutions stay
``F.conv2d``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

PRECISION_POLICIES = ("f32",)


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


def resolve_precision_policy(policy: str | None) -> str:
    """Only the ``f32`` policy is ported; ``bf16``/``mixed`` raise."""
    policy = "f32" if policy is None else policy
    if policy in ("bf16", "mixed"):
        raise NotImplementedError(
            f"precision policy '{policy}' is not ported yet; only 'f32' runs"
        )
    if policy not in PRECISION_POLICIES:
        raise ValueError(f"unknown precision policy '{policy}'")
    return policy


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

    def folded(self, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-channel ``(a, c)`` with ``bn(x) == x * a + c``."""
        inv = torch.rsqrt(self.var + eps)
        a = self.scale * inv
        c = self.offset - self.scale * self.mean * inv
        return a, c


def conv2d_same(x: torch.Tensor, conv: Conv, stride: int = 1) -> torch.Tensor:
    """NCHW conv with XLA "SAME" padding, bias added after the product."""
    kh, kw = conv.w.shape[2], conv.w.shape[3]
    top, bottom = same_pads(x.shape[2], kh, stride)
    left, right = same_pads(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
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
    out = torch.matmul(x.reshape(n * h * w, ci), wm)
    out = (
        out.reshape(n, h, w, stride, stride, co)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(n, h * stride, w * stride, co)
    )
    return out + conv.b


class ResBlock(nn.Module):
    """Pre-activation residual block (BN-ReLU-conv ×2 + shortcut)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn1 = BatchNorm(cin)
        self.conv1 = Conv(3, 3, cin, cout)
        self.bn2 = BatchNorm(cout)
        self.conv2 = Conv(3, 3, cout, cout)
        self.proj = Conv(1, 1, cin, cout) if cin != cout else None

    def forward(self, x: torch.Tensor, eps: float, stride: int = 1) -> torch.Tensor:
        a1, c1 = self.bn1.folded(eps)
        y = torch.relu(x * a1[None, :, None, None] + c1[None, :, None, None])
        y = conv2d_same(y, self.conv1, stride)
        a2, c2 = self.bn2.folded(eps)
        y = torch.relu(y * a2[None, :, None, None] + c2[None, :, None, None])
        y = conv2d_same(y, self.conv2)
        if self.proj is not None:
            shortcut = conv2d_same(x, self.proj, stride)
        elif stride != 1:
            shortcut = x[:, :, ::stride, ::stride]
        else:
            shortcut = x
        return y + shortcut


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
        self._tail_pack = None  # (weights key, hr_tail weights, tensor-core pack or None)

    # -- trunk --------------------------------------------------------------

    @torch.no_grad()
    def trunk(self, depth_lr: torch.Tensor, dem_hr: torch.Tensor) -> torch.Tensor:
        """Stem + UNet encoder/decoder: NHWC inputs → ``[N,h,w,f]`` NHWC features."""
        cfg = self.cfg
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
        eps = cfg.bn_eps
        s = cfg.scale
        depth_lr = depth_lr.to(torch.float32)
        dem_hr = dem_hr.to(torch.float32)
        n, hh, ww, c = dem_hr.shape
        dem_lr = dem_hr.reshape(n, hh // s, s, ww // s, s, c).mean(dim=(2, 4))
        x = torch.cat([depth_lr, dem_lr], dim=-1).permute(0, 3, 1, 2)
        x = conv2d_same(x, self.stem)

        skips = []
        for stage, blocks in enumerate(self.enc):
            for bi, block in enumerate(blocks):
                stride = 2 if (stage > 0 and bi == 0) else 1
                x = block(x, eps, stride)
            if stage < len(self.enc) - 1:
                skips.append(x)

        for stage, skip in zip(self.dec, reversed(skips)):
            x = conv_transpose_nhwc(x.permute(0, 2, 3, 1), stage.up, 2)
            x = torch.cat([x.permute(0, 3, 1, 2), skip], dim=1)
            for block in stage.blocks:
                x = block(x, eps)
        return x.permute(0, 2, 3, 1).contiguous()

    # -- tail ---------------------------------------------------------------

    @torch.no_grad()
    def tail(self, trunk_feat: torch.Tensor, dem_hr: torch.Tensor) -> torch.Tensor:
        """SR upsample + DEM re-fusion + head: → ``[N,H,W,1]`` NHWC prediction.

        ``dem_hr`` is the same normalized HR DEM the trunk saw. On an
        eligible configuration the fuse blocks and head run as one
        ``hr_tail`` call (the CUDA kernel for a CUDA tensor).
        """
        cfg = self.cfg
        s2d = int(cfg.hr_s2d)
        s0, s1 = split_scale(cfg.scale // s2d)
        x = trunk_feat.to(torch.float32)
        x = torch.relu(conv_transpose_nhwc(x, self.sr_up1, s0))
        x = torch.relu(conv_transpose_nhwc(x, self.sr_up2, s1))

        dem = dem_hr.to(torch.float32)
        n, hh, ww, _ = dem.shape
        if s2d > 1:
            # HR stages at (H/s2d)² with s2d²-packed DEM channels.
            dem = (
                dem.reshape(n, hh // s2d, s2d, ww // s2d, s2d, 1)
                .permute(0, 1, 3, 2, 4, 5)
                .reshape(n, hh // s2d, ww // s2d, s2d * s2d)
            )
        dem_feat = torch.relu(conv2d_same(dem.permute(0, 3, 1, 2), self.dem_feat))

        if hr_tail_eligible(self):
            from floodsr_tpu_torch.ops.kernels.hr_tail import (
                hr_tail,
                pack_hr_tail_tc,
                pack_hr_tail_weights,
                tc_eligible,
            )

            # Pack (fold BN, reorder) once per set of weights, not per call:
            # the key changes when a tensor is replaced (``.to``) or written
            # in place (``load_state_dict`` bumps ``_version``). At the widths
            # the tensor-core kernels take, their hi/lo weight pack is built
            # with it.
            tensors = [*self.fuse.parameters(), *self.fuse.buffers(), *self.head.parameters()]
            key = tuple((t.data_ptr(), t._version) for t in tensors)
            if self._tail_pack is None or self._tail_pack[0] != key:
                weights = pack_hr_tail_weights(
                    self.fuse[0], self.fuse[1], self.head, bn_eps=cfg.bn_eps
                )
                cm, ch = int(self.head.w.shape[1]), int(self.head.w.shape[0])
                eligible = tc_eligible(int(x.shape[-1]), int(dem_feat.shape[1]), cm, ch)
                self._tail_pack = (key, weights, pack_hr_tail_tc(weights) if eligible else None)
            _, weights, tc_pack = self._tail_pack
            out = hr_tail(
                x.contiguous(),
                dem_feat.permute(0, 2, 3, 1).contiguous(),
                *weights,
                tc_pack=tc_pack,
            )
        else:
            y = torch.cat([x.permute(0, 3, 1, 2), dem_feat], dim=1)
            for block in self.fuse:
                y = block(y, cfg.bn_eps)
            out = conv2d_same(y, self.head).permute(0, 2, 3, 1)
        if s2d > 1:
            # depth-to-space back to full HR resolution, single channel.
            n, hh, ww, _ = out.shape
            out = (
                out.reshape(n, hh, ww, s2d, s2d, 1)
                .permute(0, 1, 3, 2, 4, 5)
                .reshape(n, hh * s2d, ww * s2d, 1)
            )
        return out.to(torch.float32)

    @torch.no_grad()
    def forward(self, depth_lr: torch.Tensor, dem_hr: torch.Tensor) -> torch.Tensor:
        return self.tail(self.trunk(depth_lr, dem_hr), dem_hr)
