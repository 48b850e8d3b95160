"""The DEM-conditioned 16x ResUNet in plain PyTorch, from an artifact's arrays.

Written from the architecture's description (cefect/floodsr
``ResUNet_16x_DEM``, as the artifact's manifest configures it), not from the
program: the DEM box-averaged to LR and stacked with the depth; a UNet of
pre-activation residual blocks (batch norm, ReLU, 3x3 convolution, twice,
plus the input or its 1x1 projection); two transposed convolutions (kernel
equal to stride) up towards HR; the DEM packed ``hr_s2d`` x ``hr_s2d`` into
channels, a 3x3 convolution of it joined to the features; residual fuse
blocks; a 1x1 head unpacked to one channel at HR. Convolutions pad as XLA's
"SAME" does (for a stride-2 3x3 convolution on an even size: nothing before,
one after). Inference batch norm: ``(x - mean) / sqrt(var + eps) * scale +
offset``. NCHW throughout, float32; TF32 is the caller's switch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _split(scale: int) -> tuple[int, int]:
    root = int(round(math.sqrt(scale)))
    if root * root == scale:
        return root, root
    for a in range(root + 1, scale + 1):
        if scale % a == 0:
            return a, scale // a
    return scale, 1


class Reference:
    """``forward(depth_lr, dem_hr)``: ``[N, h, w]`` normalized depth and
    ``[N, h*scale, w*scale]`` normalized DEM → ``[N, H, W]`` normalized depth."""

    def __init__(self, arch: dict, arrays: dict[str, np.ndarray], device):
        self.arch = arch
        self.t = {}
        for k, a in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
            if t.ndim == 4:
                t = t.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
            self.t[k] = t.to(device)

    def conv(self, x, name, stride=1):
        w = self.t[f"{name}.w"]
        top, bottom = _pads(x.shape[2], w.shape[2], stride)
        left, right = _pads(x.shape[3], w.shape[3], stride)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w, self.t[f"{name}.b"], stride)

    def up(self, x, name):
        w = self.t[f"{name}.w"]  # OIHW of an HWIO kernel; the transposed conv stamps it flipped
        s = w.shape[2]
        wt = w.flip(2, 3).permute(1, 0, 2, 3)  # (in, out, kh, kw)
        return F.conv_transpose2d(x, wt, self.t[f"{name}.b"], stride=s)

    def bn(self, x, name):
        eps = float(self.arch["bn_eps"])
        shape = (1, -1, 1, 1)
        mean, var = self.t[f"{name}.mean"].view(shape), self.t[f"{name}.var"].view(shape)
        scale, offset = self.t[f"{name}.scale"].view(shape), self.t[f"{name}.offset"].view(shape)
        return (x - mean) / torch.sqrt(var + eps) * scale + offset

    def block(self, x, name, stride=1):
        y = self.conv(torch.relu(self.bn(x, f"{name}.bn1")), f"{name}.conv1", stride)
        y = self.conv(torch.relu(self.bn(y, f"{name}.bn2")), f"{name}.conv2")
        if f"{name}.proj.w" in self.t:
            return y + self.conv(x, f"{name}.proj", stride)
        return y + (x[:, :, ::stride, ::stride] if stride != 1 else x)

    @torch.no_grad()
    def forward(self, depth_lr: torch.Tensor, dem_hr: torch.Tensor) -> torch.Tensor:
        a = self.arch
        s, s2d = int(a["scale"]), int(a["hr_s2d"])
        n, hh, ww = dem_hr.shape
        dem_lr = dem_hr.reshape(n, hh // s, s, ww // s, s).mean(dim=(2, 4))
        x = self.conv(torch.stack([depth_lr, dem_lr], dim=1), "stem")
        skips = []
        levels = a["levels"] + 1
        for i in range(levels):
            for b in range(a["enc_blocks"]):
                x = self.block(x, f"enc.{i}.{b}", 2 if (i > 0 and b == 0) else 1)
            if i < levels - 1:
                skips.append(x)
        for i, skip in enumerate(reversed(skips)):
            x = torch.cat([self.up(x, f"dec.{i}.up"), skip], dim=1)
            for b in range(a["dec_blocks"]):
                x = self.block(x, f"dec.{i}.blocks.{b}")
        x = torch.relu(self.up(x, "sr_up1"))
        x = torch.relu(self.up(x, "sr_up2"))
        dem = (
            dem_hr.reshape(n, hh // s2d, s2d, ww // s2d, s2d)
            .permute(0, 2, 4, 1, 3)
            .reshape(n, s2d * s2d, hh // s2d, ww // s2d)
        )
        y = torch.cat([x, torch.relu(self.conv(dem, "dem_feat"))], dim=1)
        for b in range(a["fuse_blocks"]):
            y = self.block(y, f"fuse.{b}")
        y = self.conv(y, "head")  # [n, s2d*s2d, hh/s2d, ww/s2d], channel = dy * s2d + dx
        return (
            y.reshape(n, s2d, s2d, hh // s2d, ww // s2d)
            .permute(0, 3, 1, 4, 2)
            .reshape(n, hh, ww)
        )
