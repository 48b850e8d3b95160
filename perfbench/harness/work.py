"""The yardstick's work counts: operations and bytes from a configuration's
shapes, and the H100's published peaks.

Operations are the algorithm's, 2 x multiply-adds of every convolution and
transposed convolution, counted once whatever route computes them (3xTF32
does three products for one; those are not work). Bytes are what a kernel
must move at least: each input read once, each output written once.
"""

from __future__ import annotations

from perfbench.harness.weights import conv_shapes, split_scale

#: Dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet), by the
#: configuration's ``compute_dtype``: float32 runs on the tensor cores as TF32
#: at best (495 TFLOP/s), which bounds every route that keeps f32's accuracy.
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def conv_macs(arch: dict) -> dict[str, int]:
    """Multiply-adds of each convolution of one window, by kernel name."""
    lr = int(arch["lr_tile"])
    s2d = int(arch["hr_s2d"])
    hr_side = lr * int(arch["scale"]) // s2d
    levels = int(arch["levels"])
    s0, _ = split_scale(int(arch["scale"]) // s2d)
    out = {}
    for name, (kh, kw, cin, cout) in conv_shapes(arch):
        parts = name.split(".")
        if parts[0] == "stem":
            side_in = side_out = lr
        elif parts[0] == "enc":
            stage, block = int(parts[1]), int(parts[2])
            side_out = lr >> stage
            side_in = side_out * 2 if (stage > 0 and block == 0) else side_out
        elif parts[0] == "dec":
            side_out = lr >> (levels - 1 - int(parts[1]))
            side_in = side_out // 2 if parts[2] == "up" else side_out
        elif name == "sr_up1":
            side_in, side_out = lr, lr * s0
        elif name == "sr_up2":
            side_in, side_out = lr * s0, hr_side
        else:  # dem_feat, fuse blocks, head
            side_in = side_out = hr_side
        if name in ("sr_up1", "sr_up2") or name.endswith(".up"):
            out[name] = side_in * side_in * cin * cout * kh * kw  # kernel == stride
        else:
            out[name] = side_out * side_out * cin * cout * kh * kw
    return out


def window_flops(arch: dict) -> float:
    """Operations of the network's forward over one window."""
    return 2.0 * sum(conv_macs(arch).values())


def hr_tail_flops(arch: dict) -> float:
    """Operations of the HR tail's fused part (K1): the fuse blocks and the head, one window."""
    return 2.0 * sum(v for k, v in conv_macs(arch).items() if k.startswith(("fuse.", "head")))


def hr_tail_bytes(arch: dict) -> float:
    """Bytes K1 must move for one window: the upsampled features and the DEM
    features read (f32), the weights and batch-norm affines read, the head's
    output written."""
    s2d = int(arch["hr_s2d"])
    px = (int(arch["lr_tile"]) * int(arch["scale"]) // s2d) ** 2
    hr_w = int(arch["base_filters"]) * s2d
    weights = sum(
        kh * kw * cin * cout + cout
        for name, (kh, kw, cin, cout) in conv_shapes(arch)
        if name.startswith(("fuse.", "head"))
    )
    affines = sum(2 * (cin + cout) for name, (_, _, cin, cout) in conv_shapes(arch)
                  if name.startswith("fuse.") and name.endswith(".conv1"))
    return 4.0 * (px * (hr_w + int(arch["fuse_filters"]) + s2d * s2d) + weights + affines)


def n_windows(arch: dict, lr_shape) -> int:
    """Windows of a scene whose LR grid is ``lr_shape`` (feathered, overlap a quarter tile)."""
    tile = int(arch["lr_tile"]) * int(arch["scale"])
    stride = tile - (int(arch["lr_tile"]) // 4) * int(arch["scale"])

    def count(lr_side: int) -> int:
        total = -(-lr_side * int(arch["scale"]) // tile) * tile
        starts = list(range(0, max(total - tile + 1, 1), stride))
        return len(starts) + (starts[-1] != total - tile)

    return count(lr_shape[0]) * count(lr_shape[1])
