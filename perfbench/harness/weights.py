"""The weights a cell serves: the committed artifact, or a draw from the seed.

A configuration names either ``weights.artifact`` (a file of the checkout,
held to its ``sha256``) or ``weights.draw`` (the CPU tests' tiny networks;
no cell serves random weights): He-normal kernels as the
program's ``init_resunet`` draws them (zero biases, batch norm the identity),
drawn on the device in one call from the configuration's own ``seed`` (one
model for every run, as a released artifact is; a seed per run would change
the work from run to run), with the head's kernel
scaled by ``head_gain`` and its bias set to ``head_bias`` so that the random
network's output stays inside the depth range instead of clipping. The draw
is written as a ``.fsrz`` artifact (manifest, ``params.npz``, ``state.npz``)
for the program to load.
"""

from __future__ import annotations

import hashlib
import io
import json
import math
import zipfile
from pathlib import Path

import numpy as np
import torch

from perfbench.harness.spec import ROOT

_ZIP_EPOCH = (1980, 1, 1, 0, 0, 0)


def split_scale(scale: int) -> tuple[int, int]:
    root = int(round(math.sqrt(scale)))
    if root * root == scale:
        return root, root
    for a in range(root + 1, scale + 1):
        if scale % a == 0:
            return a, scale // a
    return scale, 1


def conv_shapes(arch: dict) -> list[tuple[str, tuple[int, int, int, int]]]:
    """Every convolution kernel (HWIO) in the network's order of definition."""
    f, s2d = arch["base_filters"], arch["hr_s2d"]
    widths = [f * 2**i for i in range(arch["levels"] + 1)]
    out = [("stem", (3, 3, 2, f))]

    def block(name, cin, cout):
        out.append((f"{name}.conv1", (3, 3, cin, cout)))
        out.append((f"{name}.conv2", (3, 3, cout, cout)))
        if cin != cout:
            out.append((f"{name}.proj", (1, 1, cin, cout)))

    cin = f
    for i, w in enumerate(widths):
        for b in range(arch["enc_blocks"]):
            block(f"enc.{i}.{b}", cin, w)
            cin = w
    for i, w in enumerate(reversed(widths[:-1])):
        out.append((f"dec.{i}.up", (2, 2, cin, w)))
        cin = 2 * w
        for b in range(arch["dec_blocks"]):
            block(f"dec.{i}.blocks.{b}", cin, w)
            cin = w
    s0, s1 = split_scale(arch["scale"] // s2d)
    hr = f * s2d
    out.append(("sr_up1", (s0, s0, cin, f)))
    out.append(("sr_up2", (s1, s1, f, hr)))
    out.append(("dem_feat", (3, 3, s2d * s2d, arch["fuse_filters"])))
    cin = hr + arch["fuse_filters"]
    for b in range(arch["fuse_blocks"]):
        block(f"fuse.{b}", cin, hr)
        cin = hr
    out.append(("head", (1, 1, hr, s2d * s2d)))
    return out


def bn_shapes(arch: dict) -> list[tuple[str, int]]:
    """Every batch norm ``(name, channels)``: ``bn1`` on a block's input, ``bn2`` on its width."""
    out = []
    for name, shape in conv_shapes(arch):
        if name.endswith(".conv1"):
            out.append((name[:-6] + ".bn1", shape[2]))
            out.append((name[:-6] + ".bn2", shape[3]))
    return out


def _nest(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def _skeleton(tree, leaves: list) -> object:
    if isinstance(tree, dict):
        return {k: _skeleton(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_skeleton(v, leaves) for v in tree]
    leaves.append(tree)
    return {"__leaf__": len(leaves) - 1}


def _npz(leaves: list) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf_{i:05d}": a for i, a in enumerate(leaves)})
    return buf.getvalue()


def write_artifact(fp: Path, arch: dict, params: dict, state: dict) -> int:
    """Write ``params``/``state`` (flat dotted names → arrays) as a ``.fsrz``."""
    p_leaves, s_leaves = [], []
    p_skel = _skeleton(_nest(params), p_leaves)
    s_skel = _skeleton(_nest(state), s_leaves)
    lr, scale = arch["lr_tile"], arch["scale"]
    manifest = {
        "format": "floodsr-tpu-fsrz", "version": 1, "architecture": "ResUNet_DEM",
        "config": arch,
        "io_contract": {
            "depth_input_name": "depth_lr", "dem_input_name": "dem_hr",
            "output_name": "depth_hr_pred", "depth_lr_hwc": [lr, lr, 1],
            "dem_hr_hwc": [lr * scale, lr * scale, 1], "output_hwc": [lr * scale, lr * scale, 1],
            "scale": scale,
        },
        "params_skeleton": p_skel, "state_skeleton": s_skel, "store_dtype": "float32",
        "metadata": {"purpose": "benchmark draw"},
    }
    with zipfile.ZipFile(fp, "w") as zf:
        for name, data in (
            ("manifest.json", json.dumps(manifest, sort_keys=True)),
            ("params.npz", _npz(p_leaves)), ("state.npz", _npz(s_leaves)),
        ):
            info = zipfile.ZipInfo(name, date_time=_ZIP_EPOCH)
            info.compress_type = zipfile.ZIP_STORED
            zf.writestr(info, data)
    return fp.stat().st_size


def draw(arch: dict, draw_cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """He-normal kernels from one ``torch.randn`` on ``device``; flat numpy dicts."""
    shapes = conv_shapes(arch)
    total = sum(int(np.prod(s)) for _, s in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    noise = torch.randn(total, generator=gen, device=device, dtype=torch.float32).cpu().numpy()
    params, at = {}, 0
    for name, s in shapes:
        n = int(np.prod(s))
        w = noise[at : at + n].reshape(s) * np.float32(math.sqrt(2.0 / (s[0] * s[1] * s[2])))
        b = np.zeros(s[3], np.float32)
        at += n
        if name == "head":
            w = w * np.float32(draw_cfg["head_gain"])
            b = b + np.float32(draw_cfg["head_bias"])
        params[f"{name}.w"], params[f"{name}.b"] = w.astype(np.float32), b
    state = {}
    for name, c in bn_shapes(arch):
        params[f"{name}.scale"] = np.ones(c, np.float32)
        params[f"{name}.offset"] = np.zeros(c, np.float32)
        state[f"{name}.mean"] = np.zeros(c, np.float32)
        state[f"{name}.var"] = np.ones(c, np.float32)
    return params, state


def artifact_for(cfg: dict, workdir: Path, device) -> Path:
    """The artifact the cell serves: the committed file (checked), or a draw written under ``workdir``."""
    w = cfg["weights"]
    if "artifact" in w:
        fp = ROOT / w["artifact"]
        digest = hashlib.sha256(fp.read_bytes()).hexdigest()
        if digest != w["sha256"]:
            raise RuntimeError(f"{fp} has sha256 {digest}, the configuration states {w['sha256']}")
        return fp
    params, state = draw(cfg["architecture"], w["draw"], w["draw"]["seed"], device)
    fp = workdir / "model.fsrz"
    write_artifact(fp, cfg["architecture"], params, state)
    return fp
