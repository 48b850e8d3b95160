"""Where the card's bfloat16 scene parts from the CPU's at ``hr_s2d=1``, stage by stage.

Run from the root of the repository, on a machine with a GPU (~1 min):

    python3 tests/layout_bf16_study.py                 # the card against the CPU
    python3 tests/layout_bf16_study.py --device cpu    # the CPU against itself: every distance 0

``chip_smoke.py``'s 1024² layout scene (``scene_inputs(tmp, seed, 1024,
tag="_layouts")``) with the ``hr_s2d=1`` artifact of ``init_resunet(seed,
cfg)`` under the ``bfloat16`` policy, as ``phase_layout_scenes`` runs it: the
scene executor's inputs are captured from a ``tohr`` call, then each stage of
the executor's two phases runs on the CPU and on the device in the port's
own bf16 arithmetic (the gathers, the depth scaling, K2's DEM statistics and
the normalize, the trunk's stem and each of its blocks, the SR upsample, the
DEM features, K1). For each stage two distances of the device's output from
the CPU's: **local**, the device fed the CPU's inputs of that stage (what the
stage itself departs by), and **carried**, the device fed its own previous
outputs (the departure so far). Each as rms over the CPU's rms, max |diff|,
and the share of elements that differ. One JSON line. Imports no JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (layout_config, scene_inputs, LAYOUT_SCENE)
import floodsr_tpu_torch.engine.scene as scene  # noqa: E402
from floodsr_tpu_torch.nn.checkpoint import save_artifact  # noqa: E402
from floodsr_tpu_torch.nn.resunet import (  # noqa: E402
    bf16_products,
    conv2d_same,
    conv_transpose_nhwc,
    init_resunet,
    split_scale,
)
from floodsr_tpu_torch.ops.kernels import hr_tail as ht  # noqa: E402
from floodsr_tpu_torch.ops.normalize import (  # noqa: E402
    dem_tile_stats,
    normalize_dem_with_stats,
    scale_depth_log1p,
)
from floodsr_tpu_torch.tohr import tohr  # noqa: E402

S2D = 1


def capture(tmp: Path, seed: int, device: str) -> dict:
    """The scene executor's inputs (on the host) and the executor, from one
    ``tohr`` call of the layout scene under ``bfloat16``."""
    cfg = chip_smoke.layout_config(S2D)
    model_fp = save_artifact(tmp / "s2d1.fsrz", cfg, *init_resunet(seed, cfg), {"seed": seed})
    dem_fp, depth_fp = chip_smoke.scene_inputs(tmp, seed, chip_smoke.LAYOUT_SCENE, tag="_layouts")
    cap = {}
    call = scene.SceneExecutor.__call__

    def capturing(self, depth, dem, idx):
        cap.update(ex=self, depth=depth.cpu(), dem=dem.cpu(), idx=idx)
        return call(self, depth, dem, idx)

    scene.SceneExecutor.__call__ = capturing
    try:
        tohr(model_version="ResUNet_16x_DEM", model_fp=model_fp, depth_lr_fp=depth_fp,
             dem_hr_fp=dem_fp, output_fp=tmp / "scene.tif", device=device,
             engine_options={"compute_dtype": "bfloat16", "output_transfer": "float32"})
    finally:
        scene.SceneExecutor.__call__ = call
    return cap


def run(ex, model, depth_pad, dem_pad, idx, dev: torch.device, feed: "dict | None" = None) -> dict:
    """Every stage of the executor's two phases on ``dev``, in order. With
    ``feed`` (a run's outputs on the CPU), each stage reads its inputs from
    ``feed`` instead of from this run: the stage's own departure."""
    cfg, stage = ex.cfg, ex.precision
    tile, lr_tile, scale = cfg.hr_tile, cfg.lr_tile, cfg.scale
    out = {}

    def inp(name):
        return feed[name].to(dev) if feed is not None else out[name]

    y0 = torch.as_tensor(idx["y0"], dtype=torch.int64, device=dev)
    x0 = torch.as_tensor(idx["x0"], dtype=torch.int64, device=dev)
    out["depth_tiles"] = scene.gather_tiles(depth_pad.to(dev), y0 // scale, x0 // scale, lr_tile)
    out["dem_tiles"] = scene.gather_tiles(dem_pad.to(dev), y0, x0, tile)
    out["depth_norm"] = scale_depth_log1p(inp("depth_tiles"), ex.max_depth)
    out["dem_stats"] = torch.stack(dem_tile_stats(inp("dem_tiles"), ex.dem_pct_clip), -1)
    st = inp("dem_stats")
    out["dem_norm"] = normalize_dem_with_stats(inp("dem_tiles"), st[:, 0], st[:, 1], st[:, 2])

    # phase 1: the trunk, as ResUNet._trunk_body, block by block
    on_cuda = dev.type == "cuda"
    bn = dict(eps=cfg.bn_eps, stats=None, momentum=cfg.bn_momentum)
    t = stage["trunk"]
    with bf16_products(t == torch.bfloat16 and on_cuda):
        depth = inp("depth_norm")[..., None].to(t)
        dem = inp("dem_norm")[..., None].to(t)
        n, hh, ww, c = dem.shape
        dem_lr = dem.reshape(n, hh // scale, scale, ww // scale, scale, c).mean(dim=(2, 4))
        x = torch.cat([depth, dem_lr], dim=-1).permute(0, 3, 1, 2)
        out["stem"] = conv2d_same(x, model.stem)
        prev, skips = "stem", []
        for lvl, blocks in enumerate(model.enc):
            for bi, block in enumerate(blocks):
                name = f"enc{lvl}.{bi}"
                out[name] = block(inp(prev), stride=2 if (lvl > 0 and bi == 0) else 1, **bn)
                prev = name
            if lvl < len(model.enc) - 1:
                skips.append(prev)
        for lvl, (dec, skip) in enumerate(zip(model.dec, reversed(skips))):
            up = conv_transpose_nhwc(inp(prev).permute(0, 2, 3, 1), dec.up, 2)
            out[f"dec{lvl}.up"] = torch.cat([up.permute(0, 3, 1, 2), inp(skip)], dim=1)
            prev = f"dec{lvl}.up"
            for bi, block in enumerate(dec.blocks):
                name = f"dec{lvl}.{bi}"
                out[name] = block(inp(prev), **bn)
                prev = name
    out["trunk"] = inp(prev).permute(0, 2, 3, 1).contiguous()

    # phase 2: the SR upsample, the DEM features and K1, as ResUNet._tail
    s0, s1 = split_scale(cfg.scale // S2D)
    sr_t, tail_t = stage["sr_up"], stage["tail"]
    with bf16_products(sr_t == torch.bfloat16 and on_cuda):
        out["sr_up1"] = torch.relu(conv_transpose_nhwc(inp("trunk").to(sr_t), model.sr_up1, s0))
        out["sr_up2"] = torch.relu(conv_transpose_nhwc(inp("sr_up1"), model.sr_up2, s1))
    with bf16_products(tail_t == torch.bfloat16 and on_cuda):
        d = inp("dem_norm")[..., None].to(tail_t)
        out["dem_feat"] = torch.relu(conv2d_same(d.permute(0, 3, 1, 2), model.dem_feat))
        weights = ht.pack_hr_tail_weights(model.fuse[0], model.fuse[1], model.head, bn_eps=cfg.bn_eps)
        mode = "bf16" if tail_t == torch.bfloat16 else "f32"
        pack = ht.pack_hr_tail_bf16(weights) if mode == "bf16" else ht.pack_hr_tail_tc(weights)
        out["k1"] = ht.hr_tail(
            inp("sr_up2").to(tail_t).to(torch.float32).contiguous(),
            inp("dem_feat").permute(0, 2, 3, 1).to(torch.float32).contiguous(),
            *weights, tc_pack=pack, mode=mode,
        )
    return {k: v.detach().cpu() for k, v in out.items()}


def distance(got: torch.Tensor, want: torch.Tensor) -> dict:
    g, w = got.double(), want.double()
    rms_want = float(w.square().mean().sqrt())
    return {
        "rms_rel": float((g - w).square().mean().sqrt()) / max(rms_want, 1e-30),
        "max_abs": float((g - w).abs().max()),
        "differ_share": float((got != want).double().mean()),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu (a rehearsal)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("layout_bf16_study: CUDA is not available", file=sys.stderr)
        return 2
    from floodsr_tpu_torch.device import set_strict_f32

    set_strict_f32()
    dev = torch.device(args.device)
    with tempfile.TemporaryDirectory(prefix="layout-bf16-study-") as tmp:
        cap = capture(Path(tmp), args.seed, args.device)
    ex = cap["ex"]
    model_dev = ex.model
    model_cpu = copy.deepcopy(model_dev).cpu()
    cpu = run(ex, model_cpu, cap["depth"], cap["dem"], cap["idx"], torch.device("cpu"))
    local = run(ex, model_dev, cap["depth"], cap["dem"], cap["idx"], dev, feed=cpu)
    carried = run(ex, model_dev, cap["depth"], cap["dem"], cap["idx"], dev)
    report = {
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "precision": {k: str(v) for k, v in ex.precision.items()},
        "tiles": int(len(cap["idx"]["y0"])),
        "stages": {
            name: {"local": distance(local[name], cpu[name]),
                   "carried": distance(carried[name], cpu[name]),
                   "rms": float(cpu[name].double().square().mean().sqrt())}
            for name in cpu
        },
    }
    print(json.dumps({"layout_bf16_study": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
