#!/usr/bin/env python3
"""Rounding noise in one train step's gradients: the single step and the step
on a mesh of the card, against the same step on the CPU.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/train_mesh_grad_noise.py [--config narrow|flagship] [--batch 8]

For each of the card's single step, the step over ``make_mesh(devices=
[cuda:0] * 4)`` (dp=4) and over ``... tp=2`` (dp=2, tp=2), the raw gradients
(before the clip) are held against the CPU's single step, which oneDNN sums
without FFTs: per leaf, the largest difference over the leaf's largest
gradient. Then the elements whose sign differs between the card's single step
and a mesh step (each such element moves by ``lr`` the other way in Adam's
first step; ``conv1.b``, whose true gradient is 0, left out), and how large
the CPU's gradient is there against the card's own noise on that leaf (the
larger of the two steps' largest differences from the CPU): a ratio at or
under 1 says the flip lies inside it. One JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from floodsr_tpu_torch.nn.resunet import ResUNetConfig  # noqa: E402
from floodsr_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from floodsr_tpu_torch.train import trainer as tt  # noqa: E402

CONFIGS = {
    "narrow": dict(base_filters=8, levels=2, enc_blocks=1, dec_blocks=1, fuse_filters=8,
                   fuse_blocks=2, scale=4, lr_tile=8, hr_s2d=2),
    "flagship": dict(base_filters=32, levels=4, enc_blocks=2, dec_blocks=2, fuse_filters=32,
                     fuse_blocks=2, scale=16, lr_tile=32, hr_s2d=4),
}


def single_grads(cfg, batch: dict, device: str) -> dict[str, np.ndarray]:
    state = tt.init_train_state(0, cfg, tt.TrainConfig(), device=device)
    b = {k: torch.from_numpy(v).to(state.device) for k, v in batch.items()}
    loss, _ = tt.mae_loss(state.model, b["depth_lr"], b["dem_hr"], b["target_hr"])
    loss.backward()
    return {k: p.grad.double().cpu().numpy() for k, p in state.model.named_parameters()}


def mesh_grads(cfg, batch: dict, tp: int) -> dict[str, np.ndarray]:
    state = tt.init_train_state(0, cfg, tt.TrainConfig(), device="cuda")
    placed = tt.shard_train_state(state, make_mesh(devices=[state.device] * 4, tp=tp))
    _, grads, _ = tt._mesh_gradients(placed, batch, torch.float32)
    out: dict = {}
    for (name, j), g in sorted(grads.items()):
        out.setdefault(name, []).append(g.double().cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=sorted(CONFIGS), default="narrow")
    parser.add_argument("--batch", type=int, default=8)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_mesh_grad_noise: CUDA is not available", file=sys.stderr)
        return 2
    cfg = ResUNetConfig(**CONFIGS[args.config])
    rng = np.random.default_rng(1)
    lr, hr = cfg.lr_tile, cfg.lr_tile * cfg.scale
    batch = {
        "depth_lr": rng.uniform(0, 1, (args.batch, lr, lr)).astype(np.float32),
        "dem_hr": rng.uniform(0, 1, (args.batch, hr, hr)).astype(np.float32),
        "target_hr": rng.uniform(0, 1, (args.batch, hr, hr)).astype(np.float32),
    }
    cpu = single_grads(cfg, batch, "cpu")
    card = {"card_single": single_grads(cfg, batch, "cuda"),
            "card_dp4": mesh_grads(cfg, batch, 1), "card_dp2_tp2": mesh_grads(cfg, batch, 2)}
    report = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
        "config": args.config, "batch": args.batch}
    for name, grads in card.items():
        errs = {k: float(np.abs(grads[k] - cpu[k]).max() / np.abs(cpu[k]).max()) for k in cpu}
        worst = max(errs, key=errs.get)
        entry = {"worst_leaf": worst, "worst_of_leaf_max": errs[worst],
                 "median_of_leaf_max": float(np.median(list(errs.values())))}
        if name != "card_single":
            # conv1.b feeds a batch norm alone: its true gradient is 0, all noise
            flips, inside, ratio, by_leaf = 0, 0, 0.0, {}
            for k in cpu:
                flip = np.sign(grads[k]) != np.sign(card["card_single"][k])
                if k.endswith("conv1.b") or not flip.any():
                    continue
                noise = max(np.abs(card["card_single"][k] - cpu[k]).max(), np.abs(grads[k] - cpu[k]).max())
                r = np.abs(cpu[k][flip]) / max(noise, np.finfo(np.float64).tiny)
                flips += int(flip.sum())
                inside += int((r <= 1.0).sum())
                ratio = max(ratio, float(r.max()))
                by_leaf[k] = int(flip.sum())
            entry.update({"sign_flips_vs_card_single": flips, "flips_inside_card_noise": inside,
                          "largest_flip_cpu_grad_over_card_noise": ratio,
                          "flips_by_leaf": dict(sorted(by_leaf.items(), key=lambda kv: -kv[1])[:6])})
        report[name] = entry
    print(json.dumps({"train_mesh_grad_noise": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
