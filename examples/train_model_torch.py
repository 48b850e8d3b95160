"""Training example for the PyTorch/CUDA port: fit the DEM-conditioned ResUNet
on synthetic patches.

The same steps as ``examples/train_model.py`` through ``floodsr_tpu_torch``:
dataset, deterministic split, augmentation, host-fed train steps through
``prefetch_to_device``, an eval step, a training checkpoint and the
inference-artifact export.

Run: ``python examples/train_model_torch.py [steps] [--device {cuda,cpu}]``
(default ``cuda``; the script raises when CUDA is asked for and absent).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from floodsr_tpu_torch.nn.resunet import ResUNetConfig
from floodsr_tpu_torch.parallel.streaming import prefetch_to_device
from floodsr_tpu_torch.train import (
    PatchDataset,
    TrainConfig,
    init_train_state,
    make_eval_step,
    make_train_step,
    split_indices,
)
from floodsr_tpu_torch.train.trainer import export_inference_artifact, save_train_state


def synthetic_patches(n: int, lr_tile: int, scale: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    hr = lr_tile * scale
    dem = 250 + np.cumsum(rng.normal(0, 0.3, (n, hr, hr)).astype(np.float32), axis=2)
    wse = dem.mean(axis=(1, 2), keepdims=True) + 4.0
    truth = np.clip(wse - dem, 0, 5).astype(np.float32)
    depth_lr = truth.reshape(n, lr_tile, scale, lr_tile, scale).mean(axis=(2, 4))
    return depth_lr, dem, truth


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("steps", nargs="?", type=int, default=100)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    steps = args.steps
    model_cfg = ResUNetConfig(
        base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
        fuse_filters=8, fuse_blocks=1, scale=4, lr_tile=8,
    )
    train_cfg = TrainConfig(total_steps=steps, base_lr=1e-3)

    depth_lr, dem, truth = synthetic_patches(64, model_cfg.lr_tile, model_cfg.scale)
    dataset = PatchDataset(depth_lr=depth_lr, dem_hr=dem, target_hr=truth)
    train_idx, val_idx = split_indices(len(dataset), val_fraction=0.15, seed=0)

    state = init_train_state(0, model_cfg, train_cfg, device=args.device)
    train_step = make_train_step(model_cfg, train_cfg)
    eval_step = make_eval_step(model_cfg, train_cfg)

    batches = dataset.batches(train_idx, batch_size=8, seed=0, augment=True, steps=steps)
    for i, batch in enumerate(prefetch_to_device(batches, device=args.device)):
        state, metrics = train_step(state, batch)
        if i % max(1, steps // 10) == 0:
            print(f"step {state.step:4d} loss={float(metrics['loss']):.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f}")

    val_batch = next(iter(dataset.batches(val_idx, batch_size=len(val_idx), steps=1)))
    val_metrics = eval_step(state, val_batch)
    print("validation:", {k: round(float(v), 4) for k, v in val_metrics.items()})

    out_dir = Path(tempfile.mkdtemp())
    ckpt_fp = save_train_state(out_dir / "train_ckpt.fsrz", state, model_cfg)
    infer_fp = export_inference_artifact(out_dir / "model_infer.fsrz", state, model_cfg)
    print(f"checkpoint: {ckpt_fp}\ninference artifact: {infer_fp}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
