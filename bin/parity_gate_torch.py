#!/usr/bin/env python3
"""Card-against-CPU parity gate of the PyTorch/CUDA port, per golden case.

Every ``tests/data/synth_*`` case with a ``case_spec.json`` runs through the
port's full ``tohr`` (``floodsr_tpu_torch.tohr.tohr``) on the GPU and on the
CPU, in this process; the meter-domain RMSE between the two written GeoTIFFs
is gated at BASELINE.md's 1e-3 m. ``synth_mersch`` also runs with
``window_method="hard"`` and with the ``uint12`` download. A last row runs a
thin flagship geometry through the engine banded over a mesh of four
entries of the card against the plain engine, gated at the same bar.

    python3 bin/parity_gate_torch.py [--out PATH] [--device cuda]

The keys are ``bin/parity_gate.py``'s, plus ``device`` (the card's name and
power limit as ``nvidia-smi`` prints them). The result goes to ``--out``
(default ``floodsr_tpu_torch/_build/parity_gate_torch.json``, git-ignored)
and, as one line, to stdout. Exit 0 only if every row passes; zero cases
fail. Exits non-zero, running nothing, without CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

DATA_DIR = REPO / "tests" / "data"
DEFAULT_OUT = REPO / "floodsr_tpu_torch" / "_build" / "parity_gate_torch.json"
GATE_RMSE_M = 1e-3


def gate_runs(data_dir: Path) -> list[tuple[str, str, str, dict | None]]:
    """``(label, case, window_method, engine_options)`` of every run."""
    cases = sorted(
        d.name for d in data_dir.iterdir()
        if d.is_dir() and (d / "case_spec.json").exists()
    )
    runs = [(name, name, "feather", None) for name in cases]
    if "synth_mersch" in cases:
        # The hard windows behind the bench's hard-window number, and the
        # uint12 download (quantization max_depth / 4095 / sqrt(12) ≈ 3.5e-4 m
        # of RMSE, inside the bar).
        runs.append(("synth_mersch@hard", "synth_mersch", "hard", None))
        runs.append(
            ("synth_mersch@pack12", "synth_mersch", "feather", {"output_transfer": "uint12"})
        )
    return runs


def tohr_case(
    data_dir: Path, case: str, method: str, engine_options: dict | None,
    out_fp: Path, device: str,
) -> float:
    """One ``tohr`` of ``case`` on ``device``, written to ``out_fp``; its wall seconds."""
    from floodsr_tpu_torch.tohr import tohr

    case_dir = data_dir / case
    spec = json.loads((case_dir / "case_spec.json").read_text())
    t0 = time.perf_counter()
    tohr(
        model_version="ResUNet_16x_DEM",
        model_fp=data_dir / spec.get("model_artifact", "_artifacts/model_infer_test.fsrz"),
        depth_lr_fp=case_dir / spec["inputs"]["lowres_fp"],
        dem_hr_fp=case_dir / spec["inputs"]["dem_fp"],
        output_fp=out_fp,
        window_method=method,
        engine_options=engine_options,
        device=device,
    )
    return time.perf_counter() - t0


def case_row(
    data_dir: Path, label: str, case: str, method: str, engine_options: dict | None,
    work: Path, device: str,
) -> dict:
    """Two runs on ``device``, one on the CPU, and the gate on their outputs."""
    from floodsr_tpu_torch.io import read_raster

    # The first run on the card pays the worker's first-call set-up (the
    # kernels' libraries loading, cuDNN choosing its algorithms for the
    # case's shapes); the second is what a later scene of that shape sees.
    # compile_tail_s is their difference.
    walls = [
        tohr_case(data_dir, case, method, engine_options, work / f"{label}_acc{i}.tif", device)
        for i in range(2)
    ]
    cpu_fp = work / f"{label}_cpu.tif"
    tohr_case(data_dir, case, method, engine_options, cpu_fp, "cpu")
    a = read_raster(work / f"{label}_acc1.tif")[0].astype(np.float64)
    b = read_raster(cpu_fp)[0].astype(np.float64)
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    max_abs = float(np.max(np.abs(a - b)))
    print(
        f"# {label}: rmse={rmse:.2e} max={max_abs:.2e} pass={rmse <= GATE_RMSE_M} "
        f"cold={walls[0]:.2f}s steady={walls[1]:.2f}s", file=sys.stderr, flush=True,
    )
    return {
        "rmse_m": rmse,
        "max_abs_m": max_abs,
        "pass": rmse <= GATE_RMSE_M,
        "accelerator_wall_s": round(walls[0], 2),
        "steady_s": round(walls[1], 2),
        "compile_tail_s": round(max(0.0, walls[0] - walls[1]), 2),
    }


def banded_vs_plain_row(device: str) -> dict:
    """The scene banded over four entries of ``device`` against the plain
    engine: ``bin/parity_gate.py``'s thin flagship geometry (512² tiles,
    f=8, 4 bands × 2 tile rows, weights from seed 9, inputs from seed 3).
    Both engines take ``max_batch=2``, as there."""
    from floodsr_tpu_torch.device import resolve_device
    from floodsr_tpu_torch.engine import EngineTorch
    from floodsr_tpu_torch.nn.checkpoint import save_artifact
    from floodsr_tpu_torch.nn.resunet import ResUNetConfig, init_resunet
    from floodsr_tpu_torch.parallel.mesh import make_mesh

    cfg = ResUNetConfig(base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
                        fuse_filters=8, fuse_blocks=1, scale=16, lr_tile=32)
    params, state = init_resunet(9, cfg)
    rng = np.random.default_rng(3)
    tile = cfg.hr_tile
    overlap = tile // 4
    h, w = 4 * 2 * tile, tile
    depth = rng.uniform(0, 3, (h // cfg.scale, w // cfg.scale)).astype(np.float32)
    dem = rng.uniform(300, 800, (h, w)).astype(np.float32)
    kw = dict(stride_hr=tile - overlap, overlap_hr=overlap, max_depth=5.0,
              dem_pct_clip=95.0, crop_shape=(h, w))
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="parity-banded-") as tmp:
        fp = Path(tmp) / "geom.fsrz"
        save_artifact(fp, cfg, params, state, {"purpose": "parity banded row"})
        banded = EngineTorch(fp, max_batch=2, mesh=make_mesh(devices=[dev] * 4),
                             scene_mode="banded", device=device)
        out_b, _ = banded.run_scene(depth, dem, **kw)
        banded.close()
        plain = EngineTorch(fp, max_batch=2, device=device)
        out_p, _ = plain.run_scene(depth, dem, **kw)
        plain.close()
    diff = out_b.astype(np.float64) - out_p
    rmse = float(np.sqrt(np.mean(diff ** 2)))
    return {
        "max_abs_m": float(np.max(np.abs(diff))),
        "rmse_m": rmse,
        "scene": [int(h), int(w)],
        "mesh": f"dp=4 over [{dev}] * 4",
        "pass": rmse <= GATE_RMSE_M,
    }


def gate(data_dir: Path, work: Path, device: str) -> dict:
    """Every row of the gate on ``device`` against the CPU; the result."""
    import torch

    from floodsr_tpu_torch.device import card_info, resolve_device

    dev = resolve_device(device)
    result: dict = {
        "date": time.strftime("%Y-%m-%d"),
        "hardware": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        # bin/parity_gate.py's key: the accelerator's backend.
        "tpu_backend": dev.type,
        "device": card_info(dev),
        "gate_rmse_m": GATE_RMSE_M,
        "note": (
            "Full-pipeline tohr output parity of floodsr_tpu_torch, the card "
            "(cuDNN f32 with TF32 off, K1 in 3xTF32) against the CPU float32 "
            "run in the same process, per committed golden case."
        ),
        "cases": {},
    }
    for label, case, method, engine_options in gate_runs(data_dir):
        result["cases"][label] = case_row(
            data_dir, label, case, method, engine_options, work, device
        )
    # The banded row is evidence for the case gate; with zero cases the
    # result fails already.
    if result["cases"]:
        row = banded_vs_plain_row(device)
        result["banded_vs_replicated"] = row
        print(f"# banded_vs_replicated: rmse={row['rmse_m']:.2e} "
              f"max={row['max_abs_m']:.2e} pass={row['pass']}", file=sys.stderr, flush=True)
    # Zero discovered cases fail (all() over an empty dict is True).
    if not result["cases"]:
        result["pass"] = False
        result["error"] = "no golden cases discovered under tests/data"
    else:
        result["pass"] = all(c["pass"] for c in result["cases"].values()) and (
            result.get("banded_vs_replicated", {"pass": True})["pass"]
        )
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--work", type=Path, default=None,
                    help="directory for the written rasters (default: a temporary one)")
    ap.add_argument("--device", default="cuda",
                    help="the CUDA device held against the CPU (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    if not args.device.startswith("cuda"):
        print(f"parity_gate_torch: --device {args.device} is not a CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("parity_gate_torch: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="floodsr-parity-torch-") as tmp:
        work = args.work or Path(tmp)
        work.mkdir(parents=True, exist_ok=True)
        result = gate(DATA_DIR, work, args.device)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
