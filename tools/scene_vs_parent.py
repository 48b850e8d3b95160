#!/usr/bin/env python3
"""The plain 4096² flagship scene through ``tohr`` from two checkouts, in turns.

    git archive <commit> | tar -x -C _tree/parent
    python3 tools/scene_vs_parent.py _tree/parent .

Each turn (earlier, current, current, earlier) is a child process that
imports the port from one checkout, builds its kernels, writes the scene of
``chip_smoke.scene_inputs`` (seed 0), runs ``tohr`` once unrecorded and then
``--runs`` times timed (a synchronize before and after each), and prints one
JSON line: end-to-end seconds and the worker's ``exec_s`` per run, and their
medians. The parent prints the card's name and power limit and a last JSON
line with every turn. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def turn(tree: Path, runs: int) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from floodsr_tpu_torch.tohr import tohr

    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        dem_fp, depth_fp = cs.scene_inputs(tmp, 0, cs.SCENE_SIZE)
        kw = dict(
            model_version="ResUNet_16x_DEM", model_fp=cs.FLAGSHIP, depth_lr_fp=depth_fp,
            dem_hr_fp=dem_fp, output_fp=tmp / "pred.tif", device="cuda",
        )
        tohr(**kw)
        e2e, exec_s = [], []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            diag = tohr(**kw)
            torch.cuda.synchronize()
            e2e.append(time.perf_counter() - t0)
            exec_s.append(diag["scene_timings"]["exec_s"])
    return {
        "tree": str(tree), "e2e_s": e2e, "exec_s": exec_s,
        "median_e2e_s": statistics.median(e2e), "median_exec_s": statistics.median(exec_s),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent", type=Path, help="the earlier checkout")
    parser.add_argument("change", type=Path, help="the current checkout")
    parser.add_argument("--runs", type=int, default=6)
    parser.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.turn:  # a child: time the scene from args.change alone
        print(json.dumps(turn(args.change.resolve(), args.runs)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    turns = []
    for tree in (args.parent, args.change, args.change, args.parent):
        done = subprocess.run(
            [sys.executable, __file__, str(tree), str(tree), "--runs", str(args.runs), "--turn"],
            capture_output=True, text=True, check=True,
        )
        turns.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    print(card)
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
