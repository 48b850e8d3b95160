"""Serving example for the PyTorch/CUDA port: stream many scenes through one
loaded model.

The same stream as ``examples/serve_scenes.py`` through ``floodsr_tpu_torch``
(``tohr_many`` / ``ModelWorker.run_many``): the model loads onto the device
once and every scene reuses it; the DEM stays resident in the worker's device
cache, so scenes over the same terrain decode and upload it once; and the
next scene's DEM is decoded and uploaded by a background thread while the
current scene computes. On a forecast server this is the steady-state shape:
static terrain, a stream of new depth forecasts.

Run: ``python examples/serve_scenes_torch.py [out_dir] [--device {cuda,cpu}]``
(default ``cuda``; the script raises when CUDA is asked for and absent).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from floodsr_tpu_torch.device import resolve_device
from floodsr_tpu_torch.io import from_origin, write_raster
from floodsr_tpu_torch.nn import ResUNetConfig
from floodsr_tpu_torch.nn.checkpoint import save_artifact
from floodsr_tpu_torch.nn.resunet import init_resunet
from floodsr_tpu_torch.tohr import tohr_many


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir", nargs="?", type=Path)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    out_dir = args.out_dir if args.out_dir is not None else Path(tempfile.mkdtemp())
    out_dir.mkdir(parents=True, exist_ok=True)

    cfg = ResUNetConfig(
        base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
        fuse_filters=8, fuse_blocks=1, scale=4, lr_tile=8,
    )
    params, state = init_resunet(0, cfg)
    model_fp = out_dir / "model_infer.fsrz"
    save_artifact(model_fp, cfg, params, state, {"demo": True})

    def profile(arr, res):
        return {
            "height": arr.shape[0], "width": arr.shape[1], "count": 1,
            "dtype": "float32", "crs": "EPSG:32633", "nodata": -9999.0,
            "transform": from_origin(500000.0, 4000000.0 + arr.shape[0] * res, res, res),
            "compress": "LZW",
        }

    # One static DEM (terrain) + a stream of forecast depth rasters.
    rng = np.random.default_rng(7)
    dem = 400 + np.cumsum(rng.normal(0, 0.5, (64, 64)).astype(np.float32), axis=1)
    dem_fp = out_dir / "dem.tif"
    write_raster(dem_fp, dem, profile(dem, 7.5))

    jobs = []
    for t in range(4):
        depth = rng.uniform(0, 2, (16, 16)).astype(np.float32) * (0.5 + 0.25 * t)
        lr_fp = out_dir / f"forecast_t{t}.tif"
        write_raster(lr_fp, depth, profile(depth, 30.0))
        jobs.append(
            {
                "depth_lr_fp": lr_fp,
                "dem_hr_fp": dem_fp,
                "output_fp": out_dir / f"forecast_t{t}_sr.tif",
            }
        )

    t0 = time.perf_counter()
    results = tohr_many(
        model_version="ResUNet_16x_DEM",
        model_fp=model_fp,
        jobs=jobs,
        window_method="feather",
        tile_overlap=2,
        device=args.device,
    )
    total = time.perf_counter() - t0
    for r in results:
        print(f"{r['output_fp']}  runtime_s={r['runtime_s']:.2f}")
    print(
        f"{len(jobs)} scenes in {total:.2f}s on {args.device} "
        f"(one model load; the DEM decoded once and kept on the device)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
