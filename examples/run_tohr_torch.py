"""Library-API example for the PyTorch/CUDA port: one ToHR pass end to end.

The same flow as ``examples/run_tohr.py`` through ``floodsr_tpu_torch``: a
synthetic scene and a deterministic model artifact (the same bytes the JAX
package writes for the same seed), one ``tohr`` call, and its diagnostics.

Run: ``python examples/run_tohr_torch.py [out_dir] [--device {cuda,cpu}]``
(default ``cuda``; the script raises when CUDA is asked for and absent).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from floodsr_tpu_torch.device import resolve_device
from floodsr_tpu_torch.io import from_origin, read_raster, write_raster
from floodsr_tpu_torch.nn import ResUNetConfig
from floodsr_tpu_torch.nn.checkpoint import save_artifact
from floodsr_tpu_torch.nn.resunet import init_resunet
from floodsr_tpu_torch.tohr import tohr


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir", nargs="?", type=Path)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    out_dir = args.out_dir if args.out_dir is not None else Path(tempfile.mkdtemp())
    out_dir.mkdir(parents=True, exist_ok=True)

    # A small model artifact (the flagship config is ResUNetConfig()).
    cfg = ResUNetConfig(
        base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
        fuse_filters=8, fuse_blocks=1, scale=4, lr_tile=8,
    )
    params, state = init_resunet(0, cfg)
    model_fp = out_dir / "model_infer.fsrz"
    save_artifact(model_fp, cfg, params, state, {"demo": True})

    # Synthetic inputs: 16x16 LR depth @30 m + 64x64 DEM @7.5 m.
    rng = np.random.default_rng(0)
    depth_lr = rng.uniform(0, 2, (16, 16)).astype(np.float32)
    dem = 400 + np.cumsum(rng.normal(0, 0.5, (64, 64)).astype(np.float32), axis=1)

    def profile(arr, res):
        return {
            "height": arr.shape[0], "width": arr.shape[1], "count": 1,
            "dtype": "float32", "crs": "EPSG:32633", "nodata": -9999.0,
            "transform": from_origin(500000.0, 4000000.0 + arr.shape[0] * res, res, res),
            "compress": "LZW",
        }

    lr_fp = out_dir / "depth_lr.tif"
    dem_fp = out_dir / "dem.tif"
    write_raster(lr_fp, depth_lr, profile(depth_lr, 30.0))
    write_raster(dem_fp, dem, profile(dem, 7.5))

    result = tohr(
        model_version="ResUNet_16x_DEM",
        model_fp=model_fp,
        depth_lr_fp=lr_fp,
        dem_hr_fp=dem_fp,
        output_fp=out_dir / "depth_sr.tif",
        window_method="feather",
        tile_overlap=2,
        device=args.device,
    )
    pred, _, _ = read_raster(result["output_fp"])
    print(f"wrote {result['output_fp']} shape={pred.shape} "
          f"range=[{pred.min():.3f}, {pred.max():.3f}] m "
          f"in {result['runtime_s']:.2f}s on {args.device}")
    print(json.dumps(result["preprocess"], indent=2, default=str)[:800])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
