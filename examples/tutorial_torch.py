"""Tutorial for the PyTorch/CUDA port: run FloodSR on the committed golden
case and evaluate it.

The same flow as ``examples/tutorial.py`` through ``floodsr_tpu_torch``: run
``tohr`` on the committed synthetic flagship case
(``tests/data/synth_flagship``, the full-width trained ``ResUNet_16x_DEM`` in
``tests/data/_artifacts/model_infer_flagship.fsrz``), compare it against the
hi-res truth and a bilinear baseline, and plot the result. It runs offline.

Run: ``python examples/tutorial_torch.py [out_dir] [--device {cuda,cpu}] [--no-figure]``
(default ``cuda``; the script raises when CUDA is asked for and absent).
Prints the full reference metric table (SR vs bilinear vs nearest) and, unless
``--no-figure`` is given, writes ``<out_dir>/tutorial_compare.png`` (needs
matplotlib).
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
from floodsr_tpu_torch.eval.metrics import compute_depth_error_metrics
from floodsr_tpu_torch.io import read_raster
from floodsr_tpu_torch.ops.resample import reproject_bilinear, reproject_nearest
from floodsr_tpu_torch.preprocessing import resolve_preprocess_config
from floodsr_tpu_torch.tohr import tohr

CASE_DIR = Path(__file__).resolve().parents[1] / "tests" / "data" / "synth_flagship"
DRY_THRESH_M = 1e-3
METRIC_COLUMNS = ("rmse_m", "rmse_wet_m", "mase_m", "psnr", "ssim", "bias_m")


def _load(fp):
    arr, nodata, profile = read_raster(fp)
    if nodata is not None:
        arr = np.where(arr == nodata, 0.0, arr)
    return arr.astype(np.float32), profile


def _box_smooth(arr: np.ndarray, k: int) -> np.ndarray:
    """Separable odd-k box filter (edge-padded) — numpy-only DEM smoothing."""
    if k <= 1:
        return arr
    assert k % 2 == 1, k
    pad = k // 2
    a = np.pad(arr.astype(np.float64), pad, mode="edge")
    for axis in (0, 1):
        c = np.cumsum(a, axis=axis)
        zero = np.zeros_like(np.take(c, [0], axis=axis))
        c = np.concatenate([zero, c], axis=axis)  # prefix sums, length n+1
        n = a.shape[axis]
        hi = np.take(c, range(k, n + 1), axis=axis)
        lo = np.take(c, range(0, n - k + 1), axis=axis)
        a = (hi - lo) / k
    return a


def hillshade(dem: np.ndarray, pixel_m: float, azimuth=315.0, altitude=45.0):
    """Standard Horn hillshade for the DEM basemap panel (smoothed DEM)."""
    gy, gx = np.gradient(dem, pixel_m)
    slope = np.pi / 2.0 - np.arctan(np.hypot(gx, gy))
    aspect = np.arctan2(-gx, gy)
    az, alt = np.radians(360.0 - azimuth + 90.0), np.radians(altitude)
    shaded = np.sin(alt) * np.sin(slope) + np.cos(alt) * np.cos(slope) * np.cos(
        az - np.pi / 2.0 - aspect
    )
    return np.clip(shaded, 0, 1)


def _pyplot():
    """matplotlib's pyplot on the Agg backend; raises naming ``--no-figure``."""
    try:
        import matplotlib
    except ImportError as exc:
        raise RuntimeError(
            "the figure needs matplotlib, which is not installed; "
            "pass --no-figure to print the metrics only"
        ) from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_figure(plt, fig_fp, dem, pixel_m, truth, panels, metrics) -> None:
    """Depth (single-hue sequential, dry cells transparent) over a gray DEM
    hillshade basemap; one shared scale + colorbar."""
    # Smooth the (noise-like synthetic) DEM for the basemap and compress the
    # shade into a light gray band so the depth layer stays dominant.
    shade = hillshade(_box_smooth(dem, 9), pixel_m)
    shade = 0.62 + 0.33 * shade
    vmax = float(np.percentile(truth[truth >= DRY_THRESH_M], 99.5))
    fig, axes = plt.subplots(1, 4, figsize=(16, 4.6), constrained_layout=True)
    im = None
    for ax, (title, depth, mkey) in zip(axes, panels):
        ax.imshow(shade, cmap="gray", vmin=0, vmax=1, interpolation="bilinear")
        wet = np.ma.masked_less(depth, DRY_THRESH_M)
        im = ax.imshow(wet, cmap="Blues", vmin=0, vmax=vmax, alpha=0.92,
                       interpolation="nearest")
        ax.set_title(title, fontsize=11, color="#333333")
        if mkey:
            ax.set_xlabel(f"RMSE {metrics[mkey]['rmse_m']:.3f} m  "
                          f"SSIM {metrics[mkey]['ssim']:.3f}",
                          fontsize=9, color="#555555")
        ax.set_xticks([])
        ax.set_yticks([])
    cbar = fig.colorbar(im, ax=axes, shrink=0.85, pad=0.01)
    cbar.set_label("water depth (m)", fontsize=10, color="#333333")
    fig.savefig(fig_fp, dpi=110)


def main(argv=None) -> dict:
    """Run the tutorial; returns the metrics by estimate
    (``"nearest (LR)"``, ``"bilinear"``, ``"FloodSR SR"``)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out_dir", nargs="?", type=Path)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument(
        "--no-figure", action="store_true",
        help="print the metrics only; the figure needs matplotlib",
    )
    args = parser.parse_args(argv)
    resolve_device(args.device)
    # before the inference: a missing matplotlib fails at once
    plt = None if args.no_figure else _pyplot()
    out_dir = args.out_dir if args.out_dir is not None else Path(tempfile.mkdtemp())
    out_dir.mkdir(parents=True, exist_ok=True)

    spec = json.loads((CASE_DIR / "case_spec.json").read_text())
    model_fp = CASE_DIR.parent / spec["model_artifact"]
    lr_fp = CASE_DIR / spec["inputs"]["lowres_fp"]
    dem_fp = CASE_DIR / spec["inputs"]["dem_fp"]
    truth_fp = CASE_DIR / spec["inputs"]["truth_fp"]
    output_fp = out_dir / "depth_sr.tif"

    # 1. Inference — the library entry point (CLI equivalent:
    #    `floodsr-torch tohr --in lowres030.tif --dem hires002_dem.tif
    #     --model-path model_infer_flagship.fsrz --out depth_sr.tif`).
    result = tohr(
        model_version="ResUNet_16x_DEM",
        model_fp=model_fp,
        depth_lr_fp=lr_fp,
        dem_hr_fp=dem_fp,
        output_fp=output_fp,
        device=args.device,
    )
    diag = result["preprocess"]
    n_tiles = int((diag.get("tile_dem_stats") or {}).get("tile_count", 0))
    print(f"wrote {result['output_fp']}  "
          f"({n_tiles} tiles, window_method={diag['window_method']}, "
          f"device={args.device}, runtime_s={result['runtime_s']:.2f})")

    # 2. Align everything to the prediction grid.
    pred, pred_profile = _load(output_fp)
    truth, _ = _load(truth_fp)
    lr, lr_profile = _load(lr_fp)
    dem, _ = _load(dem_fp)
    assert pred.shape == truth.shape, (pred.shape, truth.shape)

    dst_t = pred_profile["transform"]
    lr_nearest = reproject_nearest(lr, lr_profile["transform"], pred.shape, dst_t)
    lr_bilinear = reproject_bilinear(lr, lr_profile["transform"], pred.shape, dst_t)

    # 3. Reference metric set vs the hi-res truth.
    max_depth = float(resolve_preprocess_config(model_fp)["max_depth"])
    rows = {
        "nearest (LR)": lr_nearest,
        "bilinear": lr_bilinear,
        "FloodSR SR": pred,
    }
    metrics = {
        name: compute_depth_error_metrics(
            reference_depth_m=truth, estimate_depth_m=est,
            max_depth=max_depth, dry_depth_thresh_m=DRY_THRESH_M,
        )
        for name, est in rows.items()
    }
    header = f"{'estimate':<14}" + "".join(f"{c:>11}" for c in METRIC_COLUMNS)
    print("\n" + header + "\n" + "-" * len(header))
    for name, m in metrics.items():
        print(f"{name:<14}" + "".join(f"{m[c]:>11.4f}" for c in METRIC_COLUMNS))

    # 4. Figure. (title, depth, metrics key or None) — the key travels with
    #    the panel so reordering panels cannot detach a caption from its image.
    if plt is not None:
        panels = [
            ("Low-resolution input (30 m)", lr_nearest, None),
            ("Bilinear upsample", lr_bilinear, "bilinear"),
            ("FloodSR 16x SR", pred, "FloodSR SR"),
            ("Hi-res truth (1.875 m)", truth, None),
        ]
        fig_fp = out_dir / "tutorial_compare.png"
        draw_figure(plt, fig_fp, dem, abs(float(dst_t.a)), truth, panels, metrics)
        print(f"\nfigure: {fig_fp}")
    return metrics


if __name__ == "__main__":
    main()
