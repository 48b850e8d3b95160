"""The CostGrow family (``CostGrow``): what the harness knows of a cell that
serves the program's least-cost WSE downscaler, and of nothing else.

CostGrow has no weights: the served file is its parameter JSON
(``parameters``). A scenario's LR input is a water surface: the terrain's LR
mean plus the drawn depth (clipped to ``max_depth``) where wet, nodata where
dry. The judge works each judged job out again with the plain reference
(``reference/costgrow.py``) on the harness's raw arrays, and compares the
program's GeoTIFF with it. Its work count, K3's bytes a launch, is
:func:`relax_bytes_per_launch`. See ``harness/spec.py::family`` for what a
family module gives.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from perfbench.harness.synth import depth_lr

#: The controls, each of which must fail the comparison: the reference with
#: its distances accumulated in bfloat16, or each solve stopped at half the
#: sweeps it needs. ``control=True`` names the first.
CONTROLS = ("bf16_distances", "half_sweeps")

#: Bytes one K3 launch must move a cell: ``dist``, ``value`` and ``cost``
#: read, ``dist`` and ``value`` written, float32 each. A launch that made
#: several sweeps would still move them once.
RELAX_BYTES_PER_CELL = 5 * 4
#: The H100 SXM's HBM3 bandwidth (as ``harness/work.py``'s, which this family
#: does not load).
HBM_BYTES_PER_S = 3.35e12

#: The mixes' nodata, which a dry LR cell carries.
NODATA = -9999.0

#: A cell wet in both has moved when its WSE differs by more than this: 30
#: float32 spacings at 300 m, far above the rounding of a warp, far below
#: the gap between two anchors' water surfaces that a flipped path carries.
MOVED_M = 1e-3
#: The numbers held to the cell's limits. The widest gap (``max_abs_m``) is
#: logged, not held: a near tie that float32 rounding flips carries another
#: anchor's WSE, metres away, in the program as in a control; what tells them
#: apart is how many cells move, not how far.
CHECKED = ("wet_mismatch", "moved_share", "rmse_m")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def relax_bytes_per_launch(hr_shape) -> int:
    """The least traffic of one K3 launch over an ``[H, W]`` grid."""
    return int(hr_shape[0]) * int(hr_shape[1]) * RELAX_BYTES_PER_CELL


def artifact(cfg: dict, workdir: Path, device) -> Path:
    """The parameter JSON the worker reads as its model file."""
    fp = workdir / "costgrow.json"
    fp.write_text(json.dumps({"model_version": cfg["model_version"], **cfg["parameters"]}))
    return fp


def service_options(cfg: dict) -> dict:
    return {}


def warmup_shapes(cfg: dict, plan) -> list:
    """None: the worker builds nothing by shape; the mix's warm-up calls do."""
    return []


def lr_raster(cfg: dict, dem: np.ndarray, base_m: float, offset_m: float, tilt_m: float,
              lr_shape) -> np.ndarray:
    """The LR water surface: the terrain's LR mean plus the drawn depth where
    wet, the mixes' nodata where dry."""
    depth = depth_lr(dem, base_m, offset_m, tilt_m, lr_shape, float(cfg["max_depth"]))
    kh, kw = dem.shape[0] // lr_shape[0], dem.shape[1] // lr_shape[1]
    ground = dem.reshape(lr_shape[0], kh, lr_shape[1], kw).mean(axis=(1, 3))
    return np.where(depth > 0, ground + depth, NODATA).astype(np.float32)


def per_job(cfg: dict, plan) -> dict:
    return {"arch": None, "windows_per_job": None}


def reference(cfg: dict, plan, scenario: int, device, control=False) -> np.ndarray:
    """The reference's WSE for one scenario (NaN dry); a control's where asked."""
    import torch

    from perfbench.reference.costgrow import costgrow

    name = CONTROLS[0] if control is True else control
    if name and name not in CONTROLS:
        raise ValueError(f"unknown control {name!r}; known: {CONTROLS}")
    g, sc = plan.geometry, plan.scenarios[scenario]
    return costgrow(
        sc.lr, plan.areas[sc.area].dem, lr_res=g["lr_res"], hr_res=g["hr_res"],
        west=g["west"], north=g["north"], nodata=g["nodata"], params=cfg["parameters"], device=device,
        acc=torch.bfloat16 if name == "bf16_distances" else torch.float32,
        sweep_share=0.5 if name == "half_sweeps" else None,
    )


def compare(out: np.ndarray, ref: np.ndarray) -> dict:
    """Over the reference's wet cells: the share wet in only one of the two
    (``wet_mismatch``) and the share wet in both whose WSE differs by more
    than :data:`MOVED_M` (``moved_share``); over cells wet in both, the WSE's
    RMSE and widest gap (NaN = dry)."""
    wet_out, wet_ref = np.isfinite(out), np.isfinite(ref)
    both = wet_out & wet_ref
    d = out[both].astype(np.float64) - ref[both].astype(np.float64)
    n_ref = max(int(wet_ref.sum()), 1)
    return {
        "wet_mismatch": float((wet_out ^ wet_ref).sum() / n_ref),
        "moved_share": float((np.abs(d) > MOVED_M).sum() / n_ref),
        "rmse_m": float(np.sqrt(np.mean(d * d))) if d.size else 0.0,
        "max_abs_m": float(np.abs(d).max()) if d.size else 0.0,
    }


def judge(cfg: dict, plan, done: list, limits: dict, device: str, control=False) -> dict:
    """Work the judged outputs out again with the reference; the worst gaps.

    ``control`` (True, or a name of :data:`CONTROLS`): that control's output
    stands in for the program's raster.
    """
    from perfbench.reference.tiff import read_geotiff

    # Else the last job completed: no later job has written over its output.
    judged = [(j, r) for j, r in done if j.judged] or done[-1:]
    worst = {"wet_mismatch": 0.0, "moved_share": 0.0, "rmse_m": 0.0, "max_abs_m": 0.0,
             "georef": 0}
    g = plan.geometry
    for job, _ in judged:
        ref = reference(cfg, plan, job.scenario, device)
        if control:
            out = reference(cfg, plan, job.scenario, device, control)
            prof = {"height": out.shape[0], "width": out.shape[1], "west": g["west"],
                    "north": g["north"], "res_x": g["hr_res"], "res_y": g["hr_res"]}
        else:
            out, prof = read_geotiff(job.out_path)
            out = np.where(out == np.float32(g["nodata"]), np.nan, out)
        if (prof["height"], prof["width"]) != ref.shape or any(
            abs(prof[k] - g[v]) > 1e-6
            for k, v in (("west", "west"), ("north", "north"), ("res_x", "hr_res"), ("res_y", "hr_res"))
        ):
            worst["georef"] += 1
            continue
        gaps = compare(out, ref)
        log(f"# judged job {job.index} (scenario {job.scenario}): wet mismatch "
            f"{gaps['wet_mismatch']:.6e}, moved {gaps['moved_share']:.6e}, "
            f"rmse {gaps['rmse_m']:.6e} m, max {gaps['max_abs_m']:.6e} m")
        for k, v in gaps.items():
            worst[k] = max(worst[k], v)
    if judged:
        log(f"# widest gap of the judged jobs {worst['max_abs_m']:.6e} m (not held to a limit)")
    return {
        "judged": {"value": len(judged), "limit": 1},
        **{k: {"value": worst[k], "limit": float(limits[k])} for k in CHECKED},
        "georef": {"value": worst["georef"], "limit": 0},
    }
