"""The ResUNet family (``ResUNet_16x_DEM``): what the harness knows of a cell
that serves the 16x DEM-conditioned network, and of nothing else.

The configuration's ``architecture`` (the network's shapes), ``weights`` (the
committed artifact or a draw), ``policy`` (the engine's precision and batch)
and ``preprocess`` (the depth range) are read here and in the modules this
one imports: ``harness/weights.py``, ``harness/work.py``, ``harness/synth.py``
and the plain reference under ``reference/``. See ``harness/spec.py::family``
for what a family module gives.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from perfbench.harness import weights, work
from perfbench.harness.synth import depth_lr


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def artifact(cfg: dict, workdir: Path, device) -> Path:
    """The ``.fsrz`` the cell serves: the committed file (checked), or a draw."""
    return weights.artifact_for(cfg, workdir, device)


def service_options(cfg: dict) -> dict:
    """The engine's options from the configuration's ``policy``."""
    policy = cfg["policy"]
    return {"compute_dtype": policy["compute_dtype"], "max_batch": int(policy["max_batch"])}


def warmup_shapes(cfg: dict, plan) -> list[tuple[int, int]]:
    """The one scene geometry the mix sends: the LR grid times the scale."""
    lr_shape, scale = plan.geometry["lr_shape"], cfg["architecture"]["scale"]
    return [(lr_shape[0] * scale, lr_shape[1] * scale)]


def lr_raster(cfg: dict, dem: np.ndarray, base_m: float, offset_m: float, tilt_m: float,
              lr_shape) -> np.ndarray:
    """The scenario's LR depth, clipped to the configuration's depth range."""
    return depth_lr(dem, base_m, offset_m, tilt_m, lr_shape, float(cfg["preprocess"]["max_depth"]))


def per_job(cfg: dict, plan) -> dict:
    """The network's shapes and the windows of one job's scene, for the work counts."""
    arch = cfg["architecture"]
    return {"arch": arch, "windows_per_job": work.n_windows(arch, plan.geometry["lr_shape"])}


def _tf32(on: bool) -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def judge(cfg: dict, plan, done: list, limits: dict, device: str, control: bool) -> dict:
    """Work the judged outputs out again with the reference; the worst gaps.

    The reference runs in float32 with TF32 off. ``control``: the reference
    with TF32 on stands in for the program's raster.
    """
    from perfbench.reference.artifact import read_artifact
    from perfbench.reference.model import Reference
    from perfbench.reference.pipeline import run_request
    from perfbench.reference.tiff import read_geotiff

    # Else the last job completed: no later job has written over its output.
    judged = [(j, r) for j, r in done if j.judged] or done[-1:]
    worst = {"rmse_m": 0.0, "max_abs_m": 0.0, "georef": 0}
    g = plan.geometry
    if judged:
        arch, arrays = read_artifact(Path(judged[0][1]["model_fp"]))
        model = Reference(arch, arrays, device)
        for job, _ in judged:
            sc = plan.scenarios[job.scenario]
            inputs = (model, plan.areas[sc.area].dem, sc.lr, g, cfg)
            _tf32(False)
            ref = run_request(*inputs)
            if control:
                _tf32(True)
                out = run_request(*inputs)
                _tf32(False)
                prof = {"height": out.shape[0], "width": out.shape[1], "west": g["west"],
                        "north": g["north"], "res_x": g["hr_res"], "res_y": g["hr_res"]}
            else:
                out, prof = read_geotiff(job.out_path)
            if (prof["height"], prof["width"]) != ref.shape or any(
                abs(prof[k] - g[v]) > 1e-6
                for k, v in (("west", "west"), ("north", "north"), ("res_x", "hr_res"), ("res_y", "hr_res"))
            ):
                worst["georef"] += 1
                continue
            d = out.astype(np.float64) - ref.astype(np.float64)
            rmse, mx = float(np.sqrt(np.mean(d * d))), float(np.abs(d).max())
            log(f"# judged job {job.index} (scenario {job.scenario}): rmse {rmse:.6e} m, max {mx:.6e} m")
            worst["rmse_m"] = max(worst["rmse_m"], rmse)
            worst["max_abs_m"] = max(worst["max_abs_m"], mx)
        del model
    return {
        "judged": {"value": len(judged), "limit": 1},
        "rmse_m": {"value": worst["rmse_m"], "limit": float(limits["rmse_m"])},
        "max_abs_m": {"value": worst["max_abs_m"], "limit": float(limits["max_abs_m"])},
        "georef": {"value": worst["georef"], "limit": 0},
    }
