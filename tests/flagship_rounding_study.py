"""Where the port and the JAX package part on the flagship artifact, on the CPU.

Run from the root of the repository:

    JAX_PLATFORMS=cpu python tests/flagship_rounding_study.py               # stages
    JAX_PLATFORMS=cpu python tests/flagship_rounding_study.py --no-mkldnn   # same, no oneDNN
    JAX_PLATFORMS=cpu python tests/flagship_rounding_study.py --policies    # ~2.5 min

Stages: both packages' ``tohr`` on ``tests/data/synth_flagship`` in f32, with
the inputs of each scene executor captured; then, on the same inputs, each
stage of both packages against a float64 evaluation of the same network (the
port's modules in double): the DEM stats, the trunk's features by tile, the
tail's output by tile, each operation of the tail on the tiles with the
largest features, and the finished scene (before the uint16 quantization).

Policies: the ``bfloat16`` and ``mixed`` scenes against the ``float32`` scene
of each package on ``chip_smoke.py``'s policy scene
(``scene_inputs(tmp, 0, 4096, tag="_policy")``, the flagship artifact), the
distance ``chip_smoke.py::POLICY_RMSE_CEILING_M`` is derived from.

Prints one JSON line. Imports both packages, as the tests do.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("FLOODSR_AOT_CACHE", "0")  # the executor must stay a Python callable

import jax  # noqa: E402
import torch  # noqa: E402

import floodsr_tpu.engine.scene as jax_scene  # noqa: E402
import floodsr_tpu_torch.engine.scene as torch_scene  # noqa: E402
from floodsr_tpu.nn import resunet as jr  # noqa: E402
from floodsr_tpu.ops import normalize as jn  # noqa: E402
from floodsr_tpu.tohr import tohr as tohr_jax  # noqa: E402
from floodsr_tpu_torch.nn.resunet import conv2d_same, conv_transpose_nhwc, split_scale  # noqa: E402
from floodsr_tpu_torch.tohr import tohr as tohr_torch  # noqa: E402

CASE = ROOT / "tests" / "data" / "synth_flagship"


def rms(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def amax(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def capture_scenes(out_dir: Path) -> tuple[dict, dict]:
    """Run both packages' ``tohr`` and keep each scene executor's inputs and output."""
    cap = {}
    build = jax_scene.build_scene_executor
    call = torch_scene.SceneExecutor.__call__

    def build_capturing(cfg, **kw):
        fn, chunk = build(cfg, **kw)

        def run(params, state, depth, dem, idx):
            out = fn(params, state, depth, dem, idx)
            cap["jax"] = dict(cfg=cfg, params=params, state=state, out=np.asarray(out[0]))
            return out

        return run, chunk

    def call_capturing(self, depth, dem, idx):
        out = call(self, depth, dem, idx)
        cap["torch"] = dict(ex=self, depth=depth.numpy().copy(), dem=dem.numpy().copy(),
                            idx=idx, out=out[0].numpy().copy(), stats=out[1].numpy())
        return out

    spec = json.loads((CASE / "case_spec.json").read_text())
    kw = dict(
        model_version="ResUNet_16x_DEM", model_fp=CASE.parent / spec["model_artifact"],
        depth_lr_fp=CASE / spec["inputs"]["lowres_fp"], dem_hr_fp=CASE / spec["inputs"]["dem_fp"],
    )
    jax_scene.build_scene_executor = build_capturing
    torch_scene.SceneExecutor.__call__ = call_capturing
    try:
        tohr_torch(output_fp=out_dir / "torch.tif", device="cpu", **kw)
        tohr_jax(output_fp=out_dir / "jax.tif", **kw)
    finally:
        jax_scene.build_scene_executor = build
        torch_scene.SceneExecutor.__call__ = call
    return cap["jax"], cap["torch"]


def tail_ops(model, f, dem, dtype) -> dict:
    """The tail's operations one by one, unfused (``nn.ResBlock``), in ``dtype``."""
    cfg = model.cfg
    s2d = int(cfg.hr_s2d)
    s0, s1 = split_scale(cfg.scale // s2d)
    x = torch.from_numpy(np.ascontiguousarray(f)).to(dtype)
    ops = {"sr_up1": torch.relu(conv_transpose_nhwc(x, model.sr_up1, s0))}
    ops["sr_up2"] = torch.relu(conv_transpose_nhwc(ops["sr_up1"], model.sr_up2, s1))
    d = torch.from_numpy(np.ascontiguousarray(dem)).to(dtype)
    n, hh, ww, _ = d.shape
    d = d.reshape(n, hh // s2d, s2d, ww // s2d, s2d, 1).permute(0, 1, 3, 2, 4, 5)
    d = d.reshape(n, hh // s2d, ww // s2d, s2d * s2d)
    ops["dem_feat"] = torch.relu(conv2d_same(d.permute(0, 3, 1, 2), model.dem_feat)).permute(0, 2, 3, 1)
    y = torch.cat([ops["sr_up2"], ops["dem_feat"]], -1).permute(0, 3, 1, 2)
    for i, block in enumerate(model.fuse):
        y = block(y, cfg.bn_eps)
        ops[f"fuse{i}"] = y.permute(0, 2, 3, 1)
    out = conv2d_same(y, model.head).permute(0, 2, 3, 1)
    ops["head"] = out.reshape(n, hh // s2d, ww // s2d, s2d, s2d).permute(0, 1, 3, 2, 4).reshape(n, hh, ww)
    return {k: v.numpy() for k, v in ops.items()}


def stages() -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        J, T = capture_scenes(Path(tmp))
    ex, cfg, P, S = T["ex"], J["cfg"], J["params"], J["state"]
    model, model64 = ex.model, copy.deepcopy(ex.model).double()
    tile, lr_tile, scale = cfg.hr_tile, cfg.lr_tile, cfg.scale
    y0, x0 = np.asarray(T["idx"]["y0"]), np.asarray(T["idx"]["x0"])
    n = len(y0)
    dem = np.stack([T["dem"][y:y + tile, x:x + tile] for y, x in zip(y0, x0)])
    depth = np.stack([T["depth"][y // scale:y // scale + lr_tile, x // scale:x // scale + lr_tile]
                      for y, x in zip(y0, x0)])
    md, pct = ex.max_depth, ex.dem_pct_clip
    # The JAX package's phase 1 inputs feed every later stage of both.
    depth_norm = np.asarray(jax.jit(lambda a: jn.scale_depth_log1p(a, md))(depth))[..., None]
    dem_norm, st = jax.jit(lambda a: jn.normalize_dem_batch(a, pct))(dem)
    dem_norm = np.asarray(dem_norm)[..., None]
    stats_jax = np.stack([np.asarray(st[k]) for k in ("p_clip", "dem_min", "dem_max")], -1)

    trunk = jax.jit(lambda p, s, d, m: jr.resunet_trunk_apply(p, s, d, m, cfg)[0])
    tail = jax.jit(lambda p, s, f, m: jr.resunet_tail_apply(p, s, f, m, cfg, pallas_tail=False)[0])
    f_j = np.asarray(trunk(P, S, depth_norm, dem_norm))
    f_t = model.trunk(torch.from_numpy(depth_norm), torch.from_numpy(dem_norm)).numpy()
    f_64 = model64._trunk_body(torch.from_numpy(depth_norm).double(),
                               torch.from_numpy(dem_norm).double(), None).numpy()
    o_j = np.asarray(tail(P, S, f_j, dem_norm))[..., 0]
    o_t = model.tail(torch.from_numpy(f_j), torch.from_numpy(dem_norm)).numpy()[..., 0]
    o_64 = tail_ops(model64, f_j, dem_norm, torch.float64)["head"]
    report = {
        "mkldnn": torch.backends.mkldnn.enabled,
        "stats_port_minus_jax": (T["stats"] - stats_jax).tolist(),
        "trunk": [{
            "tile": [int(y0[i]), int(x0[i])], "max_abs_feature": float(np.abs(f_64[i]).max()),
            "jax_vs_f64": amax(f_j[i], f_64[i]), "port_vs_f64": amax(f_t[i], f_64[i]),
            "port_vs_jax": amax(f_t[i], f_j[i]),
        } for i in range(n)],
        "tail_on_jax_features": [{
            "tile": [int(y0[i]), int(x0[i])], "jax_vs_f64": amax(o_j[i], o_64[i]),
            "port_vs_f64": amax(o_t[i], o_64[i]), "port_vs_jax": amax(o_t[i], o_j[i]),
        } for i in range(n)],
    }
    # Each operation of the tail, on the two tiles with the largest features,
    # fed the JAX package's output of the operation before it.
    big = list(np.argsort([-np.abs(f_64[i]).max() for i in range(n)])[:2])
    x, dem_big = f_j[big], dem_norm[big]
    s0, s1 = split_scale(cfg.scale // int(cfg.hr_s2d))

    def up(params, v, stride):
        return np.asarray(jax.jit(lambda p_, v_: jax.nn.relu(jr._conv_transpose(p_, v_, stride)))(params, v))

    def up_port(m, v, conv, stride, dtype):
        return torch.relu(conv_transpose_nhwc(torch.from_numpy(v).to(dtype), getattr(m, conv), stride)).numpy()

    j1 = up(P["sr_up1"], x, s0)
    per_op = {"sr_up1": (j1, up_port(model, x, "sr_up1", s0, torch.float32),
                         up_port(model64, x, "sr_up1", s0, torch.float64))}
    j2 = up(P["sr_up2"], j1, s1)
    per_op["sr_up2"] = (j2, up_port(model, j1, "sr_up2", s1, torch.float32),
                        up_port(model64, j1, "sr_up2", s1, torch.float64))
    y = np.concatenate([j2, tail_ops(model64, x, dem_big, torch.float64)["dem_feat"].astype(np.float32)], -1)
    for i in range(len(model.fuse)):
        jb = np.asarray(jax.jit(lambda p_, s_, v: jr._res_block(p_, s_, v, cfg)[0])(
            P["fuse"][i], S["fuse"][i], y))
        per_op[f"fuse{i}"] = (jb, *(
            m.fuse[i](torch.from_numpy(y).to(dt).permute(0, 3, 1, 2), cfg.bn_eps).permute(0, 2, 3, 1).numpy()
            for m, dt in ((model, torch.float32), (model64, torch.float64))
        ))
        y = jb
    report["tail_ops_largest_tiles"] = {
        name: {
            "tiles": [[int(y0[i]), int(x0[i])] for i in big], "max_abs_ref": float(np.abs(r).max()),
            "jax_vs_f64_rms": rms(a, r), "port_vs_f64_rms": rms(b, r),
            "jax_vs_f64_max": amax(a, r), "port_vs_f64_max": amax(b, r),
        }
        for name, (a, b, r) in per_op.items()
    }
    # The whole scene in float64: the float64 network's tiles through the
    # port's mosaic in double, clipped; both packages' uint16 scenes dequantized.
    o_6464 = tail_ops(model64, f_64.astype(np.float64), dem_norm, torch.float64)["head"]
    pred64 = np.clip(np.expm1(np.clip(o_6464, 0.0, 1.0) * np.log1p(md)), 0.0, md)
    carry = [c.double() for c in ex._mosaic_init(torch.device("cpu"))]
    ex._mosaic_accumulate(carry, ex._chunk_indices(T["idx"], torch.device("cpu"))(0, n),
                          torch.from_numpy(pred64))
    acc, py, px = carry
    wsum = py[:, None] * px[None, :]
    scene64 = torch.where(wsum > 0, acc / torch.clamp_min(wsum, 1e-6), torch.zeros_like(acc))
    scene64 = scene64.clamp(0.0, md).numpy()
    h, w = scene64.shape
    scenes = {k: v["out"][:h, :w].astype(np.float64) * md / 65535.0 for k, v in (("jax", J), ("port", T))}
    report["scene"] = {
        f"{k}_vs_f64": {"max": amax(v, scene64), "rmse": rms(v, scene64),
                        "at": [int(i) for i in np.unravel_index(np.abs(v - scene64).argmax(), v.shape)]}
        for k, v in scenes.items()
    }
    d = np.abs(scenes["port"] - scenes["jax"])
    report["scene"]["port_vs_jax"] = {
        "max": float(d.max()), "rmse": rms(scenes["port"], scenes["jax"]),
        "at": [int(i) for i in np.unravel_index(d.argmax(), d.shape)],
        "over_2e-4": int((d > 2e-4).sum()),
    }
    return report


def policies() -> dict:
    import chip_smoke
    from floodsr_tpu_torch.io import read_raster

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        dem_fp, depth_fp = chip_smoke.scene_inputs(tmp, 0, chip_smoke.SCENE_SIZE, tag="_policy")
        for name, tohr, extra in (("jax", tohr_jax, {}), ("port", tohr_torch, {"device": "cpu"})):
            preds = {}
            for dtype in ("float32", "bfloat16", "mixed"):
                fp = tmp / f"{name}_{dtype}.tif"
                tohr(model_version="ResUNet_16x_DEM", model_fp=chip_smoke.FLAGSHIP,
                     depth_lr_fp=depth_fp, dem_hr_fp=dem_fp, output_fp=fp,
                     engine_options={"compute_dtype": dtype}, **extra)
                preds[dtype] = read_raster(fp)[0]
            out[name] = {
                dtype: {"rmse_vs_f32_m": chip_smoke.rmse_m(preds[dtype], preds["float32"]),
                        "max_abs_vs_f32_m": amax(preds[dtype], preds["float32"])}
                for dtype in ("bfloat16", "mixed")
            }
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-mkldnn", action="store_true",
                        help="run the port's CPU convolutions without oneDNN")
    parser.add_argument("--policies", action="store_true",
                        help="the precision policies' distance to f32 instead of the stages")
    args = parser.parse_args(argv)
    torch.backends.mkldnn.enabled = not args.no_mkldnn
    print(json.dumps(policies() if args.policies else stages()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
