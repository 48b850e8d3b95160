"""Training checkpoints and artifacts across the two packages, on the CPU.

- ``save_artifact``: the port's bytes equal the JAX package's for the same
  numpy trees (same sha256), ``float32`` and ``float16``.
- The port's checkpoint round trip is bit for bit; the JAX package loads the
  port's checkpoint (same skeleton as its own); the port restores a JAX
  checkpoint and resumes it: JAX 2 steps → save → port 1 step against JAX's
  3rd step, to the step tolerance of ``test_torch_train_step.py`` (loss rtol
  1e-5, each parameter within 1e-3 of its leaf's max displacement, 0.1% of
  a leaf's elements excepted and held to Adam's bound, ``conv1.b`` to that
  bound alone; counts exactly).
- The exported inference artifact runs in ``EngineTorch(device="cpu")``; an
  eval after a step sees the step's weights (the fused tail's weight pack is
  rebuilt); ``hr_tail`` refuses a tensor that requires grad; the inference
  forward builds no graph; ``examples/train_model_torch.py`` runs its loop on
  the CPU and leaves a checkpoint the port restores.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

import jax

from floodsr_tpu.nn.checkpoint import load_artifact as load_artifact_jax
from floodsr_tpu.nn.checkpoint import save_artifact as save_artifact_jax
from floodsr_tpu.nn.resunet import ResUNetConfig as ResUNetConfigJax
from floodsr_tpu.nn.resunet import init_resunet as init_resunet_jax
from floodsr_tpu.train import trainer as tj
from floodsr_tpu_torch.nn.checkpoint import params_from_jax, params_to_jax, save_artifact
from floodsr_tpu_torch.nn.resunet import ResUNet, ResUNetConfig
from floodsr_tpu_torch.ops.kernels.hr_tail import hr_tail, pack_hr_tail_weights
from floodsr_tpu_torch.parallel.mesh import make_mesh
from floodsr_tpu_torch.train import trainer as tt

pytestmark = pytest.mark.unit

TINY = dict(
    base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
    fuse_filters=8, fuse_blocks=1, scale=4, lr_tile=8,
)
NARROW = dict(TINY, fuse_blocks=2, hr_s2d=2)


def _batch(cfg: dict, n: int = 3, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    lr, hr = cfg["lr_tile"], cfg["lr_tile"] * cfg["scale"]
    return {
        "depth_lr": rng.uniform(0, 1, (n, lr, lr)).astype(np.float32),
        "dem_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
        "target_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
    }


def _paths(tree) -> dict[str, np.ndarray]:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def _sha(fp) -> str:
    return hashlib.sha256(fp.read_bytes()).hexdigest()


@pytest.mark.parametrize("store_dtype", [None, "float16"])
def test_save_artifact_writes_the_jax_packages_bytes(tmp_path, store_dtype):
    cfg = ResUNetConfigJax(**NARROW)
    tcfg = tj.TrainConfig(total_steps=10, weight_decay=0.01)
    state = tj.init_train_state(1, cfg, tcfg)
    state, _ = tj.make_train_step(cfg, tcfg, donate=False)(state, _batch(NARROW))
    host = jax.tree.map(np.asarray, state)
    # a training payload (int32 counts, optax's chain of named tuples) and BN state
    payload = {"params": host.params, "opt_state": host.opt_state}
    meta = {"train_step": 1, "note": "same bytes", "nested": {"b": [1, 2], "a": 0.5}}
    want = save_artifact_jax(tmp_path / "jax.fsrz", cfg, payload, host.model_state, meta,
                             store_dtype=store_dtype)
    got = save_artifact(tmp_path / "port.fsrz", ResUNetConfig(**NARROW), payload,
                        host.model_state, meta, store_dtype=store_dtype)
    assert _sha(got) == _sha(want)
    with pytest.raises(ValueError):
        save_artifact(tmp_path / "x.fsrz", ResUNetConfig(**NARROW), payload, {}, store_dtype="int8")


def _trained_port_state(cfg: dict, steps: int = 2, tcfg=None):
    tcfg = tcfg or tt.TrainConfig(total_steps=10, base_lr=1e-3)
    state = tt.init_train_state(0, ResUNetConfig(**cfg), tcfg, device="cpu")
    step = tt.make_train_step(ResUNetConfig(**cfg), tcfg)
    for i in range(steps):
        state, _ = step(state, _batch(cfg, seed=i))
    return state, step


def test_port_checkpoint_round_trip_is_bit_equal(tmp_path):
    state, step = _trained_port_state(TINY)
    fp = tt.save_train_state(tmp_path / "ckpt.fsrz", state, ResUNetConfig(**TINY), {"run": "a"})
    restored, cfg = tt.restore_train_state(fp, tt.TrainConfig(total_steps=10), device="cpu")
    assert cfg == ResUNetConfig(**TINY) and restored.step == state.step == 2
    for (k, a), (k2, b) in zip(state.model.state_dict().items(), restored.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    assert all(p.requires_grad for p in restored.model.parameters())
    assert sorted(restored.model_state) == sorted(state.model_state)
    want = tt.opt_state_to_numpy(state.opt_state)
    got = tt.opt_state_to_numpy(restored.opt_state)
    w, g = _paths(want), _paths(got)
    assert list(w) == list(g)
    assert all(np.array_equal(w[k], g[k]) and w[k].dtype == g[k].dtype for k in w)
    # the restored state steps exactly as the original does
    b = _batch(TINY, seed=9)
    _, m1 = step(state, b)
    _, m2 = step(restored, b)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, c in zip(state.model.parameters(), restored.model.parameters()):
        assert torch.equal(a, c)


def test_jax_package_loads_the_ports_training_checkpoint(tmp_path):
    tcfg_t = tt.TrainConfig(total_steps=10, base_lr=1e-3)
    state, _ = _trained_port_state(TINY, tcfg=tcfg_t)
    fp = tt.save_train_state(tmp_path / "port.fsrz", state, ResUNetConfig(**TINY))
    restored, cfg = tj.restore_train_state(fp, tj.TrainConfig(total_steps=10))
    assert cfg == ResUNetConfigJax(**TINY) and int(restored.step) == 2
    params, model_state = params_to_jax(state.model.state_dict())
    for want, got in ((params, restored.params), (model_state, restored.model_state)):
        w, g = _paths(want), _paths(got)
        assert list(w) == list(g)
        assert all(np.array_equal(w[k], g[k]) for k in w)
    # the same skeletons as a checkpoint the JAX package writes itself
    state_j = tj.init_train_state(0, ResUNetConfigJax(**TINY), tj.TrainConfig(total_steps=10))
    fp_j = tj.save_train_state(tmp_path / "jax.fsrz", state_j, ResUNetConfigJax(**TINY))
    mj, mt = load_artifact_jax(fp_j)["manifest"], load_artifact_jax(fp)["manifest"]
    assert mt["params_skeleton"] == mj["params_skeleton"]
    assert mt["state_skeleton"] == mj["state_skeleton"]
    (count, mu, _), (sched,) = restored.opt_state[-1]
    assert int(count) == int(sched) == 2 and mu.keys() == params.keys()


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_port_resumes_a_jax_checkpoint(tmp_path, weight_decay):
    tcfg = dict(total_steps=10, base_lr=1e-3, weight_decay=weight_decay)
    cj = ResUNetConfigJax(**TINY)
    state_j = tj.init_train_state(0, cj, tj.TrainConfig(**tcfg))
    step_j = tj.make_train_step(cj, tj.TrainConfig(**tcfg), donate=False)
    for i in range(2):
        state_j, _ = step_j(state_j, _batch(TINY, seed=i))
    fp = tj.save_train_state(tmp_path / "jax.fsrz", state_j, cj)
    state_t, cfg = tt.restore_train_state(fp, tt.TrainConfig(**tcfg), device="cpu")
    assert state_t.step == 2
    before = _paths(jax.tree.map(np.asarray, state_j.params))
    b = _batch(TINY, seed=2)
    state_j, mj = step_j(state_j, b)
    state_t, mt = tt.make_train_step(cfg, tt.TrainConfig(**tcfg))(state_t, b)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-5)
    assert state_t.step == int(state_j.step) == 3
    got = _paths(params_to_jax(state_t.model.state_dict())[0])
    for key, w in _paths(state_j.params).items():
        move = np.abs(w - before[key]).max()
        assert np.abs(got[key] - before[key]).max() <= 3.2 * tcfg["base_lr"], key
        if key.endswith("['conv1']['b']"):
            continue
        off = np.abs(got[key] - w) > 1e-3 * move
        assert off.sum() <= max(1, 1e-3 * off.size), (key, off.sum())
    (count, _, _), (sched,) = tt.opt_state_to_numpy(state_t.opt_state)[-1]
    assert int(count) == int(sched) == 3
    with pytest.raises(ValueError):  # a chain of the other length
        other = dict(tcfg, weight_decay=0.0 if weight_decay else 0.01)
        tt.restore_train_state(fp, tt.TrainConfig(**other), device="cpu")


def test_exported_artifact_runs_in_engine_torch(tmp_path):
    from floodsr_tpu_torch.engine import EngineTorch

    state, _ = _trained_port_state(NARROW, steps=1)
    fp = tt.export_inference_artifact(tmp_path / "infer.fsrz", state, ResUNetConfig(**NARROW),
                                      {"exported": True}, store_dtype="float16")
    art = load_artifact_jax(fp)
    assert art["manifest"]["metadata"] == {"exported": True} and "opt_state" not in art["params"]
    eng = EngineTorch(fp, max_batch=2, device="cpu")
    rng = np.random.default_rng(0)
    r = eng.run_tile(
        rng.uniform(0, 2, (8, 8)).astype(np.float32),
        rng.uniform(100, 400, (32, 32)).astype(np.float32),
    )
    assert r["prediction_m"].shape == (32, 32) and np.isfinite(r["prediction_m"]).all()
    eng.close()


def test_eval_after_a_step_sees_the_steps_weights():
    tcfg = tt.TrainConfig(total_steps=10, base_lr=1e-2)
    state, step = _trained_port_state(NARROW, steps=1, tcfg=tcfg)
    eval_step = tt.make_eval_step(ResUNetConfig(**NARROW), tcfg)
    batch = _batch(NARROW, seed=5)
    before = eval_step(state, batch)
    assert state.model._tail_pack is not None  # the fused tail's pack is cached
    state, _ = step(state, _batch(NARROW, seed=6))
    after = eval_step(state, batch)
    fresh = ResUNet(ResUNetConfig(**NARROW))
    fresh.load_state_dict(state.model.state_dict())
    want = eval_step(tt.TrainState(0, fresh, {}, []), batch)
    assert all(torch.equal(after[k], want[k]) or after[k].isnan() for k in want)
    assert not torch.equal(before["mse_m2"], after["mse_m2"])


def test_hr_tail_refuses_tensors_that_require_grad():
    model = ResUNet(ResUNetConfig(**NARROW))
    weights = pack_hr_tail_weights(model.fuse[0], model.fuse[1], model.head, bn_eps=1e-3)
    assert not any(w.requires_grad for w in weights)
    sr = torch.zeros(1, 4, 4, 16)
    dem = torch.zeros(1, 4, 4, 8)
    hr_tail(sr, dem, *weights)  # plain version on the CPU
    with pytest.raises(ValueError, match="requires grad"):
        hr_tail(sr.requires_grad_(True), dem, *weights)
    weights[2] = weights[2].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        hr_tail(sr.detach(), dem, *weights)


def test_inference_builds_no_graph_and_training_entry_points_need_cuda_or_cpu():
    state, _ = _trained_port_state(NARROW, steps=0)
    assert all(p.requires_grad for p in state.model.parameters())
    b = {k: torch.from_numpy(v)[..., None] for k, v in _batch(NARROW).items()}
    out = state.model(b["depth_lr"], b["dem_hr"])
    assert not out.requires_grad and out.grad_fn is None
    pred, _ = state.model.forward_train(b["depth_lr"], b["dem_hr"])
    assert pred.grad_fn is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt.init_train_state(0, ResUNetConfig(**TINY), tt.TrainConfig())
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt.stage_dataset_to_device(None, [])
    # mesh=, as in the JAX package: a mesh of the CPU runs the steps there; the
    # default mesh is the GPUs'; anything else is refused when the step is built
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()
    mesh = make_mesh(devices=[torch.device("cpu")] * 3)
    state = tt.init_train_state(0, ResUNetConfig(**TINY), tt.TrainConfig(), device="cpu")
    batch = _batch(TINY)
    for make in (tt.make_train_step, tt.make_eval_step):
        out = make(ResUNetConfig(**TINY), tt.TrainConfig(), mesh=mesh)(state, batch)
        metrics = out[1] if make is tt.make_train_step else out
        assert all(v.device.type == "cpu" and np.isfinite(float(v)) for v in metrics.values())
        with pytest.raises(TypeError, match="Mesh"):
            make(ResUNetConfig(**TINY), tt.TrainConfig(), mesh=object())


def test_example_trains_on_the_cpu(tmp_path, monkeypatch, capsys):
    import importlib.util
    import tempfile
    from pathlib import Path

    fp = Path(__file__).resolve().parents[1] / "examples" / "train_model_torch.py"
    spec = importlib.util.spec_from_file_location("train_model_torch", fp)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.setattr(tempfile, "mkdtemp", lambda: str(tmp_path))
    assert example.main(["4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "validation:" in out and "loss=" in out
    assert (tmp_path / "train_ckpt.fsrz").exists() and (tmp_path / "model_infer.fsrz").exists()
    restored, _ = tt.restore_train_state(tmp_path / "train_ckpt.fsrz", tt.TrainConfig(total_steps=4),
                                         device="cpu")
    assert restored.step == 4
