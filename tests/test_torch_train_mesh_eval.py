"""The port's eval step on a mesh and the checkpoints of a placed state,
against the JAX package's and the port's own unsharded paths, on the CPU.

One port state is placed on ``make_mesh(devices=[cpu] * 8, tp=2)``, takes a
step and is saved; the JAX package restores that checkpoint, places it as its
multichip dry run does and runs ``make_eval_step(mesh=make_mesh(8, tp=2))`` on
the suite's 8 virtual devices (once per module). Tolerances: the eval metrics
against JAX's as ``tests/test_torch_train_resident.py`` holds them (PSNR and
SSIM to 1e-4 absolute, the others to rtol 1e-4), against the port's unsharded
eval to rtol 1e-5 and 1e-7 absolute (each row runs the forward on its own
samples, so a convolution may sum in another order; ``bias_m`` is a mean of
differences that cancel, 3.7e-3 here, and moves by 5e-6 of itself); a placed
state that took no step saves the same bytes as the unplaced one (sha256); a
restored, placed state steps as the restored state does, to the step
tolerances of ``tests/test_torch_train_mesh.py``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

import jax

from floodsr_tpu.parallel import batch_sharding as batch_sharding_jax
from floodsr_tpu.parallel import make_mesh as make_mesh_jax
from floodsr_tpu.parallel import param_sharding_rules as rules_jax
from floodsr_tpu.parallel import replicated_sharding as replicated_jax
from floodsr_tpu.train import trainer as tj
from floodsr_tpu_torch.nn.checkpoint import params_to_jax
from floodsr_tpu_torch.nn.resunet import ResUNetConfig
from floodsr_tpu_torch.parallel.mesh import make_mesh
from floodsr_tpu_torch.train import trainer as tt

pytestmark = [pytest.mark.unit, pytest.mark.multidev]

# two fuse blocks, the first with a projection: the eval forward's fused tail
NARROW = dict(
    base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
    fuse_filters=8, fuse_blocks=2, scale=4, lr_tile=8, hr_s2d=2,
)
TCFG = dict(total_steps=100, base_lr=1e-3)
CPU = torch.device("cpu")
MESHES = {"dp8": 1, "dp4_tp2": 2}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mesh(tp: int):
    return make_mesh(devices=[CPU] * 8, tp=tp)


def _batch(n: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    lr, hr = NARROW["lr_tile"], NARROW["lr_tile"] * NARROW["scale"]
    return {
        "depth_lr": rng.uniform(0, 1, (n, lr, lr)).astype(np.float32),
        "dem_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
        "target_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
    }


def _sha(fp) -> str:
    return hashlib.sha256(fp.read_bytes()).hexdigest()


def _jax_placed(state, mesh):
    """The state placed with the production rules (the JAX package's dry run)."""
    opt = jax.tree.map(
        lambda leaf: rules_jax(mesh, leaf) if not np.isscalar(leaf) else replicated_jax(mesh),
        state.opt_state, is_leaf=lambda x: hasattr(x, "shape") or np.isscalar(x),
    )
    return tj.TrainState(
        step=jax.device_put(state.step, replicated_jax(mesh)),
        params=jax.tree.map(jax.device_put, state.params, rules_jax(mesh, state.params)),
        model_state=jax.tree.map(jax.device_put, state.model_state, rules_jax(mesh, state.model_state)),
        opt_state=jax.tree.map(jax.device_put, state.opt_state, opt),
    )


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """A port state placed at (dp=4, tp=2), stepped once and saved; the JAX
    package's sharded eval of that checkpoint."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg, tcfg = ResUNetConfig(**NARROW), tt.TrainConfig(**TCFG)
    placed = tt.shard_train_state(tt.init_train_state(4, cfg, tcfg, device="cpu"), _mesh(2))
    placed, _ = tt.make_train_step(cfg, tcfg, mesh=placed.mesh)(placed, _batch(8, seed=70))
    fp = tt.save_train_state(tmp_path_factory.mktemp("mesh_eval") / "placed.fsrz", placed, cfg)
    restored_j, cfg_j = tj.restore_train_state(fp, tj.TrainConfig(**TCFG))
    mesh_j = make_mesh_jax(8, tp=2)
    batch = _batch(8, seed=71)
    want = tj.make_eval_step(cfg_j, tj.TrainConfig(**TCFG), mesh=mesh_j)(
        _jax_placed(restored_j, mesh_j),
        {k: jax.device_put(v, batch_sharding_jax(mesh_j)) for k, v in batch.items()},
    )
    torch.set_num_threads(threads)
    return {"placed": placed, "fp": fp, "batch": batch, "restored_j": restored_j,
            "jax_eval": {k: float(v) for k, v in want.items()}}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_eval_step_on_a_mesh_matches_jax_and_the_unsharded_eval(stepped, mesh_name):
    cfg, tcfg = ResUNetConfig(**NARROW), tt.TrainConfig(**TCFG)
    restored, _ = tt.restore_train_state(stepped["fp"], tcfg, device="cpu")
    mesh = _mesh(MESHES[mesh_name])
    got = tt.make_eval_step(cfg, tcfg, mesh=mesh)(tt.shard_train_state(restored, mesh), stepped["batch"])
    plain = tt.make_eval_step(cfg, tcfg)(restored, stepped["batch"])
    want = stepped["jax_eval"]
    assert sorted(got) == sorted(want) == sorted(plain)
    for key, w in want.items():
        g = float(got[key])
        assert got[key].device == CPU and got[key].shape == ()
        if key in ("psnr", "ssim"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7, err_msg=key)
        np.testing.assert_allclose(g, float(plain[key]), rtol=1e-5, atol=1e-7, err_msg=key)
    # the state placed by the step's own rules and the placed state that stepped
    if mesh_name == "dp4_tp2":
        again = tt.make_eval_step(cfg, tcfg, mesh=mesh)(stepped["placed"], stepped["batch"])
        assert all(torch.equal(again[k], got[k]) for k in got)


@pytest.mark.parametrize("tp", [1, 2])
def test_a_placed_state_that_took_no_step_saves_byte_identical(tmp_path, tp):
    cfg, tcfg = ResUNetConfig(**NARROW), tt.TrainConfig(**TCFG)
    state = tt.init_train_state(5, cfg, tcfg, device="cpu")
    placed = tt.shard_train_state(state, _mesh(tp))
    assert bool(placed.split) == (tp > 1)
    for save in (tt.save_train_state, tt.export_inference_artifact):
        a = save(tmp_path / f"unplaced_{save.__name__}.fsrz", state, cfg, {"note": "x"})
        b = save(tmp_path / f"placed_{save.__name__}.fsrz", placed, cfg, {"note": "x"})
        assert _sha(a) == _sha(b), save.__name__


def test_jax_restores_a_checkpoint_saved_from_a_placed_stepped_state(stepped):
    whole = tt.unshard_train_state(stepped["placed"])
    params, model_state = params_to_jax(whole.model.state_dict())
    restored = jax.tree.map(np.asarray, stepped["restored_j"])
    assert int(restored.step) == 1
    for want, got in ((params, restored.params), (model_state, restored.model_state),
                      (tt.opt_state_to_numpy(whole.opt_state), restored.opt_state)):
        flat_w, flat_g = jax.tree.leaves(want), jax.tree.leaves(got)
        assert len(flat_w) == len(flat_g)
        assert all(np.array_equal(w, g) for w, g in zip(flat_w, flat_g))


def test_restore_place_step_equals_the_unplaced_path(stepped):
    cfg, tcfg = ResUNetConfig(**NARROW), tt.TrainConfig(**TCFG)
    b = _batch(8, seed=72)
    unplaced, _ = tt.restore_train_state(stepped["fp"], tcfg, device="cpu")
    start = {k: v.clone() for k, v in unplaced.model.state_dict().items()}
    placed = tt.shard_train_state(unplaced, _mesh(2))
    unplaced, want = tt.make_train_step(cfg, tcfg)(unplaced, b)
    placed, got = tt.make_train_step(cfg, tcfg, mesh=placed.mesh)(placed, b)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-5)
    assert placed.step == unplaced.step == 2
    g, w = tt.unshard_train_state(placed).model.state_dict(), unplaced.model.state_dict()
    for key, want_t in w.items():
        got_t, s = g[key].numpy(), start[key].numpy()
        if key.endswith((".mean", ".var")):
            atol = 1e-5 + (0.02 * 2 * 3.2 * 1e-3 if key.endswith("bn2.mean") else 0.0)
            np.testing.assert_allclose(got_t, want_t.numpy(), rtol=0, atol=atol, err_msg=key)
            continue
        assert np.abs(got_t - s).max() <= 3.2 * 1e-3 * 1.0001, key  # Adam's bound for one step
        if key.endswith("conv1.b"):
            continue
        off = np.abs(got_t - want_t.numpy()) > 1e-3 * np.abs(want_t.numpy() - s).max()
        assert off.sum() <= max(1, 1e-3 * off.size), (key, off.sum())
