"""Training on a mesh on the card: the sharded train step and eval step over
``[cuda:0] * 4``, held against the single step on the card.

Every test here needs an NVIDIA GPU and skips without one; the two-GPU case
skips under two devices. The file imports no JAX; run it beside the other
CUDA-only tests:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_train_mesh.py``.

A mesh of ``[cuda:0] * 4`` runs four entries on one card through the code that
distinct GPUs run (every entry holds copies of its own). Tolerances of one
step, those of ``tests/test_torch_train_mesh.py``: the loss and the gradient
norm to rtol 1e-5, every parameter within Adam's bound ``3.2 · lr`` of its
start and within 1e-3 of its leaf's largest displacement except 0.1% of the
leaf's elements (at least one; ``conv1.b``, whose true gradient is 0, to
Adam's bound alone), each Adam moment within 1e-3 of its leaf's largest
(``conv1.b`` of the largest of its kind), the running stats within 1e-5 (and
``bn2.mean`` by ``(1 − momentum) · 2 · 3.2 · lr`` more). On the card each of
these is widened by the single step's own distance from the same step on the
CPU, on that leaf (twice it: both card steps carry it): cuDNN's strict-f32
algorithms return rounding noise where the CPU's gradient is exactly 0 (an
input channel that ReLU zeroes at every position a 3×3 tap reaches on a 2×2
map), and Adam's first step moves such an element by ``lr`` one way or the
other; so a parameter that moved another way than the single step's must be
one whose CPU gradient lies inside that noise (``tools/
train_mesh_grad_noise.py`` measures it). The sharded eval launches K1 once
per ``dp`` row; its metrics agree with the unsharded eval's to rtol 1e-3
(cuDNN picks the trunk's algorithms by batch size).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from floodsr_tpu_torch.nn.resunet import ResUNetConfig
from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, route_counts
from floodsr_tpu_torch.parallel.mesh import make_mesh
from floodsr_tpu_torch.train import trainer as tt

pytestmark = pytest.mark.cuda

NARROW = dict(
    base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
    fuse_filters=8, fuse_blocks=2, scale=4, lr_tile=8, hr_s2d=2,
)
# the flagship's widths (the fused tail's tensor-core route), one LR tile of 32²
FLAGSHIP = dict(
    base_filters=32, levels=4, enc_blocks=2, dec_blocks=2, fuse_filters=32,
    fuse_blocks=2, scale=16, lr_tile=32, hr_s2d=4,
)
TCFG = dict(total_steps=100, base_lr=1e-3)
LR = TCFG["base_lr"]
MESHES = {"dp4": 1, "dp2_tp2": 2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: training on a mesh of the card")
    return torch.device("cuda", 0)


def _batch(cfg: dict, n: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    lr, hr = cfg["lr_tile"], cfg["lr_tile"] * cfg["scale"]
    return {
        "depth_lr": rng.uniform(0, 1, (n, lr, lr)).astype(np.float32),
        "dem_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
        "target_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
    }


def _leaves(state) -> dict[str, np.ndarray]:
    whole = tt.unshard_train_state(state)
    out = {f"p.{k}": v.cpu().numpy().copy() for k, v in whole.model.state_dict().items()}
    (count, mu, nu), (sched,) = whole.opt_state[-1]
    out.update({f"mu.{k}": v.cpu().numpy().copy() for k, v in mu.items()})
    out.update({f"nu.{k}": v.cpu().numpy().copy() for k, v in nu.items()})
    out["counts"] = np.array([int(count), int(sched)])
    return out


def _hold(got: dict, want: dict, cpu: dict, start: dict) -> None:
    """``got`` (a sharded step) against ``want`` (the single step on the
    card), each tolerance widened by the single step's own distance from the
    same step on the CPU (``cpu``) on that leaf: see the module docstring."""
    bound = 3.2 * LR
    tops = {kind: max(np.abs(v).max() for k, v in want.items() if k.startswith(kind))
            for kind in ("mu.", "nu.")}
    for key, w in want.items():
        g = got[key]
        noise = key.endswith("conv1.b")
        if key == "counts":
            assert np.array_equal(g, w)
            continue
        card = 2 * np.abs(w - cpu[key]).max()
        if key.startswith(("mu.", "nu.")):
            scale = tops[key[:3]] if noise else np.abs(w).max()
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * scale + card, err_msg=key)
        elif key.endswith((".mean", ".var")):
            atol = 1e-5 + (0.02 * bound if key.endswith("bn2.mean") else 0.0)
            np.testing.assert_allclose(g, w, rtol=0, atol=atol + card, err_msg=key)
        else:
            assert np.abs(g - start[key]).max() <= bound * 1.0001, key
            if noise:
                continue
            mu = "mu." + key[2:]
            inside = np.abs(cpu[mu]) <= max(np.abs(got[mu] - cpu[mu]).max(), np.abs(want[mu] - cpu[mu]).max())
            off = np.abs(g - w) > 1e-3 * np.abs(w - start[key]).max()
            assert (off & ~inside).sum() <= max(1, 1e-3 * off.size), (key, off.sum(), (off & inside).sum())


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_mesh_step_on_one_card_matches_the_single_step(cuda_device, mesh_name):
    cfg, tcfg = ResUNetConfig(**NARROW), tt.TrainConfig(**TCFG)
    b = _batch(NARROW, 8, seed=1)
    single = tt.init_train_state(0, cfg, tcfg, device="cuda")
    start = _leaves(single)
    mesh = make_mesh(devices=[cuda_device] * 4, tp=MESHES[mesh_name])
    placed = tt.shard_train_state(single, mesh)
    single, want = tt.make_train_step(cfg, tcfg)(single, b)
    placed, got = tt.make_train_step(cfg, tcfg, mesh=mesh)(placed, b)
    cpu, _ = tt.make_train_step(cfg, tcfg)(tt.init_train_state(0, cfg, tcfg, device="cpu"), b)
    assert all(v.device == cuda_device for v in got.values())
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-5)
    _hold(_leaves(placed), _leaves(single), _leaves(cpu), start)
    # replicas bit-equal, pieces on their entries
    for (i, j), entry in np.ndenumerate(placed.entries):
        sd, sd0 = entry.model.state_dict(), placed.entries[0, j].model.state_dict()
        assert all(torch.equal(t, sd0[k]) and t.device == mesh.devices[i, j] for k, t in sd.items())
    assert bool(placed.split) == (MESHES[mesh_name] > 1)


def test_bfloat16_mesh_step_on_one_card(cuda_device):
    cfg, tcfg = ResUNetConfig(**NARROW), tt.TrainConfig(**TCFG)
    b = _batch(NARROW, 8, seed=2)
    single = tt.init_train_state(0, cfg, tcfg, device="cuda")
    placed = tt.shard_train_state(single, make_mesh(devices=[cuda_device] * 4, tp=2))
    single, want = tt.make_train_step(cfg, tcfg, compute_dtype=torch.bfloat16)(single, b)
    placed, got = tt.make_train_step(cfg, tcfg, mesh=placed.mesh, compute_dtype=torch.bfloat16)(placed, b)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-3)
    # f32 products stay strict after a bf16 stage
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_eval_launches_k1_once_per_row(cuda_device, mesh_name):
    cfg, tcfg = ResUNetConfig(**FLAGSHIP), tt.TrainConfig(**TCFG)
    state = tt.init_train_state(3, cfg, tcfg, device="cuda")
    mesh = make_mesh(devices=[cuda_device] * 4, tp=MESHES[mesh_name])
    batch = _batch(FLAGSHIP, 4, seed=4)
    eval_step = tt.make_eval_step(cfg, tcfg, mesh=mesh)
    eval_step(tt.shard_train_state(state, mesh), batch)  # warm
    torch.cuda.synchronize()
    reset_launch_counts()
    got = eval_step(tt.shard_train_state(state, mesh), batch)
    torch.cuda.synchronize()
    dp = mesh.shape["dp"]
    assert launch_counts()["hr_tail"] == route_counts()["hr_tail"]["tensor"] == dp
    want = tt.make_eval_step(cfg, tcfg)(state, batch)
    for key, w in want.items():
        if torch.isfinite(w):
            np.testing.assert_allclose(float(got[key]), float(w), rtol=1e-3, atol=1e-6, err_msg=key)


def test_two_gpus(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: a mesh over distinct devices")
    cfg, tcfg = ResUNetConfig(**NARROW), tt.TrainConfig(**TCFG)
    b = _batch(NARROW, 8, seed=5)
    single = tt.init_train_state(0, cfg, tcfg, device="cuda")
    start = _leaves(single)
    cpu, _ = tt.make_train_step(cfg, tcfg)(tt.init_train_state(0, cfg, tcfg, device="cpu"), b)
    for mesh in (make_mesh(2), make_mesh(2, tp=2)):
        placed = tt.shard_train_state(single, mesh)
        placed, got = tt.make_train_step(cfg, tcfg, mesh=mesh)(placed, b)
        for (i, j), entry in np.ndenumerate(placed.entries):
            assert all(t.device == mesh.devices[i, j] for t in entry.model.state_dict().values())
        ref = tt.init_train_state(0, cfg, tcfg, device="cuda")
        ref, want = tt.make_train_step(cfg, tcfg)(ref, b)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
        _hold(_leaves(placed), _leaves(ref), _leaves(cpu), start)
        reset_launch_counts()
        tt.make_eval_step(cfg, tcfg, mesh=mesh)(placed, b)
        torch.cuda.synchronize()
        assert launch_counts()["hr_tail"] == mesh.shape["dp"]
