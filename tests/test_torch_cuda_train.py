"""The port's training path on the card, held against ``device="cpu"``.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX; run it beside the other CUDA-only tests:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_train.py``.

Tolerances of one step, card against CPU (cuDNN and oneDNN sum the f32
convolutions in other orders): loss rtol 1e-4, ``grad_norm`` rtol 1e-3, BN
running stats 1e-4 abs, each Adam moment within 1e-3 of the larger of its
leaf's max and ``MOMENT_FLOOR`` of the largest moment of its kind (a leaf
whose gradient is rounding noise, such as every block's ``conv1.b``, which
feeds a batch norm alone). Adam's first update divides every element by its
own ``|g|``, so an element whose gradient is noise may move by ``lr`` either
way on the two devices: the parameters are held instead to optax's update
computed (in float64) from the card's own moments, within 1e-3 of ``lr``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from floodsr_tpu_torch.nn.checkpoint import params_to_jax
from floodsr_tpu_torch.nn.resunet import ResUNetConfig
from floodsr_tpu_torch.ops.kernels import reset_launch_counts, route_counts
from floodsr_tpu_torch.parallel.streaming import prefetch_to_device
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
MOMENT_FLOOR = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the training path's card run")
    return torch.device("cuda")


def _batch(cfg: dict, n: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    lr, hr = cfg["lr_tile"], cfg["lr_tile"] * cfg["scale"]
    return {
        "depth_lr": rng.uniform(0, 1, (n, lr, lr)).astype(np.float32),
        "dem_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
        "target_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
    }


def _flat(tree, prefix="") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}.{k}"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}.{i}"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def test_one_step_on_the_card_matches_the_cpu(cuda_device):
    cfg = ResUNetConfig(**NARROW)
    b = _batch(NARROW, 4, seed=0)
    states = {}
    for dev in ("cuda", "cpu"):
        state = tt.init_train_state(0, cfg, tt.TrainConfig(**TCFG), device=dev)
        # copies: on the CPU ``params_to_jax``'s arrays share the parameters' memory
        init = {k: v.copy() for k, v in _flat(params_to_jax(state.model.state_dict())[0]).items()}
        state, metrics = tt.make_train_step(cfg, tt.TrainConfig(**TCFG))(state, b)
        states[dev] = (state, {k: float(v) for k, v in metrics.items()})
    (gpu, mg), (cpu, mc) = states["cuda"], states["cpu"]
    assert gpu.device.type == "cuda"
    np.testing.assert_allclose(mg["loss"], mc["loss"], rtol=1e-4)
    np.testing.assert_allclose(mg["grad_norm"], mc["grad_norm"], rtol=1e-3)
    pg, sg = params_to_jax(gpu.model.state_dict())
    sc = params_to_jax(cpu.model.state_dict())[1]
    for key, want in _flat(sc).items():
        np.testing.assert_allclose(_flat(sg)[key], want, rtol=0, atol=1e-4, err_msg=key)
    og = _flat(tt.opt_state_to_numpy(gpu.opt_state))
    oc = _flat(tt.opt_state_to_numpy(cpu.opt_state))
    assert list(og) == list(oc)
    for kind in (".1", ".2"):  # mu, nu
        keys = [k for k in oc if k.startswith(f".1.0{kind}.")]
        top = max(np.abs(oc[k]).max() for k in keys)
        for key in keys:
            scale = max(np.abs(oc[key]).max(), MOMENT_FLOOR * top)
            np.testing.assert_allclose(og[key], oc[key], rtol=0, atol=1e-3 * scale, err_msg=key)
    # the card's update is optax's on the card's own moments (float64 here)
    lr = TCFG["base_lr"]
    for key, p1 in _flat(pg).items():
        u = (og[".1.0.1" + key] / (1 - 0.9)) / (np.sqrt(og[".1.0.2" + key] / (1 - 0.999)) + 1e-8)
        np.testing.assert_allclose(p1, init[key] - lr * u, rtol=0, atol=1e-3 * lr, err_msg=key)


def test_resident_loop_reads_nothing_back_inside_a_call(cuda_device):
    cfg = ResUNetConfig(**NARROW)
    rng = np.random.default_rng(1)
    data = {k: torch.from_numpy(v).to(cuda_device) for k, v in _batch(NARROW, 6, seed=1).items()}
    state = tt.init_train_state(0, cfg, tt.TrainConfig(**TCFG), device="cuda")
    loop = tt.make_resident_train_loop(cfg, tt.TrainConfig(**TCFG), batch_size=3, steps_per_call=4)
    gen = tt.ResidentRng.from_seed(int(rng.integers(1 << 30)), device="cuda")
    state, _ = loop(state, data, gen)  # warm: cuDNN's first calls may synchronize
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, losses = loop(state, data, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert losses.device.type == "cuda" and losses.shape == (4,)
    (count, _, _), (sched,) = state.opt_state[-1]
    assert state.step == int(count) == int(sched) == 8
    assert torch.isfinite(losses).all()


def test_tf32_is_off_in_an_f32_step_and_restored_after_a_bf16_one(cuda_device, monkeypatch):
    cfg = ResUNetConfig(**NARROW)
    b = _batch(NARROW, 2, seed=2)
    seen = []
    conv2d = F.conv2d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", spy)
    state = tt.init_train_state(0, cfg, tt.TrainConfig(**TCFG), device="cuda")
    torch.backends.cudnn.allow_tf32 = True  # as another library might leave them
    torch.backends.cuda.matmul.allow_tf32 = True
    state, _ = tt.make_train_step(cfg, tt.TrainConfig(**TCFG))(state, b)
    assert seen and not any(any(flags) for flags in seen)
    seen.clear()
    step = tt.make_train_step(cfg, tt.TrainConfig(**TCFG), compute_dtype=torch.bfloat16)
    state, metrics = step(state, b)
    assert any(all(flags) for flags in seen)  # the bf16 stages' products
    assert not any(all(flags) for flags in seen[-1:])  # the f32 head
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert np.isfinite(float(metrics["loss"]))


def test_eval_step_launches_k1_on_its_tensor_core_route(cuda_device):
    cfg = ResUNetConfig(**FLAGSHIP)
    state = tt.init_train_state(0, cfg, tt.TrainConfig(**TCFG), device="cuda")
    b = _batch(FLAGSHIP, 2, seed=3)
    state, _ = tt.make_train_step(cfg, tt.TrainConfig(**TCFG))(state, b)
    eval_step = tt.make_eval_step(cfg, tt.TrainConfig(**TCFG))
    reset_launch_counts()
    metrics = eval_step(state, _batch(FLAGSHIP, 2, seed=4))
    routes = route_counts()["hr_tail"]
    assert routes["tensor"] == 1 and sum(routes.values()) == 1, routes
    assert np.isfinite(float(metrics["rmse_m"]))


def test_prefetch_to_the_card_keeps_order_and_values(cuda_device):
    batches = [{"a": np.full((1024,), i, np.float32), "b": np.arange(i + 3)} for i in range(5)]
    out = list(prefetch_to_device(iter(batches), buffer_size=2))
    assert len(out) == 5
    for i, batch in enumerate(out):
        assert batch["a"].device.type == "cuda"
        assert torch.equal(batch["a"].cpu(), torch.from_numpy(batches[i]["a"]))
        assert torch.equal(batch["b"].cpu(), torch.from_numpy(batches[i]["b"]))
