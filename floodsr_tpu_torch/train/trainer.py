"""Training the DEM-conditioned ResUNet in PyTorch.

Port of the JAX package's ``floodsr_tpu/train/trainer.py``: Adam with global
norm clipping and a piecewise-constant learning rate, MAE loss in normalized
depth space, batch-statistics batch norm, and checkpoints in the ``.fsrz``
container that either package loads.

- :func:`make_optimizer` is optax's ``chain(clip_by_global_norm,
  [add_decayed_weights], adam(piecewise_constant_schedule))`` written out by
  hand in optax 0.2.6's arithmetic (see :class:`Optimizer`); its state keeps
  optax's chain layout, so a checkpoint's skeleton is the JAX package's.
- :func:`make_train_step` takes host-fed batches
  (:func:`floodsr_tpu_torch.parallel.streaming.prefetch_to_device`);
  :func:`make_resident_train_step` / :func:`make_resident_train_loop` sample,
  rotate, flip and train on a dataset staged on the device
  (:func:`stage_dataset_to_device`) with no device-to-host read.
- :func:`make_eval_step` runs the inference forward, which takes the
  ``hr_tail`` kernel on the GPU where the configuration is eligible.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
GPU every f32 product is strict f32 (``device.set_strict_f32``), and a
``bfloat16`` step allows TF32 only inside the products of its bf16 stages
(``nn.resunet.bf16_products``) and puts the switches back after them.
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from floodsr_tpu_torch.device import resolve_device, set_strict_f32
from floodsr_tpu_torch.eval.metrics import depth_metrics_torch
from floodsr_tpu_torch.nn.checkpoint import (
    load_artifact,
    params_from_jax,
    params_to_jax,
    save_artifact,
)
from floodsr_tpu_torch.nn.resunet import (
    ResUNet,
    ResUNetConfig,
    init_resunet,
    resolve_precision_policy,
)
from floodsr_tpu_torch.ops.normalize import invert_depth_log1p

_INT32_MAX = 2**31 - 1
_MULTI_GPU = (
    "that comes with the multi-GPU training slice of the port: data-parallel "
    "steps with batch-norm statistics over the global batch and gradients "
    "summed over dp, then convolutions split over tp"
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization hyperparameters (the JAX package's, same defaults)."""

    total_steps: int = 100_000
    base_lr: float = 1e-4
    second_lr: float = 5e-5
    clipnorm: float = 1.0
    max_depth: float = 5.0
    weight_decay: float = 0.0


@dataclasses.dataclass
class TrainState:
    """Carried training state.

    ``model`` holds the parameters (``requires_grad``) and the batch-norm
    running stats; ``model_state`` maps each running-stat buffer's
    ``state_dict`` key to that buffer; ``opt_state`` is optax's chain layout
    with torch leaves (:meth:`Optimizer.init`). ``step`` counts on the host.
    """

    step: int
    model: ResUNet
    model_state: dict[str, torch.Tensor]
    opt_state: list

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def device(self) -> torch.device:
        return self.model.stem.w.device


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    """``count + 1``, staying at the int32 maximum (optax's ``safe_increment``)."""
    return torch.where(count < _INT32_MAX, count + 1, count)


class Optimizer:
    """optax 0.2.6's clip → (decay) → Adam → learning-rate chain, by hand.

    Per step, on the raw gradients ``g`` (every operation in f32):

    - clip: ``g`` unchanged when ``‖g‖ < clipnorm``, else ``(g / ‖g‖) ·
      clipnorm``; ``‖g‖`` is also the step's ``grad_norm``;
    - decayed weights (``weight_decay > 0``): ``g + wd · p``;
    - Adam: ``mu = (1−b1)·g + b1·mu``, ``nu = (1−b2)·g² + b2·nu``, ``count +=
      1``, ``u = (mu / (1 − b1^count)) / (sqrt(nu / (1 − b2^count)) + 1e-8)``;
    - learning rate: ``u · −lr(c)`` with ``c`` the schedule's count before its
      increment; ``lr`` is ``base_lr`` before ``c == total_steps // 2`` and
      ``f32(second_lr / base_lr) · base_lr`` from there;
    - ``p + u``.

    ``torch.optim.Adam`` forms its denominator as ``sqrt(v)/sqrt(bc2) + eps``
    and ``clip_grad_norm_`` divides by ``‖g‖ + 1e-6``: other roundings. The
    arithmetic runs as ``torch._foreach_*`` operations over all leaves, with
    the clip and the learning rate chosen by ``torch.where`` on the device, so
    a step reads nothing back to the host.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: TrainConfig):
        self.max_norm = float(cfg.clipnorm)
        self.weight_decay = float(cfg.weight_decay)
        self.boundary = int(cfg.total_steps // 2)
        base = np.float32(cfg.base_lr)
        self.lrs = (float(base), float(np.float32(cfg.second_lr / cfg.base_lr) * base))

    def init(self, params: dict[str, torch.Tensor]) -> list:
        """``[[], ([],) [[count, mu, nu], [count]]]``: optax's chain layout."""
        dev = next(iter(params.values())).device

        def zeros():
            return {k: torch.zeros(p.shape, dtype=p.dtype, device=dev) for k, p in params.items()}

        def count():
            return torch.zeros((), dtype=torch.int32, device=dev)

        decay = [[]] if self.weight_decay > 0 else []
        return [[], *decay, [[count(), zeros(), zeros()], [count()]]]

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
               opt_state: list) -> torch.Tensor:
        """Update ``params`` and ``opt_state`` in place; return the raw ``‖g‖``.

        ``grads`` is consumed (overwritten).
        """
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        (adam_count, mu_d, nu_d), (sched_count,) = opt_state[-1]
        mu = [mu_d[k] for k in names]
        nu = [nu_d[k] for k in names]
        dev = p[0].device
        one = torch.ones((), dtype=torch.float32, device=dev)

        g_norm = torch.stack(torch._foreach_norm(g)).square().sum().sqrt()
        keep = g_norm < self.max_norm
        # g / 1 · 1 is g exactly, so this is optax's select(keep, g, (g / ‖g‖) · max)
        torch._foreach_div_(g, torch.where(keep, one, g_norm))
        torch._foreach_mul_(g, torch.where(keep, one, one * self.max_norm))
        if self.weight_decay > 0:
            torch._foreach_add_(g, torch._foreach_mul(p, self.weight_decay))

        count = _safe_increment(adam_count)
        first = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, first)
        del first
        torch._foreach_mul_(g, g)
        torch._foreach_mul_(g, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g)
        steps = count.to(torch.float32)
        bc1 = 1 - torch.pow(one * self.b1, steps)
        bc2 = 1 - torch.pow(one * self.b2, steps)
        u = torch._foreach_div(mu, bc1)
        v = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(v)
        torch._foreach_add_(v, self.eps)
        torch._foreach_div_(u, v)
        del v
        adam_count.copy_(count)

        lr = torch.where(sched_count < self.boundary, one * self.lrs[0], one * self.lrs[1])
        torch._foreach_mul_(u, -lr)
        sched_count.copy_(_safe_increment(sched_count))
        torch._foreach_add_(p, u)
        return g_norm


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """Adam + global-norm clipping + piecewise LR (optax's arithmetic)."""
    return Optimizer(cfg)


def _train_model(cfg: ResUNetConfig, params: Any, state: Any, dev: torch.device) -> ResUNet:
    """A ResUNet on ``dev`` from numpy trees, its parameters requiring grad."""
    model = ResUNet(cfg)
    model.load_state_dict(params_from_jax(params, state), strict=True)
    model.to(dev)
    for p in model.parameters():
        p.requires_grad_(True)
    if dev.type == "cuda":
        set_strict_f32()
    return model


def init_train_state(
    seed: int, model_cfg: ResUNetConfig, train_cfg: TrainConfig, *,
    device: "str | torch.device" = "cuda",
) -> TrainState:
    """Step 0: :func:`init_resunet`'s weights (the JAX package's, bit for bit),
    zero Adam moments and counts, on ``device``."""
    dev = resolve_device(device)
    params, state = init_resunet(seed, model_cfg)
    model = _train_model(model_cfg, params, state, dev)
    return TrainState(
        step=0,
        model=model,
        model_state=dict(model.named_buffers()),
        opt_state=make_optimizer(train_cfg).init(dict(model.named_parameters())),
    )


def mae_loss(
    model: ResUNet,
    depth_lr_norm: torch.Tensor,
    dem_hr_norm: torch.Tensor,
    target_hr_norm: torch.Tensor,
    compute_dtype=torch.float32,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """MAE in normalized depth space and the new BN stats (train forward)."""
    pred, new_stats = model.forward_train(
        depth_lr_norm[..., None],
        dem_hr_norm[..., None],
        resolve_precision_policy(None, compute_dtype),
    )
    loss = torch.mean(torch.abs(pred[..., 0] - target_hr_norm))
    return loss, new_stats


def _train_on(state: TrainState, optimizer: Optimizer, batch: dict, compute_dtype) -> dict:
    """One step on a device batch: gradients, optimizer, BN stats; in place."""
    if state.device.type == "cuda":
        set_strict_f32()
    params = state.params
    for p in params.values():
        p.grad = None
    loss, new_stats = mae_loss(
        state.model, batch["depth_lr"], batch["dem_hr"], batch["target_hr"], compute_dtype
    )
    loss.backward()
    grads = {k: p.grad for k, p in params.items()}
    grad_norm = optimizer.update(params, grads, state.opt_state)
    for p in params.values():
        p.grad = None
    with torch.no_grad():
        for key, value in new_stats.items():
            state.model_state[key].copy_(value)
    state.step += 1
    return {"loss": loss.detach(), "grad_norm": grad_norm}


def _on_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(dev, torch.float32) for k, v in batch.items()}


def make_train_step(
    model_cfg: ResUNetConfig,
    train_cfg: TrainConfig,
    *,
    mesh=None,
    compute_dtype=torch.float32,
    donate: bool = True,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """The train step ``(state, batch) -> (state, metrics)``.

    ``batch`` is ``{"depth_lr": [B,h,w], "dem_hr": [B,H,W], "target_hr":
    [B,H,W]}`` in normalized [0,1] space (tensors on the state's device, or
    host arrays, which are copied there). ``metrics`` holds ``loss`` and
    ``grad_norm`` (the global norm of the raw gradients) as device scalars.
    With ``donate`` the state is updated in place and returned; without, the
    input state is left as it was and a new one is returned.
    ``compute_dtype=torch.bfloat16`` runs the uniform ``bf16`` policy.
    """
    if mesh is not None:
        raise NotImplementedError(f"make_train_step(mesh=...) shards the step; {_MULTI_GPU}")
    optimizer = make_optimizer(train_cfg)

    def step_fn(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if not donate:
            state = copy.deepcopy(state)
        metrics = _train_on(state, optimizer, _on_device(batch, state.device), compute_dtype)
        return state, metrics

    return step_fn


def stage_dataset_to_device(
    dataset, indices, *, device: "str | torch.device" = "cuda"
) -> dict[str, torch.Tensor]:
    """Normalize a patch set once and upload it once (device-resident data).

    Per-patch DEM normalization (tile-local stats) commutes with the flip and
    rot90 augmentation, so normalizing once up front is exact.
    """
    dev = resolve_device(device)
    d, m, t = [], [], []
    for i in np.asarray(indices):
        depth, dem, target = dataset._normalized_example(int(i))
        d.append(depth)
        m.append(dem)
        t.append(target)
    return {
        "depth_lr": torch.from_numpy(np.stack(d)).to(dev),
        "dem_hr": torch.from_numpy(np.stack(m)).to(dev),
        "target_hr": torch.from_numpy(np.stack(t)).to(dev),
    }


@dataclasses.dataclass
class ResidentRng:
    """The resident step's draws: ``device`` for the batch indices (no host
    read), ``host`` (a CPU generator) for the rotation and the flip, so the
    branch is chosen without reading the device."""

    device: torch.Generator
    host: torch.Generator

    @classmethod
    def from_seed(cls, seed: int, device: "str | torch.device" = "cuda") -> "ResidentRng":
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        host = torch.Generator()
        host.manual_seed(int(seed) + 1)
        return cls(device=gen, host=host)

    def draw(self, n: int, batch_size: int) -> tuple[torch.Tensor, int, bool]:
        """``(idx [batch_size] on the device, k_rot in 0..3, flip)``."""
        idx = torch.randint(
            0, n, (batch_size,), generator=self.device, device=self.device.device
        )
        k_rot = int(torch.randint(0, 4, (), generator=self.host))
        flip = bool(torch.randint(0, 2, (), generator=self.host))
        return idx, k_rot, flip


def augment_batch(data: dict[str, torch.Tensor], idx: torch.Tensor, k_rot: int,
                  flip: bool) -> dict[str, torch.Tensor]:
    """Gather ``idx`` from the staged set, ``rot90(k_rot, dims=(1, 2))``, then
    flip the last axis when ``flip``: the JAX package's resident augmentation."""
    out = {}
    for key, value in data.items():
        a = value.index_select(0, idx.to(value.device))
        if k_rot % 4:
            a = torch.rot90(a, k_rot, dims=(1, 2))
        if flip:
            a = a.flip(-1)
        out[key] = a.contiguous()
    return out


def make_resident_train_step(
    model_cfg: ResUNetConfig,
    train_cfg: TrainConfig,
    *,
    batch_size: int,
    compute_dtype=torch.float32,
):
    """Train step over a device-resident dataset: ``(state, data, rng) ->
    (state, metrics)``.

    Samples the batch, applies the rot90/flip augmentation and runs the
    standard step on the device, updating ``state`` in place. ``rng`` is a
    :class:`ResidentRng`, or the draws themselves, ``(idx, k_rot, flip)``.
    ``data`` is :func:`stage_dataset_to_device`'s dict.
    """
    optimizer = make_optimizer(train_cfg)

    def step_fn(state: TrainState, data: dict[str, torch.Tensor], rng) -> tuple[TrainState, dict]:
        n = int(data["depth_lr"].shape[0])
        idx, k_rot, flip = rng.draw(n, batch_size) if isinstance(rng, ResidentRng) else rng
        batch = augment_batch(data, idx, k_rot, flip)
        return state, _train_on(state, optimizer, batch, compute_dtype)

    return step_fn


def make_resident_train_loop(
    model_cfg: ResUNetConfig,
    train_cfg: TrainConfig,
    *,
    batch_size: int,
    steps_per_call: int,
    compute_dtype=torch.float32,
):
    """``steps_per_call`` resident steps per call: ``(state, data, rng) ->
    (state, losses[steps_per_call])``.

    ``rng`` is a :class:`ResidentRng` or a list of ``steps_per_call`` draws.
    Nothing is read back to the host inside the call; ``losses`` is one
    device tensor.
    """
    step_fn = make_resident_train_step(
        model_cfg, train_cfg, batch_size=batch_size, compute_dtype=compute_dtype
    )

    def loop(state: TrainState, data: dict[str, torch.Tensor], rng):
        draws = [rng] * steps_per_call if isinstance(rng, ResidentRng) else list(rng)
        if len(draws) != steps_per_call:
            raise ValueError(f"expected {steps_per_call} draws; got {len(draws)}")
        losses = []
        for draw in draws:
            state, metrics = step_fn(state, data, draw)
            losses.append(metrics["loss"])
        return state, torch.stack(losses)

    return loop


def make_eval_step(model_cfg: ResUNetConfig, train_cfg: TrainConfig, *, mesh=None):
    """Eval step ``(state, batch) -> {metric: mean over the batch}`` in metres.

    The inference forward (running stats; the ``hr_tail`` kernel on the GPU
    where the configuration is eligible), then :func:`invert_depth_log1p`
    and :func:`depth_metrics_torch`, averaged per metric on the device.
    """
    if mesh is not None:
        raise NotImplementedError(f"make_eval_step(mesh=...) shards the batch; {_MULTI_GPU}")

    def eval_fn(state: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        batch = _on_device(batch, state.device)
        pred = state.model(batch["depth_lr"][..., None], batch["dem_hr"][..., None])
        pred_m = invert_depth_log1p(pred[..., 0], train_cfg.max_depth)
        target_m = invert_depth_log1p(batch["target_hr"], train_cfg.max_depth)
        metrics = depth_metrics_torch(target_m, pred_m, train_cfg.max_depth)
        return {k: torch.mean(v.to(torch.float32)) for k, v in metrics.items()}

    return eval_fn


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def opt_state_to_numpy(opt_state: list) -> list:
    """The optimizer state as numpy trees in the JAX package's layout (moments
    as parameter trees, HWIO kernels; int32 counts), as a checkpoint holds it."""

    def convert(node):
        if isinstance(node, list):
            return [convert(v) for v in node]
        if isinstance(node, dict):
            return params_to_jax(node)[0]
        return np.asarray(node.detach().cpu().numpy(), dtype=np.int32)

    return convert(opt_state)


def _opt_state_from_numpy(tree: list, train_cfg: TrainConfig, model: ResUNet) -> list:
    n_chain = 3 if train_cfg.weight_decay > 0 else 2
    if not (
        isinstance(tree, list) and len(tree) == n_chain
        and all(isinstance(node, list) and not node for node in tree[:-1])
        and [len(tree[-1]), len(tree[-1][0]), len(tree[-1][1])] == [2, 3, 1]
    ):
        raise ValueError(
            "optimizer state does not have the chain layout of this TrainConfig "
            f"(weight_decay={train_cfg.weight_decay})"
        )
    (count, mu, nu), (sched,) = tree[-1]

    params = dict(model.named_parameters())

    def moments(t):
        loaded = params_from_jax(t, {})
        if loaded.keys() != params.keys():
            raise ValueError("optimizer moments do not match the model's parameters")
        return {k: loaded[k].to(p.device) for k, p in params.items()}

    def counter(c):
        return torch.tensor(int(np.asarray(c)), dtype=torch.int32, device=model.stem.w.device)

    return [*tree[:-1], [[counter(count), moments(mu), moments(nu)], [counter(sched)]]]


def save_train_state(
    fp: str | Path,
    state: TrainState,
    model_cfg: ResUNetConfig,
    metadata: dict | None = None,
) -> Path:
    """Persist a full training checkpoint (params + BN state + opt state)."""
    meta = dict(metadata or {})
    meta["train_step"] = int(state.step)
    params, model_state = params_to_jax(state.model.state_dict())
    return save_artifact(
        fp,
        model_cfg,
        {"params": params, "opt_state": opt_state_to_numpy(state.opt_state)},
        model_state,
        meta,
    )


def restore_train_state(
    fp: str | Path, train_cfg: TrainConfig, *, device: "str | torch.device" = "cuda"
) -> tuple[TrainState, ResUNetConfig]:
    """Restore a checkpoint written by :func:`save_train_state` of either package."""
    dev = resolve_device(device)
    artifact = load_artifact(fp)
    payload = artifact["params"]
    cfg = artifact["config"]
    model = _train_model(cfg, payload["params"], artifact["state"], dev)
    state = TrainState(
        step=int(artifact["manifest"]["metadata"].get("train_step", 0)),
        model=model,
        model_state=dict(model.named_buffers()),
        opt_state=_opt_state_from_numpy(payload["opt_state"], train_cfg, model),
    )
    return state, cfg


def export_inference_artifact(
    fp: str | Path,
    state: TrainState,
    model_cfg: ResUNetConfig,
    metadata: dict | None = None,
    *,
    store_dtype: str | None = None,
) -> Path:
    """Export an inference-only ``.fsrz`` (params + BN state, no opt state)."""
    params, model_state = params_to_jax(state.model.state_dict())
    return save_artifact(
        fp, model_cfg, params, model_state, metadata or {}, store_dtype=store_dtype
    )
