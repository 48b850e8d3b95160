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
- ``mesh=`` (a :class:`~floodsr_tpu_torch.parallel.mesh.Mesh`) runs both
  steps on a ``(dp, tp)`` mesh, as the JAX package's sharded ``jax.jit``
  does: the batch splits over ``dp``; :func:`shard_train_state` places the
  state (``param_sharding_rules``: output channels over ``tp``); batch norm
  normalizes by the global batch, each leaf's gradient is summed over its
  copies before the clip and Adam, and a split convolution computes its
  output piece on its own entry (:func:`floodsr_tpu_torch.nn.resunet.
  forward_train_mesh`). One process drives every device of the mesh; a
  shard's work is enqueued on its own device's current stream.

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
    forward_train_mesh,
    init_resunet,
    resolve_precision_policy,
)
from floodsr_tpu_torch.ops.normalize import invert_depth_log1p
from floodsr_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast,
    gather_to,
    param_sharding_rules,
    psum,
    to_device,
)

_INT32_MAX = 2**31 - 1


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
    def update(self, params: dict, grads: dict, opt_state: list) -> torch.Tensor:
        """Update ``params`` and ``opt_state`` in place; return the raw ``‖g‖``.

        ``grads`` is consumed (overwritten). The leaves may lie on several
        devices (a state on a mesh): the scalars of the step (``‖g‖``, the
        clip, the bias corrections, the learning rate) are formed on the
        counts' device and copied to each other device, whose leaves then take
        the same ``_foreach`` sequence.
        """
        (adam_count, mu_d, nu_d), (sched_count,) = opt_state[-1]
        dev = adam_count.device
        groups: dict = {}
        for k, p in params.items():
            groups.setdefault(p.device, []).append(k)
        norms = [torch.stack(torch._foreach_norm([grads[k] for k in names])).square().sum()
                 for names in groups.values()]
        g_norm = psum(norms, dev).sqrt()
        one = torch.ones((), dtype=torch.float32, device=dev)
        keep = g_norm < self.max_norm
        # g / 1 · 1 is g exactly, so this is optax's select(keep, g, (g / ‖g‖) · max)
        div, mul = torch.where(keep, one, g_norm), torch.where(keep, one, one * self.max_norm)
        count = _safe_increment(adam_count)
        steps = count.to(torch.float32)
        bc1 = 1 - torch.pow(one * self.b1, steps)
        bc2 = 1 - torch.pow(one * self.b2, steps)
        lr = torch.where(sched_count < self.boundary, one * self.lrs[0], one * self.lrs[1])
        for d, names in groups.items():
            scalars = [to_device(t, d) for t in (div, mul, bc1, bc2, -lr)]
            self._apply(
                [params[k] for k in names], [grads[k] for k in names],
                [mu_d[k] for k in names], [nu_d[k] for k in names], *scalars,
            )
        adam_count.copy_(count)
        sched_count.copy_(_safe_increment(sched_count))
        return g_norm

    def _apply(self, p: list, g: list, mu: list, nu: list, div, mul, bc1, bc2, neg_lr) -> None:
        """Clip, decay, Adam and the learning rate on one device's leaves."""
        torch._foreach_div_(g, div)
        torch._foreach_mul_(g, mul)
        if self.weight_decay > 0:
            torch._foreach_add_(g, torch._foreach_mul(p, self.weight_decay))
        first = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, first)
        del first
        torch._foreach_mul_(g, g)
        torch._foreach_mul_(g, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g)
        u = torch._foreach_div(mu, bc1)
        v = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(v)
        torch._foreach_add_(v, self.eps)
        torch._foreach_div_(u, v)
        del v
        torch._foreach_mul_(u, neg_lr)
        torch._foreach_add_(p, u)


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


# ---------------------------------------------------------------------------
# the state and the step on a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedTrainState:
    """A :class:`TrainState` placed on a mesh (:func:`shard_train_state`).

    ``entries[i, j]`` is the :class:`TrainState` that mesh entry ``(i, j)``
    holds on its device: a :class:`ResUNet` whose leaves named in ``split``
    (``state_dict`` keys) are their ``tp`` piece ``j`` along dimension 0, the
    Adam moments held the same way, and a copy of every other leaf and of the
    counts. Every entry holds copies of its own, also where the mesh repeats
    a device, so one device runs the reductions and broadcasts that distinct
    GPUs run. ``step`` counts on the host.
    """

    step: int
    mesh: Mesh
    split: frozenset
    entries: np.ndarray

    @property
    def cfg(self) -> ResUNetConfig:
        return self.entries[0, 0].model.cfg


def _jax_layout(t: torch.Tensor) -> torch.Tensor:
    """A shape-only stand-in for ``t`` in the JAX package's layout (HWIO for a
    kernel, as :func:`params_to_jax` writes it)."""
    shape = (t.shape[2], t.shape[3], t.shape[1], t.shape[0]) if t.ndim == 4 else tuple(t.shape)
    return torch.empty(shape, device="meta")


def _model_of(cfg: ResUNetConfig, tensors: dict[str, torch.Tensor]) -> ResUNet:
    """A :class:`ResUNet` holding ``tensors`` (whole leaves or pieces) as its
    parameters, which require grad, and its running stats."""
    with torch.device("meta"):
        model = ResUNet(cfg)
    for key, t in tensors.items():
        owner, _, attr = key.rpartition(".")
        module = model.get_submodule(owner)
        if attr in module._parameters:
            setattr(module, attr, torch.nn.Parameter(t, requires_grad=True))
        else:
            module.register_buffer(attr, t)
    return model


def _moments(opt_state: list) -> tuple[dict, dict]:
    (_, mu, nu), _ = opt_state[-1]
    return mu, nu


def shard_train_state(
    state: TrainState, mesh: Mesh, *, replicated: bool = False
) -> ShardedTrainState:
    """Place ``state`` on ``mesh``: the JAX package's ``jax.tree.map(
    jax.device_put, state, param_sharding_rules(mesh, ...))``.

    :func:`param_sharding_rules` reads each leaf in the JAX layout
    (:func:`params_to_jax`), whose last dimension is a kernel's output channel
    and the only dimension of a bias or a BN vector: dimension 0 of the
    port's tensor. A leaf that ``tp`` divides there is held as ``tp`` pieces,
    piece ``j`` on every entry ``(i, j)``, and so are its Adam moments; every
    other leaf, and the counts, whole on every entry. ``replicated`` holds
    every leaf whole (how ``jax.jit`` places a state it was given uncommitted).
    ``state`` is left as it was.
    """
    tensors = state.model.state_dict()
    tp = mesh.shape["tp"]
    split: frozenset = frozenset()
    if not replicated:
        rules = param_sharding_rules(mesh, {k: _jax_layout(t) for k, t in tensors.items()})
        split = frozenset(k for k, rule in rules.items() if "tp" in rule.spec)
    (count, mu, nu), (sched,) = state.opt_state[-1]
    entries = np.empty(mesh.devices.shape, dtype=object)
    for (i, j), dev in np.ndenumerate(mesh.devices):

        def own(key: str, t: torch.Tensor, j=j, dev=dev) -> torch.Tensor:
            piece = torch.chunk(t, tp, dim=0)[j] if key in split else t
            return piece.detach().to(dev, copy=True)

        model = _model_of(state.model.cfg, {k: own(k, t) for k, t in tensors.items()})
        opt_state = [
            *copy.deepcopy(state.opt_state[:-1]),
            [[count.to(dev, copy=True), {k: own(k, v) for k, v in mu.items()},
              {k: own(k, v) for k, v in nu.items()}], [sched.to(dev, copy=True)]],
        ]
        entries[i, j] = TrainState(state.step, model, dict(model.named_buffers()), opt_state)
    if any(d.type == "cuda" for d in mesh.distinct_devices()):
        set_strict_f32()
    return ShardedTrainState(state.step, mesh, split, entries)


@torch.no_grad()
def _row_leaves(state: ShardedTrainState, trees: list[dict], dev: torch.device) -> dict:
    """One row's leaves (``trees[j]``: entry ``j``'s) whole on ``dev``, as new
    tensors: the pieces of a split leaf concatenated in ``tp`` order."""
    return {
        k: gather_to([t[k] for t in trees], dev) if k in state.split else t0.to(dev, copy=True)
        for k, t0 in trees[0].items()
    }


def unshard_train_state(
    state: "TrainState | ShardedTrainState", device: "str | torch.device" = "cpu"
) -> TrainState:
    """A placed state whole on ``device``, from its first row (what ``jax.tree.map(
    np.asarray, state)`` reads of a placed state); a :class:`TrainState` as it is."""
    if isinstance(state, TrainState):
        return state
    dev = resolve_device(device)
    row = state.entries[0]
    model = _model_of(state.cfg, _row_leaves(state, [e.model.state_dict() for e in row], dev))
    (count, _, _), (sched,) = row[0].opt_state[-1]
    mu, nu = (_row_leaves(state, [_moments(e.opt_state)[m] for e in row], dev) for m in (0, 1))
    opt_state = [
        *copy.deepcopy(row[0].opt_state[:-1]),
        [[count.to(dev, copy=True), mu, nu], [sched.to(dev, copy=True)]],
    ]
    return TrainState(state.step, model, dict(model.named_buffers()), opt_state)


def _dp_shards(batch: dict, mesh: Mesh) -> dict[str, list[torch.Tensor]]:
    """Each leaf of ``batch`` as its ``dp`` shards in f32, shard ``i`` on the
    device of row ``i``: a host array or a tensor split on dimension 0, or
    ``prefetch_to_device(sharding=batch_sharding(mesh))``'s shards."""
    dp = mesh.shape["dp"]
    devices = mesh.axis_devices("dp")
    out = {}
    for key, value in batch.items():
        if isinstance(value, (list, tuple)):
            if len(value) != dp:
                raise ValueError(
                    f"batch leaf '{key}' has {len(value)} shards; the mesh has dp={dp}"
                )
            shards = [torch.as_tensor(v) for v in value]
        else:
            value = torch.as_tensor(value)
            if value.shape[0] % dp:
                raise ValueError(
                    f"batch leaf '{key}' does not split over dp={dp}: the global size of "
                    f"its dimension 0 should be divisible by {dp}, but it is equal to "
                    f"{value.shape[0]}"
                )
            shards = torch.chunk(value, dp, dim=0)
        out[key] = [s.to(d, torch.float32) for s, d in zip(shards, devices)]
    return out


def _holders(state: ShardedTrainState) -> dict[tuple[str, int], list[tuple[int, int]]]:
    """``(parameter, piece)`` → the entries that hold a copy, row 0's first:
    a split leaf's piece ``j`` on ``(i, j)`` for every row, a whole leaf on
    every entry (piece 0)."""
    dp, tp = state.entries.shape
    out = {}
    for name, _ in state.entries[0, 0].model.named_parameters():
        for j in range(tp) if name in state.split else (0,):
            cols = [j] if name in state.split else range(tp)
            out[name, j] = [(i, c) for i in range(dp) for c in cols]
    return out


def _mesh_gradients(state: ShardedTrainState, batch: dict, compute_dtype) -> tuple:
    """The forward and backward of a step on a mesh: ``(loss, grads,
    new_stats)``.

    Row ``i`` runs the train forward on its ``dp`` shard (:func:`forward_train_mesh`:
    batch norm over the global batch, split convolutions by ``tp`` piece); the
    loss is the mean over the global batch, on the mesh's first device. A leaf
    piece's gradient (``grads[name, j]``) is the sum of its copies' (:func:`psum`
    on the first holder: over ``dp`` for a piece, over every entry for a whole
    leaf, whose ``tp`` entries each hold a share). The copies' own ``.grad``
    are left for the caller to clear.
    """
    mesh, entries = state.mesh, state.entries
    dp = mesh.shape["dp"]
    if any(d.type == "cuda" for d in mesh.distinct_devices()):
        set_strict_f32()
    shards = _dp_shards(batch, mesh)
    rows = {
        k: [broadcast(v[i], list(mesh.devices[i])) for i in range(dp)] for k, v in shards.items()
    }
    tensors = np.empty(entries.shape, dtype=object)
    for pos, entry in np.ndenumerate(entries):
        tensors[pos] = {**dict(entry.model.named_parameters()), **entry.model_state}
        for p in entry.model.parameters():
            p.grad = None
    preds, new_stats = forward_train_mesh(
        state.cfg, tensors, state.split, mesh.devices,
        [[t[..., None] for t in row] for row in rows["depth_lr"]],
        [[t[..., None] for t in row] for row in rows["dem_hr"]],
        resolve_precision_policy(None, compute_dtype),
    )
    targets = shards["target_hr"]
    loss = psum(
        [torch.abs(p[..., 0] - t).sum() for p, t in zip(preds, targets)], mesh.devices[0, 0]
    ) / sum(t.numel() for t in targets)
    loss.backward()
    grads = {}
    for (name, j), held in _holders(state).items():
        copies = [tensors[h][name] for h in held]
        parts = [c.grad for c in copies if c.grad is not None]
        grads[name, j] = psum(parts, copies[0].device) if parts else torch.zeros_like(copies[0])
    return loss.detach(), grads, new_stats


def _train_on_mesh(
    state: ShardedTrainState, optimizer: Optimizer, batch: dict, compute_dtype
) -> dict:
    """One step on a mesh, in place: :func:`_mesh_gradients`, then the
    optimizer once per leaf piece on its first holder (row 0), whose new
    value, moments and the counts are copied to every other copy, and the new
    running stats to every entry."""
    entries = state.entries
    loss, grads, new_stats = _mesh_gradients(state, batch, compute_dtype)
    holders = _holders(state)
    params = {pos: dict(e.model.named_parameters()) for pos, e in np.ndenumerate(entries)}
    owners = {key: params[held[0]][key[0]] for key, held in holders.items()}
    mu = {key: _moments(entries[held[0]].opt_state)[0][key[0]] for key, held in holders.items()}
    nu = {key: _moments(entries[held[0]].opt_state)[1][key[0]] for key, held in holders.items()}
    (count, _, _), (sched,) = entries[0, 0].opt_state[-1]
    grad_norm = optimizer.update(owners, grads, [[[count, mu, nu], [sched]]])

    with torch.no_grad():
        for key, held in holders.items():
            for h in held[1:]:
                params[h][key[0]].copy_(owners[key])
                for moments, src in zip(_moments(entries[h].opt_state), (mu[key], nu[key])):
                    moments[key[0]].copy_(src)
        for pos, entry in np.ndenumerate(entries):
            (c, _, _), (s,) = entry.opt_state[-1]
            if pos != (0, 0):
                c.copy_(count)
                s.copy_(sched)
            for key, per_column in new_stats.items():
                entry.model_state[key].copy_(per_column[pos[1]])
            for p in params[pos].values():
                p.grad = None
            entry.step += 1
    state.step += 1
    return {"loss": loss, "grad_norm": grad_norm}


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a floodsr_tpu_torch.parallel.mesh.Mesh; got {type(mesh).__name__}"
        )


def _mesh_of(state, mesh: "Mesh | None") -> "Mesh | None":
    """The mesh a step runs on: the step's, else a placed state's own."""
    if isinstance(state, ShardedTrainState):
        if mesh is not None and state.mesh != mesh:
            raise ValueError(f"the state is placed on {state.mesh}, the step runs on {mesh}")
        return state.mesh
    return mesh


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

    With ``mesh`` the batch splits over ``dp`` (:func:`_dp_shards`; its size a
    multiple of ``dp``) and the step runs on :func:`shard_train_state`'s
    placement (:func:`_train_on_mesh`); a state not yet placed is placed
    replicated, and the step returns the placed state. A placed state steps on
    its own mesh without ``mesh``. The metrics lie on the mesh's first device.
    """
    _check_mesh(mesh)
    optimizer = make_optimizer(train_cfg)

    def step_fn(state, batch: dict):
        on_mesh = _mesh_of(state, mesh)
        if on_mesh is not None:
            if not isinstance(state, ShardedTrainState):
                # placed replicated, as jax.jit places an uncommitted argument
                state = shard_train_state(state, on_mesh, replicated=True)
            elif not donate:
                state = copy.deepcopy(state, {id(state.mesh): state.mesh})
            return state, _train_on_mesh(state, optimizer, batch, compute_dtype)
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
    With ``mesh`` (or a placed state) the batch splits over ``dp``: row ``i``
    runs the forward on its first device with the whole weights, gathered
    from the ``tp`` pieces (one ``hr_tail`` call per row on the GPU), and the
    per-sample metrics are gathered to the mesh's first device and averaged
    over the global batch.
    """
    _check_mesh(mesh)

    def metrics_of(model: ResUNet, depth_lr, dem_hr, target_hr) -> dict[str, torch.Tensor]:
        pred = model(depth_lr[..., None], dem_hr[..., None])
        pred_m = invert_depth_log1p(pred[..., 0], train_cfg.max_depth)
        target_m = invert_depth_log1p(target_hr, train_cfg.max_depth)
        return depth_metrics_torch(target_m, pred_m, train_cfg.max_depth)

    def eval_fn(state, batch: dict) -> dict[str, torch.Tensor]:
        on_mesh = _mesh_of(state, mesh)
        if on_mesh is None:
            b = _on_device(batch, state.device)
            metrics = metrics_of(state.model, b["depth_lr"], b["dem_hr"], b["target_hr"])
            return {k: torch.mean(v.to(torch.float32)) for k, v in metrics.items()}
        shards = _dp_shards(batch, on_mesh)
        keys = ("depth_lr", "dem_hr", "target_hr")
        rows = [
            metrics_of(_row_model(state, dev, i), *(shards[k][i] for k in keys))
            for i, dev in enumerate(on_mesh.axis_devices("dp"))
        ]
        first = on_mesh.devices[0, 0]
        return {
            k: torch.mean(gather_to([r[k] for r in rows], first).to(torch.float32)) for k in rows[0]
        }

    return eval_fn


def _row_model(state, dev: torch.device, i: int) -> ResUNet:
    """Row ``i``'s whole model on ``dev`` for the inference forward: the
    entry's own where nothing is split, else its row's pieces gathered."""
    if isinstance(state, ShardedTrainState):
        if not state.split:
            return state.entries[i, 0].model
        trees = [e.model.state_dict() for e in state.entries[i]]
        return _model_of(state.cfg, _row_leaves(state, trees, dev))
    if state.device == dev:
        return state.model
    tensors = {k: t.to(dev, copy=True) for k, t in state.model.state_dict().items()}
    return _model_of(state.model.cfg, tensors)


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
    """Persist a full training checkpoint (params + BN state + opt state);
    a placed state is gathered first (:func:`unshard_train_state`)."""
    state = unshard_train_state(state)
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
    """Export an inference-only ``.fsrz`` (params + BN state, no opt state);
    a placed state is gathered first (:func:`unshard_train_state`)."""
    params, model_state = params_to_jax(unshard_train_state(state).model.state_dict())
    return save_artifact(
        fp, model_cfg, params, model_state, metadata or {}, store_dtype=store_dtype
    )
