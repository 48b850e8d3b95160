"""Device mesh, placement rules and the collectives of multi-GPU inference.

Port of the JAX package's ``floodsr_tpu/parallel/mesh.py``. Two mesh axes:

- ``dp`` (data): shards the tile batch, or the scene's row bands;
- ``tp`` (tensor): the axis over which :func:`param_sharding_rules` splits
  a leaf's last dimension (convolution output channels).

**One process drives every device of the mesh.** JAX runs one controller
over its devices (``jax.jit`` + ``shard_map``) and XLA inserts the
collectives; the port keeps that shape rather than one process per GPU under
``torch.distributed``, which would need a launcher that none of ``tohr``, the
CLI or the one-thread daemon (``serve.py::TohrService``) has. So:

- a :class:`Mesh` is a ``(dp, tp)`` grid of ``torch.device`` s; entries may
  repeat one device (``[cuda:0] * 4`` on a one-GPU machine, ``[cpu] * 8`` in
  the CPU tests), which runs the same code that distinct GPUs run;
- a band's or a shard's work is enqueued on its own device's current stream;
- a ``ppermute`` becomes a device-to-device copy (:func:`to_device`): torch
  orders a copy between two CUDA devices by events on both devices' current
  streams, so no host synchronization is made per chunk;
- the convergence ``psum`` becomes a sum of per-band flags on one device
  (:func:`any_across`), read once per block by the caller;
- training's reductions are :func:`psum` (a sum of per-device pieces on one
  device) followed by :func:`broadcast`, and :func:`all_gather` concatenates
  the ``tp`` pieces of an activation on each device of a row. All three are
  made of ``Tensor.to``, ``+`` and ``torch.cat``, which autograd
  differentiates across devices: the backward of a broadcast is a ``psum``,
  that of an all-gather the slice of each piece summed over its receivers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from floodsr_tpu_torch.device import resolve_device

AXIS_NAMES = ("dp", "tp")


class Mesh:
    """A ``(dp, tp)`` grid of devices; ``shape`` is ``{"dp": .., "tp": ..}``.

    ``devices`` is an object array of ``torch.device`` shaped ``(dp, tp)``.
    Two meshes are equal (and hash alike) when they hold the same devices in
    the same places.
    """

    def __init__(self, devices, axis_names: tuple[str, str] = AXIS_NAMES):
        grid = np.asarray(devices, dtype=object)
        assert grid.ndim == 2, f"a mesh is a 2-D device grid; got shape {grid.shape}"
        self.devices = np.empty(grid.shape, dtype=object)
        for pos, dev in np.ndenumerate(grid):
            self.devices[pos] = resolve_device(dev)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str = "dp") -> list[torch.device]:
        """The device of each index along ``axis``: the first of its row or column."""
        if axis == self.axis_names[0]:
            return list(self.devices[:, 0])
        return list(self.devices[0, :])

    def distinct_devices(self) -> list[torch.device]:
        """The mesh's devices without repeats, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def _key(self):
        return (self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def visible_devices(device: "str | torch.device" = "cuda") -> list[torch.device]:
    """The devices a mesh may take: every visible GPU, or one CPU when asked.

    Raises without CUDA unless ``device`` is the CPU (as every entry point
    of the port does).
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: int | None = None,
    *,
    dp: int | None = None,
    tp: int = 1,
    devices=None,
    device: "str | torch.device" = "cuda",
) -> Mesh:
    """Build a ``(dp, tp)`` mesh over the first ``n_devices`` devices.

    ``devices`` defaults to :func:`visible_devices` of ``device``; it may
    repeat a device.
    """
    if devices is None:
        devices = visible_devices(device)
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    assert n_devices <= len(devices), (
        f"requested {n_devices} devices but only {len(devices)} available"
    )
    if dp is None:
        assert n_devices % tp == 0, f"n_devices={n_devices} not divisible by tp={tp}"
        dp = n_devices // tp
    assert dp * tp == n_devices, f"dp*tp={dp * tp} != n_devices={n_devices}"
    grid = np.empty((dp, tp), dtype=object)
    for i, dev in enumerate(devices[:n_devices]):
        grid[i // tp, i % tp] = dev
    return Mesh(grid)


def parse_mesh_spec(spec: str, device: "str | torch.device" = "cuda") -> Mesh:
    """Build a mesh from a CLI-style spec string.

    Accepted forms (user-facing via ``--mesh``):

    - ``"auto"``  — all visible devices, pure data parallel (tp=1)
    - ``"4"``     — first 4 devices, pure data parallel
    - ``"dp=4"`` / ``"dp=4,tp=2"`` — explicit axis sizes

    The visible devices are :func:`visible_devices` of ``device``. Raises
    ``ValueError`` with the accepted grammar on anything else (a CLI flag
    must not surface an assertion).
    """
    text = str(spec).strip().lower()
    if not text:
        raise ValueError("empty --mesh spec")
    devices = visible_devices(device)
    available = len(devices)
    if text == "auto":
        return make_mesh(devices=devices)
    if text.isdigit():
        dp, tp = int(text), 1
    else:
        dp = None
        tp = 1
        for part in text.split(","):
            key, _, value = part.partition("=")
            key = key.strip()
            if key not in ("dp", "tp") or not value.strip().isdigit():
                raise ValueError(
                    f"bad --mesh spec '{spec}'; expected 'auto', a device "
                    "count, or axis sizes like 'dp=4' / 'dp=4,tp=2'"
                )
            if key == "dp":
                dp = int(value)
            else:
                tp = int(value)
        if dp is None:
            if tp < 1 or available % tp != 0:
                raise ValueError(
                    f"--mesh '{spec}': {available} visible devices not "
                    f"divisible by tp={tp}"
                )
            dp = available // tp
    if dp < 1 or tp < 1:
        raise ValueError(f"--mesh '{spec}': axis sizes must be >= 1")
    n_devices = dp * tp
    if n_devices > available:
        raise ValueError(
            f"--mesh '{spec}' needs {n_devices} devices but only "
            f"{available} are visible"
        )
    return make_mesh(n_devices, dp=dp, tp=tp, devices=devices)


def mesh_device(mesh: Mesh, device: "str | torch.device") -> torch.device:
    """The device a meshed engine keeps its scene on: the mesh's first.

    Raises when ``device`` (the caller's ``device=``) names another kind of
    device than the mesh holds.
    """
    dev = resolve_device(device)
    first = mesh.devices.flat[0]
    if first.type != dev.type:
        raise ValueError(f"the mesh's devices are {first.type}, but device={dev}")
    return first


@dataclass(frozen=True)
class NamedSharding:
    """Placement of a leaf on a mesh: ``spec[i]`` names the mesh axis that
    splits dimension ``i`` (``None``: not split); ``()`` replicates."""

    mesh: Mesh
    spec: tuple = ()


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) dimension over ``dp``."""
    return NamedSharding(mesh, ("dp",))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def param_sharding_rules(mesh: Mesh, params: Any) -> Any:
    """Per-leaf :class:`NamedSharding` tree: the last dimension over ``tp``.

    A leaf's last dimension is sharded over ``tp`` when divisible by the axis
    size (conv ``w``/``b``, BN vectors); anything else is replicated. With
    ``tp=1`` this is full replication (pure data parallelism).
    """
    tp = mesh.shape["tp"]

    def rule(leaf):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if tp > 1 and len(shape) >= 1 and shape[-1] % tp == 0 and shape[-1] >= tp:
            return NamedSharding(mesh, (None,) * (len(shape) - 1) + ("tp",))
        return NamedSharding(mesh, ())

    return _tree_map(rule, params)


def shard_pytree(mesh: Mesh, tree: Any, shardings: Any | None = None) -> Any:
    """Place a tree's leaves on the mesh with the given (or rule-derived) shardings.

    Each leaf becomes an object array shaped like ``mesh.devices``: entry
    ``[i, j]`` is the piece that device holds, the whole leaf when replicated,
    or the ``j``-th chunk of its last dimension when split over ``tp``. A
    piece is copied once per device that holds it; repeated mesh entries
    share the copy.
    """
    if shardings is None:
        shardings = param_sharding_rules(mesh, tree)

    def place(leaf, sharding):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        split = "tp" in sharding.spec
        if split:
            pieces = torch.chunk(t, mesh.shape["tp"], dim=-1)
        copies: dict = {}
        out = np.empty(mesh.devices.shape, dtype=object)
        for (i, j), dev in np.ndenumerate(mesh.devices):
            piece = pieces[j] if split else t
            key = (dev, j if split else 0)
            if key not in copies:
                copies[key] = piece.to(dev).contiguous()
            out[i, j] = copies[key]
        return out

    return _tree_map(place, tree, shardings)


# ---------------------------------------------------------------------------
# collectives (what XLA inserts in the JAX package)
# ---------------------------------------------------------------------------


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device`` (itself when it is there already).

    Between two CUDA devices torch records an event on each device's current
    stream and makes the other wait on it, before and after the copy: the
    receiving stream is ordered after the sender's work with no host
    synchronization. A copy to the CPU blocks until its data is there (a
    non-blocking one may return before it is).
    """
    if t.device == device:
        return t
    return t.to(device, non_blocking=device.type == "cuda")


def ppermute(bufs: list[torch.Tensor], perm: list[tuple[int, int]]) -> list[torch.Tensor]:
    """``jax.lax.ppermute`` over per-band tensors: ``out[dst] = bufs[src]``.

    ``bufs[i]`` lives on band ``i``'s device; each received tensor lands on
    its receiver's device. A band that receives nothing gets zeros, as in JAX.
    """
    out = [torch.zeros_like(b) for b in bufs]
    for src, dst in perm:
        out[dst] = to_device(bufs[src], bufs[dst].device)
    return out


def any_across(flags: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The ``psum > 0`` of per-band boolean flags, as one boolean on ``device``.

    Nothing is read back: the caller reads the result once.
    """
    total = sum(to_device(f.to(torch.int32), device) for f in flags)
    return total > 0


def gather_to(pieces: list[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """Concatenate per-device pieces along ``dim`` on one device."""
    return torch.cat([to_device(p, device) for p in pieces], dim=dim)


def psum(pieces: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``jax.lax.psum`` of per-device pieces, as one tensor on ``device``.

    The pieces are added in the order given, the first one moved first.
    """
    total = to_device(pieces[0], device)
    for p in pieces[1:]:
        total = total + to_device(p, device)
    return total


def broadcast(t: torch.Tensor, devices: list[torch.device]) -> list[torch.Tensor]:
    """``t`` on each of ``devices``: one copy per distinct device, shared by
    the entries that repeat it (``t`` itself on its own device)."""
    copies: dict = {}
    for d in devices:
        if d not in copies:
            copies[d] = to_device(t, d)
    return [copies[d] for d in devices]


def all_gather(pieces: list[torch.Tensor], dim: int = 1) -> list[torch.Tensor]:
    """``jax.lax.all_gather(tiled=True)`` over a row's per-device pieces: the
    concatenation along ``dim`` on each piece's device, made once per distinct
    device and shared by the entries that repeat it."""
    full: dict = {}
    out = []
    for p in pieces:
        if p.device not in full:
            full[p.device] = torch.cat([to_device(q, p.device) for q in pieces], dim=dim)
        out.append(full[p.device])
    return out
