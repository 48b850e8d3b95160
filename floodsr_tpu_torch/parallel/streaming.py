"""Double-buffered host→device streaming of training batches.

Port of the JAX package's ``floodsr_tpu/parallel/streaming.py``: keep the
NEXT batch's transfer in flight while the current one is consumed. On the GPU
each batch is copied from pinned host memory on a side stream, and the
consumer's stream waits on that copy's event before the batch is handed over,
so the copy of batch ``k+1`` overlaps the compute on batch ``k`` without a
host synchronization. On the CPU the batches become torch tensors in order.

With ``sharding=batch_sharding(mesh)`` each leaf is split on dim 0 over the
mesh's ``dp`` axis and each piece goes to its ``dp`` row's device (the first
of the row's ``tp`` devices), through one side stream per distinct CUDA
device.
"""

from __future__ import annotations

from collections import deque
from collections.abc import Iterable, Iterator
from typing import Any

import numpy as np
import torch

from floodsr_tpu_torch.device import resolve_device


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return [tree]


def prefetch_to_device(
    batches: Iterable[Any],
    *,
    buffer_size: int = 2,
    sharding=None,
    device: "str | torch.device" = "cuda",
) -> Iterator[Any]:
    """Yield device-resident batches, keeping ``buffer_size`` transfers in flight.

    ``batches`` yields trees (dicts, lists, tuples) of host arrays; each leaf
    becomes a tensor on ``device``, in the same order and with the same
    values. With ``sharding`` (a :class:`~floodsr_tpu_torch.parallel.mesh.
    NamedSharding` from ``batch_sharding`` or ``replicated_sharding``) each
    leaf becomes the list of its per-device shards in ``dp`` order: split on
    dim 0 over ``dp`` (which must divide it), or one whole copy per ``dp``
    row; ``device`` is then not used.
    """
    assert buffer_size >= 1, f"buffer_size must be >= 1; got {buffer_size}"
    if sharding is None:
        targets = [resolve_device(device)]
    else:
        if tuple(sharding.spec) not in ((), ("dp",)):
            raise ValueError(
                f"prefetch_to_device places batches split over dp or replicated; "
                f"got spec {sharding.spec}"
            )
        targets = sharding.mesh.axis_devices("dp")
    split = sharding is not None and tuple(sharding.spec) == ("dp",)
    streams = {
        dev: torch.cuda.Stream(dev) for dev in dict.fromkeys(targets) if dev.type == "cuda"
    }
    queue: deque[tuple[Any, Any]] = deque()
    iterator = iter(batches)

    def pieces(x) -> list[np.ndarray]:
        arr = np.asarray(x)
        if not split:
            return [arr] * len(targets)
        if arr.shape[0] % len(targets):
            raise ValueError(
                f"a leaf of {arr.shape[0]} rows does not split over dp={len(targets)}"
            )
        return np.split(arr, len(targets))

    def put_piece(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
        if dev.type != "cuda":
            return torch.tensor(arr)
        with torch.cuda.stream(streams[dev]):
            return torch.from_numpy(np.ascontiguousarray(arr)).pin_memory().to(
                dev, non_blocking=True
            )

    def put(batch: Any) -> tuple[Any, Any]:
        def leaf(x):
            placed = [put_piece(p, dev) for p, dev in zip(pieces(x), targets)]
            return placed if sharding is not None else placed[0]

        out = _tree_map(leaf, batch)
        ready = {}
        for dev, stream in streams.items():
            ready[dev] = torch.cuda.Event()
            ready[dev].record(stream)
        return out, ready

    try:
        for _ in range(buffer_size):
            queue.append(put(next(iterator)))
    except StopIteration:
        pass

    while queue:
        batch, ready = queue.popleft()
        try:
            queue.append(put(next(iterator)))
        except StopIteration:
            pass
        for dev, event in ready.items():
            torch.cuda.current_stream(dev).wait_event(event)
        for t in _tree_leaves(batch):
            if t.device.type == "cuda":
                # allocated on the copy stream, used on the consumer's: the
                # caching allocator must not reuse the memory before then
                t.record_stream(torch.cuda.current_stream(t.device))
        yield batch
