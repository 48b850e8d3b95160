"""Double-buffered host→device streaming of training batches.

Port of the JAX package's ``floodsr_tpu/parallel/streaming.py``: keep the
NEXT batch's transfer in flight while the current one is consumed. On the GPU
each batch is copied from pinned host memory on a side stream, and the
consumer's stream waits on that copy's event before the batch is handed over,
so the copy of batch ``k+1`` overlaps the compute on batch ``k`` without a
host synchronization. On the CPU the batches become torch tensors in order.
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
    values. ``sharding`` (the JAX package's multi-device placement) is not
    taken here: placing a batch across GPUs belongs to the multi-GPU slice.
    """
    if sharding is not None:
        raise NotImplementedError(
            "prefetch_to_device(sharding=...) places batches across several GPUs; "
            "that comes with the multi-GPU slice of the port"
        )
    assert buffer_size >= 1, f"buffer_size must be >= 1; got {buffer_size}"
    dev = resolve_device(device)
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    queue: deque[tuple[Any, Any]] = deque()
    iterator = iter(batches)

    def put(batch: Any) -> tuple[Any, Any]:
        if copy_stream is None:
            return _tree_map(lambda x: torch.tensor(np.asarray(x)), batch), None
        with torch.cuda.stream(copy_stream):
            out = _tree_map(
                lambda x: torch.from_numpy(np.ascontiguousarray(x))
                .pin_memory()
                .to(dev, non_blocking=True),
                batch,
            )
            ready = torch.cuda.Event()
            ready.record(copy_stream)
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
        if ready is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            for t in _tree_leaves(batch):
                # allocated on the copy stream, used on the consumer's: the
                # caching allocator must not reuse the memory before then
                t.record_stream(consumer)
        yield batch
