"""Model artifact loader: ``.fsrz`` = zip(manifest.json, params.npz, state.npz).

Reads the artifacts the JAX package writes (its ``nn/checkpoint.py``), and
holds the two helpers the ONNX converter writes one with: the
manifest records the architecture config and a skeleton of the parameter
tree whose leaves are named ``leaf_NNNNN`` in sorted-key order; fp16-stored
leaves are upcast to float32. :func:`params_from_jax` turns the numpy tree
into a PyTorch ``state_dict`` for :class:`floodsr_tpu_torch.nn.resunet.ResUNet`.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from floodsr_tpu_torch.nn.resunet import ResUNetConfig

ARTIFACT_FORMAT = "floodsr-tpu-fsrz"
ARTIFACT_VERSION = 1


def _rebuild(skeleton: Any, arrays: dict[str, np.ndarray]) -> Any:
    """Place the numbered leaves back into the skeleton's structure."""

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            if "__leaf__" in node and len(node) == 1:
                return arrays[f"leaf_{int(node['__leaf__']):05d}"]
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(v) for v in node]
        raise ValueError(f"unexpected skeleton node: {node!r}")

    return walk(skeleton)


def _skeleton(tree: Any) -> Any:
    """JSON-able structure mirror with leaf slots replaced by indices."""
    counter = [0]

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            # sorted key order: the order the leaves are numbered and stored in
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        idx = counter[0]
        counter[0] += 1
        return {"__leaf__": idx}

    return walk(tree)


# Fixed member timestamp (the zip epoch): the payload's bytes are a pure
# function of the arrays.
_ZIP_EPOCH = (1980, 1, 1, 0, 0, 0)


def _npz_bytes(arrays: dict[str, np.ndarray]) -> bytes:
    """np.savez-compatible bytes with deterministic (epoch) member headers."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_STORED) as zf:
        for key, arr in arrays.items():
            member = io.BytesIO()
            np.lib.format.write_array(member, np.asarray(arr), allow_pickle=False)
            info = zipfile.ZipInfo(f"{key}.npy", date_time=_ZIP_EPOCH)
            info.compress_type = zipfile.ZIP_STORED
            info.external_attr = 0o644 << 16
            zf.writestr(info, member.getvalue())
    return buf.getvalue()


def _read_npz(blob: bytes) -> dict[str, np.ndarray]:
    with np.load(io.BytesIO(blob)) as npz:
        return {
            k: (npz[k].astype(np.float32) if npz[k].dtype == np.float16 else npz[k])
            for k in npz.files
        }


def load_artifact(fp: str | Path) -> dict[str, Any]:
    """Load an artifact: ``{config, params, state, manifest}`` (numpy leaves)."""
    path = Path(fp).expanduser().resolve()
    if not path.exists():
        raise AssertionError(f"model artifact does not exist: {path}")
    try:
        with zipfile.ZipFile(path) as zf:
            manifest = json.loads(zf.read("manifest.json"))
            if manifest.get("format") != ARTIFACT_FORMAT:
                raise ValueError(f"not a floodsr-tpu artifact: {path}")
            params_arrays = _read_npz(zf.read("params.npz"))
            state_arrays = _read_npz(zf.read("state.npz"))
    except zipfile.BadZipFile as err:
        raise ValueError(f"not a floodsr-tpu artifact (bad zip): {path}") from err

    return {
        "config": ResUNetConfig.from_dict(manifest["config"]),
        "params": _rebuild(manifest["params_skeleton"], params_arrays),
        "state": _rebuild(manifest["state_skeleton"], state_arrays),
        "manifest": manifest,
    }


def _flatten(tree: Any, prefix: str, out: dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}.{k}" if prefix else k, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}.{i}" if prefix else str(i), out)
    else:
        out[prefix] = np.asarray(tree)


def params_from_jax(params: Any, state: Any) -> dict[str, torch.Tensor]:
    """Numpy ``(params, state)`` trees → a ResUNet ``state_dict``.

    Keys are the dotted tree paths (``enc.1.0.conv1.w``, ``fuse.0.bn1.mean``);
    4-D conv kernels go from HWIO to OIHW; BN ``scale``/``offset`` (params) and
    ``mean``/``var`` (state) keep their names beside each other.
    """
    flat: dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    state_flat: dict[str, np.ndarray] = {}
    _flatten(state, "", state_flat)
    overlap = flat.keys() & state_flat.keys()
    assert not overlap, f"params and state share keys: {sorted(overlap)[:5]}"
    flat.update(state_flat)
    out = {}
    for key, arr in flat.items():
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return out


def params_to_jax(state_dict: dict[str, torch.Tensor]) -> tuple[dict, dict]:
    """Inverse of :func:`params_from_jax`: ``state_dict`` → numpy trees."""
    params: dict = {}
    state: dict = {}
    for key, tensor in state_dict.items():
        arr = tensor.detach().cpu().numpy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        parts = key.split(".")
        root = state if parts[-1] in ("mean", "var") else params
        node = root
        for part, nxt in zip(parts[:-1], parts[1:]):
            node = node.setdefault(part, {})
        node[parts[-1]] = np.ascontiguousarray(arr)

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(params), listify(state)
