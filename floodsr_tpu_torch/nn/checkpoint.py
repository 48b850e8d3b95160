"""Model artifact format: ``.fsrz`` = zip(manifest.json, params.npz, state.npz).

Reads and writes the artifacts of the JAX package's ``nn/checkpoint.py``:
the manifest records the architecture config and a skeleton of the parameter
tree whose leaves are named ``leaf_NNNNN`` in sorted-key order; fp16-stored
leaves are upcast to float32. :func:`save_artifact` writes the same bytes as
the JAX package's for the same numpy trees, so an artifact's sha256 (which
keys the registry) does not depend on the package that wrote it.
:func:`params_from_jax` turns the numpy tree into a PyTorch ``state_dict`` for
:class:`floodsr_tpu_torch.nn.resunet.ResUNet`, :func:`params_to_jax` back.
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


def _zip_writestr(zf: zipfile.ZipFile, name: str, data: bytes | str, *, compress: int) -> None:
    info = zipfile.ZipInfo(name, date_time=_ZIP_EPOCH)
    info.compress_type = compress
    info.external_attr = 0o644 << 16
    zf.writestr(info, data)


def _npz_bytes(arrays: dict[str, np.ndarray]) -> bytes:
    """np.savez-compatible bytes with deterministic (epoch) member headers."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_STORED) as zf:
        for key, arr in arrays.items():
            member = io.BytesIO()
            np.lib.format.write_array(member, np.asarray(arr), allow_pickle=False)
            _zip_writestr(zf, f"{key}.npy", member.getvalue(), compress=zipfile.ZIP_STORED)
    return buf.getvalue()


def _leaves(tree: Any) -> list[np.ndarray]:
    """Leaves in the skeleton's numbering: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [np.asarray(tree)]


def save_artifact(
    fp: str | Path,
    config: ResUNetConfig,
    params: Any,
    state: Any,
    metadata: dict | None = None,
    *,
    store_dtype: str | None = None,
) -> Path:
    """Write a model artifact from numpy trees; returns the written path.

    ``store_dtype="float16"`` stores float32 leaves as half precision (the
    loader restores float32); the stored dtype is recorded in the manifest.
    The manifest is ``json.dumps(..., sort_keys=True)`` and every zip member
    carries the zip epoch, so the bytes are a pure function of the trees.
    """
    path = Path(fp).expanduser().resolve()
    path.parent.mkdir(parents=True, exist_ok=True)

    params_arrays = {f"leaf_{i:05d}": a for i, a in enumerate(_leaves(params))}
    state_arrays = {f"leaf_{i:05d}": a for i, a in enumerate(_leaves(state))}
    if store_dtype == "float16":
        def half(arrays):
            return {
                k: (a.astype(np.float16) if a.dtype == np.float32 else a)
                for k, a in arrays.items()
            }

        params_arrays = half(params_arrays)
        state_arrays = half(state_arrays)
    elif store_dtype is not None:
        raise ValueError(f"unsupported store_dtype {store_dtype!r}")
    manifest = {
        "format": ARTIFACT_FORMAT,
        "version": ARTIFACT_VERSION,
        "architecture": "ResUNet_DEM",
        "config": config.to_dict(),
        "io_contract": {
            "depth_input_name": "depth_lr",
            "dem_input_name": "dem_hr",
            "output_name": "depth_hr_pred",
            "depth_lr_hwc": [config.lr_tile, config.lr_tile, 1],
            "dem_hr_hwc": [config.hr_tile, config.hr_tile, 1],
            "output_hwc": [config.hr_tile, config.hr_tile, 1],
            "scale": config.scale,
        },
        "params_skeleton": _skeleton(params),
        "state_skeleton": _skeleton(state),
        "store_dtype": store_dtype or "float32",
        "metadata": metadata or {},
    }
    with zipfile.ZipFile(path, "w") as zf:
        _zip_writestr(
            zf, "manifest.json", json.dumps(manifest, sort_keys=True),
            compress=zipfile.ZIP_DEFLATED,
        )
        _zip_writestr(zf, "params.npz", _npz_bytes(params_arrays), compress=zipfile.ZIP_DEFLATED)
        _zip_writestr(zf, "state.npz", _npz_bytes(state_arrays), compress=zipfile.ZIP_DEFLATED)
    return path


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
