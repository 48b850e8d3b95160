"""Reads a ``.fsrz`` artifact (zip: manifest, ``params.npz``, ``state.npz``)
into flat dotted names → float32 arrays, kernels in HWIO as stored."""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path

import numpy as np


def read_artifact(fp: Path) -> tuple[dict, dict[str, np.ndarray]]:
    """``(architecture, arrays)`` of the artifact at ``fp``."""
    with zipfile.ZipFile(fp) as zf:
        manifest = json.loads(zf.read("manifest.json"))
        blobs = {k: zf.read(f"{k}.npz") for k in ("params", "state")}
    flat: dict[str, np.ndarray] = {}
    for kind, blob in blobs.items():
        with np.load(io.BytesIO(blob)) as npz:
            leaves = {k: npz[k].astype(np.float32) for k in npz.files}

        def walk(node, prefix):
            if isinstance(node, dict) and set(node) == {"__leaf__"}:
                flat[prefix] = leaves[f"leaf_{int(node['__leaf__']):05d}"]
            elif isinstance(node, dict):
                for k in sorted(node):
                    walk(node[k], f"{prefix}.{k}" if prefix else k)
            else:
                for i, v in enumerate(node):
                    walk(v, f"{prefix}.{i}" if prefix else str(i))

        walk(manifest[f"{kind}_skeleton"], "")
    return manifest["config"], flat
