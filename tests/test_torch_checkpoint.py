"""Port artifact loader vs the JAX package's, and the JAX→torch weight map."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from floodsr_tpu.nn.checkpoint import load_artifact as load_artifact_jax
from floodsr_tpu_torch.nn.checkpoint import load_artifact, params_from_jax, params_to_jax
from floodsr_tpu_torch.nn.resunet import ResUNet

pytestmark = pytest.mark.unit

ARTIFACTS = Path(__file__).parent / "data" / "_artifacts"
ARTIFACT_NAMES = ("model_infer_test.fsrz", "model_infer_flagship.fsrz")


@pytest.fixture(scope="module", params=ARTIFACT_NAMES)
def both(request):
    fp = ARTIFACTS / request.param
    return request.param, load_artifact(fp), load_artifact_jax(fp)


def _leaves_with_paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_every_leaf_equals_the_jax_loader_bit_for_bit(both):
    # Same file, same upcast (fp16 -> f32): the arrays must be identical.
    _, got, want = both
    assert got["config"].to_dict() == want["config"].to_dict()
    assert got["manifest"] == want["manifest"]
    for key in ("params", "state"):
        g = _leaves_with_paths(got[key])
        w = _leaves_with_paths(want[key])
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, a), (_, b) in zip(g, w):
            assert a.dtype == b.dtype == np.float32, path
            assert a.shape == b.shape, path
            assert np.array_equal(a, b), path


def test_flagship_leaf_and_parameter_counts():
    got = load_artifact(ARTIFACTS / "model_infer_flagship.fsrz")
    leaves = jax.tree_util.tree_leaves(got["params"])
    assert got["manifest"]["store_dtype"] == "float16"
    assert len(leaves) == 196
    assert sum(int(a.size) for a in leaves) == 16_661_616


def test_params_from_jax_round_trips_and_loads_strictly(both):
    _, got, _ = both
    sd = params_from_jax(got["params"], got["state"])
    params, state = params_to_jax(sd)
    for key, tree in (("params", params), ("state", state)):
        g = _leaves_with_paths(tree)
        w = _leaves_with_paths(got[key])
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, a), (_, b) in zip(g, w):
            assert np.array_equal(a, b), path
    model = ResUNet(got["config"])
    model.load_state_dict(sd, strict=True)
    # HWIO -> OIHW for every 4-D kernel.
    w_hwio = got["params"]["stem"]["w"]
    assert torch.equal(model.stem.w, torch.from_numpy(w_hwio.transpose(3, 2, 0, 1)))
