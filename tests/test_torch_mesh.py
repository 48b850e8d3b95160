"""The port's device mesh (``floodsr_tpu_torch/parallel/mesh.py``) and the
sharded ``prefetch_to_device``, against the JAX package's.

The JAX halves run on the suite's 8-device virtual CPU mesh; the port sees 8
devices through ``visible_devices`` patched to ``[cpu] * 8`` (a mesh whose
entries repeat one device, as on a one-GPU machine). Grammar, messages, axis
sizes and sharding specs are held equal; placed shards concatenate back to
their leaf exactly.
"""

import numpy as np
import pytest
import torch

import jax

from floodsr_tpu.parallel import make_mesh as make_mesh_jax
from floodsr_tpu.parallel import param_sharding_rules as rules_jax
from floodsr_tpu.parallel.mesh import parse_mesh_spec as parse_jax
from floodsr_tpu_torch.parallel import mesh as pm
from floodsr_tpu_torch.parallel.streaming import prefetch_to_device

pytestmark = [pytest.mark.unit, pytest.mark.multidev]

CPU = torch.device("cpu")


@pytest.fixture
def eight_cpus(monkeypatch):
    """The port sees eight devices, all the CPU, as the JAX suite sees eight."""
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual CPU devices"
    monkeypatch.setattr(pm, "visible_devices", lambda device="cuda": [CPU] * 8)


def _error(fn, *args, **kw):
    with pytest.raises((ValueError, AssertionError)) as err:
        fn(*args, **kw)
    return type(err.value), str(err.value)


def test_parse_mesh_spec_grammar_matches_jax(eight_cpus):
    for spec in ("auto", "4", "dp=2,tp=2", "tp=2", " DP=8 ", "dp=1"):
        got = pm.parse_mesh_spec(spec, device="cpu")
        assert got.shape == dict(parse_jax(spec).shape), spec
        assert got.axis_names == ("dp", "tp")
        assert all(d == CPU for d in got.devices.flat)


def test_parse_mesh_spec_errors_match_jax(eight_cpus):
    for bad in ("", "dp=x", "qq=2", "dp=999", "0", "999", "dp=0", "tp=3"):
        got = _error(pm.parse_mesh_spec, bad, device="cpu")
        want = _error(parse_jax, bad)
        assert got[0] is ValueError and got == want, bad


def test_parse_mesh_spec_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.parse_mesh_spec("auto")
    mesh = pm.parse_mesh_spec("auto", device="cpu")
    assert mesh.shape == {"dp": 1, "tp": 1}
    # a meshed engine keeps its scene on the mesh's first device
    assert pm.mesh_device(mesh, "cpu") == CPU
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.mesh_device(mesh, "cuda")


def test_make_mesh_shapes_and_assertions_match_jax():
    devices = [CPU] * 8
    for kw in ({"n_devices": 8, "tp": 2}, {"n_devices": 4}, {"dp": 8}, {"n_devices": 6, "dp": 3, "tp": 2}):
        assert pm.make_mesh(devices=devices, **kw).shape == dict(make_mesh_jax(**kw).shape)
    for kw in ({"n_devices": 8, "dp": 3, "tp": 2}, {"n_devices": 9}, {"n_devices": 6, "tp": 4}):
        got = _error(pm.make_mesh, devices=devices, **kw)
        assert got[0] is AssertionError and got == _error(make_mesh_jax, **kw), kw
    # the grid is row-major over the device list, as jax's reshape
    mesh = pm.make_mesh(devices=[torch.device("cpu", i) for i in range(4)], tp=2)
    assert [str(d) for d in mesh.devices[:, 0]] == ["cpu:0", "cpu:2"]
    assert mesh.axis_devices("tp") == [torch.device("cpu", 0), torch.device("cpu", 1)]
    assert mesh == pm.make_mesh(devices=[torch.device("cpu", i) for i in range(4)], tp=2)
    assert hash(mesh) != hash(pm.make_mesh(devices=[CPU] * 4, tp=2))


def test_param_sharding_rules_match_jax():
    rng = np.random.default_rng(11)
    params = {
        "w": rng.normal(size=(3, 3, 8, 16)).astype(np.float32),
        "b": np.zeros((16,), np.float32),
        "odd": np.zeros((7,), np.float32),
        "blocks": [{"g": np.ones((8,), np.float32)}, {"s": np.float32(2.0)}],
    }
    for tp in (1, 2):
        want = rules_jax(make_mesh_jax(8, tp=tp), params)
        got = pm.param_sharding_rules(pm.make_mesh(devices=[CPU] * 8, tp=tp), params)
        flat_want = jax.tree.leaves(want, is_leaf=lambda x: hasattr(x, "spec"))
        flat_got = jax.tree.leaves(got, is_leaf=lambda x: hasattr(x, "spec"))
        assert [tuple(s.spec) for s in flat_got] == [tuple(s.spec) for s in flat_want]


def test_shard_pytree_pieces_concatenate_back():
    rng = np.random.default_rng(12)
    tree = {"w": rng.normal(size=(3, 3, 4, 8)).astype(np.float32), "odd": np.arange(5.0)}
    mesh = pm.make_mesh(devices=[CPU] * 4, tp=2)
    placed = pm.shard_pytree(mesh, tree)
    for i in range(2):
        w = torch.cat([placed["w"][i, j] for j in range(2)], dim=-1)
        np.testing.assert_array_equal(w.numpy(), tree["w"])
        for j in range(2):
            np.testing.assert_array_equal(placed["odd"][i, j].numpy(), tree["odd"])
    # one copy per device and piece: repeated mesh entries share it
    assert placed["w"][0, 0] is placed["w"][1, 0]


def test_prefetch_with_a_batch_sharding_splits_over_dp():
    rng = np.random.default_rng(13)
    batches = [
        {"a": rng.normal(size=(8, 3)).astype(np.float32), "b": [np.arange(8) + i]}
        for i in range(5)
    ]
    mesh = pm.make_mesh(devices=[torch.device("cpu", i) for i in range(8)], tp=2)
    out = list(prefetch_to_device(iter(batches), buffer_size=3, sharding=pm.batch_sharding(mesh)))
    assert len(out) == 5
    for got, want in zip(out, batches):
        assert len(got["a"]) == 4  # one shard per dp row
        np.testing.assert_array_equal(torch.cat(got["a"]).numpy(), want["a"])
        np.testing.assert_array_equal(torch.cat(got["b"][0]).numpy(), want["b"][0])
    repl = list(prefetch_to_device(iter(batches[:1]), sharding=pm.replicated_sharding(mesh)))
    assert all(np.array_equal(t.numpy(), batches[0]["a"]) for t in repl[0]["a"])
    with pytest.raises(ValueError, match="does not split over dp=4"):
        list(prefetch_to_device(iter([np.zeros((6, 2))]), sharding=pm.batch_sharding(mesh)))


def test_prefetch_without_a_sharding_is_unchanged():
    batches = [{"a": np.full((4,), i, np.float32)} for i in range(7)]
    out = list(prefetch_to_device(iter(batches), buffer_size=3, device="cpu"))
    assert [float(b["a"][0]) for b in out] == list(range(7))
    assert all(isinstance(b["a"], torch.Tensor) and b["a"].device == CPU for b in out)


def test_collectives():
    bufs = [torch.full((2, 3), float(i)) for i in range(4)]
    got = pm.ppermute(bufs, [(d, d + 1) for d in range(3)])
    # jax.lax.ppermute: a band that receives nothing gets zeros
    assert [float(t[0, 0]) for t in got] == [0.0, 0.0, 1.0, 2.0]
    flags = [torch.tensor(False), torch.tensor(False), torch.tensor(True)]
    assert bool(pm.any_across(flags, CPU)) and not bool(pm.any_across(flags[:2], CPU))
    whole = pm.gather_to(bufs, CPU)
    assert whole.shape == (8, 3) and float(whole[-1, 0]) == 3.0
    assert pm.to_device(bufs[0], CPU) is bufs[0]
