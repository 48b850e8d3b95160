"""The port's train step on a mesh against the JAX package's and its own
single step, on the CPU.

The port's meshes are ``make_mesh(devices=[cpu] * 8)`` at ``(dp=8, tp=1)``
and ``(dp=4, tp=2)``: a mesh may repeat a device, and every entry still holds
copies of its own, so the CPU runs the reductions and broadcasts that
distinct GPUs run. The JAX half is ``floodsr_tpu.train.make_train_step(
mesh=make_mesh(8, tp=2))`` on the suite's 8 virtual devices, with the state
placed as the JAX package's multichip dry run places it (``param_sharding_rules``
over params, BN state and Adam moments), computed once per module.

Tolerances, those of ``tests/test_torch_train_step.py``: the loss and
``grad_norm`` to rtol 1e-5; after each step every parameter within Adam's
bound ``3.2 · Σ lr`` of its start, and within 1e-3 of its leaf's largest
displacement except 0.1% of the leaf's elements (at least one): Adam divides
each element by its own ``sqrt(nu)``, so an element whose gradient is at the
rounding noise moves by ``lr`` either way. ``conv1.b`` feeds a batch norm
alone, so its true gradient is 0: it is held to Adam's bound alone, its
moments to 1e-3 of the largest moment. The other moments within 1e-3 of their
leaf's largest, the counts exactly, the running stats within 1e-5 (``bn2.mean``
sees ``conv1.b`` through its batch mean: ``(1 − momentum) · 2 · 3.2 · Σ lr``
more). The global batch norm is held to the unsharded ``forward_train``: the
output within 1e-5 of its max, the stats 1e-5, each gradient leaf within 1e-4
of its max (``conv1.b`` of the largest). The JAX package cannot differentiate
bf16 (ROADMAP §3): a bf16 step on a mesh is held to the port's single bf16
step, the loss and the stats as above, the gradient norm to rtol 1e-3 and the
first moments to a cosine above 0.9999 (bf16 roundings flip in the backward).

Each test here runs torch on one thread (``one_thread``): oneDNN's threads
make the many small convolutions of a mesh step 30 times slower on the CPU.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import jax

from floodsr_tpu.nn.resunet import ResUNetConfig as ResUNetConfigJax
from floodsr_tpu.nn.resunet import init_resunet as init_resunet_jax
from floodsr_tpu.parallel import batch_sharding as batch_sharding_jax
from floodsr_tpu.parallel import make_mesh as make_mesh_jax
from floodsr_tpu.parallel import param_sharding_rules as rules_jax
from floodsr_tpu.parallel import replicated_sharding as replicated_jax
from floodsr_tpu.train import trainer as tj
from floodsr_tpu_torch.nn import resunet as rn
from floodsr_tpu_torch.nn.checkpoint import params_to_jax
from floodsr_tpu_torch.nn.resunet import ResUNetConfig
from floodsr_tpu_torch.parallel.mesh import batch_sharding, make_mesh
from floodsr_tpu_torch.parallel.streaming import prefetch_to_device
from floodsr_tpu_torch.train import trainer as tt

pytestmark = [pytest.mark.unit, pytest.mark.multidev]

TINY = dict(
    base_filters=8, levels=2, enc_blocks=1, dec_blocks=1,
    fuse_filters=8, fuse_blocks=1, scale=4, lr_tile=8,
)
# two fuse blocks, the first with a projection (a fused tail in inference)
NARROW = dict(TINY, fuse_blocks=2, hr_s2d=2)
TCFG = dict(total_steps=100, base_lr=1e-3)  # the first gradient norm is ~4: clipnorm 1 clips
LR = TCFG["base_lr"]
CPU = torch.device("cpu")
MESHES = {"dp8": 1, "dp4_tp2": 2}
STEPS = 2
# a bf16 step on a mesh against the single bf16 step: the loss and the stats
# at the f32 step's tolerance; bf16 roundings flip in the backward (the
# gradient norm moves by 2e-5 to 5e-5 in these runs)
BF16_GRAD_NORM_RTOL = 1e-3
BF16_COSINE = 0.9999


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mesh(tp: int, n: int = 8):
    return make_mesh(devices=[CPU] * n, tp=tp)


def _batch(cfg: dict, n: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    lr, hr = cfg["lr_tile"], cfg["lr_tile"] * cfg["scale"]
    return {
        "depth_lr": rng.uniform(0, 1, (n, lr, lr)).astype(np.float32),
        "dem_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
        "target_hr": rng.uniform(0, 1, (n, hr, hr)).astype(np.float32),
    }


def _paths(tree) -> dict[str, np.ndarray]:
    """``{path: copy}``: a CPU tensor's numpy view changes with the next step."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): np.array(v) for k, v in flat}


def _noise_leaf(path: str) -> bool:
    # conv1.b feeds the block's second batch norm alone: zero true gradient
    return path.endswith("['conv1']['b']")


def _numpy_state(state) -> dict:
    """params, BN state, moments and counts of a port state (placed or not)."""
    whole = tt.unshard_train_state(state)
    params, model_state = params_to_jax(whole.model.state_dict())
    (count, mu, nu), (sched,) = tt.opt_state_to_numpy(whole.opt_state)[-1]
    return {"params": _paths(params), "state": _paths(model_state), "mu": _paths(mu),
            "nu": _paths(nu), "counts": (int(count), int(sched))}


def _hold(got: dict, want: dict, init: dict, steps: int) -> None:
    bound = 3.2 * LR * steps
    for key, w in want["params"].items():
        g = got["params"][key]
        assert np.abs(g - init[key]).max() <= bound, key
        if _noise_leaf(key):
            continue
        off = np.abs(g - w) > 1e-3 * np.abs(w - init[key]).max()
        assert off.sum() <= max(1, 1e-3 * off.size), (key, off.sum(), np.abs(g - w).max())
    for key, w in want["state"].items():
        atol = 1e-5 + (0.02 * bound if key.endswith("['bn2']['mean']") else 0.0)
        np.testing.assert_allclose(got["state"][key], w, rtol=0, atol=atol, err_msg=key)
    for kind in ("mu", "nu"):
        top = max(np.abs(v).max() for v in want[kind].values())
        for key, w in want[kind].items():
            scale = top if _noise_leaf(key) else np.abs(w).max()
            np.testing.assert_allclose(got[kind][key], w, rtol=0, atol=1e-3 * scale, err_msg=key)
    assert got["counts"] == want["counts"] == (steps, steps)


def _jax_placed(state, mesh):
    """The state placed with the production rules (the JAX package's dry run)."""
    opt = jax.tree.map(
        lambda leaf: rules_jax(mesh, leaf) if not np.isscalar(leaf) else replicated_jax(mesh),
        state.opt_state, is_leaf=lambda x: hasattr(x, "shape") or np.isscalar(x),
    )
    return tj.TrainState(
        step=jax.device_put(state.step, replicated_jax(mesh)),
        params=jax.tree.map(jax.device_put, state.params, rules_jax(mesh, state.params)),
        model_state=jax.tree.map(jax.device_put, state.model_state, rules_jax(mesh, state.model_state)),
        opt_state=jax.tree.map(jax.device_put, state.opt_state, opt),
    )


@pytest.fixture(scope="module")
def runs():
    """Two steps of the JAX package's sharded step and of the port's single
    step from the same start, with each step's metrics and state."""
    cj = ResUNetConfigJax(**TINY)
    mesh = make_mesh_jax(8, tp=2)
    state = _jax_placed(tj.init_train_state(0, cj, tj.TrainConfig(**TCFG)), mesh)
    step = tj.make_train_step(cj, tj.TrainConfig(**TCFG), mesh=mesh, donate=False)
    single = tt.init_train_state(0, ResUNetConfig(**TINY), tt.TrainConfig(**TCFG), device="cpu")
    single_step = tt.make_train_step(ResUNetConfig(**TINY), tt.TrainConfig(**TCFG))
    batches = [_batch(TINY, 8, seed=20 + i) for i in range(STEPS)]
    out = {"batches": batches, "jax": [], "single": [], "init": _paths(init_resunet_jax(0, cj)[0])}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for b in batches:
        state, m = step(state, {k: jax.device_put(v, batch_sharding_jax(mesh)) for k, v in b.items()})
        host = jax.tree.map(np.asarray, state)
        (count, mu, nu), (sched,) = host.opt_state[-1]
        out["jax"].append(({k: float(v) for k, v in m.items()}, {
            "params": _paths(host.params), "state": _paths(host.model_state),
            "mu": _paths(mu), "nu": _paths(nu), "counts": (int(count), int(sched)),
        }))
        single, m = single_step(single, b)
        out["single"].append(({k: float(v) for k, v in m.items()}, _numpy_state(single)))
    torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_step_matches_jax_and_the_single_step(runs, mesh_name):
    mesh = _mesh(MESHES[mesh_name])
    state = tt.shard_train_state(
        tt.init_train_state(0, ResUNetConfig(**TINY), tt.TrainConfig(**TCFG), device="cpu"), mesh
    )
    step = tt.make_train_step(ResUNetConfig(**TINY), tt.TrainConfig(**TCFG), mesh=mesh)
    for i, b in enumerate(runs["batches"]):
        state, metrics = step(state, b)
        assert all(m.device == CPU and m.shape == () for m in metrics.values())
        got = _numpy_state(state)
        for want_metrics, want in (runs["jax"][i], runs["single"][i]):
            np.testing.assert_allclose(float(metrics["loss"]), want_metrics["loss"], rtol=1e-5)
            np.testing.assert_allclose(float(metrics["grad_norm"]), want_metrics["grad_norm"], rtol=1e-5)
            _hold(got, want, runs["init"], i + 1)
    assert state.step == STEPS and all(e.step == STEPS for e in state.entries.flat)
    assert float(runs["jax"][0][0]["grad_norm"]) > 1.0  # the clip ran


def _grads_of_copies(state: tt.ShardedTrainState) -> dict[str, np.ndarray]:
    """Each leaf's gradient: the sum of its copies' over the row index, the
    ``tp`` pieces concatenated."""
    out = {}
    dp, tp = state.entries.shape
    for name in dict(state.entries[0, 0].model.named_parameters()):
        per_column = [
            sum(dict(state.entries[i, j].model.named_parameters())[name].grad for i in range(dp))
            for j in range(tp)
        ]
        out[name] = torch.cat(per_column) if name in state.split else sum(per_column)
    return out


@pytest.mark.parametrize("tp", [1, 2])
def test_global_batch_norm_and_its_gradients_match_the_unsharded_forward(tp):
    cfg = ResUNetConfig(**NARROW)
    b = _batch(NARROW, 4, seed=5)
    single = tt.init_train_state(3, cfg, tt.TrainConfig(), device="cpu")
    mesh = _mesh(tp, n=2 * tp)  # two shards of two samples
    placed = tt.shard_train_state(single, mesh)
    cot = np.random.default_rng(6).normal(size=b["dem_hr"].shape).astype(np.float32)

    want, want_stats = single.model.forward_train(
        torch.from_numpy(b["depth_lr"])[..., None], torch.from_numpy(b["dem_hr"])[..., None]
    )
    (want[..., 0] * torch.from_numpy(cot)).sum().backward()
    want_grads = {k: p.grad for k, p in single.model.named_parameters()}

    tensors = np.empty(mesh.devices.shape, dtype=object)
    for pos, e in np.ndenumerate(placed.entries):
        tensors[pos] = {**dict(e.model.named_parameters()), **e.model_state}
    shard = {k: [[torch.from_numpy(v[2 * i:2 * i + 2])[..., None]] * tp for i in range(2)]
             for k, v in b.items()}
    preds, stats = rn.forward_train_mesh(
        cfg, tensors, placed.split, mesh.devices, shard["depth_lr"], shard["dem_hr"]
    )
    sum((p[..., 0] * torch.from_numpy(c)).sum() for p, c in zip(preds, np.split(cot, 2))).backward()

    got, want = torch.cat(preds).detach().numpy(), want.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    for key, w in want_stats.items():
        g = torch.cat(stats[key]) if key in placed.split else stats[key][0]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=key)
    got_grads = _grads_of_copies(placed)
    top = max(float(g.abs().max()) for g in want_grads.values())
    for key, w in want_grads.items():
        scale = top if key.endswith("conv1.b") else float(w.abs().max())
        np.testing.assert_allclose(got_grads[key].numpy(), w.numpy(), rtol=0, atol=1e-4 * scale, err_msg=key)

    # two passes: features far from zero keep their variance (E[x²] − E[x]² would not)
    x = torch.from_numpy(np.random.default_rng(7).normal(1e4, 1.0, (4, 3, 8, 8)).astype(np.float32))
    bn = rn.BatchNorm(3)
    y_want, mean_want, var_want = bn.batch_affine(x, 1e-3, 0.99)
    ys, mean, var = rn.batch_norm_across(list(x.split(2)), [bn.scale] * 2, [bn.offset] * 2, 1e-3)
    np.testing.assert_allclose(var.numpy(), torch.var(x, dim=(0, 2, 3), correction=0).numpy(), rtol=1e-4)
    np.testing.assert_allclose(torch.cat(ys).numpy(), y_want.numpy(), rtol=0, atol=1e-3)


def _piece(whole: dict, key: str, j: int, split) -> torch.Tensor:
    """Piece ``j`` of 2 of a split leaf, else the whole leaf."""
    return torch.chunk(whole[key], 2)[j] if key in split else whole[key]


def test_placement_replicas_and_pieces():
    cfg = ResUNetConfig(**TINY)
    mesh = _mesh(2)
    state = tt.init_train_state(0, cfg, tt.TrainConfig(**TCFG), device="cpu")
    placed = tt.shard_train_state(state, mesh)
    # the split leaves are those param_sharding_rules splits in the JAX layout
    mesh_j = make_mesh_jax(8, tp=2)
    want, got = set(), set()
    for tree in init_resunet_jax(0, ResUNetConfigJax(**TINY)):
        split = _paths(jax.tree.map(lambda r: "tp" in r.spec, rules_jax(mesh_j, tree)))
        want |= {k for k, is_split in split.items() if is_split}
    for tree in params_to_jax({k: torch.zeros(1) for k in placed.split}):
        got |= set(_paths(tree))
    assert got == want and len(want) > 0

    step = tt.make_train_step(cfg, tt.TrainConfig(**TCFG), mesh=mesh)
    for i in range(STEPS):
        placed, _ = step(placed, _batch(TINY, 8, seed=30 + i))
    whole = tt.unshard_train_state(placed)
    full = whole.model.state_dict()
    (_, mu_full, nu_full), _ = whole.opt_state[-1]
    for (i, j), entry in np.ndenumerate(placed.entries):
        first = placed.entries[0, j]
        sd, sd0 = entry.model.state_dict(), first.model.state_dict()
        (_, mu, nu), _ = entry.opt_state[-1]
        for key, t in sd.items():
            # every replica of a piece is the same bits as row 0's
            assert torch.equal(t, sd0[key]), (i, j, key)
            assert torch.equal(t, _piece(full, key, j, placed.split)), (i, j, key)
            if key in mu:
                assert torch.equal(mu[key], _piece(mu_full, key, j, placed.split))
                assert torch.equal(nu[key], _piece(nu_full, key, j, placed.split))
        (c, _, _), (s,) = entry.opt_state[-1]
        assert int(c) == int(s) == STEPS
    assert placed.entries[0, 0].model.stem.w.shape[0] == cfg.base_filters // 2


def test_each_convolution_piece_is_computed_on_its_own_entry(monkeypatch):
    cfg = ResUNetConfig(**NARROW)
    mesh = _mesh(2, n=4)
    state = tt.init_train_state(1, cfg, tt.TrainConfig(), device="cpu")
    placed = tt.shard_train_state(state, mesh)
    calls = []
    for fn in ("conv2d_same", "conv_transpose_nhwc"):
        real = getattr(rn, fn)

        def record(x, conv, stride, real=real, fn=fn):
            out = real(x, conv, stride)
            calls.append((fn, x, conv, stride, out))
            return out

        monkeypatch.setattr(rn, fn, record)
    tensors = np.empty(mesh.devices.shape, dtype=object)
    owner = {}
    for pos, e in np.ndenumerate(placed.entries):
        tensors[pos] = {**dict(e.model.named_parameters()), **e.model_state}
        owner.update({id(t): (pos, k) for k, t in tensors[pos].items()})
    b = _batch(NARROW, 4, seed=9)
    shard = {
        k: [[torch.from_numpy(v[2 * i:2 * i + 2])[..., None]] * 2 for i in range(2)]
        for k, v in b.items()
    }
    rn.forward_train_mesh(cfg, tensors, placed.split, mesh.devices, shard["depth_lr"], shard["dem_hr"])
    monkeypatch.undo()

    full = dict(state.model.named_parameters())
    by_conv: dict = {}
    for fn, x, conv, stride, out in calls:
        (i, j), key = owner[id(conv.w)]
        assert key in placed.split and out.device == mesh.devices[i, j]
        assert torch.equal(conv.w, torch.chunk(full[key], 2)[j])
        by_conv.setdefault((key, i), []).append((fn, x, stride, out))
    names = {k[:-2] for k in full if k.endswith(".w")}
    assert {k[:-2] for k, _ in by_conv} == names
    for (key, i), pieces in by_conv.items():
        assert len(pieces) == 2
        fn, x, stride, _ = pieces[0]
        whole = rn.Conv(1, 1, 1, 1)
        whole.w, whole.b = full[key], full[key[:-2] + ".b"]
        with torch.no_grad():
            if fn == "conv2d_same":
                want = rn.conv2d_same(x, whole, stride)
                got = torch.cat([p[3] for p in pieces], dim=1)
            else:
                want = rn.conv_transpose_nhwc(x, whole, stride)
                got = torch.cat([p[3] for p in pieces], dim=-1)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_donate_false_and_an_unplaced_state():
    cfg = ResUNetConfig(**TINY)
    mesh = _mesh(2)
    b = _batch(TINY, 8, seed=40)
    state = tt.init_train_state(0, cfg, tt.TrainConfig(**TCFG), device="cpu")
    before = copy.deepcopy(state.model.state_dict())
    # an unplaced state is placed replicated and left as it was
    placed, m_repl = tt.make_train_step(cfg, tt.TrainConfig(**TCFG), mesh=mesh)(state, b)
    assert isinstance(placed, tt.ShardedTrainState) and not placed.split and placed.step == 1
    assert state.step == 0 and all(torch.equal(before[k], v) for k, v in state.model.state_dict().items())
    # donate=False leaves every entry of a placed state as it was
    by_rules = tt.shard_train_state(state, mesh)
    snapshot = [copy.deepcopy(e.model.state_dict()) for e in by_rules.entries.flat]
    new, m_rules = tt.make_train_step(cfg, tt.TrainConfig(**TCFG), mesh=mesh, donate=False)(by_rules, b)
    assert new is not by_rules and new.step == 1 and by_rules.step == 0
    for e, snap in zip(by_rules.entries.flat, snapshot):
        assert all(torch.equal(snap[k], v) for k, v in e.model.state_dict().items())
        (c, _, _), _ = e.opt_state[-1]
        assert int(c) == 0
    # with donation the state is stepped in place
    same, _ = tt.make_train_step(cfg, tt.TrainConfig(**TCFG), mesh=mesh)(by_rules, b)
    assert same is by_rules and by_rules.step == 1
    # replicated and by the rules, the same step
    np.testing.assert_allclose(float(m_repl["loss"]), float(m_rules["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_repl["grad_norm"]), float(m_rules["grad_norm"]), rtol=1e-5)
    # a placed state steps on its own mesh; another mesh refuses it
    tt.make_train_step(cfg, tt.TrainConfig(**TCFG))(new, b)
    assert new.step == 2
    with pytest.raises(ValueError, match="placed on"):
        tt.make_train_step(cfg, tt.TrainConfig(**TCFG), mesh=_mesh(1))(new, b)


def test_a_batch_that_dp_does_not_divide_fails_as_the_jax_step_does():
    cfg = ResUNetConfig(**TINY)
    bad = _batch(TINY, 6, seed=41)
    mesh_j = make_mesh_jax(8, tp=2)
    state_j = tj.init_train_state(0, ResUNetConfigJax(**TINY), tj.TrainConfig(**TCFG))
    with pytest.raises(ValueError, match="should be divisible by 4, but it is equal to 6"):
        tj.make_train_step(ResUNetConfigJax(**TINY), tj.TrainConfig(**TCFG), mesh=mesh_j)(state_j, bad)
    state = tt.init_train_state(0, cfg, tt.TrainConfig(**TCFG), device="cpu")
    with pytest.raises(ValueError, match="should be divisible by 4, but it is equal to 6"):
        tt.make_train_step(cfg, tt.TrainConfig(**TCFG), mesh=_mesh(2))(state, bad)
    with pytest.raises(ValueError, match="should be divisible by 4, but it is equal to 6"):
        tt.make_eval_step(cfg, tt.TrainConfig(**TCFG), mesh=_mesh(2))(state, bad)


def test_prefetched_shards_step_as_the_host_batch():
    cfg = ResUNetConfig(**TINY)
    mesh = _mesh(2)
    batches = [_batch(TINY, 8, seed=50 + i) for i in range(2)]
    start = tt.init_train_state(0, cfg, tt.TrainConfig(**TCFG), device="cpu")
    results = []
    for feed in (batches, prefetch_to_device(iter(batches), sharding=batch_sharding(mesh))):
        state = tt.shard_train_state(start, mesh)
        step = tt.make_train_step(cfg, tt.TrainConfig(**TCFG), mesh=mesh)
        losses = []
        for b in feed:
            if feed is not batches:
                assert all(isinstance(v, list) and len(v) == 4 for v in b.values())
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        results.append((losses, tt.unshard_train_state(state).model.state_dict()))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(results[0][1][k], results[1][1][k]) for k in results[0][1])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_bfloat16_on_a_mesh_matches_the_single_bf16_step(mesh_name):
    cfg = ResUNetConfig(**NARROW)
    tcfg = tt.TrainConfig(**TCFG)
    b = _batch(NARROW, 8, seed=60)
    single = tt.init_train_state(2, cfg, tcfg, device="cpu")
    placed = tt.shard_train_state(single, _mesh(MESHES[mesh_name]))
    single, want = tt.make_train_step(cfg, tcfg, compute_dtype=torch.bfloat16)(single, b)
    placed, got = tt.make_train_step(cfg, tcfg, mesh=placed.mesh, compute_dtype=torch.bfloat16)(placed, b)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=BF16_GRAD_NORM_RTOL)
    g, w = _numpy_state(placed), _numpy_state(single)
    flat_g = np.concatenate([g["mu"][k].ravel() for k in w["mu"]])
    flat_w = np.concatenate([w["mu"][k].ravel() for k in w["mu"]])
    assert flat_g @ flat_w / (np.linalg.norm(flat_g) * np.linalg.norm(flat_w)) > BF16_COSINE
    for key in w["state"]:
        np.testing.assert_allclose(g["state"][key], w["state"][key], rtol=0, atol=1e-5, err_msg=key)

