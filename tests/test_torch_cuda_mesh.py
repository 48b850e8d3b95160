"""Multi-GPU inference on the card: the banded and replicated scenes and the
banded CostGrow fill, held against the single-device paths.

Every test here needs an NVIDIA GPU and skips without one; the two-GPU case
skips under two devices. The file imports no JAX; run it beside the other
CUDA-only tests: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda_mesh.py``.

A mesh of ``[cuda:0] * 4`` runs four bands (or four shards) on one card,
through the code two real GPUs run. cuDNN picks a convolution algorithm by
batch size, and randomly initialised weights at the flagship's widths carry
the change to the output (1e-3 m and more), so every path here runs each tile
at one batch width (``WIDTH``: the scene's 20 tiles and its bands' 8/4/4/4
split into batches of 4). Tolerances: a meshed scene agrees with the plain
scene to 1e-4 m (the sums at a seam run in another order), the per-tile stats
are the same bits; the banded fill equals ``mcp_fill`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from floodsr_tpu_torch.engine import EngineTorch
from floodsr_tpu_torch.nn.checkpoint import save_artifact
from floodsr_tpu_torch.nn.resunet import ResUNetConfig, init_resunet
from floodsr_tpu_torch.ops.costgrow import mcp_fill
from floodsr_tpu_torch.ops.costgrow_banded import mcp_fill_sharded
from floodsr_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from floodsr_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.cuda

# the flagship's widths (the fused tail's tensor-core route), 512² HR tiles
FLAGSHIP = dict(
    base_filters=32, levels=4, enc_blocks=2, dec_blocks=2, fuse_filters=32,
    fuse_blocks=2, scale=16, lr_tile=32, hr_s2d=4,
)
SCENE = (2048, 1536)
RUN = dict(stride_hr=384, overlap_hr=128, max_depth=5.0, dem_pct_clip=95.0)
WIDTH = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the mesh's kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def artifact(tmp_path, cuda_device):
    cfg = ResUNetConfig(**FLAGSHIP)
    params, state = init_resunet(3, cfg)
    fp = tmp_path / "flagship_widths.fsrz"
    save_artifact(fp, cfg, params, state, {"purpose": "mesh test"})
    rng = np.random.default_rng(8)
    dem = (300.0 + np.cumsum(rng.normal(0.0, 0.3, SCENE), axis=1)).astype(np.float32)
    depth = rng.gamma(1.5, 0.6, (SCENE[0] // 16, SCENE[1] // 16)).clip(0, 5).astype(np.float32)
    return fp, depth, dem


def _scene(fp, depth, dem, mesh=None, mode="replicated"):
    dp = 1 if mesh is None else mesh.shape["dp"]
    eng = EngineTorch(
        fp, mesh=mesh, scene_mode=mode, output_transfer="float32", max_batch=WIDTH,
        scene_chunk=WIDTH * (dp if mode == "replicated" else 1), scene_trunk_chunk=WIDTH,
    )
    reset_launch_counts()
    out, stats = eng.run_scene(depth, dem, crop_shape=SCENE, **RUN)
    torch.cuda.synchronize()
    counts = launch_counts()
    eng.close()
    return out, stats, counts


def _hold(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k])
    assert got[2]["hr_tail"] > 0 and got[2]["tile_stats"] > 0, got[2]


@pytest.mark.parametrize("mode", ["banded", "replicated"])
def test_four_bands_on_one_card_equal_the_plain_scene(artifact, cuda_device, mode):
    plain = _scene(*artifact)
    _hold(_scene(*artifact, make_mesh(devices=[cuda_device] * 4), mode), plain)


def _fill_problem(seed, h, w):
    rng = np.random.default_rng(seed)
    domain = rng.random((h, w)) > 0.05
    cost = rng.uniform(1.0, 5.0, (h, w)).astype(np.float32)
    seeds = np.zeros((h, w), bool)
    seeds[rng.integers(0, h, 40), rng.integers(0, w, 40)] = True
    seeds &= domain
    values = np.where(seeds, rng.normal(size=(h, w)) * 10, np.nan).astype(np.float32)
    return values, seeds, cost, domain


def _hold_fill(problem, mesh, device):
    reset_launch_counts()
    got_fill, got_dist = mcp_fill_sharded(*problem, mesh)
    assert launch_counts()["relax_step"] > 0
    want_fill, want_dist = mcp_fill(*(torch.from_numpy(a).to(device) for a in problem))
    np.testing.assert_array_equal(got_dist, want_dist.cpu().numpy())
    np.testing.assert_array_equal(got_fill, want_fill.cpu().numpy())


def test_banded_fill_on_one_card_equals_mcp_fill(cuda_device):
    _hold_fill(_fill_problem(4, 1000, 700), make_mesh(devices=[cuda_device] * 4), cuda_device)


def test_two_gpus(artifact, cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: a mesh over distinct devices")
    mesh = make_mesh(2)
    plain = _scene(*artifact)
    for mode in ("banded", "replicated"):
        _hold(_scene(*artifact, mesh, mode), plain)
    _hold_fill(_fill_problem(5, 1000, 700), mesh, cuda_device)
