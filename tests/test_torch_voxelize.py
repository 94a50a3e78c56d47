"""The port's voxelizer (``rtpose_tpu_torch/ops/voxelize.py``) against
rtpose_tpu's on the same numpy point clouds, on the CPU.

Tolerances: ``voxelize`` moves points and counts them, so all five outputs
are held exactly (integers equal, ``voxels`` bit for bit), also where
voxels overflow ``max_points``, where more groups than ``max_voxels``
exist, with out-of-range and padding rows and with no valid point.
``dynamic_scatter_mean`` and ``scatter_to_dense`` add float32 values in
scatter order: rtol 1e-6.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rtpose_tpu.ops import voxelize as jvox

from rtpose_tpu_torch.ops import voxelize as tvox

RANGE = (-2.0, -2.0, -2.0, 2.0, 2.0, 2.0)
SIZE = (0.5, 0.25, 0.5)          # grid (x, y, z) = (8, 16, 8)
N = 512

# (valid points, max_points, max_voxels): plain; max_points overflow (many
# points share a voxel); max_voxels overflow (more occupied voxels than
# slots); no valid point
CASES = {
    "plain": (400, 35, 1024),
    "max_points_overflow": (400, 2, 1024),
    "max_voxels_overflow": (400, 8, 24),
    "empty": (0, 4, 64),
}


def _points(seed, n_valid):
    """Points inside the range, a cluster that crowds one voxel, points out
    of range on every axis, and padding rows of garbage past ``n_valid``."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, -2, 0], [2, 2, 2, 1], size=(N, 4)).astype(np.float32)
    pts[:40, :3] = rng.uniform(0.05, 0.2, size=(40, 3))            # one voxel
    pts[40:60, :3] = rng.uniform(2.0, 3.0, size=(20, 3)) * rng.choice([-1, 1], (20, 3))
    pts[60:64, 0] = 2.0                                             # the upper edge
    pts[n_valid:] = rng.normal(size=(N - n_valid, 4)).astype(np.float32)
    return pts


def _specs(max_points, max_voxels):
    return (jvox.VoxelizerSpec(RANGE, SIZE, max_points, max_voxels),
            tvox.VoxelizerSpec(RANGE, SIZE, max_points, max_voxels))


def test_grid_sizes_match():
    for rng_, size in ((RANGE, SIZE), ((0.77, -5.025, -1.0875, 8.02, 5.025, 4.7125),
                                       (0.0453125, 0.15703125, 0.3625))):
        a = jvox.VoxelizerSpec(rng_, size)
        b = tvox.VoxelizerSpec(rng_, size)
        assert a.grid_size_xyz == b.grid_size_xyz and a.grid_size_zyx == b.grid_size_zyx


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_voxelize_matches_jax_exactly(seed, case):
    n_valid, max_points, max_voxels = CASES[case]
    pts = _points(seed, n_valid)
    jspec, tspec = _specs(max_points, max_voxels)
    want = jvox.voxelize(jnp.asarray(pts), jnp.int32(n_valid), jspec)
    got = tvox.voxelize(torch.from_numpy(pts), n_valid, tspec)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(want[k]), got[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    nv = int(got["num_voxels"])
    if case == "empty":
        assert nv == 0 and int(got["num_points_per_voxel"].sum()) == 0
    elif case == "max_points_overflow":
        assert int(got["num_points_per_voxel"].max()) == max_points
    elif case == "max_voxels_overflow":
        assert nv == max_voxels
    # slots come out in flat-id order (the sorted-id deviation)
    c = got["coors"][:nv].long()
    flat = (c[:, 0] * 16 + c[:, 1]) * 8 + c[:, 2]
    assert bool((flat[1:] > flat[:-1]).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_dynamic_scatter_mean_matches_jax(seed):
    pts = _points(seed, 450)
    jspec, tspec = _specs(8, 64)
    want = np.asarray(jvox.dynamic_scatter_mean(jnp.asarray(pts), jnp.int32(450), jspec))
    got = tvox.dynamic_scatter_mean(torch.from_numpy(pts), 450, tspec).numpy()
    assert got.shape == want.shape == (8, 16, 8, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_to_dense_matches_jax(seed):
    """A batch of three (different ``num_voxels``, one of them 0) through the
    port's single ``index_add_``, each sample against JAX's per-sample
    scatter."""
    rng = np.random.default_rng(seed)
    grid = (8, 16, 8)
    B, V, C = 3, 40, 5
    feats = rng.normal(size=(B, V, C)).astype(np.float32)
    coors = np.zeros((B, V, 3), np.int32)
    for b in range(B):       # distinct coordinates per sample, as voxelize gives
        flat = rng.choice(np.prod(grid), size=V, replace=False)
        coors[b] = np.stack(np.unravel_index(flat, grid), 1)
    nv = np.array([V, 17, 0], np.int32)
    got = tvox.scatter_to_dense(torch.from_numpy(feats), torch.from_numpy(coors),
                                torch.from_numpy(nv), grid).numpy()
    assert got.shape == (B, *grid, C)
    for b in range(B):
        want = np.asarray(jvox.scatter_to_dense(jnp.asarray(feats[b]), jnp.asarray(coors[b]),
                                                jnp.int32(nv[b]), grid))
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=0)
    assert not got[2].any()
