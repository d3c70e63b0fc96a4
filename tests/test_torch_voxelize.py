"""df3d_torch.ops.voxelize (sort method) against df3d.ops.voxelize: integer
outputs equal exactly, features to atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.ops.voxelize import voxelize as jvoxelize
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d_torch.ops.voxelize import voxelize, voxelize_batch
from torch_port_helpers import one_torch_thread  # noqa: F401

VS = (0.5, 0.5, 0.25)
PCR = (-4.0, -4.0, -1.0, 4.0, 4.0, 1.0)
GRID = (8, 16, 16)  # (Z, Y, X)


def _points(rng, n=400):
    """Points with voxel-boundary coordinates, out-of-range points, and one
    voxel holding more than max_points_per_voxel points."""
    p = np.concatenate([rng.uniform(-4.5, 4.5, (n, 2)),
                        rng.uniform(-1.2, 1.2, (n, 1)),
                        rng.rand(n, 2)], -1)
    # exact boundaries: origin + k * voxel size, and the range's far edges
    k = rng.randint(0, 17, (60, 3))
    p[:60, :3] = np.array(PCR[:3]) + k * np.array(VS)
    p[60:64, :3] = [[4.0, 0.0, 0.0], [0.0, 4.0, 0.0], [0.0, 0.0, 1.0],
                    [-4.0, -4.0, -1.0]]
    # 15 points in one voxel (cap is 10), spread over the file
    rows = rng.choice(np.arange(64, n), 15, replace=False)
    p[rows, :3] = [1.1, -2.3, -0.9] + 0.01 * rng.rand(15, 3)
    return p.astype(np.float32)


def _check(got, want):
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_array_equal(got.num_points.numpy(),
                                  np.asarray(want.num_points))
    np.testing.assert_array_equal(got.num_voxels.numpy(),
                                  np.asarray(want.num_voxels))
    np.testing.assert_array_equal(got.point_voxel_id.numpy(),
                                  np.asarray(want.point_voxel_id))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("max_voxels", [512, 96], ids=["room", "capped"])
def test_voxelize_matches_jax(max_voxels):
    rng = np.random.RandomState(0)
    pts = _points(rng)
    valid = rng.rand(len(pts)) > 0.05
    got = voxelize(torch.from_numpy(pts), torch.from_numpy(valid), VS, PCR,
                   GRID, max_voxels, 10)
    # one jitted program (op by op it compiled ~140 small ones)
    want = jax.jit(jvoxelize, static_argnums=(2, 3, 4, 5, 6))(
        jnp.asarray(pts), jnp.asarray(valid), VS, PCR, GRID, max_voxels, 10)
    _check(got, want)
    assert got.num_points.max().item() == 10  # the 15-point voxel is capped
    if max_voxels == 96:
        assert got.num_voxels.item() == 96


def test_voxelize_batch_matches_jax():
    rng = np.random.RandomState(1)
    pts = np.stack([_points(rng), _points(rng)])
    valid = rng.rand(*pts.shape[:2]) > 0.05
    got = voxelize_batch(torch.from_numpy(pts), torch.from_numpy(valid), VS,
                         PCR, GRID, 256, 10)
    want = jax.jit(jvoxelize_batch, static_argnums=(2, 3, 4, 5, 6))(
        jnp.asarray(pts), jnp.asarray(valid), VS, PCR, GRID, 256, 10)
    assert got.features.shape == (2, 256, 5)
    _check(got, want)
