"""The RoI grid's sin and cos, df3d_torch against the JAX package under
`jit` on the CPU: `core.boxes.xla_sin_cos` gives XLA's f32 sin and cos to
the bit (glibc's sinf and cosf, which XLA's CPU backend calls), where
torch's differ by an ulp on ~5% of headings; and on KITTI's stride-2
lattice (tests/test_torch_voxelrcnn.py's `kitti_lattice` block) the RoI
grid points and both stages of the neighbour search equal the jitted JAX
functions' for RoIs at headings where torch's sin or cos differ from
XLA's. With torch's sin and cos in their place, grid points move by an
ulp, and one RoI (the 1835th of the draw) puts a voxel on the other side
of the 0.4 m radius at two grid points, which changes their neighbour
sets: the case the rounding pins. The search runs on the 100 RoIs from
the 1800th (the whole draw takes ~20 s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.core.calib import voxel_centers_from_coords as jcenters
from df3d.ops import roi_ops as jroi
from df3d_torch.core import boxes as tboxes
from df3d_torch.core.calib import voxel_centers_fma
from df3d_torch.ops import roi_ops as troi
import torch_parallel_ranks
from torch_port_helpers import one_torch_thread  # noqa: F401

KITTI_VS, KITTI_PCR = (0.05, 0.05, 0.1), (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
GRID, COARSE, MAX_LOCAL, RADIUS, NSAMPLE = 6, 4.0, 256, 0.4, 16


def _angles():
    rng = np.random.RandomState(0)
    return np.concatenate([
        rng.uniform(-np.pi, np.pi, 20000), rng.uniform(-119.9, 119.9, 20000),
        rng.uniform(-1e-3, 1e-3, 2000), rng.uniform(-0.8, 0.8, 4000),
        [0.0, -0.0, 0.75, -0.75, np.pi / 4, np.pi / 2, np.pi, -np.pi,
         2 * np.pi, 1e-30, 119.99, -119.99]]).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's searches on one thread (`torch_parallel_ranks.one_thread`:
    the workers share every core)."""
    with torch_parallel_ranks.one_thread():
        yield


@pytest.fixture(scope="module")
def xla():
    """XLA's sin and cos of `_angles()`, jitted on the CPU."""
    a = _angles()
    s, c = jax.jit(lambda x: (jnp.sin(x), jnp.cos(x)))(a)
    return a, np.asarray(s), np.asarray(c)


def test_sin_cos_round_as_xla(xla):
    a, s, c = xla
    got_s, got_c = tboxes.xla_sin_cos(torch.from_numpy(a))
    np.testing.assert_array_equal(got_s.numpy(), s)
    np.testing.assert_array_equal(got_c.numpy(), c)
    t = torch.from_numpy(a)
    differ = (torch.sin(t).numpy() != s) | (torch.cos(t).numpy() != c)
    assert differ.mean() > 0.05  # the case this rounding is for


def _lattice_rois(xla):
    """The `kitti_lattice` block and one RoI for each of the first 20000
    headings (over [-pi, pi]) where torch's sin or cos differ from XLA's:
    centred on a voxel centre within 2 voxels of the block's middle, cubes
    of 0.8, 1.2 or 1.6 m; the 100 from the 1800th."""
    a, s, c = xla
    rng = np.random.RandomState(0)  # `_angles()`'s first draw, then on
    assert (rng.uniform(-np.pi, np.pi, 20000).astype(np.float32)
            == a[:20000]).all()
    t = torch.from_numpy(a[:20000])
    heads = a[:20000][(torch.sin(t).numpy() != s[:20000])
                      | (torch.cos(t).numpy() != c[:20000])]
    zz, yy, xx = np.meshgrid(np.arange(7) + 3, np.arange(13) + 197,
                             np.arange(13) + 100, indexing="ij")
    block = np.stack([zz, yy, xx], -1).reshape(-1, 3).astype(np.int32)
    vs = np.float32(2) * np.asarray(KITTI_VS, np.float32)
    centre = (block[len(block) // 2, ::-1] * vs
              + np.asarray(KITTI_PCR[:3], np.float32) + vs / 2)
    n = len(heads)
    offsets = rng.randint(-2, 3, (n, 3)).astype(np.float32) * vs
    sizes = rng.choice([0.8, 1.2, 1.6], (n, 1)) * np.ones((1, 3))
    rois = np.concatenate([centre + offsets, sizes, heads[:, None]], -1)
    return block, rois[1800:1900].astype(np.float32), n


def _port_search(block, rois):
    coords = torch.from_numpy(block)[None]
    xyz = voxel_centers_fma(coords, KITTI_VS, KITTI_PCR, 2)
    valid = coords[..., 0] >= 0
    r = torch.from_numpy(rois)[None]
    lidx, lmask = troi.collect_local_voxels(r[..., :3], xyz, valid, COARSE,
                                            MAX_LOCAL)
    grid = troi.roi_grid_points(r, GRID)
    nidx, found = troi.grid_ball_query(grid, xyz, lidx, lmask, RADIUS,
                                       NSAMPLE)
    return [v[0].numpy() for v in (grid, lidx, lmask, nidx, found)]


def test_roi_grid_neighbours_at_xla_headings(xla, monkeypatch):
    block, rois, n_differ = _lattice_rois(xla)

    @jax.jit  # as the eval and training steps run it
    def search(coords, rois):
        xyz = jcenters(coords, KITTI_VS, KITTI_PCR, 2)
        lidx, lmask = jroi.collect_local_voxels(rois[:, :3], xyz,
                                                coords[:, 0] >= 0, COARSE,
                                                MAX_LOCAL)
        grid = jroi.roi_grid_points(rois, GRID)
        nidx, found = jroi.grid_ball_query(grid, xyz, lidx, lmask, RADIUS,
                                           NSAMPLE)
        return grid, lidx, lmask, nidx, found

    want = [np.asarray(v) for v in search(block, rois)]
    got = _port_search(block, rois)
    for name, g, w in zip(("grid", "lidx", "lmask", "nidx", "found"), got,
                          want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert want[4].sum() > 200_000  # grid points find their neighbours
    # torch's own sin and cos: grid points an ulp off, and neighbour sets
    # that differ
    monkeypatch.setattr(tboxes, "xla_sin_cos",
                        lambda a: (torch.sin(a), torch.cos(a)))
    grid, _, _, nidx, found = _port_search(block, rois)
    assert (grid != want[0]).any(-1).mean() > 0.01
    moved = (nidx != want[3]).any(-1) | (found != want[4]).any(-1)
    assert moved.sum() == 2
    print(f"torch's sin or cos differ from XLA's on {n_differ} of 20000 "
          f"headings; on {len(rois)} RoIs, {(grid != want[0]).any(-1).sum()}"
          f" of {grid.shape[0] * grid.shape[1]} grid points an ulp off with "
          f"torch's sin and cos, {moved.sum()} neighbour sets moved")
