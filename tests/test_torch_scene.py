"""Port parity, scene build and grid ops: scatter / gather, stencil, roll,
crop and build_scene_planes (slam_tpu_torch vs slam_tpu, CPU).

Integer outputs (counts, keep and GA flags, rolled grids) must match
exactly. Coordinate sums match to 1e-5: one-hot matmuls and index_add_
add in different orders."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import sim2d_config
from slam_tpu.ops import roll as jroll
from slam_tpu.ops import scatter2d as jsc
from slam_tpu.ops import stencil as jst
from slam_tpu.ops import voxel as jvox
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.sim import world2d as jw
from slam_tpu.types import PointCloud as JCloud
from slam_tpu_torch.ops import roll as troll
from slam_tpu_torch.ops import scatter2d as tsc
from slam_tpu_torch.ops import stencil as tst
from slam_tpu_torch.ops import voxel as tvox
from slam_tpu_torch.pipeline import slam2d as tslam
from slam_tpu_torch.types import PointCloud
from tests.torch_parity import assert_close, assert_equal, to_torch

torch.set_num_threads(1)

CFG = sim2d_config()


def _cells(B=2, N=300, H=24, W=20, seed=0):
    rng = np.random.default_rng(seed)
    cx = rng.integers(-3, H + 3, (B, N)).astype(np.int32)
    cy = rng.integers(-3, W + 3, (B, N)).astype(np.int32)
    v = rng.uniform(-0.25, 0.25, (B, N)).astype(np.float32)
    valid = rng.random((B, N)) < 0.8
    v[~valid] = np.nan          # masked lanes may carry NaN
    return cx, cy, v, valid


def test_scatter_add_2d_multi_matches_jax():
    cx, cy, v, valid = _cells()
    got = tsc.scatter_add_2d_multi(to_torch(cx), to_torch(cy),
                                   (None, to_torch(v)), to_torch(valid),
                                   (24, 20))
    want = jax.vmap(lambda a, b, c, d: jsc.scatter_add_2d_multi(
        a, b, (None, c), d, (24, 20)))(cx, cy, v, valid)
    assert_equal(got[0], want[0])
    assert_close(got[1], want[1], atol=1e-5)


def test_gather_cells_2d_matches_jax():
    rng = np.random.default_rng(1)
    grids = rng.normal(size=(2, 24, 20, 3)).astype(np.float32)
    cx, cy, _, _ = _cells(seed=1)
    got = tsc.gather_cells_2d(tuple(to_torch(grids[..., k])
                                    for k in range(3)),
                              to_torch(cx), to_torch(cy))
    want = jax.vmap(jsc.gather_cells_2d)(grids, cx, cy)
    assert_close(torch.stack(got, -1), want, atol=1e-6)


@pytest.mark.parametrize("case", ["test_grid_icp", "batched"])
def test_scatter_max_2d_matches_jax(case):
    """tests/test_grid_icp.py's cases (a real max, negative values, a
    masked lane, untouched cells at 0) and random batched cells with
    out-of-grid and NaN-carrying masked lanes: exact."""
    if case == "test_grid_icp":
        cx, cy = np.array([[1, 1, 2, 5]]), np.array([[1, 1, 3, 5]])
        v = np.array([[3.0, 5.0, -2.0, 7.0]], np.float32)
        valid = np.array([[True, True, True, False]])
        shape = (8, 8)
    else:
        cx, cy, v, valid = _cells(seed=3)
        shape = (24, 20)
    got = tsc.scatter_max_2d(to_torch(cx), to_torch(cy), to_torch(v),
                             to_torch(valid), shape)
    want = jax.vmap(lambda a, b, c, d: jsc.scatter_max_2d(a, b, c, d, shape))(
        cx, cy, v, valid)
    assert_equal(got, want)
    if case == "test_grid_icp":
        assert float(got[0, 1, 1]) == 5.0 and float(got[0, 2, 3]) == -2.0
        assert float(got[0, 5, 5]) == 0.0 and float(got[0, 0, 0]) == 0.0


@pytest.mark.parametrize("raster", ["indicator", "float"])
def test_neighbor_sum_2d_matches_jax(raster):
    rng = np.random.default_rng(2)
    x = rng.random((2, 17, 13))
    x = (x < 0.5) if raster == "indicator" else x * 3.0
    x = x.astype(np.float32)
    got = tst.neighbor_sum_2d(to_torch(x))
    want = jst.neighbor_sum_2d(jnp.asarray(x))
    if raster == "indicator":
        assert_equal(got, want)       # border cells: off-grid is not empty
    else:
        assert_close(got, want, atol=1e-5)


def test_roll_shift_fresh_match_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 12, 9, 2)).astype(np.float32)
    d = np.array([[2, -3], [-13, 4], [0, 0]], np.int32)
    got = troll.roll_2d(to_torch(a), to_torch(d))
    for b in range(3):
        assert_equal(got[b], np.roll(a[b], (-d[b, 0], -d[b, 1]), (0, 1)))
        assert_equal(got[b], jroll.roll_2d(jnp.asarray(a[b]), d[b, 0],
                                           d[b, 1]))
    assert_equal(troll.fresh_mask(to_torch(d), 12, 9),
                 jax.vmap(lambda x: jroll.fresh_mask(x, 12, 9))(d))
    center = np.array([[0.0, 0.0], [1.3, -2.1], [10.0, 4.0]], np.float32)
    new = np.array([[0.25, 0.75], [3.9, -2.2], [-4.0, 4.5]], np.float32)
    gd, gc = troll.shift_step(to_torch(center), to_torch(new), 0.5)
    wd, wc = jax.vmap(lambda c, n: jroll.shift_step(c, n, 0.5))(center, new)
    assert_equal(gd, wd)              # includes round-half-to-even cases
    assert_close(gc, wc, atol=1e-6)


def _scans(B=3, seed=0):
    world = jw.make_world(jax.random.PRNGKey(42), CFG.sim)
    rng = np.random.default_rng(seed)
    pose = np.stack([rng.uniform(-20, 20, B), rng.uniform(-20, 20, B),
                     rng.uniform(-3, 3, B)], -1).astype(np.float32)
    r, h = jax.vmap(lambda p: jw.raycast(world, p, CFG.sim))(pose)
    r = np.asarray(r) + rng.normal(0, 0.01, r.shape).astype(np.float32)
    x, y, h = jw.scan_to_planes(r, np.asarray(h))
    x, y, h = np.array(x), np.array(y), np.array(h)
    x[0, :5] = np.nan                 # dropouts are misses
    return x, y, h & np.isfinite(x)


def test_build_scene_planes_matches_jax():
    x, y, h = _scans()
    xs, ys = np.where(h, x, 0.0), np.where(h, y, 0.0)
    got = tslam.build_scene_planes(to_torch(xs), to_torch(ys), to_torch(h),
                                   CFG)
    want = jax.vmap(lambda a, b, c: jslam.build_scene_planes(a, b, c, CFG))(
        xs, ys, h)
    assert_equal(got[3], want[3], "keep")
    assert_equal(got[2], want[2], "ga")
    assert_close(got[0], want[0], atol=1e-5, what="sx")
    assert_close(got[1], want[1], atol=1e-5, what="sy")
    assert got[3].sum() > 100 and got[2].sum() > 10


def _assert_scene_matches_jax(x, y, h, cfg):
    xs, ys = np.where(h, x, 0.0), np.where(h, y, 0.0)
    got = tslam.build_scene_planes(to_torch(xs), to_torch(ys), to_torch(h),
                                   cfg)
    want = jax.jit(jax.vmap(lambda a, b, c: jslam.build_scene_planes(
        a, b, c, cfg)))(xs, ys, h)
    assert_equal(got[3], want[3], "keep")
    assert_equal(got[2], want[2], "ga")
    assert_close(got[0], want[0], atol=1e-5, what="sx")
    assert_close(got[1], want[1], atol=1e-5, what="sy")
    return got


def _cloud_cfg(**kw):
    return dataclasses.replace(CFG, cloud=dataclasses.replace(CFG.cloud,
                                                              **kw))


def test_build_scene_planes_needs_capacity():
    """A scan wider than scene_capacity: the incidence builder compacts
    its kept centroids to the front, then truncates (a 360-beam scan into
    128 slots)."""
    x, y, h = _scans()
    got = _assert_scene_matches_jax(x, y, h, _cloud_cfg(scene_capacity=128))
    assert got[3].shape == (3, 128)
    assert bool(got[3][:, :100].all())        # the front slots are filled


def test_build_scene_planes_grid_builder_matches_jax():
    """Builder "grid": the scatter-to-grid builder on the 360-beam scans."""
    x, y, h = _scans()
    got = _assert_scene_matches_jax(x, y, h, _cloud_cfg(scene_builder="grid"))
    assert got[3].sum() > 100 and got[2].sum() > 10


def test_build_scene_planes_auto_above_4096_matches_jax():
    """Builder "auto" routes a 5,000-point scan to the grid builder: more
    occupied cells than scene_capacity keeps the most observed."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-40, 40, (2, 5000)).astype(np.float32)
    y = rng.uniform(-40, 40, (2, 5000)).astype(np.float32)
    x[:, :2000] = rng.normal(0, 3, (2, 2000))    # dense cells near the robot
    h = rng.random((2, 5000)) < 0.9
    got = _assert_scene_matches_jax(x, y, h, _cloud_cfg(scene_capacity=1024))
    assert bool(got[3].all())


def test_build_scene_matches_build_scene_planes():
    x, y, h = _scans()
    xyz = torch.stack([to_torch(np.where(h, x, 0.0)),
                       to_torch(np.where(h, y, 0.0)),
                       torch.zeros(x.shape)], -1)
    cloud = tslam.build_scene(xyz, to_torch(h), CFG)
    sx, sy, ga, keep = tslam.build_scene_planes(xyz[..., 0], xyz[..., 1],
                                                to_torch(h), CFG)
    assert_equal(cloud.valid, keep)
    assert_equal(cloud.is_ga(), ga)
    assert_equal(cloud.xyz[..., 0], sx)
    assert_equal(cloud.xyz[..., 1], sy)


def test_classify_ground_adjacent_matches_jax():
    from slam_tpu.ops import classify as jcls
    from slam_tpu_torch.ops import classify as tcls
    rng = np.random.default_rng(8)
    B, N = 2, 300
    xyz = np.concatenate([rng.normal(0, 8, (B, N, 2)),
                          np.zeros((B, N, 1))], -1).astype(np.float32)
    xyz[:, :20, :2] += 200.0          # beyond the grid: keep their flags
    valid = rng.random((B, N)) < 0.9
    flags = rng.integers(0, 8, (B, N)).astype(np.int32)
    center = rng.uniform(-2, 2, (B, 2)).astype(np.float32)
    want = jax.vmap(lambda a, b, c, d: jcls.classify_ground_adjacent(
        JCloud(a, b, c), d, 64, 0.5, 2))(xyz, valid, flags, center)
    got = tcls.classify_ground_adjacent(
        PointCloud(to_torch(xyz), to_torch(valid), to_torch(flags)),
        to_torch(center), 64, 0.5, 2)
    assert_equal(got.flags, want.flags)
    assert (got.flags != to_torch(flags)).any()
    assert_equal(got.flags[:, :20], flags[:, :20])


def test_crop_box_matches_jax():
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-80, 80, (2, 50, 3)).astype(np.float32)
    valid = rng.random((2, 50)) < 0.9
    flags = np.zeros((2, 50), np.int32)
    center = np.array([[3.0, -4.0], [-20.0, 10.0]], np.float32)
    got = tvox.crop_box(PointCloud(to_torch(xyz), to_torch(valid),
                                   to_torch(flags)), to_torch(center), 55.0)
    want = jax.vmap(lambda a, b, c, d: jvox.crop_box(
        JCloud(a, b, c), d, 55.0))(xyz, valid, flags, center)
    assert_equal(got.valid, want.valid)
