"""Port parity, the MLS cluster grid (slam_tpu_torch.mapping.mls vs
slam_tpu.mapping.mls, CPU).

Both packages take the same terrain scans (a slope, a step ridge and two
box obstacles, tests/test_mls_parity.py's generator) on a grid carried
across scans: slam_tpu folds the first scans, the grid crosses to the port
through interop.mls_grid_from_numpy, and both fold the rest. slam_tpu runs
jitted and vmapped over two robots with different scans.

Tolerances: counts (num_pts) and drivability exact; cluster means and
variances 1e-5 (XLA:CPU fuses the running-mean blends into multiply-adds,
the port rounds each step); exports exact in validity and order, their
points 1e-5. The port also meets tests/test_mls_parity.py's f64 oracle at
that file's own bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import MlsConfig as JMlsConfig
from slam_tpu.mapping import mls as jmls
from slam_tpu.types import PointCloud as JCloud
from slam_tpu_torch import interop
from slam_tpu_torch.config import MlsConfig
from slam_tpu_torch.mapping import mls as tmls
from slam_tpu_torch.types import PointCloud
from tests.test_mls_parity import _OracleMLS, _terrain_scans
from tests.torch_parity import (assert_close, assert_equal, numpy_tree,
                                to_np, to_torch)

torch.set_num_threads(1)

B = 2
SCANS = 4          # scans folded, the first CARRY of them by slam_tpu alone
CARRY = 2


def _cfgs(resolution):
    kw = dict(size_x=48, size_y=48, resolution=resolution, max_range=30.0,
              update_dist=24)
    return JMlsConfig(**kw), MlsConfig(**kw)


def _scans(resolution, n_pts=1500):
    """(SCANS, B, n_pts, 3): robot b's scans are terrain seed b's, with
    every other point of a 2 x 4 m patch lifted 2.5 m (an overhang: two
    cluster levels per cell), xy scaled by resolution / 0.5 (the same
    cells at every resolution); every fifth point of each scan is
    masked."""
    per = [_terrain_scans(seed, SCANS, n_pts) for seed in range(B)]
    xyz = np.stack([np.stack([p[k] for p in per]) for k in range(SCANS)])
    patch = (np.abs(xyz[..., 0] + 7.0) < 1.0) & \
        (np.abs(xyz[..., 1] - 6.0) < 2.0)
    patch[..., ::2] = False
    xyz[..., 2] += np.where(patch, 2.5, 0.0).astype(np.float32)
    xyz[..., :2] *= np.float32(resolution / 0.5)
    valid = np.ones(xyz.shape[:-1], bool)
    valid[..., ::5] = False
    return xyz, valid


def _jcloud(xyz, valid):
    return JCloud(xyz=xyz, valid=valid,
                  flags=np.zeros(valid.shape, np.int32))


def _tcloud(xyz, valid):
    return PointCloud(xyz=to_torch(xyz), valid=to_torch(valid),
                      flags=torch.zeros(valid.shape, dtype=torch.int32))


def _jax_fold(jcfg, grid, xyz, valid):
    return jax.jit(jax.vmap(lambda g, x, v: jmls.add_to_mls(
        g, _jcloud(x, v), jcfg)))(grid, xyz, valid)


def _jax_grid0(jcfg):
    return jax.vmap(lambda _: jmls.init_mls(jcfg))(jnp.arange(B))


def assert_grid_close(got, want, tol=1e-5):
    assert_equal(got.num_pts, want.num_pts, "num_pts")
    assert_equal(got.drivable, want.drivable, "drivable")
    assert_close(got.mean, want.mean, atol=tol, what="mean")
    assert_close(got.var_z, want.var_z, atol=tol, what="var_z")
    assert_equal(got.origin, want.origin, "origin")
    assert_close(got.center, want.center, atol=0.0, what="center")


@pytest.fixture(scope="module")
def folded():
    """Per resolution: the scans and slam_tpu's grids (numpy) after each
    scan."""
    out = {}
    for res in (0.5, 0.2):
        jcfg, _ = _cfgs(res)
        xyz, valid = _scans(res)
        g = _jax_grid0(jcfg)
        grids = []
        for k in range(SCANS):
            g = _jax_fold(jcfg, g, xyz[k], valid[k])
            grids.append(numpy_tree(g))
        out[res] = xyz, valid, grids
    return out


@pytest.mark.parametrize("resolution", [0.5, 0.2])
def test_add_to_mls_on_a_carried_grid_matches_jax(folded, resolution):
    """0.2 m (MlsConfig's default) is no power of two: the binning divides
    through true_div."""
    xyz, valid, grids = folded[resolution]
    _, tcfg = _cfgs(resolution)
    g = interop.mls_grid_from_numpy(grids[CARRY - 1], "cpu")
    for k in range(CARRY, SCANS):
        g = tmls.add_to_mls(g, _tcloud(xyz[k], valid[k]), tcfg)
    want = grids[-1]
    assert_grid_close(g, want)
    num = np.asarray(want.num_pts)
    assert ((num >= 3).sum(-1) >= 2).sum() >= 2   # multi-level cells
    assert (np.asarray(want.drivable) == 0).sum() > 20
    assert (np.asarray(want.drivable) == 1).sum() > 100
    back = interop.state_to_numpy(g)
    assert_equal(back["num_pts"], want.num_pts)


def test_add_to_mls_from_empty_matches_jax(folded):
    """Every scan through the port from an empty grid, with points outside
    the grid and beyond max_range, and a robot whose scan is all masked."""
    xyz, valid, _ = folded[0.5]
    jcfg, tcfg = _cfgs(0.5)
    far = xyz.copy()
    far[:, :, :40, :2] *= 4.0                        # off the grid / range
    valid = valid.copy()
    valid[-1, 1] = False
    g = tmls.init_mls(tcfg, B, device="cpu")
    jg = _jax_grid0(jcfg)
    for k in range(SCANS):
        g = tmls.add_to_mls(g, _tcloud(far[k], valid[k]), tcfg)
        jg = _jax_fold(jcfg, jg, far[k], valid[k])
    assert_grid_close(g, numpy_tree(jg))


def test_shift_offset_and_export_match_jax(folded):
    """shift_origin_mls by a different whole-cell step per robot,
    offset_mls_z, and get_segmented_clouds, whose scores (small integer
    counts) tie nearly everywhere: the export keeps top_k's lower-index
    order among ties."""
    jcfg, tcfg = _cfgs(0.5)
    jg = folded[0.5][2][-1]
    tg = interop.mls_grid_from_numpy(jg, "cpu")
    new_c = np.array([[1.3, -2.2], [-3.6, 0.4]], np.float32)
    dz = np.array([0.25, -0.4], np.float32)
    want = jax.jit(jax.vmap(lambda g, c, d: jmls.offset_mls_z(
        jmls.shift_origin_mls(g, c, jcfg), d)))(jg, new_c, dz)
    got = tmls.offset_mls_z(tmls.shift_origin_mls(tg, to_torch(new_c), tcfg),
                            to_torch(dz))
    assert_grid_close(got, numpy_tree(want))
    assert not np.array_equal(np.asarray(want.num_pts),
                              np.asarray(jg.num_pts))

    cap = 700
    jo, jgnd = jax.jit(jax.vmap(lambda g: jmls.get_segmented_clouds(
        g, jcfg, cap)))(jg)
    to, tgnd = tmls.get_segmented_clouds(tg, tcfg, cap)
    for got_c, want_c in ((to, jo), (tgnd, jgnd)):
        assert_equal(got_c.valid, want_c.valid)
        assert_equal(got_c.flags, want_c.flags)
        assert_close(got_c.xyz, want_c.xyz, atol=1e-5)
    n_obs = np.asarray(jo.valid).sum(-1)
    assert n_obs.min() > 20 and np.asarray(jgnd.valid).sum(-1).min() > 100
    # the ground export is cut at cap: ties decide who is in it
    assert np.asarray(jgnd.valid).sum(-1).max() == cap


def test_sort_k_matches_jax_with_ties_and_empty_slots():
    rng = np.random.default_rng(4)
    key = rng.integers(0, 3, (64, 4)).astype(np.float32)
    key[rng.random((64, 4)) < 0.3] = np.inf
    arrs = [rng.normal(size=(64, 4)).astype(np.float32) for _ in range(3)]
    want = jmls._sort_k(jnp.asarray(key), [jnp.asarray(a) for a in arrs])
    got = tmls._sort_k(to_torch(key), [to_torch(a) for a in arrs])
    for g, w in zip(got, want):
        assert_equal(g, w)


def test_add_to_mls_meets_the_sequential_oracle():
    """tests/test_mls_parity.py's f64 point-sequential transcription of the
    reference: drivability agrees on >= 97 % of the cells both decide, and
    the ground cluster's height to <= 1 cm mean and <= 15 cm max."""
    cfg = MlsConfig(size_x=48, size_y=48, resolution=0.5, max_range=30.0,
                    update_dist=24)
    oracle = _OracleMLS(dataclasses.replace(JMlsConfig(), **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}))
    grid = tmls.init_mls(cfg, 1, device="cpu")
    for s in _terrain_scans():
        oracle.add_to_map(s)
        grid = tmls.add_to_mls(grid, _tcloud(s[None], np.ones((1, len(s)),
                                                             bool)), cfg)
    ours = to_np(grid.drivable)[0]
    ref = oracle.drivable
    both = (ours != -1) & (ref != -1)
    assert both.sum() > 150
    assert (ours[both] == ref[both]).mean() >= 0.97
    num = to_np(grid.num_pts)[0]
    init = num >= cfg.min_cluster_points
    gidx = np.argmax(init, -1)
    our_z = np.take_along_axis(to_np(grid.mean)[0, ..., 2], gidx[..., None],
                               2)[..., 0]
    ref_z = oracle.ground_z()
    have = init.any(-1) & np.isfinite(ref_z)
    dz = np.abs(our_z[have] - ref_z[have])
    assert dz.mean() <= 0.01 and dz.max() <= 0.15
