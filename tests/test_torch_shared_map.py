"""Port parity, the fleet's shared map (BASELINE config 5): merge_maps and
fleet_rollout_shared (slam_tpu_torch vs slam_tpu, CPU).

Tolerances:
- merge_maps: counts exact, offset sums 1e-6; a misaligned merge gives NaN
  counts in both.
- One macro's shared fold, the same registered scans into the same grid:
  counts exact, sum_x / sum_y 1e-5 (the scatter adds in another order).
- Two macros of fleet_rollout_shared with one particle and no sensor
  noise, so that no random draw reaches the result (one particle is the
  prediction itself): trajectories 1e-5, shared-grid counts exact,
  sum_x / sum_y 2e-3. The scans themselves differ: raycast agrees to
  1e-4 + 1e-5 * range (tests/test_torch_sim.py; cancellation at grazing
  incidence), so scene centroids differ by up to 3e-4 m and a cell's sum
  of a dozen offsets by up to 1.2e-3 (measured).
- The port's own rollout, 4 robots x 8 macros on its generator: ATE below
  0.5 m over ticks >= 8, the bound of slam_tpu's own test
  (tests/test_relocalize_shared.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import sim2d_config
from slam_tpu.mapping import point_map as jpm
from slam_tpu.parallel import shared_map as jsm
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.sim import world2d as jw
from slam_tpu_torch import interop
from slam_tpu_torch.mapping.point_map import PointMapGrid, init_point_map
from slam_tpu_torch.parallel import shared_map as tsm
from slam_tpu_torch.pipeline import slam2d as tslam
from slam_tpu_torch.utils import profiling as tprof
from tests.torch_parity import (assert_close, assert_equal, numpy_tree,
                                to_torch)

torch.set_num_threads(1)


def _grids(B=3, G=16, seed=0):
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 4, (B, G, G)).astype(np.float32)
    sx, sy, sz = (rng.normal(0, 0.1, (B, G, G)).astype(np.float32)
                  for _ in range(3))
    center = np.tile(np.array([[1.5, -2.0]], np.float32), (B, 1))
    return count, sx, sy, sz, center


@pytest.mark.parametrize("aligned", [True, False])
def test_merge_maps_matches_jax(aligned):
    count, sx, sy, sz, center = _grids()
    if not aligned:
        center[1, 0] += 0.5
    want = jsm.merge_maps(jpm.PointMapGrid(
        count=count, sum_x=sx, sum_y=sy, sum_z=sz, center=center,
        resolution=0.5))
    got = tsm.merge_maps(PointMapGrid(
        count=to_torch(count), sum_x=to_torch(sx), sum_y=to_torch(sy),
        sum_z=to_torch(sz), center=to_torch(center), resolution=0.5))
    assert got.count.shape == (1, 16, 16) and got.center.shape == (1, 2)
    assert_equal(got.count[0], want.count)
    for a, b in ((got.sum_x, want.sum_x), (got.sum_y, want.sum_y),
                 (got.sum_z, want.sum_z)):
        assert_close(a[0], b, atol=1e-6)
    assert_equal(got.center[0], want.center)
    assert bool(torch.isnan(got.count).all()) == (not aligned)


def test_one_macro_fold_matches_jax():
    B, T, N, G = 3, 4, 96, 48
    rng = np.random.default_rng(2)
    qx, qy = (rng.normal(0, 6, (B, T, N)).astype(np.float32)
              for _ in range(2))
    valid = rng.random((B, T, N)) < 0.9
    jsh = jpm.init_point_map(G, 0.5).replace(
        center=jnp.array([0.5, -1.0]))
    jsh = jpm.update_point_map_xy(jsh, qx[0, 0], qy[0, 0], None, valid[0, 0])
    want = jpm.update_point_map_xy(jsh, qx.reshape(-1), qy.reshape(-1), None,
                                   valid.reshape(-1), 0.5)
    got = tsm.fold_scans(interop.point_map_from_numpy(numpy_tree(jsh), "cpu"),
                         to_torch(qx), to_torch(qy), to_torch(valid))
    assert_equal(got.count[0], want.count)
    assert_close(got.sum_x[0], want.sum_x, atol=1e-5)
    assert_close(got.sum_y[0], want.sum_y, atol=1e-5)
    assert_equal(got.sum_z[0], want.sum_z)
    assert_equal(got.center[0], want.center)


def _pf_cfg(**pf):
    c = sim2d_config()
    return dataclasses.replace(
        c, icp=dataclasses.replace(c.icp, matcher="particle"),
        pf=dataclasses.replace(c.pf, **pf))


def test_two_macros_match_jax_without_draws():
    cfg = _pf_cfg(num_particles=1, score_stride=4)
    cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, range_noise=0.0, gyro_noise=0.0))
    B = 2
    world = jw.make_world(jax.random.PRNGKey(42), cfg.sim)
    st = jax.vmap(lambda k: jslam.init_state(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), B)).replace(map_grid=None)
    start = jnp.array([[0.0, 0.0, 0.0, 0.0], [2.0, -1.5, 0.6, 0.0]])
    st = st.replace(pose=start, true_pose=start, ekf=st.ekf.replace(
        mu=st.ekf.mu.at[:, 0].set(start[:, 0]).at[:, 1].set(start[:, 1])
        .at[:, 6].set(start[:, 2])))
    shared = jpm.init_point_map(cfg.mls.size_x, cfg.icp.voxel_leaf_obs[0])
    fin, jshared, (est, true) = jax.jit(lambda s, sh: jsm.fleet_rollout_shared(
        s, sh, world, cfg, num_macro=2))(st, shared)

    tfin, tshared, (test, ttrue) = tsm.fleet_rollout_shared(
        interop.state_from_numpy(numpy_tree(st), "cpu"),
        interop.point_map_from_numpy(numpy_tree(shared), "cpu"),
        interop.world_from_numpy(numpy_tree(world), "cpu"), cfg, 2,
        generator=torch.Generator())
    assert test.shape == (B, 8, 3)
    assert_close(test, est, atol=1e-5)
    assert_close(ttrue, true, atol=1e-5)
    assert_equal(tfin.scan_reg_ok, fin.scan_reg_ok)
    assert bool(fin.scan_reg_ok.all())      # the second macro matched
    assert_equal(tshared.count[0], jshared.count)
    assert_close(tshared.sum_x[0], jshared.sum_x, atol=2e-3)
    assert_close(tshared.sum_y[0], jshared.sum_y, atol=2e-3)
    assert_equal(tfin.local_map.counts, fin.local_map.counts)
    assert tfin.map_grid is None


def test_fleet_rollout_tracks_on_shared_map():
    cfg = _pf_cfg()
    gen = torch.Generator().manual_seed(7)
    world = interop.world_from_numpy(numpy_tree(jw.make_world(
        jax.random.PRNGKey(42), cfg.sim)), "cpu")
    B = 4
    states = tslam.init_state(cfg, B, device="cpu", generator=gen)
    shared = init_point_map(1, cfg.mls.size_x, cfg.icp.voxel_leaf_obs[0],
                            device="cpu")
    states, shared, (est, true) = tsm.fleet_rollout_shared(
        states, shared, world, cfg, num_macro=8, generator=gen)
    assert est.shape == (B, 32, 3)
    err = est[:, 8:, :2] - true[:, 8:, :2]
    ate = float(err.pow(2).sum(-1).mean().sqrt())
    assert np.isfinite(ate) and ate < 0.5, ate
    assert states.map_grid is None
    assert float(shared.count.sum()) >= 4 * 8
    assert tprof.count_of("k5.launches") == 0
    with pytest.raises(ValueError, match="batch-1"):
        tsm.fleet_rollout_shared(
            states, init_point_map(2, 8, device="cpu"), world, cfg, 1,
            generator=gen)


def test_rollout_without_mesh_counts_no_merge():
    """A single process reduces nothing: fleet_rollout_shared with mesh=None
    leaves the merge counters where they were."""
    cfg = _pf_cfg()
    gen = torch.Generator().manual_seed(11)
    world = interop.world_from_numpy(numpy_tree(jw.make_world(
        jax.random.PRNGKey(42), cfg.sim)), "cpu")
    states = tslam.init_state(cfg, 2, device="cpu", generator=gen)
    shared = init_point_map(1, cfg.mls.size_x, cfg.icp.voxel_leaf_obs[0],
                            device="cpu")
    names = ("shared_map.merges", "shared_map.merge_bytes")
    before = [tprof.count_of(n) for n in names]
    _, shared, _ = tsm.fleet_rollout_shared(
        states, shared, world, cfg, num_macro=2, ticks_per_macro=2,
        generator=gen, mesh=None)
    assert float(shared.count.sum()) > 0
    assert [tprof.count_of(n) for n in names] == before
