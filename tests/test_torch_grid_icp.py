"""Port parity, the "grid" matcher: the nearest-centroid field, lookup,
icp_fit_grid, whole frames with matcher "grid" in 2D and 3D, and a 3D
rollout at slam_tpu's mid scale (slam_tpu_torch vs slam_tpu, CPU).

Grids are made by slam_tpu's point-map update from numpy points and
carried across with slam_tpu_torch.interop.

Tolerances:
- field: px, py, valid and n_class exact (the flood is the same rolls,
  selects and roundings in both; a take needs a strictly nearer
  candidate, so ties go to the same neighbour);
- lookup: points and flags exact;
- icp_fit_grid: ok and num_corr exact, pose 1e-5, mean residual 1e-5
  (the Procrustes sums add in another order);
- frames: registration flags and map counts exact, poses 1e-4 (as the
  "points" and "fused" frames of tests/test_torch_slam2d.py and
  tests/test_torch_slam3d.py);
- the port's own mid-scale rollout: slam_tpu's bounds for the same run
  (tests/test_scale_rollout.py: ATE < 0.2 m, mean |z error| < 0.1 m over
  ticks >= 4, registration live on the last tick).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from slam_tpu.config import IcpConfig, ref_scale_config
from slam_tpu.mapping.point_map import init_point_map as j_init_point_map
from slam_tpu.mapping.point_map import update_point_map_xy as j_update_pm
from slam_tpu.ops import grid_icp as jg
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.pipeline import slam3d as jslam3d
from slam_tpu.sim import world2d as jw2
from slam_tpu.sim import world3d as jw3
from slam_tpu_torch import interop
from slam_tpu_torch.mapping.point_map import init_point_map
from slam_tpu_torch.ops import grid_icp as tg
from slam_tpu_torch.pipeline import slam2d as tslam
from slam_tpu_torch.pipeline import slam3d as tslam3d
from tests.test_reference_parity import ours_slam, parity_cfg
from tests.test_torch_slam2d import _frames, _noise_free_cfg, port_slam
from tests.test_torch_slam3d import (_cut_gp, _next_frame, _noise_free,
                                     _port, _port_frame)
from tests.torch_parity import (assert_close, assert_equal, numpy_tree,
                                to_torch)

torch.set_num_threads(1)

RES = 0.5


@functools.partial(jax.jit, static_argnums=3)
def _jax_update(x, y, v, G):
    return jax.vmap(lambda a, b, c: j_update_pm(
        j_init_point_map(G, RES), a, b, None, c, RES))(x, y, v)


# slam_tpu's field, vmapped over robots, compiled once a shape
_jax_field = jax.jit(jax.vmap(lambda g: jg.nearest_point_field(g, RES)))


def _jax_grids(x, y, v, G):
    """slam_tpu point maps (B, G, G) of points (B, N), and the port's."""
    grids = _jax_update(x, y, v, G)
    return grids, interop.point_map_from_numpy(numpy_tree(grids), "cpu")


def _blobs(rng, B, N, G):
    """Points of filled squares (their inner cells are not ground
    adjacent) and scattered points (isolated cells are)."""
    half = G // 2 * RES - 2.0
    x = rng.uniform(-half, half, (B, N)).astype(np.float32)
    y = rng.uniform(-half, half, (B, N)).astype(np.float32)
    n = N // 2
    cx = rng.uniform(-half + 4, half - 4, (B, 1)).astype(np.float32)
    cy = rng.uniform(-half + 4, half - 4, (B, 1)).astype(np.float32)
    x[:, :n] = cx + rng.uniform(-2.5, 2.5, (B, n))
    y[:, :n] = cy + rng.uniform(-2.5, 2.5, (B, n))
    return x, y


def _field_case(case):
    rng = np.random.default_rng(0)
    G = 64
    if case == "three robots":
        x, y = _blobs(rng, 3, 500, G)
        v = rng.random(x.shape) < 0.9
    elif case == "edge wrap":
        # tests/test_grid_icp.py:115: one point in the last interior
        # column; with wrap-around the first columns would come out valid
        x = np.full((3, 500), (G - 2 - G // 2 + 0.5) * RES, np.float32)
        y = np.zeros((3, 500), np.float32)
        v = np.zeros((3, 500), bool)
        v[:, 0] = True
    else:                      # "empty class": scattered cells only
        x = rng.uniform(-14, 14, (3, 500)).astype(np.float32)
        y = rng.uniform(-14, 14, (3, 500)).astype(np.float32)
        v = np.zeros(x.shape, bool)
        v[:, :40] = True
    return _jax_grids(x, y, v, G)


@pytest.mark.parametrize("case", ["three robots", "edge wrap",
                                  "empty class"])
def test_field_matches_jax(case):
    jgrid, tgrid = _field_case(case)
    want = _jax_field(jgrid)
    got = tg.nearest_point_field(tgrid, RES)
    for k in ("px", "py", "valid", "n_class"):
        assert_equal(getattr(got, k), getattr(want, k), k)
    assert_equal(got.center, jgrid.center)
    if case == "edge wrap":
        assert not got.valid[0, :, :3, :].any()
        assert got.valid[0, :, -8:-1, 28:36].any()
    elif case == "empty class":
        assert (got.n_class[:, 0] == 0).all() and (got.n_class[:, 1] > 5).all()
        assert not got.valid[:, 0].any()
    else:
        assert (got.n_class > 3).all()


def test_lookup_matches_jax():
    jgrid, tgrid = _field_case("three robots")
    field = tg.nearest_point_field(tgrid, RES)
    jfield = _jax_field(jgrid)
    rng = np.random.default_rng(1)
    q = rng.uniform(-18, 18, (3, 300, 2)).astype(np.float32)   # some off-grid
    q_ga = rng.random((3, 300)) < 0.5
    got_pt, got_ok = tg.lookup(field, to_torch(q), to_torch(q_ga))
    want_pt, want_ok = jax.vmap(jg.lookup)(jfield, q, q_ga)
    assert_equal(got_ok, want_ok)
    assert_equal(got_pt, want_pt)
    assert 0 < int(got_ok.sum()) < q_ga.size


def _ga_of_cells(count):
    """slam_tpu's ground-adjacency rule on an occupancy raster (G, G)."""
    occ = count > 0
    G = occ.shape[0]
    pad = np.pad(~occ, 1).astype(int)
    box = sum(pad[1 + di:1 + di + G, 1 + dj:1 + dj + G]
              for di in (-1, 0, 1) for dj in (-1, 0, 1)) - (~occ)
    inner = np.zeros_like(occ)
    inner[1:-1, 1:-1] = True
    return occ & inner & (box >= 2)


@pytest.mark.parametrize("loop", ["scan", "while"])
def test_icp_fit_grid_matches_jax(loop):
    """Three robots: robot 0 fits a known transform; robot 1 has fewer
    scene points than min_scene_points (not ok, pose left at init);
    robot 2's map holds <= 3 cells of its NGA class (those points take no
    part)."""
    G = 96
    rng = np.random.default_rng(2)
    x, y = _blobs(rng, 3, 600, G)
    x[2, :300] = rng.uniform(-20, 20, 300)        # no filled square
    y[2, :300] = rng.uniform(-20, 20, 300)
    v = np.ones(x.shape, bool)
    jgrid, tgrid = _jax_grids(x, y, v, G)
    jfield = _jax_field(jgrid)
    field = tg.nearest_point_field(tgrid, RES)
    assert int(field.n_class[2, 0]) <= 3 and int(field.n_class[0, 0]) > 3

    # each point's class is its map cell's
    S = 256
    pts = np.stack([x[:, :S], y[:, :S]], -1)
    ci = np.floor(pts / RES).astype(int) + G // 2
    ga = np.stack([_ga_of_cells(np.asarray(jgrid.count[b]))[
        ci[b, :, 0], ci[b, :, 1]] for b in range(3)])
    th, t = 0.04, np.array([0.25, -0.15], np.float32)
    c, s = np.cos(th), np.sin(th)
    R = np.array([[c, -s], [s, c]], np.float32)
    scene = ((pts - t) @ R).astype(np.float32)
    valid = np.ones((3, S), bool)
    valid[1, 3:] = False
    cfg = IcpConfig(inlier_dist=1.0, max_iterations=20, min_scene_points=5,
                    loop=loop)
    init = np.zeros((3, 3), np.float32)
    want = jax.jit(jax.vmap(lambda sc, va, g, f, p: jg.icp_fit_grid(
        sc, va, g, f, p, cfg)))(scene, valid, ga, jfield, init)
    got = tg.icp_fit_grid(to_torch(scene), to_torch(valid), to_torch(ga),
                          field, to_torch(init), cfg)
    assert_equal(got.ok, want.ok)
    assert_equal(got.num_corr, want.num_corr)
    assert_close(got.pose, want.pose, atol=1e-5)
    assert_close(got.mean_residual, want.mean_residual, atol=1e-5)
    assert_close(got.delta, want.delta, atol=1e-5)
    assert got.ok.tolist() == [True, False, True]
    assert_equal(got.pose[1], init[1])
    assert abs(float(got.pose[0, 2]) - th) < 0.02
    assert float((got.pose[0, :2] - to_torch(t)).norm()) < 0.15


def test_field_resolution_mismatch_raises():
    g = init_point_map(1, 32, RES, device="cpu")
    with pytest.raises(ValueError, match="resolution"):
        tg.nearest_point_field(g, 0.25)


def test_grid_frames_match_jax():
    """slam_step_io with matcher "grid" (the field built from the map grid
    every frame) on the 12 first parity frames of
    tests/test_reference_parity.py."""
    cfg = parity_cfg()
    cfg = dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp,
                                                           matcher="grid"))
    frames = _frames(cfg, n=12)
    want = ours_slam(cfg, frames)
    got = port_slam(cfg, frames)
    assert_close(got, want, atol=1e-4)
    truth = frames[3]
    assert np.abs(got[:, :2] - truth[:, :2]).max() < 0.05


def test_grid_rollout_2d_matches_jax_noise_free():
    """slam2d.rollout with matcher "grid": two macros of four ticks for two
    robots without sensor noise, each macro's field built before the
    shifts, against slam_tpu's rollout."""
    cfg = _noise_free_cfg("grid")
    world = jw2.make_world(jax.random.PRNGKey(42), cfg.sim)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    st = jax.vmap(lambda k: jslam.init_state(k, cfg))(keys)
    fin, (est, true) = jax.vmap(lambda s: jslam.rollout(s, world, cfg, 8))(st)
    tfin, (test, ttrue) = tslam.rollout(
        interop.state_from_numpy(numpy_tree(st), "cpu"),
        interop.world_from_numpy(numpy_tree(world), "cpu"), cfg, 8,
        torch.Generator().manual_seed(0))
    assert_close(ttrue, true, atol=1e-5)
    assert_close(test, est, atol=1e-4)
    assert_equal(tfin.scan_reg_ok, fin.scan_reg_ok)
    assert_equal(tfin.map_grid.count, fin.map_grid.count)
    assert bool(tfin.scan_reg_ok.all())
    assert not bool(tfin.map_cloud.valid.any())     # no export


# ------------------------------------------------------ 3D, mid scale

def _midscale(cut=True):
    """tests/test_scale_rollout.py's mid scale: ref_scale_config with
    5,120 rays (160 azimuths), matcher "grid", the completeness gate
    scaled with the ray count; cut: the ground GP at 1 sweep of 16 signal
    slots (slam_tpu's compile time)."""
    cfg = ref_scale_config()
    cfg = cfg.replace(
        sim=dataclasses.replace(cfg.sim, num_azimuth=160),
        icp=dataclasses.replace(cfg.icp, matcher="grid"),
        cloud=dataclasses.replace(cfg.cloud, min_scan_points=1464))
    return _cut_gp(cfg, sweeps=1, capacity=16) if cut else cfg


@pytest.fixture(scope="module")
def unfused_xla():
    """slam_tpu compiled without XLA's optimizing passes, as
    tests/test_torch_slam3d.py compiles it (its height fit's fused
    eigen-solve rounds differently from the same primitives one by one)."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


def test_grid_frame_3d_matches_jax(unfused_xla):
    """Two noise-free mid-scale frames of one robot with matcher "grid":
    the first on an empty map (no registration; it seeds the map), the
    second registered against the field of that map."""
    cfg = _noise_free(_midscale())
    world = jw3.make_world(jax.random.PRNGKey(42), cfg.sim)
    st = jslam3d.init_state_3d(jax.random.PRNGKey(0), cfg, world)
    gm = jslam3d.init_ground_map(cfg)
    step = jax.jit(lambda s, g, f: jslam3d.process_frame_3d(s, g, *f, cfg))
    ts, tgm = _port((st, gm))
    for _ in range(2):
        frame = _next_frame(world, cfg, st)
        true = jax.jit(lambda k, p: jw2.unicycle_step(
            p[:3], jw2.drive_cmd(k, cfg.sim.dt), cfg.sim.dt))(st.step,
                                                             st.true_pose)
        st, gm = step(st, gm, frame)
        st = st.replace(true_pose=st.true_pose.at[:3].set(true))
        ts, tgm = tslam3d.slam_step_3d_io(ts, tgm, *_port_frame(frame), cfg)
        assert_equal(ts.scan_reg_ok[0], st.scan_reg_ok)
        assert_close(ts.scan_reg_pose[0], st.scan_reg_pose, atol=1e-4)
        assert_close(ts.pose[0], st.pose, atol=1e-4)
        assert_equal(ts.map_grid.count[0], st.map_grid.count)
        assert_equal(tgm.grid.count[0], gm.grid.count)
        assert_equal(ts.prev_scene.valid[0], st.prev_scene.valid)
    assert bool(ts.scan_reg_ok[0]) and int(ts.prev_scene.valid.sum()) > 20


def test_grid_rollout_3d_tracks_at_midscale():
    """The port's rollout_3d with matcher "grid" (the field built once a
    macro, after the shifts) at tests/test_scale_rollout.py's mid scale,
    with sensor noise from a torch generator, held to that test's bounds
    for slam_tpu's own run: one robot, 12 ticks."""
    cfg = _midscale(cut=False)
    gen = torch.Generator().manual_seed(0)
    world = interop.world3d_from_numpy(numpy_tree(jw3.make_world(
        jax.random.PRNGKey(42), cfg.sim)), "cpu")
    st = tslam3d.init_state_3d(cfg, 1, world, device="cpu", generator=gen)
    gm = tslam3d.init_ground_map(cfg, 1, device="cpu")
    fin, _, (est, true, reg_ok) = tslam3d.rollout_3d(st, world, gm, cfg, 12,
                                                     gen)
    assert bool(fin.scan_reg_ok[0]) and bool(reg_ok[0, 4:].all())
    err = est[0, 4:, :2] - true[0, 4:, :2]
    ate = float(err.pow(2).sum(-1).mean().sqrt())
    zerr = float((est[0, 4:, 3] - true[0, 4:, 3]).abs().mean())
    assert np.isfinite(ate) and ate < 0.2, ate
    assert zerr < 0.1, zerr
    # the grid matcher exports no map cloud: the target stays empty
    assert not bool(fin.map_cloud.valid.any())
