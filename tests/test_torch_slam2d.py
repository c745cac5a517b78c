"""Port parity, the whole slice: slam2d on the 40 parity frames of
tests/test_reference_parity.py, the rollout's macro structure, and the
state round trip (slam_tpu_torch vs slam_tpu, CPU).

Tolerances:
- "points" port vs JAX slam_step_io: per-frame xy <= 1 cm, yaw <= 5 mrad
  (measured 7.1 mm, 1.8 mrad). JAX's CPU nearest neighbour uses the
  expanded |q|^2 - 2 q.m + |m|^2 form, whose ~1e-3 m^2 error at 45 m flips
  near-tied correspondences; with the direct form patched in, the two
  agree to <= 1 mm, 1 mrad.
- "fused" port (K1's plain version on the CPU) vs the cached f64 oracle:
  ATE <= 1 cm and yaw < 0.01 rad, the bounds of the JAX package's own
  parity test.
- noise-free rollout, port vs JAX: poses to 1e-5 (measured 4e-7).
"""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import sim2d_config
from slam_tpu.ops import icp_pallas as jip, nn as jnn
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.sim import world2d as jw
from slam_tpu_torch import interop
from slam_tpu_torch.pipeline import slam2d as tslam
from slam_tpu_torch.utils import profiling as tprof
from tests.golden_cache import cached_oracle
from tests.test_reference_parity import (_render_frames, oracle_slam,
                                         ours_slam, parity_cfg)
from tests.torch_parity import (assert_close, assert_equal, numpy_tree,
                                pallas_interpret)

torch.set_num_threads(1)


def _frames(cfg, n=40):
    world = jw.make_world(jax.random.PRNGKey(42), cfg.sim)
    return _render_frames(cfg, world, n)


def _jax_start(cfg):
    st = jslam.init_state(jax.random.PRNGKey(0), cfg, calibrate_gyro=False)
    return st.replace(ekf=st.ekf.replace(
        gyro_bias=jnp.float32(cfg.sim.gyro_bias)))


def port_slam(cfg, frames):
    """The port over external frames, one robot, from the JAX start state
    (ours_slam's loop)."""
    ranges, hits, cmds, _ = frames
    st = jax.tree.map(lambda x: np.asarray(x)[None], _jax_start(cfg))
    ts = interop.state_from_numpy(st, "cpu")
    ang0 = np.arange(cfg.sim.num_beams) * (2 * np.pi / cfg.sim.num_beams)
    traj = []
    for t in range(len(ranges)):
        r = np.where(hits[t], ranges[t], cfg.sim.beam_max_range)
        scan = np.stack([r * np.cos(ang0), r * np.sin(ang0),
                         np.zeros_like(r)], -1).astype(np.float32)
        ts = tslam.slam_step_io(
            ts, torch.from_numpy(scan)[None],
            torch.from_numpy(np.array(hits[t]))[None],
            torch.tensor([cmds[t][2] + cfg.sim.gyro_bias],
                         dtype=torch.float32),
            torch.from_numpy(np.array(cmds[t], np.float32))[None], cfg)
        traj.append(ts.pose[0, :3].numpy())
    return np.array(traj)


def _direct_sq_dist(q, m):
    d = q[..., :, None, :] - m[..., None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]


@pytest.mark.parametrize("nn_form,xy_tol,yaw_tol", [
    ("expanded", 1e-2, 5e-3),
    ("direct", 1e-3, 1e-3),
])
def test_points_slice_matches_jax(nn_form, xy_tol, yaw_tol):
    cfg = parity_cfg()
    frames = _frames(cfg)
    if nn_form == "direct":
        with mock.patch.object(jnn, "pairwise_sq_dist", _direct_sq_dist):
            want = ours_slam(cfg, frames)
    else:
        want = ours_slam(cfg, frames)
    got = port_slam(cfg, frames)
    assert np.abs(got[:, :2] - want[:, :2]).max() <= xy_tol
    dyaw = np.arctan2(np.sin(got[:, 2] - want[:, 2]),
                      np.cos(got[:, 2] - want[:, 2]))
    assert np.abs(dyaw).max() <= yaw_tol


def test_fused_slice_matches_oracle():
    cfg = parity_cfg()
    frames = _frames(cfg)
    ref = cached_oracle("parity2d", oracle_slam, (cfg,), frames,
                        lambda: oracle_slam(cfg, frames))
    fused = dataclasses.replace(cfg, icp=dataclasses.replace(
        cfg.icp, matcher="fused"))
    got = port_slam(fused, frames)
    err = np.linalg.norm(got[:, :2] - ref[:, :2], axis=1)
    assert np.sqrt(np.mean(err[5:] ** 2)) <= 0.01
    dyaw = np.abs(np.arctan2(np.sin(got[:, 2] - ref[:, 2]),
                             np.cos(got[:, 2] - ref[:, 2])))
    assert dyaw[5:].max() < 0.01
    assert tprof.count_of("k1.launches") == 0  # the CPU ran the plain version


def _noise_free_cfg(matcher="points"):
    c = sim2d_config()
    return dataclasses.replace(
        c, icp=dataclasses.replace(c.icp, matcher=matcher),
        sim=dataclasses.replace(c.sim, range_noise=0.0, gyro_noise=0.0))


def test_rollout_matches_jax_noise_free():
    """Two macros of four ticks for two robots. Without sensor noise the
    random streams drop out, so the macro structure (one export and one
    re-centring per macro) and every stage are compared end to end."""
    cfg = _noise_free_cfg()
    world = jw.make_world(jax.random.PRNGKey(42), cfg.sim)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    st = jax.vmap(lambda k: jslam.init_state(k, cfg))(keys)
    fin, (est, true) = jax.vmap(lambda s: jslam.rollout(s, world, cfg, 7))(st)
    tfin, (test, ttrue) = tslam.rollout(
        interop.state_from_numpy(numpy_tree(st), "cpu"),
        interop.world_from_numpy(numpy_tree(world), "cpu"), cfg, 7,
        torch.Generator().manual_seed(0))
    assert test.shape == (2, 7, 3)        # 7 ticks round up to 2 macros
    assert_close(test, est, atol=1e-5)
    assert_close(ttrue, true, atol=1e-5)
    assert_equal(tfin.step, fin.step)
    assert_equal(tfin.map_grid.count, fin.map_grid.count)
    assert_close(tfin.local_map.counts, fin.local_map.counts, atol=0)
    assert_close(tslam.ate(test, ttrue),
                 jax.vmap(jslam.ate)(est, true), atol=1e-5)


def test_fused_rollout_on_cpu_uses_plain_kernels():
    cfg = sim2d_config()
    gen = torch.Generator().manual_seed(0)
    world = jw.make_world(jax.random.PRNGKey(1), cfg.sim)
    st = tslam.init_state(cfg, 2, device="cpu", generator=gen)
    fin, (est, true) = tslam.rollout(
        st, interop.world_from_numpy(numpy_tree(world), "cpu"), cfg, 8, gen)
    assert est.shape == (2, 8, 3) and torch.isfinite(est).all()
    assert (tslam.ate(est, true) < 0.05).all()
    assert fin.scan_reg_ok.all() and (fin.map_grid.count > 0).any()
    assert tprof.count_of("k1.launches") == 0
    assert tprof.count_of("k4.launches") == 0


@pytest.mark.parametrize("matcher", ["points", "particle", "fused"])
def test_frame_without_incremental_map_matches_jax(matcher):
    """incremental_map=False: the robots' grid is left alone, and the
    matcher registers against state.map_cloud, its GA flags re-classified
    around the prediction: "fused" with the fused fit (JAX's K1 in
    interpret mode, the TPU path), "points" and "particle" with "points"
    (a particle matcher with no pf_target has no live grid to score).
    JAX's direct NN form is patched in, as above; pose 1e-4."""
    cfg = dataclasses.replace(parity_cfg(), icp=dataclasses.replace(
        parity_cfg().icp, matcher=matcher))
    frames = _frames(cfg, n=4)
    ranges, hits, cmds, _ = frames
    ang0 = np.arange(cfg.sim.num_beams) * (2 * np.pi / cfg.sim.num_beams)
    scans = [np.stack([ranges[t] * np.cos(ang0), ranges[t] * np.sin(ang0),
                       np.zeros_like(ranges[t])], -1).astype(np.float32)
             for t in range(4)]
    pts = dataclasses.replace(cfg, icp=dataclasses.replace(
        cfg.icp, matcher="points"))
    st = _jax_start(cfg)
    for t in range(3):                  # build a map with the points matcher
        st = jslam.slam_step_io(st, scans[t], hits[t], np.float32(cmds[t][2]),
                                cmds[t], pts)
    args = (scans[3], hits[3], np.float32(cmds[3][2]), cmds[3])
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(jnn, "pairwise_sq_dist",
                                              _direct_sq_dist))
        if matcher == "fused":
            # slam_tpu takes the fused kernel only on a TPU
            spy = mock.Mock(wraps=jip.fused_register)
            stack.enter_context(pallas_interpret())
            stack.enter_context(mock.patch.object(jax, "default_backend",
                                                  lambda: "tpu"))
            stack.enter_context(mock.patch.object(jip, "fused_register",
                                                  spy))
        want = jslam.slam_step_io(st, *args, cfg, incremental_map=False)
    if matcher == "fused":
        assert spy.called
    ts = interop.state_from_numpy(jax.tree.map(
        lambda x: np.asarray(x)[None], st), "cpu")
    got = tslam.process_frame(ts, torch.from_numpy(scans[3])[None],
                              torch.from_numpy(np.array(hits[3]))[None],
                              torch.tensor([cmds[3][2]], dtype=torch.float32),
                              torch.from_numpy(np.array(cmds[3],
                                                        np.float32))[None],
                              cfg, incremental_map=False)
    assert bool(want.scan_reg_ok) and bool(got.scan_reg_ok[0])
    assert_close(got.scan_reg_pose[0], want.scan_reg_pose, atol=1e-4)
    assert_close(got.pose[0], want.pose, atol=1e-4)
    assert_equal(got.map_grid.count[0], want.map_grid.count)
    assert_equal(got.map_cloud.valid[0], want.map_cloud.valid)


def test_state_round_trip():
    cfg = parity_cfg()
    frames = _frames(cfg, n=3)
    st = _jax_start(cfg)
    step = jax.jit(lambda s, sc, h, g, c: jslam.slam_step_io(
        s, sc, h, g, c, cfg))
    ranges, hits, cmds, _ = frames
    ang0 = np.arange(cfg.sim.num_beams) * (2 * np.pi / cfg.sim.num_beams)
    for t in range(3):
        scan = np.stack([ranges[t] * np.cos(ang0), ranges[t] * np.sin(ang0),
                         np.zeros_like(ranges[t])], -1).astype(np.float32)
        st = step(st, scan, hits[t], np.float32(cmds[t][2]), cmds[t])
    stacked = jax.tree.map(lambda x: np.stack([np.asarray(x)] * 2), st)
    back = interop.state_to_numpy(interop.state_from_numpy(stacked, "cpu"))
    for path, leaf in jax.tree_util.tree_leaves_with_path(stacked):
        keys = [p.name for p in path]
        if keys[0] in ("rng", "graph_full"):
            # the port draws from a Generator; graph_full is pose-graph state
            continue
        got = back
        for k in keys:
            got = got[k]
        assert_equal(got, leaf, "/".join(keys))
    assert float(np.abs(stacked.map_grid.count).sum()) > 0
