"""Port parity, relocalization (slam_tpu_torch.ops.fft_match and
slam_tpu_torch.pipeline.relocalize vs slam_tpu, CPU).

slam_tpu runs jitted and vmapped over robots. Its CPU nearest neighbour
(the ICP polish's) uses the expanded |q|^2 - 2 q.m + |m|^2 form; the direct
form the port and K4 use is patched in, as tests/test_torch_graph.py does.

FFT ties: the correlation values are integer overlap counts carrying the
FFT's rounding, and XLA's and PyTorch's FFTs round differently, so where
two lags tie on the integer either may win. The coarse poses are held
equal only where the best (rotation, lag) leads every other by at least
half a count; elsewhere the port's choice must score within 1e-3 counts of
the best in slam_tpu's own correlation. Scores are held to 1e-5 always,
rasters and dilations exactly, correlations to 1e-3, polished poses to
1e-4 (the polish starts from equal coarse poses).
"""

import contextlib
import dataclasses
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import GlobalMatchConfig as JGm, IcpConfig as JIcp
from slam_tpu.config import sim2d_config as j_sim2d_config
from slam_tpu.ops import fft_match as jfft, nn as jnn
from slam_tpu.pipeline import relocalize as jrel
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.sim import world2d as jw
from slam_tpu.types import PointCloud as JCloud
from slam_tpu_torch import interop
from slam_tpu_torch.config import GlobalMatchConfig, IcpConfig, sim2d_config
from slam_tpu_torch.ops import fft_match as tfft
from slam_tpu_torch.pipeline import relocalize as trel
from slam_tpu_torch.types import PointCloud
from tests.torch_parity import (assert_close, assert_equal, numpy_tree,
                                to_np, to_torch)

torch.set_num_threads(1)

GM = dict(num_rotations=32, grid_size=96, grid_resolution=0.5,
          accept_score=0.55, rot_chunk=8)
ICP = dict(max_points=512, inlier_dist=1.0, max_iterations=15)
TIE_LEAD = 0.5        # counts: a best (rotation, lag) this far ahead is unique
TIE_TOL = 1e-3        # counts: a choice this close to the best is a tie


def _direct_sq_dist(q, m):
    d = q[..., :, None, :] - m[..., None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]


def _direct_nn():
    return mock.patch.object(jnn, "pairwise_sq_dist", _direct_sq_dist)


def _xyz(xy):
    return np.concatenate([xy, np.zeros(xy.shape[:-1] + (1,), np.float32)],
                          -1)


def _jcloud(xy, valid):
    return JCloud(xyz=_xyz(xy), valid=valid,
                  flags=np.zeros(valid.shape, np.int32))


def _tcloud(xy, valid):
    return PointCloud(xyz=to_torch(_xyz(xy)), valid=to_torch(valid),
                      flags=torch.zeros(valid.shape, dtype=torch.int32))


def _problems(seed=0, B=5, M=400, N=160):
    """B maps of M points (+-40 m) and scenes of <= N points seen from a
    true pose within 30 m, 2 cm noise; robot B-1 sees another map (a
    rejection). Returns (map xy, scene xy, scene valid, true poses,
    priors)."""
    rng = np.random.default_rng(seed)
    mp = rng.uniform(-40, 40, (B, M, 2)).astype(np.float32)
    poses = np.concatenate([rng.uniform(-6, 6, (B, 2)),
                            rng.uniform(-np.pi, np.pi, (B, 1))], -1
                           ).astype(np.float32)
    sc = np.zeros((B, N, 2), np.float32)
    sv = np.zeros((B, N), bool)
    for b in range(B):
        src = mp[b] if b < B - 1 else rng.uniform(-40, 40, (M, 2))
        c, s = np.cos(poses[b, 2]), np.sin(poses[b, 2])
        local = (src - poses[b, :2]) @ np.array([[c, -s], [s, c]])
        keep = np.flatnonzero(np.linalg.norm(local, axis=1) < 30)[:N]
        sc[b, :len(keep)] = local[keep] + rng.normal(0, 0.02, (len(keep), 2))
        sv[b, :len(keep)] = True
    prior = (poses[:, :2] + rng.uniform(-3, 3, (B, 2))).astype(np.float32)
    return mp, sc, sv, poses, prior


def _jax_fracs(mp, sc, sv, prior, cfg):
    """slam_tpu's own search planes for one robot: (K, (2G)^2) correlation
    over occupied scene cells, as global_match scores them."""
    K = cfg.num_rotations
    angles = jnp.arange(K) * (2 * jnp.pi / K)
    map_img = jfft.dilate(jfft.rasterize(
        jnp.asarray(mp), jnp.ones(mp.shape[0], bool), jnp.asarray(prior),
        cfg), cfg.smooth_radius)

    def rot(th):
        c, s = jnp.cos(th), jnp.sin(th)
        R = jnp.array([[c, -s], [s, c]])
        return jfft.rasterize(jnp.asarray(sc) @ R.T, jnp.asarray(sv),
                              jnp.zeros(2), cfg)
    imgs = jax.vmap(rot)(angles)
    corr = jfft.fft_correlate(map_img, imgs).reshape(K, -1)
    cells = jnp.maximum(jnp.sum(imgs, axis=(1, 2)), 1.0)
    return np.asarray(corr), np.asarray(cells)


def _lag_of(pose, prior, cfg):
    """(rotation, flat lag) a coarse pose was decoded from."""
    K, G, P = cfg.num_rotations, cfg.grid_size, 2 * cfg.grid_size
    k = int(round(float(pose[2]) / (2 * math.pi / K))) % K
    dx, dy = (int(round(float(v))) for v in
              (np.asarray(pose[:2]) - prior) / cfg.grid_resolution)
    return k, (dx % P) * P + (dy % P)


def _check_tie_rule(got_coarse, want_coarse, mp, sc, sv, prior, cfg):
    """Per robot: True where the best (rotation, lag) is unique by TIE_LEAD
    counts (then the coarse poses must be equal), else the port's choice
    must be within TIE_TOL counts of the best."""
    unique = []
    for b in range(mp.shape[0]):
        corr, cells = _jax_fracs(mp[b], sc[b], sv[b], prior[b], cfg)
        frac = corr / cells[:, None]
        order = np.argsort(frac, axis=None)
        best, second = frac.flat[order[-1]], frac.flat[order[-2]]
        kb = order[-1] // frac.shape[1]
        if (best - second) * cells[kb] >= TIE_LEAD:
            assert_close(got_coarse[b], want_coarse[b], atol=1e-5,
                         what=f"robot {b}")
            unique.append(True)
        else:
            k, lag = _lag_of(got_coarse[b], prior[b], cfg)
            assert (best - frac[k, lag]) * cells[k] <= TIE_TOL, b
            unique.append(False)
    return np.array(unique)


def test_rasterize_dilate_correlate_match_jax():
    """Points on and off the raster (and masked ones), a raster dilated by
    2, and the zero-padded correlation of 4 rotated scenes."""
    cfg_j, cfg_t = JGm(grid_size=64, grid_resolution=0.5), \
        GlobalMatchConfig(grid_size=64, grid_resolution=0.5)
    rng = np.random.default_rng(1)
    xy = rng.uniform(-20, 20, (3, 500, 2)).astype(np.float32)
    xy[:, ::7] *= 3.0                                 # off the raster
    valid = rng.random((3, 500)) < 0.9
    center = rng.uniform(-2, 2, (3, 2)).astype(np.float32)
    want = jax.vmap(lambda a, v, c: jfft.rasterize(a, v, c, cfg_j))(
        xy, valid, center)
    got = tfft.rasterize(to_torch(xy), to_torch(valid), to_torch(center),
                         cfg_t)
    assert_equal(got, want)
    assert 100 < float(np.asarray(want).sum(-1).sum(-1).min())
    dwant = jax.vmap(lambda a: jfft.dilate(a, 2))(want)
    dgot = tfft.dilate(got, 2)
    assert_equal(dgot, dwant)
    scenes = np.asarray(want)[[1, 2, 0, 1]][None].repeat(3, 0)
    cwant = jax.vmap(jfft.fft_correlate)(dwant, scenes)
    cgot = tfft.fft_correlate(dgot, to_torch(scenes))
    assert cgot.shape == (3, 4, 128, 128)
    assert_close(cgot, cwant, atol=1e-3)


def test_global_match_matches_jax_under_the_tie_rule():
    mp, sc, sv, poses, prior = _problems()
    B = mp.shape[0]
    jcfg, tcfg = JGm(**GM), GlobalMatchConfig(**GM)
    jicp, ticp = JIcp(**ICP), IcpConfig(**ICP)
    ones = np.ones(mp.shape[:2], bool)

    def jax_match(icp):
        def one(s, v, m, p):
            return jfft.global_match(
                JCloud(xyz=s, valid=v, flags=jnp.zeros(v.shape, jnp.int32)),
                JCloud(xyz=m, valid=jnp.ones(m.shape[0], bool),
                       flags=jnp.zeros(m.shape[0], jnp.int32)), p, jcfg, icp)
        return jax.jit(jax.vmap(one))(_xyz(sc), sv, _xyz(mp), prior)
    with _direct_nn():
        want_c, want = jax_match(None), jax_match(jicp)
    args = (_tcloud(sc, sv), _tcloud(mp, ones), to_torch(prior), tcfg)
    got_c = tfft.global_match(*args)
    got = tfft.global_match(*args, ticp)
    for g, w in ((got_c, want_c), (got, want)):
        assert_close(g.score, w.score, atol=1e-5)
        assert_equal(g.ok, w.ok)
    unique = _check_tie_rule(to_np(got_c.pose), np.asarray(want_c.pose), mp,
                             sc, sv, prior, jcfg)
    assert_close(to_np(got.pose)[unique], np.asarray(want.pose)[unique],
                 atol=1e-4)
    ok = np.asarray(want.ok)
    assert ok[:-1].all() and not ok[-1]
    err = np.linalg.norm(to_np(got.pose)[:-1, :2] - poses[:-1, :2], axis=-1)
    assert err.max() < 0.3


def _state_with(map_xy, scene_xy, scene_valid, pose):
    """A slam_tpu state (numpy, stacked over robots) holding the given map
    cloud, last scene and belief."""
    cfg = j_sim2d_config()
    B = map_xy.shape[0]
    st = jax.vmap(lambda k: jslam.init_state(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), B))
    st = numpy_tree(st)
    C = cfg.cloud.map_capacity
    mxy = np.zeros((B, C, 2), np.float32)
    mxy[:, :map_xy.shape[1]] = map_xy
    mval = np.zeros((B, C), bool)
    mval[:, :map_xy.shape[1]] = True
    S = cfg.cloud.scene_capacity
    sxy = np.zeros((B, S, 2), np.float32)
    sxy[:, :scene_xy.shape[1]] = scene_xy
    sval = np.zeros((B, S), bool)
    sval[:, :scene_xy.shape[1]] = scene_valid
    pose4 = np.concatenate([pose, np.zeros((B, 1), np.float32)], -1)
    mu = st.ekf.mu.copy()
    mu[:, [0, 1, 6]] = pose
    return st.replace(map_cloud=_jcloud(mxy, mval),
                      prev_scene=_jcloud(sxy, sval), pose=pose4,
                      ekf=st.ekf.replace(mu=mu))


def test_relocalize_with_fallback_matches_jax():
    """A map no scene matches (accept 0.99): rejections count up from each
    robot's carried counter; at max_failures the prior is published as an
    accepted match of score 0 and the counter resets."""
    mp, sc, sv, _, prior = _problems(seed=2, B=2)
    prior3 = np.concatenate([prior, np.array([[0.3], [-1.0]], np.float32)],
                            -1)
    st = _state_with(mp, sc, sv, prior3)
    gm = {**GM, "max_failures": 3, "accept_score": 0.99}
    base = j_sim2d_config()
    jcfg = base.replace(global_match=dataclasses.replace(base.global_match,
                                                         **gm))
    tcfg = _port_cfg(jcfg)
    step = jax.jit(jax.vmap(lambda s, f: jrel.relocalize_with_fallback(
        s, s.prev_scene, jcfg, f)))
    ts = interop.state_from_numpy(st, "cpu")
    jf = np.array([0, 1], np.int32)
    tf = to_torch(jf)
    for k in range(3):
        with _direct_nn():
            want, jf = step(st, jf)
        got, tf = trel.relocalize_with_fallback(ts, ts.prev_scene, tcfg, tf)
        assert_equal(tf, jf, f"failures after call {k}")
        assert_equal(got.ok, want.ok)
        assert_close(got.score, want.score, atol=1e-5)
        fell_back = np.asarray(want.score) == 0.0
        assert_close(to_np(got.pose)[fell_back],
                     np.asarray(want.pose)[fell_back], atol=0.0)
    # robot 1 fell back on call 2, robot 0 on call 3
    assert_equal(jf, [0, 1])
    assert bool(np.asarray(want.ok)[0]) and float(want.score[0]) == 0.0


@pytest.fixture(scope="module")
def fleet():
    """tests/test_relocalize_shared.py:172's fleet: three robots after a
    60-tick slam_tpu rollout, as numpy."""
    c = j_sim2d_config()
    cfg = dataclasses.replace(c, global_match=dataclasses.replace(
        c.global_match, num_rotations=64, grid_size=192,
        grid_resolution=0.5, accept_score=0.35))
    world = jw.make_world(jax.random.PRNGKey(42), cfg.sim)
    st = jax.vmap(lambda k: jslam.init_state(k, cfg))(
        jax.random.split(jax.random.PRNGKey(5), 3))
    st, _ = jax.vmap(lambda s: jslam.rollout(s, world, cfg, 60))(st)
    return cfg, numpy_tree(st)


def _port_cfg(jcfg):
    c = sim2d_config()
    return c.replace(global_match=dataclasses.replace(
        c.global_match, **dataclasses.asdict(jcfg.global_match)))


def test_fleet_relocalize_if_lost_matches_jax(fleet):
    """A healthy fleet passes through as it is; with robot 1's belief
    kidnapped by (+8 m, -5 m) and flagged lost, only robot 1 moves, back to
    within 0.8 m of its true pose, in both packages; the others stay bit
    for bit."""
    jcfg, st = fleet
    tcfg = _port_cfg(jcfg)
    healthy = st.replace(scan_reg_ok=np.ones(3, bool))
    th = interop.state_from_numpy(healthy, "cpu")
    out = trel.fleet_relocalize_if_lost(th, tcfg)
    assert out is th
    jout = jax.jit(lambda s: jrel.fleet_relocalize_if_lost(s, jcfg))(healthy)
    assert_equal(jout.ekf.mu, healthy.ekf.mu)

    mu = healthy.ekf.mu.copy()
    mu[1, :2] += [8.0, -5.0]
    pose = healthy.pose.copy()
    pose[1, :2] += [8.0, -5.0]
    lost = healthy.replace(ekf=healthy.ekf.replace(mu=mu), pose=pose,
                           scan_reg_ok=np.array([True, False, True]))
    with _direct_nn():
        want = jax.jit(lambda s: jrel.fleet_relocalize_if_lost(s, jcfg))(
            lost)
    tl = interop.state_from_numpy(lost, "cpu")
    got = trel.fleet_relocalize_if_lost(tl, tcfg)
    true1 = lost.true_pose[1, :2]
    for mu_ in (to_np(got.ekf.mu), np.asarray(want.ekf.mu)):
        assert np.linalg.norm(mu_[1, :2] - true1) < 0.8
    for r in (0, 2):
        assert_equal(got.ekf.mu[r], tl.ekf.mu[r])
        assert_equal(got.pose[r], tl.pose[r])
        assert_equal(got.ekf.sigma[r], tl.ekf.sigma[r])
    assert_close(got.ekf.mu[1], want.ekf.mu[1], atol=1e-3)
    assert_close(got.pose, want.pose, atol=1e-3)
