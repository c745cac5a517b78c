"""Port parity, the 6-DoF graph's building blocks (slam_tpu_torch vs
slam_tpu, CPU): quaternions and se3_matrix, the SO(3) maps and their
round trips, rigid_transform_3d (the weighted 3D Kabsch, a rank-2 wall
and a ground plane among the cases), the 3D nearest neighbour and its
query-chunked form, icp3d_fit, the 6 x 6 LUM information, and K2's packed
problems above RESIDENT_TILE_LIMIT, which go to K3's plain version.

slam_tpu's CPU nearest neighbour uses the expanded |q|^2 - 2 q.m + |m|^2
form; the direct form the port uses is patched into
slam_tpu.ops.nn.pairwise_sq_dist, as tests/test_torch_graph.py does in 2D.

Tolerances: rotations from slam_tpu's f32 SVD lie up to 7.3e-5 from the
f64 Kabsch rotation on such problems, the port's Jacobi SVD 1.1e-6: held
to 1e-4 of each other (translations 1e-4 times their lever, 10 m);
quaternion and SO(3) maps 2e-6 (3e-4 rad within 1e-3 of pi, where both
packages take the axis from R + I); nearest indices exact and distances
to 4 f32 ulps of |q|^2 + |m|^2 (the direct form in both, an FMA apart);
icp3d poses 1e-4, inlier counts exact (1e-3 m on two edge problems
recorded on the card, tests/data/se3_edge_minima.npz); the LUM
information relative 1e-2 (it divides by the residual variance of ~1 cm
noise).
"""

import dataclasses
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from slam_tpu import geometry as jgeo
from slam_tpu.config import sim3d_config
from slam_tpu.graph import pose_graph3d as jpg3
from slam_tpu.ops import align as jalign
from slam_tpu.ops import icp3d as jicp3d
from slam_tpu.ops import nn as jnn
from slam_tpu_torch import geometry as tgeo
from slam_tpu_torch.graph import pose_graph3d as tpg3
from slam_tpu_torch.ops import align as talign
from slam_tpu_torch.ops import icp3d as ticp3d
from slam_tpu_torch.ops import icp_fused
from slam_tpu_torch.ops import nn as tnn
from slam_tpu_torch.utils import profiling as tprof
from tests.torch_parity import assert_close, assert_equal, to_np, to_torch

torch.set_num_threads(1)

ICP = dataclasses.replace(sim3d_config().icp, inlier_dist=4.0)


def _direct_sq_dist(q, m):
    d = q[..., :, None, :] - m[..., None, :, :]
    out = d[..., 0] * d[..., 0]
    for k in range(1, q.shape[-1]):
        out = out + d[..., k] * d[..., k]
    return out


def direct_nn():
    return mock.patch.object(jnn, "pairwise_sq_dist", _direct_sq_dist)


def _rot(rng, n, span=0.5):
    rpy = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    return np.asarray(jgeo.rot3_from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2]))


def test_quaternion_and_se3_matrix_match_jax():
    rng = np.random.default_rng(0)
    rpy = rng.uniform(-3.1, 3.1, (64, 3)).astype(np.float32)
    xyz = rng.uniform(-50, 50, (64, 3)).astype(np.float32)
    q = jgeo.quat_from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2])
    tq = tgeo.quat_from_rpy(*to_torch(rpy).unbind(-1))
    assert_close(tq, q, atol=2e-6, what="quat_from_rpy")
    # on one quaternion: near pitch +-pi/2 yaw is ill-conditioned
    assert_close(tgeo.yaw_from_quat(to_torch(np.asarray(q))),
                 jgeo.yaw_from_quat(q), atol=2e-6, what="yaw_from_quat")
    assert_close(tgeo.se3_matrix(to_torch(xyz), to_torch(rpy)),
                 jgeo.se3_matrix(xyz, rpy), atol=1e-5, what="se3_matrix")


def _rotation_vectors(rng):
    """Generic, tiny (the Taylor branches) and near-pi rotation vectors."""
    axis = rng.normal(size=(48, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = np.concatenate([rng.uniform(0.01, 3.0, 24), 10.0 ** rng.uniform(
        -8, -3, 12), np.pi - 10.0 ** rng.uniform(-6, -4, 12)])
    return (axis * ang[:, None]).astype(np.float32)


def test_so3_maps_and_round_trips_match_jax():
    rng = np.random.default_rng(1)
    w = _rotation_vectors(rng)
    R = jpg3.so3_exp(w)
    tR = tpg3.so3_exp(to_torch(w))
    assert_close(tR, R, atol=2e-6, what="so3_exp")
    assert_close(tpg3.so3_hat(to_torch(w)), jpg3.so3_hat(w), atol=0,
                 what="so3_hat")
    # the same rotations through both logs
    tw = tpg3.so3_log(to_torch(np.asarray(R)))
    jw = jpg3.so3_log(R)
    assert_close(tw[:36], jw[:36], atol=2e-6, what="so3_log")
    assert_close(tw[36:], jw[36:], atol=3e-4, what="so3_log near pi")
    back = tpg3.so3_exp(tw)
    # arccos of an f32 cosine: ~eps / sin(t), 1e-5 at t = 0.01
    assert_close(back[:36], R[:36], atol=2e-5, what="exp(log(R))")
    assert_close(back[36:], R[36:], atol=3e-4, what="exp(log(R)) near pi")
    q = jpg3.rot_to_quat(R)
    tq = tpg3.rot_to_quat(to_torch(np.asarray(R)))
    assert_close(tq[:36], q[:36], atol=2e-6, what="rot_to_quat")
    assert bool((tq[:, 0] >= 0).all())
    assert_close(tpg3.quat_to_rot(tq), R, atol=3e-6, what="quat round trip")
    assert_close(tpg3.quat_to_rot(to_torch(np.asarray(q))),
                 jpg3.quat_to_rot(q), atol=2e-6, what="quat_to_rot")


def _kabsch_case(case, seed):
    """(a, b, w) for one problem: a scatter, a wall (x = 3, rank-2 H) or a
    flat ground patch (z = 0), moved by a rotation and translation, 2 cm
    noise."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, [8, 8, 0.8], (60, 3))
    if case == "wall":
        a[:, 0] = 3.0
    elif case == "ground":
        a[:, 2] = 0.0
    R = _rot(rng, 1, span=3.0)[0] if case == "any_rotation" else \
        _rot(rng, 1)[0]
    b = a @ R.T + rng.normal(0, 3, 3) + rng.normal(0, 0.02, a.shape)
    w = (rng.random(60) < 0.8).astype(np.float32)
    return a.astype(np.float32), b.astype(np.float32), w


@pytest.mark.parametrize("case", ["scatter", "any_rotation", "wall",
                                  "ground"])
def test_rigid_transform_3d_matches_jax(case):
    """The rotation is unique wherever rank(H) >= 2: a wall and a flat
    patch (H of rank 2) included."""
    probs = [_kabsch_case(case, s) for s in range(8)]
    a, b, w = (np.stack(x) for x in zip(*probs))
    want = jax.vmap(jalign.rigid_transform_3d)(a, b, w)
    got = talign.rigid_transform_3d(to_torch(a), to_torch(b), to_torch(w))
    assert_close(got.R, want.R, atol=1e-4, what="R")
    assert_close(got.t, want.t, atol=1e-3, what="t")
    assert_close(got.rmse, want.rmse, atol=1e-4, what="rmse")
    eye = np.broadcast_to(np.eye(3), (8, 3, 3))
    assert_close(got.R @ got.R.mT, eye, atol=2e-6, what="orthogonal")
    assert_close(torch.linalg.det(got.R), np.ones(8), atol=2e-6, what="det")


def test_rigid_transform_3d_without_a_unique_rotation_is_identity():
    """Fewer than three weighted points or collinear ones: rank(H) < 2, the
    rotation is not unique, and the port gives the identity (slam_tpu's
    SVD gives one of the rotations)."""
    a, b, w = _kabsch_case("scatter", 0)
    line = np.zeros_like(a)
    line[:, 0] = np.linspace(-5, 5, 60)
    cases = [(a, b, np.zeros_like(w)), (a, b, np.eye(60, dtype=np.float32)[
        0] + np.eye(60, dtype=np.float32)[1]), (line, line + 1.0, w)]
    a, b, w = (to_torch(np.stack(x)) for x in zip(*cases))
    got = talign.rigid_transform_3d(a, b, w)
    assert_close(got.R, np.broadcast_to(np.eye(3), (3, 3, 3)), atol=0)
    assert bool(torch.isfinite(got.t).all())


def test_apply_se2_to_cloud_matches_jax():
    xyz = np.random.default_rng(2).uniform(-30, 30, (40, 3)).astype(
        np.float32)
    assert_close(talign.apply_se2_to_cloud(to_torch(xyz), 1.5, -2.0, 0.7),
                 jalign.apply_se2_to_cloud(xyz, 1.5, -2.0, 0.7), atol=1e-5)


def _nn_problem(seed, B=3, S=70, C=90):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-40, 40, (B, C, 3)).astype(np.float32)
    q = (m[:, rng.integers(0, C, S)] + rng.normal(0, 2, (B, S, 3))).astype(
        np.float32)
    m_valid = rng.random((B, C)) < 0.85
    m_valid[2, :] = False                      # a robot with no model
    q_cls = rng.integers(0, 3, (B, S)).astype(np.int32)
    m_cls = rng.integers(0, 3, (B, C)).astype(np.int32)
    m_cls[1] = np.where(m_cls[1] == 2, 0, m_cls[1])   # class 2 empty
    return q, m, m_valid, q_cls, m_cls


def _assert_nn_close(got, want, q, m):
    gidx, gd = got
    widx, wd = want
    assert_equal(gidx, widx, "idx")
    tol = 4 * np.finfo(np.float32).eps * (
        (q ** 2).sum(-1) + (m ** 2).sum(-1).max(-1, keepdims=True))
    assert (np.abs(to_np(gd) - np.asarray(wd)) <= np.maximum(
        tol, 4e-7 * np.abs(np.asarray(wd)))).all()


@pytest.mark.parametrize("classes", [False, True])
def test_nearest_neighbor_3d_and_tiled_match_jax(classes):
    """Both with and without classes, with a robot whose model is empty
    (its queries all take BIG penalties, as slam_tpu's) and one whose class
    2 is empty; slam_tpu's tiled form in chunks of 16 of the 70 queries
    against the port's, which is nearest_neighbor itself (chunked by
    NN_CHUNK_ELEMENTS, here 16 queries a chunk too), in 3D and, on the
    CPU, in 2D (K4's plain version)."""
    q, m, m_valid, q_cls, m_cls = _nn_problem(3)
    qc, mc = (q_cls, m_cls) if classes else (None, None)
    with direct_nn():
        want = jax.vmap(jnn.nearest_neighbor)(q, m, m_valid, qc, mc)
        want_t = jax.vmap(lambda *a: jnn.nearest_neighbor_tiled(
            *a, chunk=16))(q, m, m_valid, qc, mc)
    args = (to_torch(q), to_torch(m), to_torch(m_valid),
            None if qc is None else to_torch(qc),
            None if mc is None else to_torch(mc))
    _assert_nn_close(tnn.nearest_neighbor(*args), want, q, m)
    _assert_nn_close(tnn.nearest_neighbor_tiled(*args), want_t, q, m)
    with mock.patch.object(tnn, "NN_CHUNK_ELEMENTS", 3 * 90 * 16):
        _assert_nn_close(tnn.nearest_neighbor(*args), want, q, m)
        _assert_nn_close(tnn.nearest_neighbor_tiled(*args), want_t, q, m)
    # 2D on the CPU: K4's plain version against slam_tpu's tiled form, on
    # the robots with a model (with none, every distance is BIG and the two
    # pick different first minima); classes as flags, since K4's planes
    # mark an invalid model point class 2
    q2, m2, mv2 = q[:2, :, :2], m[:2, :, :2], m_valid[:2]
    qc2, mc2 = (None, None) if qc is None else (qc[:2] == 1, mc[:2] == 1)
    with direct_nn():
        want2 = jax.vmap(lambda *a: jnn.nearest_neighbor_tiled(
            *a, chunk=16))(q2, m2, mv2, qc2, mc2)
    _assert_nn_close(tnn.nearest_neighbor_tiled(
        to_torch(q2), to_torch(m2), to_torch(mv2),
        None if qc2 is None else to_torch(qc2),
        None if mc2 is None else to_torch(mc2)), want2, q2, m2)


def _icp3d_problems(seed, n=3):
    """n edge problems: a model keyframe (120 obstacle points of classes 0
    and 1, 260 ground points on a gently sloped surface, class 2) in its
    frame and the scene as the same world seen from a pose 0.3-0.6 m and
    a few degrees away, with 1 cm noise and scattered invalid slots; the
    init is the true relative pose perturbed. Problem 2 has 4 scene
    points (not ok)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        obst = np.concatenate([rng.uniform(-8, 8, (120, 2)),
                               rng.uniform(0.3, 2.0, (120, 1))], -1)
        gxy = rng.uniform(-7, 7, (260, 2))
        gnd = np.concatenate([gxy, (0.05 * gxy[:, :1] - 0.03 * gxy[:, 1:] +
                                    0.02 * np.sin(gxy[:, :1]))], -1)
        world = np.concatenate([obst, gnd])
        cls = np.concatenate([rng.integers(0, 2, 120), np.full(260, 2)])
        R = _rot(rng, 1, span=0.05)[0]
        t = rng.uniform(-0.6, 0.6, 3) * [1, 1, 0.2]
        scene = (world - t) @ R                      # R^T (p - t)
        scene += rng.normal(0, 0.01, scene.shape)
        perm = rng.permutation(len(world))
        m_valid = rng.random(len(world)) < 0.95
        s_valid = rng.random(len(world)) < 0.9
        if k == 2:
            s_valid[:] = False
            s_valid[:4] = True
        init_R = R @ _rot(rng, 1, span=0.02)[0]
        init_t = t + rng.normal(0, 0.1, 3)
        out.append((scene[perm], s_valid[perm], cls[perm], world, m_valid,
                    cls, init_t, init_R))
    return [np.stack(x).astype(np.int32 if x[0].dtype.kind == "i" else
                                np.bool_ if x[0].dtype == bool else
                                np.float32) for x in zip(*out)]


def test_icp3d_fit_matches_jax():
    args = _icp3d_problems(4)
    cfg = dataclasses.replace(ICP, max_iterations=30)
    with direct_nn():
        want = jax.jit(jax.vmap(lambda *a: jicp3d.icp3d_fit(*a, cfg)))(*args)
    got = ticp3d.icp3d_fit(*map(to_torch, args), cfg)
    assert_equal(got.ok, want.ok, "ok")
    assert np.asarray(want.ok).tolist() == [True, True, False]
    assert_equal(got.num_corr, want.num_corr, "num_corr")
    assert_close(got.R, want.R, atol=1e-4, what="R")
    assert_close(got.t, want.t, atol=1e-4, what="t")
    assert_close(got.mean_residual, want.mean_residual, atol=1e-6,
                 rtol=1e-3, what="mean_residual")
    # converged near the truth: the fit is no no-op
    d = np.abs(to_np(got.t)[:2] - (args[6][:2] - 0.0))
    assert float(np.asarray(want.delta)[:2].max()) < cfg.min_delta * 10
    assert d.max() < 0.5


def test_icp3d_wrong_minima_of_card_edges_match_jax():
    """Two keyframe edges of the 6-DoF chain that settle far from the
    truth, recorded on the card (`python3 -m slam_tpu_torch.edge_study
    --dump`: sim3d_se3_config, fleet seed 18, the worst robot's two edges
    0.70 m and 2.69 m from the true relative pose): slam_tpu's icp3d_fit
    lands in the same minimum from the same inputs, and the port on the
    CPU too (1e-3 m, 1e-4 in R: 50 iterations of f32 fits, an FMA apart),
    so the error is slam_tpu's 3D edge fit, not the port."""
    d = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "se3_edge_minima.npz"))
    args = [d[k] for k in ("scene_xyz", "scene_valid", "scene_class",
                           "model_xyz", "model_valid", "model_class",
                           "init_t", "init_R")]
    cfg = dataclasses.replace(sim3d_config().icp,
                              max_iterations=int(d["max_iterations"]))
    with direct_nn():
        want = jax.jit(jax.vmap(lambda *a: jicp3d.icp3d_fit(*a, cfg)))(*args)
    got = ticp3d.icp3d_fit(*map(to_torch, args), cfg)
    assert np.asarray(want.ok).all()
    assert_close(got.t, want.t, atol=1e-3, what="t")
    assert_close(got.R, want.R, atol=1e-4, what="R")
    assert_close(torch.from_numpy(d["card_t"]), want.t, atol=1e-3,
                 what="card t")
    off = np.linalg.norm(np.asarray(want.t)[:, :2] - d["true_rel"][:, :2],
                         axis=-1)
    assert (off > 0.5).all(), off


def test_fit_step_3d_matches_jax():
    args = _icp3d_problems(5)
    q, qv, qc, m, mv, mc, t, R = args
    with direct_nn():
        want = jax.vmap(lambda *a: jicp3d.fit_step_3d(*a, 4.0))(
            q, qv, qc, m, mv, mc, t, R)
    got = ticp3d.fit_step_3d(*map(to_torch, (q, qv, qc, m, mv, mc, t, R)),
                             4.0)
    for name, g, w, tol in zip(("t", "R", "delta", "num_corr", "mean_res"),
                               got, want, (1e-4, 1e-4, 1e-4, 0, 1e-5)):
        assert_close(g, w, atol=tol, what=name)
    part = ticp3d._class_participation_multi(*map(to_torch, (qc, mc, mv)))
    assert_equal(part, jax.vmap(jicp3d._class_participation_multi)(
        qc, mc, mv))


def test_edge_information_lum6_matches_jax():
    """Three problems: ~1 cm residuals, too few correspondences (6: the
    identity) and none."""
    rng = np.random.default_rng(6)
    src = rng.uniform(-10, 10, (3, 200, 3)).astype(np.float32)
    tgt = (src + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    w = (rng.random((3, 200)) < 0.8).astype(np.float32)
    w[1] = 0.0
    w[1, :6] = 1.0
    w[2] = 0.0
    want = jax.vmap(jpg3.edge_information_lum6)(src, tgt, w)
    got = tpg3.edge_information_lum6(to_torch(src), to_torch(tgt),
                                     to_torch(w))
    assert_close(got[0], want[0], atol=1e-2, rtol=1e-2, what="info")
    assert_close(got[1:], np.broadcast_to(np.eye(6), (2, 6, 6)), atol=0)
    assert_close(want[1:], got[1:], atol=0)
    assert float(np.asarray(want[0]).max()) > 1e4


def test_k2_above_the_resident_limit_runs_k3_plain():
    """A packed problem of 1,500 x 1,500 points (S x C = 2.25M > 2M):
    icp_fused no longer raises but runs K3's plain version (the tiled fit
    over model blocks), whose pose equals the resident plain fit's to
    1e-5 (only the tie sums' order differs); icp_fused_reference takes the
    same route."""
    rng = np.random.default_rng(7)
    P = 1500
    m = rng.uniform(-30, 30, (1, P, 2)).astype(np.float32)
    th = 0.02
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    s = ((m - [0.3, -0.2]) @ rot).astype(np.float32)
    s += rng.normal(0, 0.01, s.shape).astype(np.float32)
    ga_m = rng.random((1, P)) < 0.3
    args = (to_torch(s), torch.ones(1, P, dtype=torch.bool), to_torch(ga_m),
            to_torch(m), torch.ones(1, P, dtype=torch.bool), to_torch(ga_m),
            torch.zeros(1, 3), sim3d_config().icp)
    assert P * P > icp_fused.RESIDENT_TILE_LIMIT
    with pytest.raises(ValueError, match="RESIDENT_TILE_LIMIT"):
        icp_fused.icp_fused_planes(*icp_fused.packed_planes(*args[:6]),
                                   args[6], args[7])
    got = icp_fused.icp_fused(*args)
    ref = icp_fused.icp_fused_reference(*args)
    resident = icp_fused._decode(icp_fused._reference_slab(
        *icp_fused.packed_planes(*args[:6]),
        icp_fused._pack_init4(args[6]), args[7])[0])
    assert_equal(got.pose, ref.pose)
    assert bool(got.ok[0]) and int(got.num_corr[0]) > 1400
    assert_close(got.pose, resident.pose, atol=1e-5)
    assert_equal(got.num_corr, resident.num_corr)
    assert abs(float(got.pose[0, 2]) - th) < 1e-3
    assert tprof.count_of("k2.launches") == 0
    assert tprof.count_of("k3.launches") == 0
