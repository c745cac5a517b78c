"""Port parity, the "points" matcher: K4's plain version (nearest
neighbour) and icp_fit (slam_tpu_torch vs slam_tpu, CPU).

Against the Pallas kernel in interpret mode K4's plain version picks the
same indices, with distances to 1 f32 ulp: both compute the direct
dx*dx + dy*dy, which XLA:CPU fuses into a multiply-add while PyTorch (and
the CUDA kernel, built with -fmad=false) round each step. Against
slam_tpu/ops/nn.py, which JAX runs on a CPU, distances agree to 4 f32 ulps
of |q|^2 + |m|^2 (the expanded |q|^2 - 2 q.m + |m|^2 form cancels), and
indices wherever the best distance wins by more than that. icp_fit poses
agree to 1e-4, and mean residuals to 1e-4 m^2, the expanded form's error
at 40 m."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import IcpConfig
from slam_tpu.ops import icp as jicp
from slam_tpu.ops import nn as jnn
from slam_tpu.ops import nn_pallas as jnnp
from slam_tpu_torch.ops import icp as ticp
from slam_tpu_torch.ops import nn as tnn
from slam_tpu_torch.utils import profiling as tprof
from tests.torch_parity import (assert_close, assert_equal, pallas_interpret,
                                to_torch)

torch.set_num_threads(1)


def _problem(B=2, S=96, C=160, seed=0, span=40.0):
    """Scene = noisy, moved subset of the model, classes GA / NGA."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(-span, span, (B, C, 2)).astype(np.float32)
    m_ga = rng.random((B, C)) < 0.4
    m_valid = rng.random((B, C)) < 0.9
    idx = rng.integers(0, C, (B, S))
    th = 0.03
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    q = (np.take_along_axis(m, idx[..., None], 1) - [0.3, -0.2]) @ R
    q = (q + rng.normal(0, 0.02, q.shape)).astype(np.float32)
    q_ga = np.take_along_axis(m_ga, idx, 1)
    q_valid = rng.random((B, S)) < 0.95
    return q, q_valid, q_ga, m, m_valid, m_ga


def _planes(q, q_ga, m, m_valid, m_ga):
    qc = q_ga.astype(np.float32)
    mc = np.where(m_valid, m_ga.astype(np.float32), 2.0).astype(np.float32)
    return (q[..., 0], q[..., 1], qc, m[..., 0], m[..., 1], mc)


def test_nn_plain_matches_pallas_interpret():
    q, _, q_ga, m, m_valid, m_ga = _problem()
    planes = _planes(q, q_ga, m, m_valid, m_ga)
    with pallas_interpret():
        widx, wd = jnnp._nn_batched(*map(jnp.asarray, planes))
    gidx, gd = tnn.nearest_neighbor_reference(*map(to_torch, planes))
    assert_equal(gidx, widx)
    assert_close(gd, wd, atol=0, rtol=1.2e-7)


def test_nn_plain_matches_jax_cpu_path():
    q, _, q_ga, m, m_valid, m_ga = _problem(seed=1)
    gidx, gd = tnn.nearest_neighbor(
        to_torch(q), to_torch(m), to_torch(m_valid),
        to_torch(q_ga.astype(np.int32)), to_torch(m_ga.astype(np.int32)))
    widx, wd = jax.vmap(jnn.nearest_neighbor)(
        q, m, m_valid, q_ga.astype(np.int32), m_ga.astype(np.int32))
    tol = 4 * np.finfo(np.float32).eps * (
        (q ** 2).sum(-1) + (m ** 2).sum(-1).max(-1, keepdims=True))
    assert (np.abs(gd.numpy() - np.asarray(wd)) <= tol).all()
    # where the runner-up is farther than the tolerance, the index is equal
    d2 = ((q[:, :, None] - m[:, None]) ** 2).sum(-1)
    bad = ~m_valid[:, None] | (q_ga[:, :, None] != m_ga[:, None])
    d2 = np.sort(np.where(bad, np.inf, d2), -1)
    clear = d2[..., 1] - d2[..., 0] > 2 * tol
    assert clear.mean() > 0.9
    assert_equal(gidx.numpy()[clear], np.asarray(widx)[clear])


def test_nn_unconstrained_and_2d_only():
    q, _, _, m, m_valid, _ = _problem(seed=2)
    gidx, _ = tnn.nearest_neighbor(to_torch(q), to_torch(m),
                                   to_torch(m_valid))
    widx, _ = jax.vmap(jnn.nearest_neighbor)(q, m, m_valid)
    assert (gidx.numpy() == np.asarray(widx)).mean() > 0.99
    # K4 is 2D only: 3D queries take the plain N-D form (no launch, on any
    # device; tests/test_torch_icp3d.py holds it to slam_tpu), and a query
    # whose dimension differs from the model's is refused
    idx, d2 = tnn.nearest_neighbor(torch.zeros(1, 4, 3),
                                   torch.ones(1, 5, 3),
                                   torch.ones(1, 5, dtype=torch.bool))
    assert_equal(idx, torch.zeros(1, 4, dtype=torch.int32))
    assert_equal(d2, torch.full((1, 4), 3.0))
    assert tprof.count_of("k4.launches") == 0
    with pytest.raises(ValueError, match="D=3"):
        tnn.nearest_neighbor(torch.zeros(1, 4, 3), torch.zeros(1, 5, 2),
                             torch.ones(1, 5, dtype=torch.bool))


def test_procrustes_and_fit_step_match_jax():
    q, q_valid, q_ga, m, m_valid, m_ga = _problem(seed=3)
    rng = np.random.default_rng(3)
    w = (rng.random(q.shape[:2]) < 0.7).astype(np.float32)
    mc = m[:, :q.shape[1]]
    gy, gt, gw = ticp.procrustes_2d(to_torch(q), to_torch(mc), to_torch(w))
    wy, wt, ww = jax.vmap(jicp.procrustes_2d)(q, mc, w)
    assert_close(gy, wy, atol=1e-5)
    assert_close(gt, wt, atol=1e-4)
    assert_close(gw, ww, atol=0)

    pose = np.array([[0.1, -0.2, 0.02], [0.0, 0.3, -0.01]], np.float32)
    got = ticp.fit_step(to_torch(q), to_torch(q_valid), to_torch(q_ga),
                        to_torch(m), to_torch(m_valid), to_torch(m_ga),
                        to_torch(pose), 1.0)
    want = jax.vmap(lambda *a: jicp.fit_step(*a, 1.0))(
        q, q_valid, q_ga, m, m_valid, m_ga, pose)
    assert_close(got[0], want[0], atol=1e-5)
    assert_equal(got[2], want[2])


def test_icp_fit_matches_jax():
    cfg = IcpConfig(max_iterations=20, inlier_dist=1.0)
    q, q_valid, q_ga, m, m_valid, m_ga = _problem(B=3, seed=4)
    q_valid[2] = False
    q_valid[2, :3] = True                # below min_scene_points
    init = np.zeros((3, 3), np.float32)
    got = ticp.icp_fit(to_torch(q), to_torch(q_valid), to_torch(q_ga),
                       to_torch(m), to_torch(m_valid), to_torch(m_ga),
                       to_torch(init), cfg)
    want = jax.vmap(lambda *a: jicp.icp_fit(*a, cfg))(
        q, q_valid, q_ga, m, m_valid, m_ga, init)
    assert_close(got.pose, want.pose, atol=1e-4)
    assert_equal(got.ok, want.ok)
    assert_equal(got.num_corr, want.num_corr)
    assert_close(got.mean_residual, want.mean_residual, atol=1e-4)
    assert got.ok[:2].all() and not got.ok[2]


# ---- K4's algorithm, emulated: the class-grouped walk ----------------------

F32 = np.float32


def _sqdist(qx, qy, mx, my):
    dx = F32(qx) - mx
    dy = F32(qy) - my
    return dx * dx + dy * dy          # f32, each step rounded on its own


def _grouped_nn(qx, qy, qc, mx, my, mv, mc, tile):
    """K4's algorithm in numpy, robot by robot: queries grouped by class
    walk their class's valid model points tile by tile with a strict `<`;
    a query whose every pair is cross-class or invalid answers (0, BIG) when
    model point 0 gives BIG; other such queries, and queries of other
    classes where the model holds other classes, walk every point with
    `BIG + d2` on bad pairs."""
    B, S = qx.shape
    C = mx.shape[1]
    big = F32(tnn.BIG)
    idx = np.zeros((B, S), np.int32)
    dist = np.zeros((B, S), F32)
    for b in range(B):
        m = np.where(mv[b], mc[b], F32(2)).astype(F32)
        m = np.where(m >= 2, F32(2), m)
        counts = {1.0: (m == 1).sum(), 0.0: (m == 0).sum()}
        other = ((m < 2) & (m != 1) & (m != 0)).sum()
        for i in range(S):
            c = qc[b, i]
            grouped = c in counts and counts[c] > 0
            if not grouped and not (c not in counts and other) and \
                    big + _sqdist(qx[b, i], qy[b, i], mx[b, 0],
                                  my[b, 0]) == big:
                idx[b, i], dist[b, i] = 0, big
                continue
            best, bi = F32(np.inf), 0
            for t0 in range(0, C, tile):
                ks = np.arange(t0, min(C, t0 + tile))
                if grouped:
                    ks = ks[m[ks] == c]
                if not len(ks):
                    continue
                d = _sqdist(qx[b, i], qy[b, i], mx[b, ks], my[b, ks])
                if not grouped:
                    bad = (m[ks] >= 2) | (m[ks] != c)
                    d = np.where(bad, big + d, d)
                j = int(np.argmin(d))
                if d[j] < best:
                    best, bi = d[j], int(ks[j])
            idx[b, i], dist[b, i] = bi, best
    return idx, dist


def _k4_problem(seed, B=3, S=40, C=60):
    """Duplicated model points (exact ties), robot 1 without GA model
    points, robot 2 without any valid model point, query pads (class -1)."""
    rng = np.random.default_rng(seed)
    q, _, q_ga, m, m_valid, m_ga = _problem(B=B, S=S, C=C, seed=seed)
    m[:, 1::4] = m[:, 0::4][:, :m[:, 1::4].shape[1]]
    m_ga[:, 1::4] = m_ga[:, 0::4][:, :m_ga[:, 1::4].shape[1]]
    m_valid[1] &= ~m_ga[1]
    m_valid[2] = False
    qc = np.where(rng.random((B, S)) < 0.1, -1.0, q_ga).astype(F32)
    return q, qc, m, m_valid, m_ga


@pytest.mark.parametrize("tile", [60, 7])
def test_grouped_walk_matches_plain_and_pallas(tile):
    """The emulated grouped walk (one tile, and tiles of 7 points) against
    the plain version (idx equal, dist in bits) and slam_tpu's Pallas
    kernel in interpret mode (idx equal, dist to 1 ulp: XLA's FMA)."""
    q, qc, m, m_valid, m_ga = _k4_problem(seed=5)
    mc = m_ga.astype(F32)
    got = _grouped_nn(q[..., 0], q[..., 1], qc, m[..., 0], m[..., 1],
                      m_valid, mc, tile)
    planes = (q[..., 0], q[..., 1], qc, m[..., 0], m[..., 1],
              np.where(m_valid, mc, F32(2)).astype(F32))
    widx, wd = tnn.nearest_neighbor_reference(*map(to_torch, planes))
    np.testing.assert_array_equal(got[0], widx.numpy())
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  wd.numpy().view(np.int32))
    with pallas_interpret():
        pidx, pd = jnnp._nn_batched(*map(jnp.asarray, planes))
    np.testing.assert_array_equal(got[0], np.asarray(pidx))
    assert_close(torch.from_numpy(got[1]), pd, atol=0, rtol=1.2e-7)
    # the cases the test is for are there: ties, the (0, BIG) answers
    assert (got[1] == F32(tnn.BIG)).sum() > 40
    assert (np.abs(m[:, 1::4] - m[:, 0::4][:, :15]).sum(-1) == 0).all()


def test_grouped_walk_other_classes():
    """Model points of a class other than 0 and 1 (class -1 in the model):
    the queries of that class take the full walk and find them."""
    q, qc, m, m_valid, m_ga = _k4_problem(seed=6)
    mc = m_ga.astype(F32)
    mc[:, 3::5] = -1.0
    got = _grouped_nn(q[..., 0], q[..., 1], qc, m[..., 0], m[..., 1],
                      m_valid, mc, 13)
    planes = (q[..., 0], q[..., 1], qc, m[..., 0], m[..., 1],
              np.where(m_valid, mc, F32(2)).astype(F32))
    widx, wd = tnn.nearest_neighbor_reference(*map(to_torch, planes))
    np.testing.assert_array_equal(got[0], widx.numpy())
    np.testing.assert_array_equal(got[1], wd.numpy())
    pads = qc[0] == -1
    assert (got[1][0][pads] < F32(tnn.BIG)).all()


def test_k4_operand_layout():
    """nn_layout gives the strides that read nearest_neighbor's views
    (queries (B, S, 2), the model a view of (B, C, 3), masks) as they lie;
    nn_tiles fits a tile and the queries in shared memory."""
    q = torch.randn(3, 40, 2)
    m3 = torch.randn(3, 60, 3)
    mv = torch.rand(3, 60) < 0.9
    planes = (q[..., 0], q[..., 1], None, m3[..., 0], m3[..., 1], mv, None)
    lay = tnn.nn_layout(*planes)
    assert lay[4:6] == [0, 0] and lay[12:] == [0, 0]
    for k, p in enumerate(planes):
        if p is None:
            continue
        back = torch.as_strided(p, p.shape, lay[2 * k:2 * k + 2],
                                p.storage_offset())
        assert torch.equal(back, p)
    assert lay[6:8] == [180, 3]
    assert tnn.nn_tiles(384, 512) == (512, 384)
    tile, qchunk = tnn.nn_tiles(384, 50000)
    assert 24 * (tile + qchunk) <= tnn.cuda_build.MAX_SMEM < 24 * (
        tile + 1 + qchunk)
    assert tnn.nn_tiles(5000, 10) == (10, tnn.MAX_QCHUNK)
