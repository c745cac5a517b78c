"""Port parity, config 4's planar pose graph (slam_tpu_torch.graph.pose_graph
and slam2d's graph mode vs slam_tpu, CPU).

slam_tpu runs as on a TPU: `jax.default_backend` patched to "tpu" and its
Pallas kernels in interpret mode, so both sides measure edges with K2 (the
port's plain version here). slam_tpu's CPU nearest neighbour (the edge
information's) uses the expanded |q|^2 - 2 q.m + |m|^2 form; the direct
form the port and K4 use is patched in, as tests/test_torch_slam2d.py
does.

The keyframes are views of one synthetic world from a path whose stops are
1.1-1.8 m apart with distinct spacings, against a keyframe gate of 0.5 m:
no ulp can flip the gate, an eviction score tie or the edge gates (every
edge's ICP lands within 0.1 m and 0.02 rad of its odometry guess, against
gates of 10 m and 0.2 rad; hundreds of correspondences against 5).

Tolerances: integers (node and edge counts, edge_ij, edge_valid, stamps,
keyframe masks and flags) exact, and copied values exact; edge poses 1e-4
(the fused fit's bound, tests/test_torch_icp_fused.py); edge information
relative 1e-2 (it divides by the residual variance of ~1 cm noise, which
the fits' last ulps move); optimised poses 1e-4 (the Cholesky factors and
the summation order of H differ); regenerated map points 1e-5.
"""

import contextlib
import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from slam_tpu.config import sim2d_config
from slam_tpu_torch.config import sim2d_graph_config
from slam_tpu.graph import pose_graph as jpg
from slam_tpu.ops import icp_pallas as jip, nn as jnn, voxel as jvoxel
from slam_tpu.ops.icp import edge_information_2d as j_edge_info
from slam_tpu import geometry as jgeo
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.sim import world2d as jw
from slam_tpu.types import PointCloud as JCloud
from slam_tpu.utils import metrics as jmetrics
from slam_tpu_torch import geometry as tgeo, interop
from slam_tpu_torch.graph import pose_graph as tpg
from slam_tpu_torch.ops import icp_fused
from slam_tpu_torch.ops.icp import edge_information_2d as t_edge_info
from slam_tpu.pipeline import relocalize as jrel
from slam_tpu.ops.fft_match import MatchResult as JMatch
from slam_tpu_torch.ops.fft_match import MatchResult
from slam_tpu_torch.ops.voxel import (compact, voxel_downsample,
                                      voxel_downsample_pairwise)
from slam_tpu_torch.pipeline import relocalize as trel
from slam_tpu_torch.pipeline import slam2d as tslam
from slam_tpu_torch.types import PointCloud
from slam_tpu_torch.utils import profiling as tprof
from tests.torch_parity import (assert_close, assert_equal, numpy_tree,
                                pallas_interpret, to_np, to_torch)

torch.set_num_threads(1)

B = 2
BASE = sim2d_config()
GCFG = dataclasses.replace(BASE.graph, max_nodes=8, max_edges=24,
                           keyframe_points=64, knn_dist_thresh=0.5,
                           map_regen="grid", regen_grid_bins=128)
CFG = BASE.replace(graph=GCFG)
SPACING = (1.23, 1.57, 1.11, 1.79, 1.36, 1.64, 1.42, 1.18, 1.71, 1.29, 1.53)
M = 96          # scene slots a keyframe cloud comes in
WORLD = 60      # world points every keyframe sees


def _direct_sq_dist(q, m):
    d = q[..., :, None, :] - m[..., None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]


@contextlib.contextmanager
def as_on_tpu():
    """slam_tpu's TPU path on the CPU: K2 (and K1, K4) in interpret mode,
    and the direct NN form."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(pallas_interpret())
        stack.enter_context(mock.patch.object(jax, "default_backend",
                                              lambda: "tpu"))
        stack.enter_context(mock.patch.object(jnn, "pairwise_sq_dist",
                                              _direct_sq_dist))
        yield


def _path(seed):
    """Keyframe stops (len(SPACING) + 1, 3) true poses, the poses the
    graph is given (true plus a few cm of drift), and (stops, M, 3) scans of
    the world seen from the true poses (1 cm noise, slots scattered,
    GA flags a property of the world point)."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, WORLD)
    r = rng.uniform(3.0, 9.0, WORLD)
    world = np.stack([7.0 + 1.6 * r * np.cos(ang), r * np.sin(ang)], -1)
    ga = rng.random(WORLD) < 0.4
    x = np.concatenate([[0.0], np.cumsum(SPACING)])
    true = np.stack([x, 0.3 * np.sin(x), 0.05 * np.cos(x)], -1)
    given = true + rng.normal(0, [0.03, 0.03, 0.005], true.shape)
    scans = np.zeros((len(x), M, 3), np.float32)
    valid = np.zeros((len(x), M), bool)
    flags = np.zeros((len(x), M), np.int32)
    for k, (tx, ty, th) in enumerate(true):
        d = world - [tx, ty]
        c, s = np.cos(th), np.sin(th)
        local = np.stack([c * d[:, 0] + s * d[:, 1],
                          -s * d[:, 0] + c * d[:, 1]], -1)
        local += rng.normal(0, 0.01, local.shape)
        slots = np.sort(rng.choice(M, WORLD, replace=False))
        scans[k, slots, :2] = local
        valid[k, slots] = True
        flags[k, slots] = np.where(ga, JCloud.FLAG_GA, 0)
    pose4 = np.concatenate([given, rng.normal(0, 0.01, (len(x), 1))], -1)
    return pose4.astype(np.float32), scans, valid, flags


def _robots():
    """Per stop k: pose (B, 4) and cloud (B, M) of both robots."""
    paths = [_path(seed) for seed in (1, 2)]
    return [tuple(np.stack([p[i][k] for p in paths]) for i in range(4))
            for k in range(len(SPACING) + 1)]


def _jax_graph0():
    g = jpg.init_graph(GCFG)
    return jax.tree.map(lambda x: np.stack([np.asarray(x)] * B), g)


@pytest.fixture(scope="module")
def sequence():
    """slam_tpu's graphs along the path: graphs[k] before stop k is
    offered, added[k] whether it was taken. Stop 8 fills the graph; stops
    9-11 evict."""
    stops = _robots()
    spy = mock.Mock(wraps=jip.make_icp_fused)
    add = jax.jit(jax.vmap(lambda g, p, x, v, f: jpg.add_keyframe(
        g, p, JCloud(xyz=x, valid=v, flags=f), CFG.icp, GCFG,
        min_points=GCFG.min_keyframe_points)))
    graphs, added = [_jax_graph0()], []
    with as_on_tpu(), mock.patch.object(jip, "make_icp_fused", spy):
        for pose, xyz, valid, flags in stops:
            g, a = add(graphs[-1], pose, xyz, valid, flags)
            graphs.append(numpy_tree(g))
            added.append(np.asarray(a))
    assert spy.called
    return stops, graphs, added


def _port_graph(g):
    return interop.graph_from_numpy(g, "cpu")


def _cloud(xyz, valid, flags):
    return PointCloud(xyz=to_torch(xyz), valid=to_torch(valid),
                      flags=to_torch(flags))


EXACT = ("node_pose", "node_valid", "node_stamp", "kf_xyz", "kf_valid",
         "kf_flags", "edge_ij", "edge_valid", "num_nodes", "num_edges",
         "edges_dropped")


def assert_graph_close(got, want, rel_tol=1e-4, info_rtol=1e-2,
                       pose_tol=0.0):
    valid = np.asarray(want.edge_valid)
    for f in EXACT:
        if f == "node_pose" and pose_tol:
            assert_close(got.node_pose, want.node_pose, atol=pose_tol,
                         what=f)
        else:
            assert_equal(getattr(got, f), getattr(want, f), f)
    assert_close(to_np(got.edge_rel)[valid], np.asarray(want.edge_rel)[valid],
                 atol=rel_tol, what="edge_rel")
    assert_close(to_np(got.edge_info)[valid],
                 np.asarray(want.edge_info)[valid], atol=1e-3,
                 rtol=info_rtol, what="edge_info")


def test_se2_ops_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform([-20, -20, -3.1], [20, 20, 3.1], (64, 3)).astype(
        np.float32)
    b = rng.uniform([-20, -20, -3.1], [20, 20, 3.1], (64, 3)).astype(
        np.float32)
    for jf, tf, args in ((jgeo.se2_compose, tgeo.se2_compose, (a, b)),
                         (jgeo.se2_inverse, tgeo.se2_inverse, (a,)),
                         (jgeo.se2_relative, tgeo.se2_relative, (a, b))):
        assert_close(tf(*map(to_torch, args)), jf(*args), atol=2e-5,
                     what=tf.__name__)


def test_edge_information_matches_jax():
    rng = np.random.default_rng(1)
    t = rng.uniform(-15, 15, (3, 80, 2)).astype(np.float32)
    m = (t + rng.normal(0, 0.02, t.shape)).astype(np.float32)
    w = (rng.random((3, 80)) < 0.8).astype(np.float32)
    w[2] = 0.0                          # no correspondence: the identity
    want = jax.vmap(j_edge_info)(t, m, w)
    got = t_edge_info(to_torch(t), to_torch(m), to_torch(w))
    assert_close(got, want, atol=1e-3, rtol=1e-4)
    assert_equal(got[2], np.eye(3))


@pytest.mark.parametrize("capacity", [40, 96, 128])
def test_compact_matches_jax(capacity):
    rng = np.random.default_rng(capacity)
    xyz = rng.normal(0, 5, (3, 96, 3)).astype(np.float32)
    valid = rng.random((3, 96)) < 0.6
    valid[2] = False
    flags = rng.integers(0, 8, (3, 96)).astype(np.int32)
    want = jax.vmap(lambda x, v, f: jvoxel.compact(
        JCloud(xyz=x, valid=v, flags=f), capacity))(xyz, valid, flags)
    got = compact(_cloud(xyz, valid, flags), capacity)
    for f in ("xyz", "valid", "flags"):
        assert_equal(getattr(got, f), getattr(want, f), f)


def _synthetic_graph(seed, n_valid, stamps=None):
    """A slam_tpu graph (numpy, batch B) whose first n_valid nodes sit at
    chosen places, some of them at equal distance from the query."""
    g = _jax_graph0()
    rng = np.random.default_rng(seed)
    N = GCFG.max_nodes
    pose = np.zeros((B, N, 4), np.float32)
    pose[..., :2] = rng.integers(-4, 5, (B, N, 2))     # integer grid: ties
    g = g.replace(node_pose=pose,
                  node_valid=np.arange(N)[None].repeat(B, 0) < n_valid,
                  node_stamp=np.where(np.arange(N) < n_valid,
                                      (np.arange(N) if stamps is None
                                       else stamps), -1)[None].repeat(B, 0)
                  .astype(np.int32),
                  num_nodes=np.full(B, n_valid, np.int32))
    return g


@pytest.mark.parametrize("n_valid,k", [(6, 3), (8, 3), (2, 3), (5, 12)])
def test_knn_keyframes_with_ties_matches_jax(n_valid, k):
    g = _synthetic_graph(n_valid, n_valid)
    q = np.zeros((B, 2), np.float32)
    exclude = np.array([0, n_valid - 1], np.int32)
    want = jax.vmap(lambda gg, p, e: jpg.knn_keyframes(gg, p, k, e))(
        g, q, exclude)
    got = tpg.knn_keyframes(_port_graph(g), to_torch(q), k,
                            to_torch(exclude).long())
    assert_equal(got[0], want[0])
    assert_equal(got[1], want[1])


@pytest.mark.parametrize("protect_recent", [1, 3])
def test_eviction_slot_matches_jax(protect_recent):
    g = _synthetic_graph(5, GCFG.max_nodes,
                         stamps=np.array([0, 7, 2, 5, 4, 3, 6, 1]))
    rng = np.random.default_rng(6)
    E = GCFG.max_edges
    g = g.replace(edge_ij=rng.integers(0, GCFG.max_nodes, (B, E, 2)).astype(
        np.int32), edge_valid=rng.random((B, E)) < 0.5)
    want = jax.vmap(lambda gg: jpg._eviction_slot(
        gg, 0.5, protect_recent))(g)
    got = tpg._eviction_slot(_port_graph(g), 0.5, protect_recent)
    assert_equal(got[0], want[0])
    assert_equal(got[1], want[1])


@pytest.mark.parametrize("stop,what", [
    (0, "the first keyframe, into an empty graph"),
    (3, "a partly full graph"),
    (9, "a full graph, which evicts"),
])
def test_add_keyframe_matches_jax(sequence, stop, what):
    stops, graphs, added = sequence
    pose, xyz, valid, flags = stops[stop]
    got, got_added = tpg.add_keyframe(
        _port_graph(graphs[stop]), to_torch(pose), _cloud(xyz, valid, flags),
        CFG.icp, GCFG, min_points=GCFG.min_keyframe_points)
    want = graphs[stop + 1]
    assert_equal(got_added, added[stop], what)
    assert_graph_close(got, want)
    n = np.asarray(want.num_nodes)
    if stop == 0:
        assert (n == 1).all() and (np.asarray(want.num_edges) == 0).all()
    if stop == 3:
        assert (n == 4).all() and (np.asarray(want.num_edges) >= 3).all()
    if stop == 9:
        assert (n == GCFG.max_nodes).all()
        # a slot was reused: the newest stamp sits in an old slot
        assert (np.asarray(want.node_stamp).max(-1) >= GCFG.max_nodes).all()
    assert tprof.count_of("k2.launches") == 0
    assert tprof.count_of("k4.launches") == 0


def test_add_keyframe_too_close_adds_nothing(sequence):
    """A pose 0.2 m from the newest keyframe (the gate is 0.5 m) is not
    taken, and the graph is unchanged."""
    stops, graphs, _ = sequence
    pose, xyz, valid, flags = stops[4]
    g = _port_graph(graphs[5])
    near = to_torch(pose).clone()
    near[:, 0] += 0.2
    got, added = tpg.add_keyframe(g, near, _cloud(xyz, valid, flags),
                                  CFG.icp, GCFG)
    assert not added.any()
    for f in EXACT + ("edge_rel", "edge_info"):
        assert_equal(getattr(got, f), getattr(g, f), f)


@pytest.mark.parametrize("min_delta", [1e-5, 0.0])
def test_optimize_matches_jax(sequence, min_delta):
    """The full graph of the path (8 nodes, drifted poses, edges from the
    true geometry). min_delta > 0: each robot freezes after its first
    update below it; this assumes the updates shrink monotonically (as
    slam_tpu's while loop does, ROADMAP queue 3), which the data here
    meets: both sides stop within the same iterations."""
    _, graphs, _ = sequence
    g = graphs[9]
    gcfg = dataclasses.replace(GCFG, opt_min_delta=min_delta)
    want, want_delta = jax.jit(jax.vmap(lambda gg: jpg.optimize(gg, gcfg)))(g)
    got, got_delta = tpg.optimize(_port_graph(g), gcfg)
    assert_close(got.node_pose, want.node_pose, atol=1e-4)
    assert_close(got_delta, want_delta, atol=1e-4)
    moved = np.abs(np.asarray(want.node_pose) - np.asarray(g.node_pose))
    assert moved[..., :2].max() > 1e-3        # the optimiser did something
    for f in EXACT[1:]:
        assert_equal(getattr(got, f), getattr(want, f), f)


def test_regenerate_map_grid_matches_jax(sequence):
    _, graphs, _ = sequence
    g = graphs[11]
    want = jax.jit(jax.vmap(lambda gg: jpg.regenerate_map_grid(
        gg, 256, resolution=0.5, grid_bins=GCFG.regen_grid_bins,
        ga_threshold=2, recall=CFG.cloud.export_recall)))(g)
    got = tpg.regenerate_map_grid(_port_graph(g), 256, resolution=0.5,
                                  grid_bins=GCFG.regen_grid_bins,
                                  ga_threshold=2,
                                  recall=CFG.cloud.export_recall)
    assert_equal(got.valid, want.valid)
    assert_equal(got.flags, want.flags)
    assert_close(got.xyz, want.xyz, atol=1e-5)
    assert np.asarray(want.valid).sum(-1).min() > 50


def _graph_state(sequence):
    """A slam_tpu graph-mode state (numpy, batch B) holding the path's
    graph after stop 7, the last scene and pose at stop 8."""
    stops, graphs, _ = sequence
    pose, xyz, valid, flags = stops[8]
    st = jax.vmap(lambda k: jslam.init_state(k, CFG, with_graph=True))(
        jax.random.split(jax.random.PRNGKey(0), B))
    pad = CFG.cloud.scene_capacity - M
    scene = JCloud(xyz=np.pad(xyz, ((0, 0), (0, pad), (0, 0))),
                   valid=np.pad(valid, ((0, 0), (0, pad))),
                   flags=np.pad(flags, ((0, 0), (0, pad))))
    return numpy_tree(st).replace(graph=graphs[8], prev_scene=scene,
                                  pose=pose, step=np.full(B, 40, np.int32))


def test_graph_update_on_a_carried_graph_matches_jax(sequence):
    """One whole graph tick (keyframe, edges, optimise, regenerate) on a
    JAX state carried across with interop, the metrics ring included."""
    st = _graph_state(sequence)
    st = st.replace(metrics_ring=jax.tree.map(
        lambda x: np.stack([np.asarray(x)] * B), jmetrics.init_ring(16)))
    with as_on_tpu():
        want, want_delta = jax.jit(jax.vmap(
            lambda s: jslam.graph_update_delta(s, CFG)))(st)
    ts = interop.state_from_numpy(st, "cpu")
    got, got_delta = tslam.graph_update_delta(ts, CFG)
    assert_graph_close(got.graph, want.graph, pose_tol=1e-4)
    assert_close(got_delta, want_delta, atol=1e-4)
    assert_equal(got.map_cloud.valid, want.map_cloud.valid)
    assert_equal(got.map_cloud.flags, want.map_cloud.flags)
    assert_close(got.map_cloud.xyz, want.map_cloud.xyz, atol=1e-4)
    assert_equal(got.graph_full, want.graph_full)
    assert_equal(got.metrics_ring[0], want.metrics_ring[0])
    assert_equal(got.metrics_ring[1], want.metrics_ring[1])
    assert np.asarray(want.graph.num_nodes).min() == GCFG.max_nodes
    back = interop.state_to_numpy(got)
    assert_equal(back["graph"]["edge_ij"], want.graph.edge_ij)
    assert_equal(back["metrics_ring"][1], want.metrics_ring[1])


def test_register_scan_reclassifies_by_default():
    """register_scan without the argument re-classifies the target, as
    slam_tpu's default does (direct NN form patched in on both sides)."""
    rng = np.random.default_rng(3)
    cfg = BASE
    C, S = cfg.cloud.map_capacity, cfg.cloud.scene_capacity
    mxy = rng.uniform(-20, 20, (B, C, 2)).astype(np.float32)
    mflags = np.where(rng.random((B, C)) < 0.5, JCloud.FLAG_GA, 0).astype(
        np.int32)                                 # stale flags
    mvalid = rng.random((B, C)) < 0.9
    idx = rng.integers(0, C, (B, S))
    sxy = (np.take_along_axis(mxy, idx[..., None], 1) + [0.2, -0.1]).astype(
        np.float32)
    sflags = np.take_along_axis(mflags, idx, 1)
    svalid = rng.random((B, S)) < 0.9
    z = np.zeros((B, C, 1), np.float32)
    mxyz = np.concatenate([mxy, z], -1)
    sxyz = np.concatenate([sxy, z[:, :S]], -1)
    init = np.zeros((B, 3), np.float32)
    with mock.patch.object(jnn, "pairwise_sq_dist", _direct_sq_dist):
        want = jax.vmap(lambda s, m, i: jslam.register_scan(s, m, i, cfg))(
            JCloud(xyz=sxyz, valid=svalid, flags=sflags),
            JCloud(xyz=mxyz, valid=mvalid, flags=mflags), init)
        stale = jax.vmap(lambda s, m, i: jslam.register_scan(
            s, m, i, cfg, reclassify=False))(
            JCloud(xyz=sxyz, valid=svalid, flags=sflags),
            JCloud(xyz=mxyz, valid=mvalid, flags=mflags), init)
    got = tslam.register_scan(_cloud(sxyz, svalid, sflags),
                              _cloud(mxyz, mvalid, mflags), to_torch(init),
                              cfg)
    assert_close(got.pose, want.pose, atol=1e-4)
    assert_equal(got.num_corr, want.num_corr)
    assert not np.array_equal(np.asarray(want.num_corr),
                              np.asarray(stale.num_corr))


def test_graph_rollout_noise_free_matches_jax():
    """Two macros of four ticks and a graph tick each, two robots, no
    sensor noise (the random streams drop out): poses 1e-4, the graphs'
    integers exact. The robots drive ~0.12 m a tick, so the graph ticks
    find them ~0.48 m from the origin (the first keyframe) and ~0.49 m
    further on: a keyframe gate of 0.3 m keeps both decisions 0.19 m
    from it."""
    cfg = CFG.replace(
        graph=dataclasses.replace(GCFG, knn_dist_thresh=0.3),
        sim=dataclasses.replace(CFG.sim, range_noise=0.0, gyro_noise=0.0))
    world = jw.make_world(jax.random.PRNGKey(42), cfg.sim)
    st = jax.vmap(lambda k: jslam.init_state(k, cfg, with_graph=True))(
        jax.random.split(jax.random.PRNGKey(0), B))
    with as_on_tpu():
        fin, (est, true) = jax.jit(jax.vmap(lambda s: jslam.rollout_with_graph(
            s, world, cfg, 2, 4)))(st)
    tfin, (test, ttrue) = tslam.rollout_with_graph(
        interop.state_from_numpy(numpy_tree(st), "cpu"),
        interop.world_from_numpy(numpy_tree(world), "cpu"), cfg, 2,
        torch.Generator().manual_seed(0), graph_every=4)
    assert test.shape == (B, 8, 3)
    assert_close(test, est, atol=1e-4)
    assert_close(ttrue, true, atol=1e-5)
    for f in ("num_nodes", "num_edges", "edge_ij", "edge_valid",
              "node_valid", "node_stamp", "edges_dropped"):
        assert_equal(getattr(tfin.graph, f), getattr(fin.graph, f), f)
    assert_close(tfin.graph.node_pose, fin.graph.node_pose, atol=1e-4)
    assert (np.asarray(fin.graph.num_nodes) == 2).all()
    assert (np.asarray(fin.graph.num_edges) >= 1).all()
    assert_equal(tfin.map_cloud.valid, fin.map_cloud.valid)


def test_graph_modes_not_ported_raise():
    """Every graph mode is ported now; the refusal that stays is
    slam_tpu's own: edge_registration "3d" makes SE(3) measurements that
    only engine "se3" consumes. Both packages refuse it."""
    bad = dataclasses.replace(GCFG, edge_registration="3d")
    with pytest.raises(ValueError, match='engine="se3"'):
        jpg.init_graph(bad)
    with pytest.raises(ValueError, match='engine="se3"'):
        tpg.init_graph(bad, 1, "cpu")
    g = tpg.init_graph(dataclasses.replace(bad, engine="se3"), 1, "cpu")
    assert g.node_rp.shape == (1, GCFG.max_nodes, 2)


def test_config4_is_the_jax_benchmarks():
    """sim2d_graph_config is the config bench.py's bench_graph builds."""
    c = sim2d_config()
    want = c.replace(graph=dataclasses.replace(
        c.graph, max_nodes=32, max_edges=128, keyframe_points=384,
        map_regen="grid", regen_grid_bins=256))
    assert dataclasses.asdict(sim2d_graph_config()) == \
        dataclasses.asdict(want)


def test_edge_fit_jumps_at_an_exact_tie():
    """Why chip_smoke's [graph] holds K2 to its plain version at 1e-3 only
    on edge problems without a near-tie: the tie-averaged fit (both
    packages' K2) is discontinuous at an exact tie. A symmetric problem
    whose one scene point sits exactly between two model points (all
    coordinates multiples of 1/8, so every sum is exact) converges to the
    identity from init 0 (the pair averaged); a 1e-6 m init offset picks
    one of the two and settles b / N = 0.5 / 21 m away. Port and slam_tpu
    agree on each side (1e-5)."""
    ys = np.arange(-5, 6) * 0.5
    model = [(2.0, y) for y in ys] + [(-2.0, y) for y in ys if y != 0]
    model += [(1.0, 0.5), (1.0, -0.5)]                 # the tied pair
    scene = [(2.0, y) for y in ys] + [(-2.0, y) for y in ys if y != 0]
    scene += [(1.0, 0.0)]
    S, C = 24, 24
    s_xy = np.zeros((3, S, 2), np.float32)
    m_xy = np.zeros((3, C, 2), np.float32)
    s_xy[:, :len(scene)] = scene
    m_xy[:, :len(model)] = model
    s_valid = np.arange(S)[None].repeat(3, 0) < len(scene)
    m_valid = np.arange(C)[None].repeat(3, 0) < len(model)
    ga = np.zeros((3, S), bool)
    init = np.zeros((3, 3), np.float32)
    init[1, 1], init[2, 1] = 1e-6, -1e-6
    icp = dataclasses.replace(CFG.icp, max_iterations=GCFG.edge_icp_max_iter)
    with pallas_interpret():
        want = jax.vmap(jip.make_icp_fused(icp))(s_xy, s_valid, ga, m_xy,
                                                 m_valid, ga, init)
    got = icp_fused.icp_fused(*map(to_torch, (s_xy, s_valid, ga, m_xy,
                                              m_valid, ga, init)), icp)
    assert_close(got.pose, want.pose, atol=1e-5)
    assert_close(got.pose[0], np.zeros(3), atol=1e-7)
    jump = 0.5 / len(scene)
    assert_close(got.pose[1:, 1], [jump, -jump], atol=2e-3)


def _voxel_cloud(seed, B=2, N=300):
    """Clouds (B, N) with points sharing voxels at the 0.5 m x 0.5 m x 2 m
    leaf (clustered centres), masked points, and 0/1 flag bits."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-15, 15, (B, 60, 3)) * [1, 1, 0.2]
    pick = rng.integers(0, 60, (B, N))
    xyz = (np.take_along_axis(centres, pick[..., None], 1) +
           rng.normal(0, 0.2, (B, N, 3))).astype(np.float32)
    valid = rng.random((B, N)) < 0.9
    flags = rng.integers(0, 8, (B, N)).astype(np.int32)
    return xyz, valid, flags


@pytest.mark.parametrize("capacity", [64, 512])
def test_voxel_downsample_matches_jax(capacity):
    """Counts and flags exact, centroids 1e-5; at 64 slots the voxels
    overflow the capacity and the tail is dropped."""
    xyz, valid, flags = _voxel_cloud(5)
    leaf = (0.5, 0.5, 2.0)
    want = jax.jit(jax.vmap(lambda x, v, f: jvoxel.voxel_downsample(
        JCloud(xyz=x, valid=v, flags=f), leaf, capacity)))(xyz, valid, flags)
    got = voxel_downsample(_cloud(xyz, valid, flags), leaf, capacity)
    assert_equal(got.valid, want.valid)
    assert_equal(got.flags, want.flags)
    assert_close(got.xyz, want.xyz, atol=1e-5)
    n = np.asarray(want.valid).sum(-1)
    assert n.min() > 40 and (n.max() == capacity) == (capacity == 64)


def test_voxel_downsample_pairwise_and_update_map_cloud_match_jax():
    xyz, valid, flags = _voxel_cloud(6, N=160)
    leaf = CFG.icp.voxel_leaf_obs
    want = jax.vmap(lambda x, v, f: jvoxel.voxel_downsample_pairwise(
        JCloud(xyz=x, valid=v, flags=f), leaf))(xyz, valid, flags)
    got = voxel_downsample_pairwise(_cloud(xyz, valid, flags), leaf)
    assert_equal(got.valid, want.valid)
    assert_equal(got.flags, want.flags)
    assert_close(got.xyz, want.xyz, atol=1e-5)

    mxyz, mvalid, mflags = _voxel_cloud(7, N=CFG.cloud.map_capacity)
    pose = np.array([[1.0, -2.0, 0.4], [-3.0, 0.5, -1.2]], np.float32)
    want = jax.jit(jax.vmap(lambda m, s, p: jslam.update_map_cloud(
        m, s, p, CFG)))(JCloud(xyz=mxyz, valid=mvalid, flags=mflags),
                        JCloud(xyz=xyz, valid=valid, flags=flags), pose)
    got = tslam.update_map_cloud(_cloud(mxyz, mvalid, mflags),
                                 _cloud(xyz, valid, flags), to_torch(pose),
                                 CFG)
    assert_equal(got.valid, want.valid)
    assert_equal(got.flags, want.flags)
    assert_close(got.xyz, want.xyz, atol=1e-5)


def _voxel_centroids_f64(graph, leaf, capacity):
    """(B, capacity, 3) f64 centroids of the voxels of every keyframe point
    in the world (as the port computes it in f32), in ascending voxel id."""
    xyz = to_np(tpg._kf_world_xyz(graph)).astype(np.float64)
    xyz = xyz.reshape(xyz.shape[0], -1, 3)
    valid = to_np(graph.kf_valid & graph.node_valid[..., None]).reshape(
        xyz.shape[:2])
    out = np.zeros((xyz.shape[0], capacity, 3))
    for b in range(xyz.shape[0]):
        q = np.floor(xyz[b] / np.asarray(leaf)).astype(np.int64)
        vid = (q[:, 0] * 4096 + q[:, 1]) * 4096 + q[:, 2]
        ids = np.unique(vid[valid[b]])[:capacity]
        out[b, :len(ids)] = [xyz[b][valid[b] & (vid == v)].mean(0)
                             for v in ids]
    return out


def _lifted(g, copies=1):
    """Graph g with world point j of every keyframe (slot j // copies:
    keyframe slots hold the world points in order) at height 0.9 m when
    j is odd, 0 otherwise, so that neighbouring MLS cells differ by more
    than height_threshold (obstacles, not only ground); with copies > 1
    keyframe 0 holds each of its points `copies` times, 1 cm apart (so its
    cells initialize on their own)."""
    kf = np.asarray(g.kf_xyz).copy()
    valid = np.asarray(g.kf_valid).copy()
    if copies > 1:
        n = valid[:, 0].sum(-1).min() // copies * copies
        src = np.arange(n) // copies
        jit = np.random.default_rng(9).normal(0, 0.01, (n, 2))
        kf[:, 0, :n, :2] = kf[:, 0, src, :2] + jit
        valid[:, 0] = np.arange(kf.shape[2]) < n
    j = np.arange(kf.shape[2]) // copies
    kf[..., 2] += np.where(j % 2 == 1, 0.9, 0.0).astype(np.float32)
    return g.replace(kf_xyz=kf.astype(np.float32), kf_valid=valid)


def test_regenerate_map_voxel_and_mls_match_jax(sequence):
    """The voxel merge of every keyframe, and the global MLS rebuild (one
    add_to_mls per keyframe slot, then the cluster-mean export) with its
    grid, on the full graph of the path. Voxel centroids: 5e-5 against
    slam_tpu and 2e-5 against f64 centroids. Both packages sum each voxel
    as a difference of two prefix sums of the points' offsets from their
    voxel centres; with the 2 m z leaf those offsets are ~1 m, so the
    prefixes grow to ~500 over the 512 keyframe points and round at a few
    1e-5 (slam_tpu itself lies 2.1e-5 from the f64 centroids here)."""
    _, graphs, _ = sequence
    g = graphs[11]
    leaf = CFG.icp.voxel_leaf_obs
    want = jax.jit(jax.vmap(lambda gg: jpg.regenerate_map(gg, 256, leaf)))(g)
    tg = _port_graph(g)
    got = tpg.regenerate_map(tg, 256, leaf)
    assert_equal(got.valid, want.valid)
    assert_equal(got.flags, want.flags)
    assert_close(got.xyz, want.xyz, atol=5e-5)
    assert_close(got.xyz, _voxel_centroids_f64(tg, leaf, 256), atol=2e-5)
    assert np.asarray(want.valid).sum(-1).min() > 50

    mcfg = dataclasses.replace(CFG.mls, size_x=96, size_y=96)
    g = _lifted(g)
    wo, wg, wgrid = jax.jit(jax.vmap(lambda gg: jpg.regenerate_map_mls(
        gg, mcfg, 256)))(g)
    to, tg, tgrid = tpg.regenerate_map_mls(_port_graph(g), mcfg, 256)
    for a, b in ((to, wo), (tg, wg)):
        assert_equal(a.valid, b.valid)
        assert_close(a.xyz, b.xyz, atol=1e-5)
    assert_equal(tgrid.num_pts, wgrid.num_pts)
    assert_equal(tgrid.drivable, wgrid.drivable)
    assert_close(tgrid.mean, wgrid.mean, atol=1e-5)
    assert np.asarray(wo.valid).sum(-1).min() > 5
    assert np.asarray(wg.valid).sum(-1).min() > 10


def test_relocalization_edge_matches_jax(sequence):
    """Robot 0 takes the edge; robot 1's match is refused. Then a graph
    whose edge table is full drops the edge and counts it."""
    _, graphs, _ = sequence
    g = graphs[7]
    rng = np.random.default_rng(8)
    belief = np.asarray(g.node_pose)[:, 3] + rng.normal(0, 0.3, (B, 4))
    belief = belief.astype(np.float32)
    match = (belief[:, :3] + [0.4, -0.2, 0.05]).astype(np.float32)
    ok = np.array([True, False])
    run = jax.jit(jax.vmap(lambda gg, b, m, o: jpg.relocalization_edge(
        gg, b, m, o, GCFG)))
    want, want_inj = run(g, belief, match, ok)
    got, got_inj = tpg.relocalization_edge(
        _port_graph(g), to_torch(belief), to_torch(match), to_torch(ok),
        GCFG)
    assert_equal(got_inj, want_inj)
    assert_equal(got_inj, [True, False])
    assert_graph_close(got, want, rel_tol=1e-5, info_rtol=0.0)
    full = g.replace(edge_valid=np.ones_like(g.edge_valid))
    want, want_inj = run(full, belief, match, np.array([True, True]))
    got, got_inj = tpg.relocalization_edge(
        _port_graph(full), to_torch(belief), to_torch(match),
        torch.ones(B, dtype=torch.bool), GCFG)
    assert not got_inj.any()
    assert_equal(got.edges_dropped, want.edges_dropped)
    assert_equal(got.edges_dropped, np.asarray(full.edges_dropped) + 1)


def test_apply_relocalization_graph_matches_jax(sequence):
    """A kidnapped robot (belief off by 1.5 m and 0.1 rad) with a genuine
    match, and one whose match is the give-up fallback (score 0): the first
    shifts its belief, takes the edge, re-optimises and regenerates its
    target; the second shifts its belief only."""
    st = _graph_state(sequence)
    pose = np.asarray(st.pose).copy()
    match = JMatch(pose=pose[:, :3].copy(),
                   score=np.array([0.8, 0.0], np.float32),
                   ok=np.array([True, True]))
    kid = pose.copy()
    kid[:, :2] += [1.5, -1.0]
    kid[:, 2] += 0.1
    mu = np.asarray(st.ekf.mu).copy()
    mu[:, [0, 1, 6]] = kid[:, :3]
    st = st.replace(pose=kid, ekf=st.ekf.replace(mu=mu))
    with as_on_tpu():
        want = jax.jit(jax.vmap(lambda s, m: jrel.apply_relocalization_graph(
            s, m, CFG)))(st, match)
    got = trel.apply_relocalization_graph(
        interop.state_from_numpy(st, "cpu"),
        MatchResult(*(to_torch(x) for x in match)), CFG)
    # 2e-4: the edge (information 1000 on x, y) pulls the newest node ~1.8 m
    # through ten GN steps; the solves' rounding leaves 1.1e-4 in one y
    assert_graph_close(got.graph, want.graph, pose_tol=2e-4)
    assert_equal(got.graph.num_edges - to_torch(st.graph.num_edges), [1, 0])
    assert_close(got.ekf.mu, want.ekf.mu, atol=1e-5)
    assert_close(got.pose, want.pose, atol=1e-5)
    assert_equal(got.map_cloud.valid, want.map_cloud.valid)
    # the node poses' 2e-4, and their yaw's 1e-5 at up to 20 m
    assert_close(got.map_cloud.xyz, want.map_cloud.xyz, atol=5e-4)


def test_home_and_mission_commands_match_jax(sequence):
    """HOME: the global map from keyframe 0 alone (here holding each of its
    points three times, so that its cells initialize)."""
    _, graphs, _ = sequence
    g = _lifted(graphs[11], copies=3)
    mcfg = dataclasses.replace(CFG.mls, size_x=96, size_y=96)
    wo, wg, wp = jax.jit(jax.vmap(lambda gg: jpg.home_command(
        gg, mcfg, 128)))(g)
    to, tg, tp = tpg.mission_command(tpg.FSM_HOME, _port_graph(g), mcfg, 128)
    for a, b in ((to, wo), (tg, wg)):
        assert_equal(a.valid, b.valid)
        assert_close(a.xyz, b.xyz, atol=1e-5)
    assert_equal(tp, wp)
    assert np.asarray(wg.valid).sum(-1).min() > 10
    assert tpg.mission_command(tpg.FSM_INIT, _port_graph(g), mcfg, 8) is None
    with pytest.warns(RuntimeWarning):
        assert tpg.mission_command(tpg.FSM_FIX, _port_graph(g), mcfg,
                                   8) is None


@pytest.mark.parametrize("map_regen", ["voxel", "mls"])
def test_graph_update_regenerations_match_jax(sequence, map_regen):
    """One whole graph tick on a carried graph with the target regenerated
    by a voxel merge (the config's default) or by the global MLS rebuild
    (its obstacle export). The keyframes' points stand at two heights
    (_lifted): on a flat 2D world every initialized cluster is drivable
    ground, and the obstacle export, the "mls" target, is empty in both
    packages."""
    gcfg = dataclasses.replace(GCFG, map_regen=map_regen)
    cfg = CFG.replace(graph=gcfg, mls=dataclasses.replace(
        CFG.mls, size_x=96, size_y=96))
    st = _graph_state(sequence)
    st = st.replace(graph=_lifted(st.graph))
    with as_on_tpu():
        want, want_delta = jax.jit(jax.vmap(
            lambda s: jslam.graph_update_delta(s, cfg)))(st)
    got, got_delta = tslam.graph_update_delta(
        interop.state_from_numpy(st, "cpu"), cfg)
    assert_graph_close(got.graph, want.graph, pose_tol=1e-4)
    assert_close(got_delta, want_delta, atol=1e-4)
    assert_equal(got.map_cloud.valid, want.map_cloud.valid)
    assert_equal(got.map_cloud.flags, want.map_cloud.flags)
    assert_close(got.map_cloud.xyz, want.map_cloud.xyz, atol=1e-4)
    assert np.asarray(want.map_cloud.valid).sum(-1).min() > 2
