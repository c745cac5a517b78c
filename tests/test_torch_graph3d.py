"""Port parity, config 4 in 3D (slam_tpu_torch vs slam_tpu, CPU): the 6-DoF
keyframe path (add_keyframe with its attitude tilt, node_rp and the 3D
edges of _edge_measurement_3d), the SE(3) optimisers (optimize_native,
optimize_planar, optimize_se3 with total_chi2), relocalization_edge's
6-DoF lift, apply_graph_offset, the state round trip, and the 2D
rollout_with_graph with engine "se3" (the 3D rollouts are
tests/test_torch_graph3d_rollout.py's).

The 6-DoF keyframes are tests/test_graph_se3_edges.py's drifted-z loop
over a ramp (five keyframes on a 4 m circle, 96 world obstacles, 224
fresh ground samples each), for two robots with 0.15 m and 0.08 m of z
drift a node. slam_tpu runs as on a TPU where it reaches a Pallas kernel
(`jax.default_backend` patched to "tpu", Pallas in interpret mode: K1 on
the ticks and K2 on planar edges, the port's plain versions here), with
the direct NN form patched into slam_tpu.ops.nn.pairwise_sq_dist (the 3D
edges' nearest neighbours), and compiled without XLA's optimizing passes
(faster to compile).

Tolerances: integers (counts, edge_ij, validity, stamps, flags) exact;
node poses and attitudes copied exactly; keyframe points 1e-5 (the tilt's
matmul); 6-DoF edges 1e-4 (the fits' bound, tests/test_torch_icp3d.py),
their information relative 1e-2; optimised poses 1e-4; the rollout
1e-4.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import sim2d_config, sim3d_config
from slam_tpu.graph import pose_graph as jpg
from slam_tpu.graph import pose_graph3d as jpg3
from slam_tpu.pipeline import slam2d as jslam2d
from slam_tpu.pipeline import slam3d as jslam3d
from slam_tpu.sim import world2d as jw2
from slam_tpu.sim import world3d as jw3
from slam_tpu.types import PointCloud as JCloud
from slam_tpu_torch import interop
from slam_tpu_torch.graph import pose_graph as tpg
from slam_tpu_torch.graph import pose_graph3d as tpg3
from slam_tpu_torch.pipeline import slam2d as tslam2d
from slam_tpu_torch.pipeline import slam3d as tslam3d
from slam_tpu_torch.types import PointCloud
from tests.test_graph_se3_edges import _graph_cfg, _loop_fixture
from tests.test_torch_graph import as_on_tpu
from tests.test_torch_icp3d import direct_nn
from tests.torch_parity import (assert_close, assert_equal, numpy_tree,
                                to_np, to_torch)

torch.set_num_threads(1)

B = 2
CFG3 = _graph_cfg(sim3d_config(), "se3", "3d")
DRIFTS = (0.15, 0.08)
EXACT = ("node_pose", "node_valid", "node_stamp", "kf_valid", "kf_flags",
         "edge_ij", "edge_valid", "num_nodes", "num_edges", "edges_dropped",
         "node_rp")


@pytest.fixture(scope="module", autouse=True)
def _unfused_xla():
    """slam_tpu compiled without XLA's optimizing passes, for this file: it
    compiles several times faster, and XLA:CPU's fused eigen-solve rounds
    differently (tests/test_torch_slam3d.py)."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


@pytest.fixture(scope="module")
def loop():
    """The loop's inputs per keyframe (pose, cloud, attitude; both robots
    stacked) and slam_tpu's graphs before and after each insertion."""
    stops = []
    for drift in DRIFTS:
        calls = []

        def record(graph, pose, cloud, icp_cfg, gcfg, attitude=None):
            calls.append((np.asarray(pose), np.asarray(cloud.xyz),
                          np.asarray(cloud.valid), np.asarray(cloud.flags),
                          np.asarray(attitude)))
            return graph, jnp.asarray(True)
        with mock.patch.object(jpg, "add_keyframe", record):
            _loop_fixture(CFG3, z_drift_per_node=drift)
        stops.append(calls)
    stops = [tuple(np.stack(x) for x in zip(*per_robot))
             for per_robot in zip(*stops)]
    add = jax.jit(jax.vmap(lambda g, p, x, v, f, a: jpg.add_keyframe(
        g, p, JCloud(xyz=x, valid=v, flags=f), CFG3.icp, CFG3.graph,
        attitude=a)))
    g = jax.tree.map(lambda x: np.stack([np.asarray(x)] * B),
                     jpg.init_graph(CFG3.graph))
    graphs = [g]
    with direct_nn():
        for stop in stops:
            g, added = add(graphs[-1], *stop)
            assert np.asarray(added).all()
            graphs.append(numpy_tree(g))
    return stops, graphs


def _port_graph(g):
    return interop.graph_from_numpy(g, "cpu")


def assert_graph3d_close(got, want, pose_tol=0.0):
    valid = np.asarray(want.edge_valid)
    for f in EXACT:
        if f in ("node_pose", "node_rp") and pose_tol:
            assert_close(getattr(got, f), getattr(want, f), atol=pose_tol,
                         what=f)
        else:
            assert_equal(getattr(got, f), getattr(want, f), f)
    assert_close(got.kf_xyz, want.kf_xyz, atol=1e-5, what="kf_xyz")
    for f, atol, rtol in (("edge_rel", 1e-4, 0.0), ("edge_rel6", 1e-4, 0.0),
                          ("edge_info", 1e-2, 1e-2),
                          ("edge_info6", 1e-2, 1e-2)):
        assert_close(to_np(getattr(got, f))[valid],
                     np.asarray(getattr(want, f))[valid], atol=atol,
                     rtol=rtol, what=f)


@pytest.mark.parametrize("stop", [0, 1, 3, 4])
def test_add_keyframe_6dof_matches_jax(loop, stop):
    """Keyframe `stop` into the carried graph: the tilt into the body
    frame, node_rp, and every 3D edge (rel, rel6, both informations, the
    gates' verdicts)."""
    stops, graphs = loop
    pose, xyz, valid, flags, att = stops[stop]
    cloud = PointCloud(xyz=to_torch(xyz), valid=to_torch(valid),
                       flags=to_torch(flags))
    got, added = tpg.add_keyframe(_port_graph(graphs[stop]), to_torch(pose),
                                  cloud, CFG3.icp, CFG3.graph,
                                  attitude=to_torch(att))
    assert bool(added.all())
    assert_graph3d_close(got, graphs[stop + 1])
    if stop == 4:
        # the loop closes: an edge from node 0 to a node beyond 1
        eij = np.asarray(graphs[5].edge_ij)[np.asarray(graphs[5].edge_valid)]
        assert ((eij == 0).any(1) & (eij.max(1) >= 2)).any()


def test_edge_measurement_3d_matches_jax(loop):
    """The B x 4 candidate edges into node 4 measured in one batched fit,
    accepted or not."""
    _, graphs = loop
    g = graphs[5]
    src = np.array([[3, 0, 1, 2]] * B, np.int32)
    dst = np.full(B, 4, np.int32)
    with direct_nn():
        want = jax.jit(jax.vmap(lambda gg, ss, d: jax.vmap(
            lambda s: jpg._edge_measurement_3d(gg, s, d, CFG3.icp,
                                               CFG3.graph))(ss)))(g, src, dst)
    got = tpg._edge_measurement_3d(_port_graph(g), to_torch(src),
                                   to_torch(dst), CFG3.icp, CFG3.graph)
    rel, info, rel6, info6, ok = got
    assert_equal(ok, want[4])
    assert np.asarray(want[4]).sum() >= 6
    for name, a, b, atol, rtol in (("rel", rel, want[0], 1e-4, 0),
                                   ("info", info, want[1], 1e-2, 1e-2),
                                   ("rel6", rel6, want[2], 1e-4, 0),
                                   ("info6", info6, want[3], 1e-2, 1e-2)):
        assert_close(a, b, atol=atol, rtol=rtol, what=name)


def test_optimize_native_matches_jax(loop):
    """The drifted loop solved over its measured 6-DoF edges: poses,
    attitudes and the newest node's delta; total_chi2 falls."""
    _, graphs = loop
    g = graphs[5]
    want, want_delta = jax.jit(jax.vmap(lambda gg: jpg3.optimize_native(
        gg, CFG3.graph)))(g)
    tg = _port_graph(g)
    got, got_delta = tpg3.optimize_native(tg, CFG3.graph)
    assert_close(got.node_pose, want.node_pose, atol=1e-4, what="node_pose")
    assert_close(got.node_rp, want.node_rp, atol=1e-4, what="node_rp")
    assert_close(got_delta, want_delta, atol=1e-4, what="delta")
    before = tpg3.total_chi2(tpg3.from_native(tg))
    after = tpg3.total_chi2(tpg3.from_native(got))
    assert_close(before, jax.jit(jax.vmap(lambda gg: jpg3.total_chi2(
        jpg3.from_native(gg))))(g), atol=0, rtol=1e-3, what="chi2")
    assert bool((after < 0.1 * before).all())
    # the drifted z comes back (test_graph_se3_edges' own bound)
    z = to_np(got.node_pose)[:, :5, 3]
    assert np.abs(z - z[:, :1]).max() < 1.0


@pytest.mark.parametrize("min_delta", [1e-5, 0.0])
def test_optimize_se3_and_planar_match_jax(loop, min_delta):
    """optimize_planar on the loop's planar projection (its edge_rel /
    edge_info, roll and pitch dropped), with and without the early exit
    (0: all ten steps), and from_planar, optimize_se3 and total_chi2 on
    the way."""
    _, graphs = loop
    g = graphs[5].replace(node_rp=None, edge_rel6=None, edge_info6=None)
    gcfg = dataclasses.replace(CFG3.graph, engine="se3",
                               edge_registration="2d", opt_min_delta=min_delta)

    @jax.jit
    @jax.vmap
    def run(gg):
        se3 = jpg3.from_planar(gg)
        return (jpg3.optimize_planar(gg, gcfg), se3,
                jpg3.total_chi2(se3))
    (want, want_delta), se3, chi2 = run(g)
    tg = _port_graph(g)
    got, got_delta = tpg3.optimize_planar(tg, gcfg)
    assert_close(got.node_pose, want.node_pose, atol=1e-4)
    assert_close(got_delta, want_delta, atol=1e-4)
    tse3 = tpg3.from_planar(tg)
    assert_close(tse3.node_R, se3.node_R, atol=1e-6)
    assert_close(tse3.edge_info, se3.edge_info, atol=0)
    assert_close(tpg3.total_chi2(tse3), chi2, atol=1e-2, rtol=1e-3)
    after = tpg3.total_chi2(tpg3.optimize_se3(
        tse3, iterations=gcfg.opt_iterations, lm_lambda=gcfg.lm_lambda,
        min_delta=min_delta))
    assert bool((after < to_torch(chi2)).all())


def test_se3_engine_z_lift_matches_jax():
    """tests/test_pipeline3d_graph.py's two-node fixture (in a graph of 8
    slots): a loop-closure grade edge measures dz = +0.5 m;
    optimize_planar lifts node 1 as slam_tpu does."""
    cfg = sim3d_config()
    cfg = cfg.replace(graph=dataclasses.replace(cfg.graph, max_nodes=8,
                                                max_edges=8))
    g = jpg.init_graph(cfg.graph)
    g = g.replace(
        node_pose=g.node_pose.at[1].set(jnp.array([6.0, 0.0, 0.0, 0.0])),
        node_valid=g.node_valid.at[:2].set(True),
        node_stamp=g.node_stamp.at[0].set(0).at[1].set(1),
        num_nodes=jnp.int32(2),
        edge_ij=g.edge_ij.at[0].set(jnp.array([0, 1])),
        edge_rel=g.edge_rel.at[0].set(jnp.array([6.0, 0.0, 0.0, 0.5])),
        edge_info=g.edge_info.at[0].set(jnp.eye(4)),
        edge_valid=g.edge_valid.at[0].set(True), num_edges=jnp.int32(1))
    want, want_delta = jax.jit(lambda gg: jpg3.optimize_planar(
        gg, cfg.graph))(g)
    tg = _port_graph(jax.tree.map(lambda x: np.asarray(x)[None], g))
    got, got_delta = tpg3.optimize_planar(tg, cfg.graph)
    assert_close(got.node_pose[0], want.node_pose, atol=1e-5)
    assert_close(got_delta[0], want_delta, atol=1e-5)
    assert abs(float(got_delta[0, 3]) - 0.5) < 0.02


def test_relocalization_edge_6dof_matches_jax(loop):
    """A 6-DoF graph takes the planar match lifted (yaw a z rotation
    vector, roll and pitch pinned); robot 1's match is refused."""
    _, graphs = loop
    g = graphs[5]
    rng = np.random.default_rng(9)
    belief = (np.asarray(g.node_pose)[:, 4] + rng.normal(0, 0.3, (B, 4))
              ).astype(np.float32)
    match = (belief[:, :3] + [0.4, -0.2, 0.05]).astype(np.float32)
    ok = np.array([True, False])
    want, want_inj = jax.jit(jax.vmap(lambda gg, b, m, o: (
        jpg.relocalization_edge(gg, b, m, o, CFG3.graph))))(g, belief, match,
                                                            ok)
    got, got_inj = tpg.relocalization_edge(
        _port_graph(g), to_torch(belief), to_torch(match), to_torch(ok),
        CFG3.graph)
    assert_equal(got_inj, want_inj)
    assert_equal(got_inj, [True, False])
    assert_graph3d_close(got, want)
    assert_close(got.edge_rel6, want.edge_rel6, atol=1e-5)
    assert_close(got.edge_info6, want.edge_info6, atol=0)


def test_apply_graph_offset_matches_jax():
    rng = np.random.default_rng(10)
    count = rng.integers(0, 4, (B, 32, 32)).astype(np.float32)
    grid = {k: (rng.normal(0, 1, (B, 32, 32)) * count).astype(np.float32)
            for k in ("sum_x", "sum_y", "sum_z")}
    cloud = JCloud(xyz=rng.normal(0, 5, (B, 40, 3)).astype(np.float32),
                   valid=rng.random((B, 40)) < 0.7,
                   flags=np.zeros((B, 40), np.int32))
    from slam_tpu.mapping.point_map import init_point_map as j_init
    g0 = j_init(32, 0.5)
    jgrid = jax.tree.map(lambda x: np.stack([np.asarray(x)] * B), g0)
    jgrid = jgrid.replace(count=count, **grid)
    gm = jslam3d.GroundMap(grid=jgrid, cloud=cloud)
    delta = rng.normal(0, 0.3, (B, 4)).astype(np.float32)
    want = jax.vmap(jslam3d.apply_graph_offset)(gm, delta)
    got = tslam3d.apply_graph_offset(
        interop.ground_map_from_numpy(numpy_tree(gm), "cpu"), to_torch(delta))
    assert_close(got.grid.sum_z, want.grid.sum_z, atol=1e-6)
    assert_equal(got.grid.count, want.grid.count)
    assert_close(got.cloud.xyz, want.cloud.xyz, atol=0)


def test_rollout_with_graph_2d_se3_engine_matches_jax():
    """The 2D graph rollout with engine "se3" (optimize_planar), as
    tests/test_torch_graph.py's noise-free se2z case."""
    base = sim2d_config()
    cfg = base.replace(
        graph=dataclasses.replace(base.graph, max_nodes=8, max_edges=24,
                                  keyframe_points=64, knn_dist_thresh=0.3,
                                  map_regen="grid", regen_grid_bins=128,
                                  engine="se3"),
        sim=dataclasses.replace(base.sim, range_noise=0.0, gyro_noise=0.0))
    world = jw2.make_world(jax.random.PRNGKey(42), cfg.sim)
    st = jax.vmap(lambda k: jslam2d.init_state(k, cfg, with_graph=True))(
        jax.random.split(jax.random.PRNGKey(0), B))
    with as_on_tpu():
        fin, (est, true) = jax.jit(jax.vmap(
            lambda s: jslam2d.rollout_with_graph(s, world, cfg, 2, 4)))(st)
    tfin, (test, _) = tslam2d.rollout_with_graph(
        interop.state_from_numpy(numpy_tree(st), "cpu"),
        interop.world_from_numpy(numpy_tree(world), "cpu"), cfg, 2,
        torch.Generator().manual_seed(0), graph_every=4)
    assert_close(test, est, atol=1e-4)
    for f in ("num_nodes", "num_edges", "edge_ij", "edge_valid"):
        assert_equal(getattr(tfin.graph, f), getattr(fin.graph, f), f)
    assert_close(tfin.graph.node_pose, fin.graph.node_pose, atol=1e-4)
    assert (np.asarray(fin.graph.num_edges) >= 1).all()


def test_state_round_trip_graph3d(loop):
    """A 6-DoF graph-mode state (graph, prev_ground, attitude) carried
    across and back, leaf for leaf."""
    _, graphs = loop
    world = jw3.make_world(jax.random.PRNGKey(42), CFG3.sim)
    st = jax.vmap(lambda k: jslam3d.init_state_3d(k, CFG3, world,
                                                  with_graph=True))(
        jax.random.split(jax.random.PRNGKey(0), B))
    st = numpy_tree(st).replace(graph=graphs[5])
    tst = interop.state_from_numpy(st, "cpu")
    assert tst.prev_ground.capacity == CFG3.graph.keyframe_points
    back = interop.state_to_numpy(tst)
    for path, leaf in jax.tree_util.tree_leaves_with_path(st):
        keys = [p.name for p in path]
        if keys[0] in ("rng", "graph_full"):
            continue
        got = back
        for k in keys:
            got = got[k]
        assert_equal(got, leaf, "/".join(keys))
    tinit = tslam3d.init_state_3d(CFG3, B, interop.world3d_from_numpy(
        numpy_tree(world), "cpu"), device="cpu",
        generator=torch.Generator().manual_seed(0), with_graph=True)
    for f in ("node_rp", "edge_rel6", "edge_info6"):
        assert getattr(tinit.graph, f).shape[1:] == getattr(graphs[0], f
                                                            ).shape[1:]
    # graph mode keeps no obstacle point-map grid (slam_tpu's is a pytree
    # placeholder that graph mode never reads)
    assert tinit.map_grid is None and tinit.prev_ground is not None


def test_3d_graph_configs_are_the_jax_missions():
    """ref_scale_graph_config is the config bench.py's long mission
    (bench_ref_scale_longrun) builds; sim3d_se3_config the 6-DoF chain at
    sim3d with the 2.5 m gate of slam_tpu's own 3D graph tests."""
    from slam_tpu import config as jcfg
    from slam_tpu_torch import config as tcfg
    c = jcfg.ref_scale_config()
    want = c.replace(
        graph=dataclasses.replace(c.graph, max_nodes=64, max_edges=320,
                                  keyframe_points=2048, edge_min_corr=30),
        global_match=dataclasses.replace(c.global_match, grid_size=192,
                                         num_rotations=64))
    assert dataclasses.asdict(tcfg.ref_scale_graph_config()) == \
        dataclasses.asdict(want)
    c = jcfg.sim3d_config()
    want = c.replace(graph=dataclasses.replace(
        c.graph, engine="se3", edge_registration="3d", knn_dist_thresh=2.5))
    assert dataclasses.asdict(tcfg.sim3d_se3_config()) == \
        dataclasses.asdict(want)


def test_init_se3_graph_matches_jax():
    want = jpg3.init_se3_graph(6, 10)
    got = tpg3.init_se3_graph(B, 6, 10, device="cpu")
    for f in ("node_t", "node_R", "node_valid", "edge_ij", "edge_t",
              "edge_R", "edge_info", "edge_valid"):
        assert_equal(getattr(got, f), np.broadcast_to(
            np.asarray(getattr(want, f)), (B,) + getattr(want, f).shape), f)
