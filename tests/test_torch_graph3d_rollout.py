"""Port parity, config 4 in 3D end to end (slam_tpu_torch vs slam_tpu,
CPU): one noise-free rollout_3d_with_graph per engine ("se2z", "se3" over
planar edges, "se3" over 3D edges with the ground sample the state
carries), two robots, three macros of four graph-mode ticks and a graph
tick.

slam_tpu runs as on a TPU (`jax.default_backend` patched to "tpu",
Pallas in interpret mode: K1 on the ticks, K2 on planar edges; the port's
plain versions here), with the N-D direct NN form patched into
slam_tpu.ops.nn.pairwise_sq_dist (the 3D edges'), compiled without XLA's
optimizing passes: XLA:CPU's fused eigen-solve rounds differently
(tests/test_torch_slam3d.py), and it compiles several times faster.
The scans come from each package's own raycast, which agree to ~1e-4 m
(tests/test_torch_slam3d.py); the ground GP is cut to 2 sweeps of 16
signal slots to keep the compile short.

Tolerances: poses 1e-4 (z included), the graphs' integers exact, node
poses and attitudes 1e-4, the ground map's counts exact, its z sums 1e-3.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from slam_tpu.config import sim3d_config
from slam_tpu.pipeline import slam3d as jslam3d
from slam_tpu.sim import world3d as jw3
from slam_tpu_torch import interop
from slam_tpu_torch.pipeline import slam3d as tslam3d
from tests.test_torch_graph import as_on_tpu
from tests.test_torch_icp3d import direct_nn
from tests.torch_parity import assert_close, assert_equal, numpy_tree

torch.set_num_threads(1)

B = 2


@pytest.fixture(scope="module", autouse=True)
def _unfused_xla():
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


def _cut_gp(cfg):
    return dataclasses.replace(cfg, ground=dataclasses.replace(
        cfg.ground, max_insac_sweeps=2, signal_capacity=16))


def _noise_free(cfg):
    return dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, range_noise=0.0, gyro_noise=0.0))


@pytest.mark.parametrize("engine,edges", [("se2z", "2d"), ("se3", "2d"),
                                          ("se3", "3d")])
def test_rollout_3d_with_graph_noise_free_matches_jax(engine, edges):
    """Three macros of four graph-mode ticks and a graph tick each, two
    robots, no sensor noise: poses 1e-4 (z included), the graphs' integers
    exact, node poses 1e-4, the ground map's counts exact. The robots
    drive ~0.12 m a tick, so each graph tick finds them ~0.48 m from the
    last keyframe, against a keyframe gate of 0.3 m."""
    base = _noise_free(_cut_gp(sim3d_config()))
    cfg = base.replace(graph=dataclasses.replace(
        base.graph, max_nodes=8, max_edges=24, keyframe_points=256,
        knn_dist_thresh=0.3, engine=engine, edge_registration=edges))
    world = jw3.make_world(jax.random.PRNGKey(42), cfg.sim)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    st = jax.vmap(lambda k: jslam3d.init_state_3d(k, cfg, world,
                                                  with_graph=True))(keys)
    gm = jax.vmap(lambda _: jslam3d.init_ground_map(cfg))(keys)
    # the inner patch: the N-D direct form (as_on_tpu's is 2D)
    with as_on_tpu(), direct_nn():
        fin, fgm, (est, true) = jax.jit(jax.vmap(
            lambda s, g: jslam3d.rollout_3d_with_graph(s, world, g, cfg, 3,
                                                       4)))(st, gm)
    tfin, tgm, (test, ttrue) = tslam3d.rollout_3d_with_graph(
        interop.state_from_numpy(numpy_tree(st), "cpu"),
        interop.world3d_from_numpy(numpy_tree(world), "cpu"),
        interop.ground_map_from_numpy(numpy_tree(gm), "cpu"), cfg, 3,
        torch.Generator().manual_seed(0), graph_every=4)
    assert test.shape == (B, 12, 4)
    assert_close(ttrue, true, atol=1e-5)
    assert_close(test, est, atol=1e-4)
    for f in ("num_nodes", "num_edges", "edge_ij", "edge_valid",
              "node_valid", "node_stamp", "edges_dropped"):
        assert_equal(getattr(tfin.graph, f), getattr(fin.graph, f), f)
    assert_close(tfin.graph.node_pose, fin.graph.node_pose, atol=1e-4)
    if edges == "3d":
        assert_close(tfin.graph.node_rp, fin.graph.node_rp, atol=1e-4)
        assert_equal(tfin.prev_ground.valid, fin.prev_ground.valid)
        assert_close(tfin.prev_ground.xyz, fin.prev_ground.xyz, atol=1e-4)
    assert_equal(tgm.grid.count, fgm.grid.count)
    assert_close(tgm.grid.sum_z, fgm.grid.sum_z, atol=1e-3)
    assert_equal(tfin.map_cloud.valid, fin.map_cloud.valid)
    assert (np.asarray(fin.graph.num_nodes) >= 3).all()
    assert (np.asarray(fin.graph.num_edges) >= 2).all()
