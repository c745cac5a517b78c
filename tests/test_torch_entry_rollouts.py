"""The port's entry points' rollouts against slam_tpu's on the CPU:
run_sim2d.run (with and without --graph), fed
slam_tpu's world and initial state through interop with the sensor noise
off (the random streams drop out), give the numbers slam_tpu's functions
compute. slam_tpu runs as tests/test_torch_graph.py runs it
(`as_on_tpu`: Pallas in interpret mode, so K1 and K2 on both sides, the
direct NN form patched in). Tolerances as there: poses 1e-4, so the ATE
1e-4; counts and the graphs' integers exact. (tests/test_torch_entry.py
holds the mains, run_fleet and make_replay, and
tests/test_torch_entry_eviction.py eviction_study: each file compiles
slam_tpu's rollouts of its own, and is kept to ~30 s on one worker.)
"""

import dataclasses

import jax
import pytest
import torch

from slam_tpu.config import sim2d_config
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu_torch import run_sim2d
from tests.test_torch_entry import _jax_start, _noise_free
from tests.test_torch_graph import as_on_tpu
from tests.torch_parity import assert_close

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _unfused_xla():
    """slam_tpu compiled without XLA's optimizing passes: several times
    faster to compile (as tests/test_torch_graph3d_rollout.py does)."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


@pytest.mark.parametrize("graph", [False, True], ids=["ticks", "graph"])
def test_run_sim2d_matches_jax(graph):
    """One robot, 16 noise-free ticks: 4 macros of 4, or with the graph 2
    macros of 8 and a graph tick each. The graph is cut to 8 keyframes of
    128 points (slam_tpu's interpret-mode K2 on the default 1,024-point
    keyframes takes most of a minute to compile) with its keyframe gate at
    0.5 m (the robot drives ~0.96 m a macro), so that both graph ticks add
    a keyframe and the second measures an edge (K2)."""
    cfg = _noise_free(sim2d_config())
    if graph:
        cfg = cfg.replace(graph=dataclasses.replace(
            cfg.graph, max_nodes=8, max_edges=24, keyframe_points=128,
            knn_dist_thresh=0.5))
    world, st, tworld, tst = _jax_start(cfg, 1, with_graph=graph)
    with as_on_tpu():
        if graph:
            fin, (est, true) = jax.jit(jax.vmap(
                lambda s: jslam.rollout_with_graph(s, world, cfg, 2, 8)))(st)
        else:
            fin, (est, true) = jax.jit(jax.vmap(
                lambda s: jslam.rollout(s, world, cfg, 16)))(st)
    got = run_sim2d.run(cfg, tworld, tst, 16, torch.Generator(), graph=graph)
    assert got["steps"] == 16
    assert_close(got["est"], est[0], atol=1e-4)
    assert_close(got["ate"], jslam.ate(est[0, 12:], true[0, 12:]), atol=1e-4)
    assert got["map_points"] == int(fin.map_cloud.valid[0].sum())
    if graph:
        assert got["keyframes"] == int(fin.graph.num_nodes[0]) == 2
        assert got["edges"] == int(fin.graph.num_edges[0]) >= 1
