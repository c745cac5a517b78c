"""tools/eviction_study.py's mission against the port's
(slam_tpu_torch.eviction_study) on the CPU: at --max-nodes 4 --macros 8
with the sensor noise off, fed slam_tpu's world and initial state through
interop, run(...) gives the nodes, edges and dropped edges of slam_tpu's
rollout_with_graph, run as tests/test_torch_graph.py runs it
(`as_on_tpu`: Pallas in interpret mode, K1 and K2 on both sides, the
direct NN form patched in), and its overall ATE within 1e-4 m (poses
1e-4, as there).
"""

import jax
import numpy as np
import pytest
import torch

from slam_tpu.pipeline import slam2d as jslam
from slam_tpu_torch import eviction_study
from tests.test_torch_entry import _jax_start, _noise_free
from tests.test_torch_graph import as_on_tpu

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _unfused_xla():
    """slam_tpu compiled without XLA's optimizing passes, several times
    faster to compile (as tests/test_torch_graph3d_rollout.py does)."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


def test_eviction_study_matches_jax():
    """--max-nodes 4 --macros 8 without sensor noise: the graph fills and
    evicts, and the nodes, edges and dropped edges are slam_tpu's."""
    cfg = _noise_free(eviction_study.config(4))
    world, st, tworld, tst = _jax_start(cfg, 1, with_graph=True)
    with as_on_tpu():
        fin, (est, true) = jax.jit(jax.vmap(
            lambda s: jslam.rollout_with_graph(s, world, cfg, 8, 4)))(st)
    got = eviction_study.run(cfg, tworld, tst, 8, torch.Generator())
    assert got["steps"] == 32
    assert got["nodes"] == int(fin.graph.num_nodes[0])
    assert got["edges"] == int(fin.graph.num_edges[0])
    assert got["edges_dropped"] == int(fin.graph.edges_dropped[0])
    assert got["full"] == bool(fin.graph_full[0]) is True
    err = np.linalg.norm(np.asarray(est[0, :, :2] - true[0, :, :2]), axis=1)
    assert abs(got["overall"] - float(np.sqrt((err ** 2).mean()))) < 1e-4
