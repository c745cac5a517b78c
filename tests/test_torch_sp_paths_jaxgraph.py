"""Port parity, the sp axis's graph mode against slam_tpu: the port's
whole-grid run of tests/test_torch_sp_paths.py's graph case
(dryrun_multichip's graph path, two macros of 4 ticks and a graph tick,
a keyframe every 0.4 m, the "grid" regeneration; B = 8, noise off)
against slam_tpu's unsharded run on the same inputs (slam_tpu's initial
states carried across). tests/test_torch_sp_paths.py holds the split
runs to this whole-grid run within 1e-5; this module, with its slam_tpu
compile, holds the whole-grid run to slam_tpu within 1e-4: poses, and
the graphs' keyframe poses and edge counts.

slam_tpu runs as on a TPU (K1 and K2 in Pallas interpret mode) with the
direct NN form patched in, as tests/test_torch_graph.py runs it.
"""

from unittest import mock

import jax
import numpy as np
import torch

from slam_tpu.ops import nn as jnn
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu_torch.parallel import mesh as tmesh
from tests import torch_sp_paths_worker as W
from tests.test_torch_graph import as_on_tpu
from tests.test_torch_icp3d import _direct_sq_dist
from tests.test_torch_sp_paths import TWO_D, jax_inputs
from tests.torch_parity import assert_close, assert_equal

torch.set_num_threads(1)


def test_whole_grid_graph_matches_slam_tpu():
    cfgs, j, st, port = jax_inputs(TWO_D)
    with as_on_tpu(), mock.patch.object(jnn, "pairwise_sq_dist",
                                        _direct_sq_dist):
        fin, (est, _) = jax.jit(jax.vmap(lambda x: jslam.rollout_with_graph(
            x, st["world"], j["graph"], W.GRAPH_MACROS, W.GRAPH_EVERY)))(
            st["states_graph"])
    whole = W.graph(port, tmesh.make_mesh(1), cfgs)
    assert_close(whole["est"], np.asarray(est)[..., :3], atol=1e-4)
    rep = whole["replicated"]
    assert_equal(rep["n_edges"], np.asarray(fin.graph.num_edges))
    assert_equal(rep["n_nodes"], np.asarray(fin.graph.num_nodes))
    assert_close(rep["nodes"], np.asarray(fin.graph.node_pose), atol=1e-4)
    assert int(rep["n_edges"].min()) >= 1
