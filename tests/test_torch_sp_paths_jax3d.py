"""Port parity, the sp axis's 3D paths against slam_tpu: the port's
whole-grid runs of tests/test_torch_sp_paths.py's 3D cases (the
reference-scale engines at dryrun_multichip's tiny shapes, B = 8, noise
off) against slam_tpu's unsharded runs on the same inputs (slam_tpu's
initial states carried across). tests/test_torch_sp_paths.py holds the
split runs to these whole-grid runs within 1e-5; this module, with its
slam_tpu compiles, holds the whole-grid runs to slam_tpu within 1e-4.

slam_tpu runs with its scatter ground-binning engine forced (as
dryrun_multichip forces it) and the direct N-D NN form patched in. The
port's slam_step_3d without shifts is held to the first tick of
slam_tpu's rollout_3d: from an empty map both register against the same
empty field and update the same grids.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from slam_tpu.ops import ground as jground
from slam_tpu.ops import nn as jnn
from slam_tpu.pipeline import slam3d as jslam3
from slam_tpu_torch.parallel import mesh as tmesh
from tests import torch_sp_paths_worker as W
from tests.test_torch_icp3d import _direct_sq_dist
from tests.test_torch_sp_paths import THREE_D, jax_inputs
from tests.torch_parity import assert_close

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    cfgs, j, st, port = jax_inputs(THREE_D)
    old = jground.INCIDENCE_LIMIT
    jground.INCIDENCE_LIMIT = 0          # the scatter binning engine
    try:
        with mock.patch.object(jnn, "pairwise_sq_dist", _direct_sq_dist):
            _, _, (roll, _) = jax.jit(jax.vmap(
                lambda x, y: jslam3.rollout_3d(x, st["world3"], y,
                                               j["ref3d"], 8)))(
                st["states3"], st["gm3"])
            _, _, (graph, _) = jax.jit(jax.vmap(
                lambda x, y: jslam3.rollout_3d_with_graph(
                    x, st["world3"], y, j["ref3d_graph"], W.GRAPH_MACROS,
                    W.GRAPH_EVERY)))(st["states3g"], st["gm3"])
    finally:
        jground.INCIDENCE_LIMIT = old
    whole = W.ref3d(port, tmesh.make_mesh(1), cfgs)
    return whole, dict(rollout=np.asarray(roll), graph=np.asarray(graph))


@pytest.mark.parametrize("case", ["rollout", "graph"])
def test_whole_grid_3d_matches_slam_tpu(runs, case):
    whole, jax_est = runs
    est = whole[case]["est"]
    assert est.shape == jax_est[case].shape
    assert_close(est, jax_est[case], atol=1e-4)
    assert bool(torch.isfinite(est).all())


def test_step_matches_slam_tpu_first_tick(runs):
    whole, jax_est = runs
    assert_close(whole["step"]["est"][:, 0], jax_est["rollout"][:, 0],
                 atol=1e-4)
