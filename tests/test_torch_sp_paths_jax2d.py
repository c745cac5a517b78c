"""Port parity, the sp axis's 2D paths against slam_tpu: the port's
whole-grid runs of tests/test_torch_sp_paths.py's 2D cases
(dryrun_multichip's scale engines with the "grid" matcher, and MLS plus
relocalization with robot 0 lost; B = 8, noise off; graph mode is
tests/test_torch_sp_paths_jaxgraph.py's) against slam_tpu's unsharded
runs on the same inputs (slam_tpu's initial states carried across).
tests/test_torch_sp_paths.py holds the split runs to these whole-grid
runs within 1e-5; this module, with its slam_tpu compiles, holds the
whole-grid runs to slam_tpu within 1e-4.

slam_tpu runs with the direct NN form patched in; the MLS case
("fused") as on a TPU, Pallas in interpret mode, as
tests/test_torch_graph.py runs it.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.geometry import se2_apply as jse2_apply
from slam_tpu.mapping import mls as jmls
from slam_tpu.ops import nn as jnn
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.pipeline.relocalize import fleet_relocalize_if_lost as jreloc
from slam_tpu.types import PointCloud as JCloud
from slam_tpu_torch.parallel import mesh as tmesh
from tests import torch_sp_paths_worker as W
from tests.test_torch_graph import as_on_tpu
from tests.test_torch_icp3d import _direct_sq_dist
from tests.test_torch_sp_paths import B, TWO_D, jax_inputs
from tests.torch_parity import assert_close

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    cfgs, j, st, port = jax_inputs(TWO_D)
    world = st["world"]
    out = {}
    with mock.patch.object(jnn, "pairwise_sq_dist", _direct_sq_dist):
        _, (est, _) = jax.jit(jax.vmap(lambda x: jslam.rollout(
            x, world, j["grid2d"], 8)))(st["states_grid"])
        out["grid2d"] = est
        with as_on_tpu():
            cm = j["mls"]

            @jax.jit
            def mls_step(s, g):
                s = jax.vmap(lambda x: jslam.slam_step(x, world, cm))(s)
                scene = s.prev_scene
                xy = jax.vmap(jse2_apply)(s.pose[:, :3], scene.xyz[..., :2])
                cloud = JCloud(
                    xyz=jnp.concatenate([xy, scene.xyz[..., 2:]], -1),
                    valid=scene.valid, flags=scene.flags)
                g = jax.vmap(lambda gr, cl: jmls.add_to_mls(gr, cl, cm.mls))(
                    g, cloud)
                return jreloc(s, cm, lost=jnp.arange(B) == 0), g
            s, _ = mls_step(st["states_mls"], st["mls_grids"])
            out["mls"] = s.pose[:, None]
    one = tmesh.make_mesh(1)
    whole = dict(grid2d=W.grid2d(port, one, cfgs), mls=W.mls(port, one, cfgs))
    return whole, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("case", ["grid2d", "mls"])
def test_whole_grid_2d_matches_slam_tpu(runs, case):
    whole, jax_est = runs
    est = whole[case]["est"]
    assert est.shape[:2] == jax_est[case].shape[:2]
    assert_close(est[..., :3], jax_est[case][..., :3], atol=1e-4)
    assert bool(torch.isfinite(est).all())
