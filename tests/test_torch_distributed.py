"""Port parity, the fleet over ranks: two real gloo processes on the CPU
(tests/torch_dist_worker.py) against one process of the port and against
slam_tpu, as tests/test_two_process_distributed.py does for JAX.

The two ranks are launched once for the module; they meet through a file
store in a temporary directory (no fixed port), run every case and write
their results there.

Tolerances:
- (a) config 1 over dp: B = 8 sim2d_config robots, "points" matcher,
  sensor noise off (no random draw reaches the result), 8 ticks: the
  gathered trajectories equal one process of the port to 1e-5 and
  slam_tpu's run to 1e-4 (the tolerance of JAX's own two-process test;
  slam_tpu runs with the direct NN form patched in, the port's form, as
  tests/test_torch_slam2d.py does).
- (b) make_shared_map_merger over 2 ranks x 4 grids against slam_tpu's
  merger on 8 virtual devices and against merge_maps: counts exact, sums
  1e-5 (the ranks sum in another order); grids moved on rank 1 only give
  NaN counts on both ranks.
- (c) fleet_rollout_shared with a 2-rank mesh, one robot a rank,
  tests/test_torch_shared_map.py's noise-free one-particle setup, 2
  macros: against one process of the port trajectories 1e-5, counts
  exact; against slam_tpu that file's tolerances (trajectories 1e-5,
  counts exact, offset sums 2e-3).
- (d) mesh_scaling (the ref-scale "grid" fleet) at B = 2: sp = 1 gives
  the same rows on both ranks; with --sp 2 each rank holds half of every
  grid's rows, and the poses equal one process's run of the same robots
  on whole grids to 1e-5 and each other in bits.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import sim2d_config
from slam_tpu.mapping import point_map as jpm
from slam_tpu.ops import nn as jnn
from slam_tpu.parallel import mesh as jmesh
from slam_tpu.parallel import shared_map as jsm
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.sim import world2d as jw
from slam_tpu_torch import interop, mesh_scaling
from slam_tpu_torch.mapping.point_map import PointMapGrid
from slam_tpu_torch.parallel import multihost
from slam_tpu_torch.parallel import shared_map as tsm
from slam_tpu_torch.pipeline import slam2d as tslam
from tests.torch_parity import assert_close, assert_equal, numpy_tree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
B = 8


def _cfg(matcher, **pf):
    c = sim2d_config()
    return dataclasses.replace(
        c, icp=dataclasses.replace(c.icp, matcher=matcher),
        pf=dataclasses.replace(c.pf, **pf),
        sim=dataclasses.replace(c.sim, range_noise=0.0, gyro_noise=0.0))


def _direct_sq_dist(q, m):
    d = q[..., :, None, :] - m[..., None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]


def _grids(G=16, seed=3):
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 4, (B, G, G)).astype(np.float32)
    sx, sy, sz = (rng.normal(0, 0.1, (B, G, G)).astype(np.float32)
                  for _ in range(3))
    center = np.tile(np.array([[1.5, -2.0]], np.float32), (B, 1))
    return count, sx, sy, sz, center


def _pf_start(cfg):
    st = jax.vmap(lambda k: jslam.init_state(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), WORLD)).replace(map_grid=None)
    start = jnp.array([[0.0, 0.0, 0.0, 0.0], [2.0, -1.5, 0.6, 0.0]])
    return st.replace(pose=start, true_pose=start, ekf=st.ekf.replace(
        mu=st.ekf.mu.at[:, 0].set(start[:, 0]).at[:, 1].set(start[:, 1])
        .at[:, 6].set(start[:, 2])))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """slam_tpu's inputs carried across, the two ranks' results, and
    slam_tpu's own runs."""
    cfg = _cfg("points")
    pcfg = _cfg("particle", num_particles=1, score_stride=4)
    world = jw.make_world(jax.random.PRNGKey(42), cfg.sim)
    st = jax.vmap(lambda k: jslam.init_state(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), B))
    pst = _pf_start(pcfg)
    pshared = jpm.init_point_map(pcfg.mls.size_x, pcfg.icp.voxel_leaf_obs[0])
    count, sx, sy, sz, center = _grids()
    t = torch.from_numpy
    inputs = dict(
        world=interop.world_from_numpy(numpy_tree(world), "cpu"),
        fleet_states=interop.state_from_numpy(numpy_tree(st), "cpu"),
        pf_states=interop.state_from_numpy(numpy_tree(pst), "cpu"),
        pf_shared=interop.point_map_from_numpy(numpy_tree(pshared), "cpu"),
        grids=PointMapGrid(count=t(count), sum_x=t(sx), sum_y=t(sy),
                           sum_z=t(sz), center=t(center), resolution=0.5))
    work = tmp_path_factory.mktemp("dist")
    torch.save(inputs, work / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dist_worker", str(r), str(WORLD),
         str(work)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]

    with mock.patch.object(jnn, "pairwise_sq_dist", _direct_sq_dist):
        _, (jest, jtrue) = jax.jit(jax.vmap(
            lambda s: jslam.rollout(s, world, cfg, 8)))(st)
    jgrids = jpm.PointMapGrid(count=count, sum_x=sx, sum_y=sy, sum_z=sz,
                              center=center, resolution=0.5)
    jmerged = jsm.make_shared_map_merger(jmesh.make_mesh(8))(jgrids)
    jfin, jshared, (jpest, jptrue) = jax.jit(
        lambda s, sh: jsm.fleet_rollout_shared(s, sh, world, pcfg, 2))(
        pst, pshared)
    return dict(inputs=inputs, ranks=ranks, cfg=cfg, pcfg=pcfg,
                jax_fleet=(jest, jtrue), jax_merged=jmerged,
                jax_merge_maps=jsm.merge_maps(jgrids),
                jax_shared=(jfin, jshared, jpest, jptrue))


def test_ranks_form_the_group(setup):
    for r, out in enumerate(setup["ranks"]):
        assert out["world"] == WORLD and out["rank"] == r
        assert out["mesh"] == {"dp": WORLD, "sp": 1}
        assert out["local_batch"] == B // WORLD
        assert out["fleet"]["local"] == B // WORLD


def test_fleet_over_two_ranks_matches_one_process_and_slam_tpu(setup):
    inp = setup["inputs"]
    _, (est, true) = tslam.rollout(inp["fleet_states"], inp["world"],
                                   setup["cfg"], 8, torch.Generator())
    jest, jtrue = setup["jax_fleet"]
    for out in setup["ranks"]:
        got = out["fleet"]
        assert got["est"].shape == (B, 8, 3)
        assert_close(got["est"], est, atol=1e-5)
        assert_close(got["true"], true, atol=1e-5)
        assert_close(got["est"], jest, atol=1e-4)
        assert_close(got["true"], jtrue, atol=1e-4)


def test_merger_over_two_ranks_matches_slam_tpu(setup):
    want, plain = setup["jax_merged"], setup["jax_merge_maps"]
    for out in setup["ranks"]:
        got = out["merger"]["aligned"]
        assert got.count.shape == (1, 16, 16)
        assert_equal(got.count[0], want.count)
        assert_equal(got.count[0], plain.count)
        for n in ("sum_x", "sum_y", "sum_z"):
            assert_close(getattr(got, n)[0], getattr(want, n), atol=1e-5)
            assert_close(getattr(got, n)[0], getattr(plain, n), atol=1e-5)
        assert_equal(got.center[0], want.center)
    a, b = (out["merger"]["aligned"] for out in setup["ranks"])
    for n in tsm.CHANNELS:          # the replicas agree to the bit
        assert torch.equal(getattr(a, n), getattr(b, n))


def test_grids_moved_on_one_rank_poison_every_rank(setup):
    for out in setup["ranks"]:
        got = out["merger"]["misaligned"]
        assert bool(torch.isnan(got.count).all())
        assert bool(torch.isfinite(got.sum_x).all())
        # the merged centre is rank 0's robot 0, which did not move
        assert_equal(got.center[0], setup["inputs"]["grids"].center[0])


def test_shared_rollout_over_two_ranks(setup):
    inp = setup["inputs"]
    _, one, (est, true) = tsm.fleet_rollout_shared(
        inp["pf_states"], inp["pf_shared"], inp["world"], setup["pcfg"], 2,
        generator=torch.Generator())
    jfin, jshared, jest, jtrue = setup["jax_shared"]
    grids = [out["shared"]["shared"] for out in setup["ranks"]]
    for n in tsm.CHANNELS:          # the replicas agree to the bit
        assert torch.equal(getattr(grids[0], n), getattr(grids[1], n))
    for out in setup["ranks"]:
        got = out["shared"]
        assert got["est"].shape == (WORLD, 8, 3)
        assert_close(got["est"], est, atol=1e-5)
        assert_close(got["true"], true, atol=1e-5)
        assert_equal(got["shared"].count, one.count)
        assert_close(got["shared"].sum_x, one.sum_x, atol=1e-5)
        assert_close(got["shared"].sum_y, one.sum_y, atol=1e-5)
        assert_close(got["est"], jest, atol=1e-5)
        assert_close(got["true"], jtrue, atol=1e-5)
        assert_equal(got["ok"], jfin.scan_reg_ok)
        assert_equal(got["shared"].count[0], jshared.count)
        assert_close(got["shared"].sum_x[0], jshared.sum_x, atol=2e-3)
        assert_close(got["shared"].sum_y[0], jshared.sum_y, atol=2e-3)
    assert float(one.count.sum()) > 0


def test_mesh_scaling_over_two_ranks(setup):
    """python3 -m slam_tpu_torch.mesh_scaling's run() with the group up: one
    robot a rank at B = 2, the rows equal on both ranks; with --sp 2 both
    ranks step both robots on half of every grid's rows, and the fleet's
    poses equal one process's --sp 1 run of the same robots (the dp row's
    generator) within 1e-5."""
    rows = [out["scaling"]["rows"] for out in setup["ranks"]]
    assert len(rows[0]) == 1
    for a, b in zip(rows[0], rows[1]):
        assert_equal(a.pop("pose"), b.pop("pose"))
    assert rows[0] == rows[1]
    row = rows[0][0]
    assert (row["batch"], row["dp"], row["sp"], row["robots_per_rank"]) == (
        2, WORLD, 1, 1)
    assert row["finite"] and row["rate"] > 0 and row["ms_step"] > 0
    assert row["peak_mb"] == [None, None]        # not measured on the CPU
    alone = mesh_scaling.run([2], 1, 1, "cpu")[0]
    for out in setup["ranks"]:
        sp = out["scaling"]["sp_rows"][0]
        assert (sp["batch"], sp["dp"], sp["sp"], sp["robots_per_rank"]) == (
            2, 1, 2, 2)
        assert sp["finite"] and sp["rate"] > 0
        assert sp["pose"].shape == (2, 4)
        assert_close(sp["pose"], alone["pose"], atol=1e-5)
    assert torch.equal(setup["ranks"][0]["scaling"]["sp_rows"][0]["pose"],
                       setup["ranks"][1]["scaling"]["sp_rows"][0]["pose"])


def test_init_distributed_is_a_no_op_alone(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    multihost.init_distributed()
    multihost.init_distributed(backend="gloo")
    assert not torch.distributed.is_initialized()
    assert multihost.world_size() == 1 and multihost.rank() == 0
    assert multihost.host_local_batch(16) == 16
    assert multihost.make_fleet_mesh().shape == {"dp": 1, "sp": 1}


def test_two_ranks_on_one_card_are_refused():
    """init_distributed's NCCL check, on a store the test fills: a rank
    whose card another rank reports raises and names gloo; distinct cards
    pass."""
    store = torch.distributed.HashStore()
    store.set("slam_tpu_torch/card/1", "GPU-a")
    with pytest.raises(ValueError, match='backend="gloo"'):
        multihost.refuse_shared_cards(store, 0, 2, "GPU-a")
    store = torch.distributed.HashStore()
    store.set("slam_tpu_torch/card/1", "GPU-b")
    multihost.refuse_shared_cards(store, 0, 2, "GPU-a")
