"""Port parity, the sp axis: four gloo processes on the CPU
(tests/torch_sp_worker.py, launched once for the module) split each
robot's grids by rows, on the (dp, sp) layouts 1 x 4 and 2 x 2 (slam_tpu's
dryrun_multichip layout), against one process of the port on whole grids
and against slam_tpu, as tests/test_spatial_sharding.py holds slam_tpu's
sharded runs to its unsharded ones.

Tolerances:
- config 1 (tests/test_spatial_sharding.py's setup: B = 8 sim2d_config
  robots, 8 ticks; sensor noise off, as tests/test_torch_distributed.py's
  case (a)): "points" against slam_tpu (direct NN form patched in) poses
  1e-4; "points" and "fused" against the port's whole-grid run poses
  1e-5, local_map counts exact, drivable equal, map_grid channels 1e-4;
- the MLS banks (test_mls_banks_sharded_equivalence's inputs): 1e-5
  against slam_tpu and the port's whole grid, counts and drivability
  exact;
- the merger on dp2 x sp2 (test_shared_map_merge_replication_checked's
  grids): counts exact, sums 1e-5, against slam_tpu's merger on
  make_mesh(8, sp=2) and merge_maps; a moved dp shard gives NaN counts;
- fleet_rollout_shared (case (c) of test_torch_distributed.py): the
  shared grid bit-identical on all four ranks; trajectories 1e-5 and
  counts exact against one process of the port;
- every split leaf on a rank is (B / dp, H / sp, W, ...), and the state
  outside the grids is bit-identical on the ranks of each sp group.
"""

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

from slam_tpu.config import MlsConfig as JMlsConfig
from slam_tpu.mapping import mls as jmls
from slam_tpu.mapping import point_map as jpm
from slam_tpu.ops import nn as jnn
from slam_tpu.parallel import mesh as jmesh
from slam_tpu.parallel import shared_map as jsm
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.sim import world2d as jw
from slam_tpu.types import cloud_from_xyz as jcloud
from slam_tpu_torch import interop
from slam_tpu_torch.config import MlsConfig
from slam_tpu_torch.mapping.mls import init_mls
from slam_tpu_torch.mapping.point_map import PointMapGrid
from slam_tpu_torch.parallel import shared_map as tsm
from slam_tpu_torch.pipeline import slam2d as tslam
from tests.test_torch_distributed import _cfg, _direct_sq_dist, _pf_start
from tests.torch_parity import assert_close, assert_equal, numpy_tree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
B = 8
LAYOUTS = {4: (1, 4), 2: (2, 2)}      # sp: (dp, sp)
MLS_KW = dict(size_x=64, size_y=64, resolution=0.5, max_range=30.0,
              update_dist=32)


def _mls_inputs():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-12, 12, (B, 256, 3)).astype(np.float32)
    xyz[..., 2] = rng.uniform(-0.5, 2.0, (B, 256)).astype(np.float32)
    return xyz


def _merge_inputs():
    B, G = 8, 64
    rng = np.random.default_rng(1)
    pts = rng.uniform(-10, 10, (B, 128, 3)).astype(np.float32)
    grids = jax.vmap(lambda _: jpm.init_point_map(G))(jnp.arange(B))
    return jax.vmap(lambda g, p: jpm.update_point_map(
        g, p, jnp.ones(128, bool), 0.5))(grids, jnp.array(pts))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """slam_tpu's inputs carried across, the four ranks' results, and
    slam_tpu's own runs."""
    cfg = _cfg("points")
    pcfg = _cfg("particle", num_particles=1, score_stride=4)
    world = jw.make_world(jax.random.PRNGKey(42), cfg.sim)
    st = jax.vmap(lambda k: jslam.init_state(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), B))
    pst = _pf_start(pcfg)
    pshared = jpm.init_point_map(pcfg.mls.size_x, pcfg.icp.voxel_leaf_obs[0])
    mls_xyz = _mls_inputs()
    jgrids = _merge_inputs()
    t = torch.from_numpy
    mcfg = MlsConfig(**MLS_KW)
    inputs = dict(
        world=interop.world_from_numpy(numpy_tree(world), "cpu"),
        fleet_states=interop.state_from_numpy(numpy_tree(st), "cpu"),
        pf_states=interop.state_from_numpy(numpy_tree(pst), "cpu"),
        pf_shared=interop.point_map_from_numpy(numpy_tree(pshared), "cpu"),
        mls_cfg=mcfg, mls_grids=init_mls(mcfg, B, device="cpu"),
        mls_xyz=t(mls_xyz),
        merge_grids=PointMapGrid(
            **{n: t(np.array(getattr(jgrids, n))) for n in
               (*tsm.CHANNELS, "center")}, resolution=0.5))
    work = tmp_path_factory.mktemp("sp")
    torch.save(inputs, work / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_sp_worker", str(r), str(WORLD),
         str(work)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        # slam_tpu's runs while the ranks run
        with mock.patch.object(jnn, "pairwise_sq_dist", _direct_sq_dist):
            _, (jest, _) = jax.jit(jax.vmap(
                lambda s: jslam.rollout(s, world, cfg, 8)))(st)
        jmcfg = JMlsConfig(**MLS_KW)
        jmls_out = jax.jit(jax.vmap(lambda g, c: jmls.add_to_mls(
            g, c, jmcfg)))(jax.vmap(lambda _: jmls.init_mls(jmcfg))(
                jnp.arange(B)), jcloud(jnp.array(mls_xyz)))
        jmerged = jsm.make_shared_map_merger(jmesh.make_mesh(8, sp=2))(jgrids)
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(inputs=inputs, ranks=ranks, cfg=cfg, pcfg=pcfg,
                jax_est=jest, jax_mls=jmls_out, jax_merged=jmerged)


@pytest.fixture(scope="module")
def whole(setup):
    """The port's own whole-grid runs in this process."""
    inp = setup["inputs"]
    out = {}
    for m in ("points", "fused"):
        fin, (est, true) = tslam.rollout(
            inp["fleet_states"], inp["world"], _cfg(m), 8,
            torch.Generator().manual_seed(0))
        out[m] = (fin, est, true)
    out["shared"] = tsm.fleet_rollout_shared(
        inp["pf_states"], inp["pf_shared"], inp["world"], setup["pcfg"], 2,
        generator=torch.Generator())
    return out


def _runs(setup, sp, case):
    return [r[sp][case] for r in setup["ranks"]]


@pytest.mark.parametrize("sp", LAYOUTS)
def test_layout_and_slabs(setup, sp):
    """make_fleet_mesh(sp) on four ranks is slam_tpu's make_mesh(4, sp);
    each rank holds (B / dp, H / sp, W) of every grid leaf, block j."""
    dp, _ = LAYOUTS[sp]
    want = np.arange(WORLD).reshape(dp, sp).tolist()
    for r, out in enumerate(setup["ranks"]):
        assert out[sp]["mesh"] == want
        i, j = out[sp]["coords"]
        assert want[i][j] == r
        occ, pm = out[sp]["points"]["shapes"]
        assert occ["counts"] == occ["drivable"] == (B // dp, 192 // sp, 192)
        assert occ["center"] == (B // dp, 2)
        assert pm["count"] == pm["sum_z"] == (B // dp, 192 // sp, 192)
        assert out[sp]["points"]["rows"] == (j, 192)
        assert out[sp]["mls"]["shape"]["mean"] == (B // dp, 64 // sp, 64, 4,
                                                   3)


@pytest.mark.parametrize("sp", LAYOUTS)
@pytest.mark.parametrize("matcher", ["points", "fused"])
def test_config1_matches_whole_grids(setup, whole, sp, matcher):
    fin, est, true = whole[matcher]
    for got in _runs(setup, sp, matcher):
        assert got["est"].shape == (B, 8, 3)
        assert_close(got["est"], est, atol=1e-5)
        assert_close(got["true"], true, atol=1e-5)
        assert_equal(got["local_map"].counts, fin.local_map.counts)
        assert_equal(got["local_map"].drivable, fin.local_map.drivable)
        for n in tsm.CHANNELS:
            assert_close(getattr(got["map_grid"], n),
                         getattr(fin.map_grid, n), atol=1e-4)
        if matcher == "points":
            assert_close(got["est"], setup["jax_est"], atol=1e-4)
    assert float(fin.local_map.counts.sum()) > 0


@pytest.mark.parametrize("sp", LAYOUTS)
@pytest.mark.parametrize("case", ["points", "fused", "shared"])
def test_replicated_state_within_sp_groups(setup, sp, case):
    """The per-robot state outside the grids is bit-identical on the
    ranks of each dp row."""
    dp, _ = LAYOUTS[sp]
    runs = _runs(setup, sp, case)
    for i in range(dp):
        row = [runs[r]["replicated"] for r in range(i * sp, (i + 1) * sp)]
        for other in row[1:]:
            for k, v in row[0].items():
                assert torch.equal(v, other[k]), (i, k)


@pytest.mark.parametrize("sp", LAYOUTS)
def test_mls_banks_split_by_rows(setup, sp):
    want = setup["jax_mls"]
    for got in _runs(setup, sp, "mls"):
        g = got["grid"]
        assert_equal(g.num_pts, want.num_pts)
        assert_equal(g.drivable, want.drivable)
        assert_close(g.mean, want.mean, atol=1e-5)
        assert_close(g.var_z, want.var_z, atol=1e-5)
    assert int((np.asarray(want.drivable) == 1).sum()) > 0


def test_merger_on_dp2_sp2(setup):
    want = setup["jax_merged"]
    plain = tsm.merge_maps(setup["inputs"]["merge_grids"])
    runs = _runs(setup, 2, "merger")
    for got in runs:
        a = got["aligned"]
        assert a.count.shape == (1, 64, 64)
        assert_equal(a.count[0], want.count)
        assert_equal(a.count, plain.count)
        for n in ("sum_x", "sum_y", "sum_z"):
            assert_close(getattr(a, n)[0], getattr(want, n), atol=1e-5)
            assert_close(getattr(a, n), getattr(plain, n), atol=1e-5)
        assert bool(torch.isnan(got["misaligned"].count).all())
        assert_equal(got["misaligned"].center, plain.center)
    for got in runs[1:]:        # the replicas agree to the bit
        for n in tsm.CHANNELS:
            assert torch.equal(getattr(got["aligned"], n),
                               getattr(runs[0]["aligned"], n))


@pytest.mark.parametrize("sp", LAYOUTS)
def test_shared_rollout_with_split_local_maps(setup, whole, sp):
    fin, one, (est, true) = whole["shared"]
    runs = _runs(setup, sp, "shared")
    for n in tsm.CHANNELS:         # bit-identical on all four ranks
        for got in runs[1:]:
            assert torch.equal(getattr(got["shared"], n),
                               getattr(runs[0]["shared"], n))
    for got in runs:
        assert_close(got["est"], est, atol=1e-5)
        assert_close(got["true"], true, atol=1e-5)
        assert_equal(got["shared"].count, one.count)
        assert_close(got["shared"].sum_x, one.sum_x, atol=1e-5)
        assert_equal(got["local_map"].counts, fin.local_map.counts)
    assert float(one.count.sum()) > 0
