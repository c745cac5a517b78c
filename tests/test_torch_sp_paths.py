"""Port parity, the sp axis beyond the 2D ticks: four gloo processes on the
CPU (tests/torch_sp_paths_worker.py, launched once for the module) split
each robot's grids by rows on the (dp, sp) layouts 1 x 4 and 2 x 2, and
run slam_tpu's dryrun_multichip paths at its tiny shapes, B = 8, sensor
noise off (the 2D cases with 360 beams and 64-cell grids, the 3D ones
with 64 azimuths: tests/torch_sp_paths_worker.py says why):
- the 3D reference-scale engines (grid scene builder, "grid" matcher,
  grid height, GroundMap.grid split too): one slam_step_3d without
  shifts, a 2-macro rollout_3d, and one 4-tick macro of
  rollout_3d_with_graph;
- the 2D scale engines with the "grid" matcher, a 2-macro rollout;
- graph mode, two macros of 4 ticks and a graph tick;
- MLS plus relocalization, robot 0 flagged lost.

Tolerances:
- against one process of the port on whole grids: poses within 1e-5,
  grid counts and flags exact, sums within 1e-4; the "grid" field's rows
  (px, py, valid) stitched from the slabs equal to the whole grid's in
  bits, n_class equal;
- against slam_tpu unsharded, on the same inputs (slam_tpu's initial
  states carried across): the port's whole-grid runs are held to
  slam_tpu's within 1e-4 in tests/test_torch_sp_paths_jax3d.py,
  tests/test_torch_sp_paths_jax2d.py and
  tests/test_torch_sp_paths_jaxgraph.py (slam_tpu's compiles there, apart
  from this module's gloo world);
- the replicated state (pose, EKF, map cloud, scene, graph nodes and
  edges) bit-identical on the ranks of each sp group;
- every split leaf on a rank is (B / dp, H / sp, W, ...).
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from slam_tpu import config as jconfig
from slam_tpu.mapping import mls as jmls
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.pipeline import slam3d as jslam3
from slam_tpu.sim import world2d as jw
from slam_tpu.sim import world3d as jw3
from slam_tpu_torch import interop
from slam_tpu_torch.parallel import mesh as tmesh
from tests import torch_sp_paths_worker as W
from tests.torch_parity import assert_close, assert_equal, numpy_tree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
B = 8
G = 32              # the 3D cases' grids; the 2D cases' are 64 a side
LAYOUTS = {4: (1, 4), 2: (2, 2)}      # sp: (dp, sp)
CASES = [("ref3d", "step"), ("ref3d", "rollout"), ("ref3d", "graph"),
         ("grid2d", None), ("graph", None), ("mls", None)]
IDS = ["3d-step", "3d-rollout", "3d-graph", "grid2d", "graph", "mls-reloc"]


def jax_config(port_cfg):
    """slam_tpu's SlamConfig with every field of the port's."""
    base = jconfig.SlamConfig()
    return dataclasses.replace(base, **{
        f.name: dataclasses.replace(
            getattr(base, f.name),
            **{g.name: getattr(getattr(port_cfg, f.name), g.name)
               for g in dataclasses.fields(getattr(port_cfg, f.name))})
        for f in dataclasses.fields(port_cfg)
        if dataclasses.is_dataclass(getattr(port_cfg, f.name))})


TWO_D = ("world", "states_grid", "states_graph", "states_mls", "mls_grids")
THREE_D = ("world3", "states3", "states3g", "gm3")


@functools.lru_cache(maxsize=2)
def jax_inputs(names=TWO_D + THREE_D):
    """(port configs, slam_tpu configs, slam_tpu's worlds and initial
    states named `names` (B = 8, keys split from PRNGKey(0), the worlds
    seeded 42), the same carried across to the port)."""
    cfgs = W.configs()
    j = {k: jax_config(c) for k, c in cfgs.items()}
    keys = jax.random.split(jax.random.PRNGKey(0), B)

    def each(f):
        return jax.jit(jax.vmap(f))(keys)
    make = dict(
        world=lambda: jax.jit(lambda k: jw.make_world(k, j["grid2d"].sim))(
            jax.random.PRNGKey(42)),
        world3=lambda: jax.jit(lambda k: jw3.make_world(k, j["ref3d"].sim))(
            jax.random.PRNGKey(42)),
        states_grid=lambda: each(lambda k: jslam.init_state(k, j["grid2d"])),
        states_graph=lambda: each(lambda k: jslam.init_state(
            k, j["graph"], with_graph=True)),
        states_mls=lambda: each(lambda k: jslam.init_state(k, j["mls"])),
        states3=lambda: each(lambda k: jslam3.init_state_3d(
            k, j["ref3d"], st["world3"])),
        states3g=lambda: each(lambda k: jslam3.init_state_3d(
            k, j["ref3d_graph"], st["world3"], with_graph=True)),
        gm3=lambda: each(lambda _: jslam3.init_ground_map(j["ref3d"])),
        mls_grids=lambda: each(lambda _: jmls.init_mls(j["mls"].mls)))
    st = {}
    for k in names:
        st[k] = make[k]()
    carry = dict(world=interop.world_from_numpy,
                 world3=interop.world3d_from_numpy,
                 gm3=interop.ground_map_from_numpy,
                 mls_grids=interop.mls_grid_from_numpy)
    port = {k: carry.get(k, interop.state_from_numpy)(numpy_tree(v), "cpu")
            for k, v in st.items()}
    return cfgs, j, st, port


def whole_runs(port, cfgs) -> dict:
    """The four paths in one process of the port on whole grids."""
    one = tmesh.make_mesh(1)
    return dict(ref3d=W.ref3d(port, one, cfgs),
                grid2d=W.grid2d(port, one, cfgs),
                graph=W.graph(port, one, cfgs), mls=W.mls(port, one, cfgs))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """slam_tpu's inputs carried across, the four ranks' results and the
    port's whole-grid runs."""
    cfgs, _, _, inputs = jax_inputs()
    work = tmp_path_factory.mktemp("sp_paths")
    torch.save(inputs, work / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_sp_paths_worker", str(r),
         str(WORLD), str(work)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        whole = whole_runs(inputs, cfgs)      # while the ranks run
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
    return dict(ranks=ranks, whole=whole)


def _get(out, case):
    path, sub = case
    return out[path] if sub is None else out[path][sub]


def _runs(setup, sp, case):
    return [_get(r[sp], case) for r in setup["ranks"]]


def test_layout_and_slabs(setup):
    """make_fleet_mesh(sp) on four ranks; each rank holds (B / dp, H / sp,
    W) of every grid, GroundMap.grid and the MLS banks included."""
    for sp, (dp, _) in LAYOUTS.items():
        want = np.arange(WORLD).reshape(dp, sp).tolist()
        for r, out in enumerate(setup["ranks"]):
            assert out[sp]["mesh"] == want
            for case in CASES:
                got = _get(out[sp], case)
                i, j = got["coords"]
                assert want[i][j] == r
                g = G if case[0] == "ref3d" else 64
                for k, shape in got["shapes"].items():
                    assert shape[:3] == (B // dp, g // sp, g), (case, k)


@pytest.mark.parametrize("sp", LAYOUTS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_grids_match_whole_grids(setup, sp, case):
    """Poses 1e-5 against the port on whole grids, counts and flags
    exact, sums 1e-4."""
    want = _get(setup["whole"], case)
    for got in _runs(setup, sp, case):
        assert got["est"].shape == want["est"].shape
        assert_close(got["est"], want["est"], atol=1e-5)
        assert_close(got["true"], want["true"], atol=1e-5)
        for k, g in got["grids"].items():
            w = want["grids"][k]
            g, w = getattr(g, "grid", g), getattr(w, "grid", w)
            for f in dataclasses.fields(g):
                a, b = getattr(g, f.name), getattr(w, f.name)
                if not isinstance(a, torch.Tensor):
                    continue
                if a.is_floating_point() and f.name not in (
                        "count", "counts", "num_pts"):
                    assert_close(a, b, atol=1e-4, what=f"{k}.{f.name}")
                else:
                    assert_equal(a, b)
    assert bool(torch.isfinite(want["est"]).all())


@pytest.mark.parametrize("sp", LAYOUTS)
@pytest.mark.parametrize("case", [("ref3d", "rollout"), ("grid2d", None)],
                         ids=["3d", "2d"])
def test_field_slabs_are_whole_rows(setup, sp, case):
    """The "grid" field built on each rank's slab is the whole grid's rows
    in bits (the map grids match exactly on the CPU, so the whole-grid
    run's field is the reference), n_class the whole grid's."""
    dp = LAYOUTS[sp][0]
    want = _get(setup["whole"], case)["field"]
    runs = _runs(setup, sp, case)
    for i in range(dp):
        row = sorted((r["coords"][1], r["field"]) for r in runs
                     if r["coords"][0] == i)
        robots = slice(i * B // dp, (i + 1) * B // dp)
        for k in range(3):
            assert_equal(torch.cat([f[k] for _, f in row], 2),
                         want[k][robots])
        for _, f in row:
            assert_equal(f[3], want[3][robots])
    assert int(want[2].sum()) > 0


@pytest.mark.parametrize("sp", LAYOUTS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replicated_state_within_sp_groups(setup, sp, case):
    """The per-robot state outside the grids is bit-identical on the
    ranks of each dp row."""
    dp = LAYOUTS[sp][0]
    runs = _runs(setup, sp, case)
    for i in range(dp):
        row = [runs[r]["replicated"] for r in range(i * sp, (i + 1) * sp)]
        for other in row[1:]:
            for k, v in row[0].items():
                assert torch.equal(v, other[k]), (i, k)


def test_the_paths_did_their_work(setup):
    """Not vacuous: the 3D and 2D point maps and the ground map filled,
    the "grid" fits registered, every graph holds a second keyframe (the
    2D ones an edge), and the MLS banks took the scene."""
    whole = setup["whole"]
    roll = whole["ref3d"]["rollout"]
    assert float(roll["grids"]["ground"].grid.count.sum()) > 0
    assert float(roll["grids"]["map_grid"].count.sum()) > 0
    assert bool(roll["replicated"]["ok"].all())
    assert bool(whole["grid2d"]["replicated"]["ok"].all())
    assert int(whole["graph"]["replicated"]["n_edges"].min()) >= 1
    for g in (whole["graph"], whole["ref3d"]["graph"]):
        assert int(g["replicated"]["n_nodes"].min()) >= 2
    assert float(whole["mls"]["grids"]["mls"].num_pts.sum()) > 0
