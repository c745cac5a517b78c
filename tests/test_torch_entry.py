"""The port's user entry points (slam_tpu_torch.run_sim2d, run_fleet,
run_sim3d, run_reloc, eviction_study, make_replay) against slam_tpu's
examples and tools, on the CPU.

- Each module's main(["--device", "cpu", ...]) at
  tests/test_examples_smoke.py's tiny sizes prints the lines that file
  checks for the counterpart ("ATE=", "keyframes=", "icp ok 8/8" on both
  shared-map fleets, "loop-closure edge from node 0 injected",
  "relocalized"), and without --device it raises when no card is
  visible.
- run_fleet.run --shared-map ("fused"), fed slam_tpu's world and initial
  states through interop with the sensor noise off (the random streams
  drop out), gives the numbers slam_tpu's functions compute for the
  example's macro. slam_tpu runs as tests/test_torch_graph.py runs it
  (`as_on_tpu`: Pallas in interpret mode, so K1 on both sides, the
  direct NN form patched in). Tolerances as there: poses 1e-4, so the
  median error 1e-4; counts exact. The example's merge counts the last
  merge once per robot; the port's folds each robot's additions once
  (test_fold_counts_each_observation_once).
- make_replay's bytes from slam_tpu's seed-42 world equal
  tools/make_replay.py's under tests/test_torch_live.py's grazing-ray
  rule.
- metrics.nan_debug raises at the first tick and field that is not
  finite, and is off by default.

tests/test_torch_entry_rollouts.py holds run_sim2d's and eviction_study's
rollouts against slam_tpu's.
"""

import dataclasses
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import sim2d_config
from slam_tpu.mapping import point_map as jpm
from slam_tpu.mapping.point_map import export_points as jexport_points
from slam_tpu.parallel.shared_map import merge_maps as jmerge_maps
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.sim import replay as jreplay
from slam_tpu.sim import world2d as jw
from slam_tpu_torch import interop, make_replay, run_fleet
from slam_tpu_torch.mapping.point_map import PointMapGrid
from slam_tpu_torch.pipeline import slam2d as tslam
from slam_tpu_torch.utils import metrics
from tests.test_torch_graph import as_on_tpu
from tests.test_torch_live import _jax_drive, _range_tolerance
from tests.torch_parity import assert_close, assert_equal, numpy_tree

torch.set_num_threads(1)

ENTRY_POINTS = ("run_sim2d", "run_fleet", "run_sim3d", "run_reloc",
                "eviction_study", "make_replay")


def _noise_free(cfg):
    return dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, range_noise=0.0, gyro_noise=0.0))


def _jax_start(cfg, batch, with_graph=False):
    """slam_tpu's seed-42 world and seed-0 states, and the port's copies."""
    world = jw.make_world(jax.random.PRNGKey(42), cfg.sim)
    st = jax.vmap(lambda k: jslam.init_state(k, cfg, with_graph=with_graph))(
        jax.random.split(jax.random.PRNGKey(0), batch))
    return (world, st, interop.world_from_numpy(numpy_tree(world), "cpu"),
            interop.state_from_numpy(numpy_tree(st), "cpu"))


@pytest.fixture
def clean_metrics():
    yield
    metrics.disable()
    metrics.clear()
    metrics.nan_debug(False)


@pytest.mark.parametrize("module,argv,lines", [
    ("run_sim2d", ["--steps", "20"], ["ATE=", "map_points=", "wrote"]),
    ("run_sim2d", ["--steps", "16", "--graph"], ["ATE=", "keyframes="]),
    ("run_fleet", ["--batch", "8", "--steps", "8", "--shared-map"],
     ["robot-steps/s on cpu", "icp ok 8/8"]),
    ("run_fleet", ["--batch", "8", "--steps", "12", "--shared-map",
                   "--matcher", "particle"],
     ["robot-steps/s on cpu", "icp ok 8/8"]),
    ("run_fleet", ["--batch", "4", "--steps", "4", "--matcher", "points",
                   "--metrics", "--debug-nans"],
     ["icp ok 4/4", "metrics over 8 records (8 steps): icp ok-rate"]),
    ("run_reloc", ["--steps", "48", "--graph"],
     ["with pose graph", "kidnapped: belief now",
      "loop-closure edge from node 0 injected", "relocalized: score"]),
    ("run_sim3d", ["--steps", "8", "--metrics"],
     ["8 steps on cpu", "xy ATE", "renders ->", "metrics: icp ok-rate"]),
    ("eviction_study", ["--max-nodes", "4", "--macros", "8"],
     ["max_nodes=4 kf_dist=1.0", "edges_dropped=", "ATE by mission quarter",
      "mean dist to nearest surviving node"]),
    ("make_replay", ["--frames", "6"], ["wrote 6 frames x 364 floats"]),
], ids=lambda v: "-".join(v) if isinstance(v, list) else v)
def test_main_prints_the_examples_lines(module, argv, lines, tmp_path,
                                        capsys, clean_metrics):
    out_flag = {"make_replay": ["--out", str(tmp_path / "scans.bin")],
                "eviction_study": [], "run_fleet": []}.get(
        module, ["--out", str(tmp_path)])
    importlib.import_module(f"slam_tpu_torch.{module}").main(
        argv + out_flag + ["--device", "cpu"])
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, out
    assert "nan" not in out.lower(), out


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_main_raises_without_a_card(module):
    argv = {"eviction_study": ["--max-nodes", "4"]}.get(module, [])
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            importlib.import_module(f"slam_tpu_torch.{module}").main(argv)


def _jax_shared_cloud_run(world, cfg, batch, n_macro, as_example=False):
    """examples/run_fleet.py's --shared-map macro for a cloud matcher, with
    the robots' additions folded into the shared grid once
    (run_fleet.fold_fleet_grids), or as_example with the example's own
    merge of the robots' grids outright."""

    @jax.jit
    def run(s):
        def macro(ss, _):
            shared = jax.tree.map(lambda a: a[0], ss.map_grid)

            def ticks(x):
                def tick(x2, _):
                    return jslam.slam_step(x2, world, cfg, refresh_map=False,
                                           shift_maps=False), None
                return jax.lax.scan(tick, x, None, length=4)[0]
            ss = jax.vmap(ticks)(ss)
            if as_example:
                merged = jmerge_maps(ss.map_grid)
            else:
                added = jmerge_maps(ss.map_grid.replace(**{
                    k: getattr(ss.map_grid, k) - getattr(shared, k)
                    for k in ("count", "sum_x", "sum_y", "sum_z")}))
                merged = added.replace(**{
                    k: getattr(added, k) + getattr(shared, k)
                    for k in ("count", "sum_x", "sum_y", "sum_z")})

            def bcast(m):
                return jnp.broadcast_to(m[None], (batch,) + m.shape)
            cloud = jexport_points(merged, cfg.cloud.map_capacity,
                                   ga_threshold=cfg.icp.ga_threshold,
                                   recall=cfg.cloud.export_recall)
            return ss.replace(map_grid=jax.tree.map(bcast, merged),
                              map_cloud=jax.tree.map(bcast, cloud)), None
        return jax.lax.scan(macro, s, None, length=n_macro)[0]
    return run


def test_run_fleet_shared_map_matches_jax():
    """Two robots, --steps 8 (two 4-tick macros) run twice, the second
    continuing the first, with the "fused" matcher and no sensor noise: the
    first macro has no target, every later one registers against the
    shared map's export. slam_tpu's macro is the example's, its merge
    folding each robot's additions once."""
    cfg = _noise_free(sim2d_config())
    B = 2
    world, st, tworld, tst = _jax_start(cfg, B)
    run = _jax_shared_cloud_run(world, cfg, B, 2)
    with as_on_tpu():
        fin = run(run(st))
    got = run_fleet.run(cfg, tworld, tst, 8, torch.Generator(),
                        shared_map=True)
    final = got["final"]
    assert_close(final.pose, fin.pose, atol=1e-4)
    assert_equal(final.scan_reg_ok, fin.scan_reg_ok)
    assert got["icp_ok"] == int(fin.scan_reg_ok.sum()) == B
    err = np.linalg.norm(np.asarray(fin.pose[:, :2] - fin.true_pose[:, :2]),
                         axis=1)
    assert abs(got["median_err"] - float(np.median(err))) < 1e-4
    assert_equal(final.map_grid.count, fin.map_grid.count)
    assert_equal(final.map_cloud.valid, fin.map_cloud.valid)
    # every robot holds a copy of its own: no two share storage
    assert final.map_grid.count[0].data_ptr() != \
        final.map_grid.count[1].data_ptr()


def test_fold_counts_each_observation_once():
    """fold_fleet_grids on robots' grids that are the shared grid S plus
    their own additions n_b: S + sum n_b. The example's merge of the grids
    outright (slam_tpu's merge_maps on the same grids) gives B S + sum
    n_b, the previous merge counted B times over."""
    rng = np.random.default_rng(5)
    B, G = 3, 16
    S = rng.integers(0, 50, (1, G, G)).astype(np.float32)
    n = rng.integers(0, 5, (B, G, G)).astype(np.float32)
    sx = rng.normal(0, 1, (1, G, G)).astype(np.float32)
    nx = rng.normal(0, 1, (B, G, G)).astype(np.float32)
    z = np.zeros((B, G, G), np.float32)

    def grid(c, x, b):
        return PointMapGrid(count=torch.as_tensor(c), sum_x=torch.as_tensor(x),
                            sum_y=torch.zeros(b, G, G),
                            sum_z=torch.zeros(b, G, G),
                            center=torch.zeros(b, 2), resolution=0.5)
    got = run_fleet.fold_fleet_grids(grid(S, sx, 1), grid(S + n, sx + nx, B))
    assert_equal(got.count[0], S[0] + n.sum(0))
    assert_close(got.sum_x[0], sx[0] + nx.sum(0), atol=1e-5)
    ex = jmerge_maps(jpm.PointMapGrid(
        count=jnp.asarray(S + n), sum_x=jnp.asarray(sx + nx),
        sum_y=jnp.asarray(z), sum_z=jnp.asarray(z),
        center=jnp.zeros((B, 2)), resolution=0.5))
    assert_equal(ex.count, B * S[0] + n.sum(0))


def test_make_replay_bytes_match_jax(tmp_path):
    cfg = sim2d_config()
    world = jw.make_world(jax.random.PRNGKey(42), cfg.sim)
    n = 12
    want = jreplay.synth_frames(world, cfg.sim, n, seed=3)
    path = tmp_path / "scans.bin"
    r = make_replay.run(cfg, interop.world_from_numpy(numpy_tree(world),
                                                      "cpu"), n, str(path), 3)
    got = np.fromfile(path, dtype="<f4").reshape(n, -1)
    assert (r["frames"], r["floats"], r["nbytes"]) == (n, want.shape[1],
                                                        want.nbytes)
    nb = cfg.sim.num_beams
    assert_equal(got[:, :nb] == cfg.sim.beam_max_range,
                 want[:, :nb] == cfg.sim.beam_max_range)
    _, poses = _jax_drive(n)
    err = np.abs(got[:, :nb].astype(np.float64) - want[:, :nb])
    assert (err <= _range_tolerance(world, poses, want[:, :nb])).all()
    assert_close(got[:, nb:], want[:, nb:], atol=1e-6)


def _nan_at_tick(n):
    """slam_step, with a NaN written into the EKF mean from tick n on."""
    step = tslam.slam_step

    def poisoned(s, *a, **k):
        s = step(s, *a, **k)
        if int(s.step[0]) > n:
            s = s.replace(ekf=s.ekf.replace(mu=s.ekf.mu * float("nan")))
        return s
    return mock.patch.object(tslam, "slam_step", poisoned)


def test_nan_debug_raises_at_the_first_bad_tick(clean_metrics):
    cfg = sim2d_config()
    gen = torch.Generator().manual_seed(0)
    world = tslam.world2d.make_world(gen, cfg.sim, device="cpu")
    st = tslam.init_state(cfg, 2, device="cpu", generator=gen)
    with _nan_at_tick(2):
        tslam.rollout(st, world, cfg, 4, gen)          # off: runs through
        metrics.nan_debug(True)
        with pytest.raises(FloatingPointError,
                           match=r"tick 2: state\.ekf\.mu is not finite"):
            tslam.rollout(st, world, cfg, 4, gen)
