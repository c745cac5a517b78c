"""Port parity, the metrics layer and aligned ATE (slam_tpu_torch.utils.
metrics and slam2d.ate_aligned vs slam_tpu, CPU).

Ring rows are compared bit for bit (NaN rows included), except the
mean_residual a tick writes, which carries the registration's rounding
(1e-4 m^2; JAX's direct NN form patched in, as tests/test_torch_slam2d.py
does). Aligned ATE agrees to 1e-5 m.
"""

import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from slam_tpu.config import sim2d_config
from slam_tpu.ops import nn as jnn
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.sim import world2d as jw
from slam_tpu.utils import metrics as jmetrics
from slam_tpu_torch import interop
from slam_tpu_torch.config import sim3d_config
from slam_tpu_torch.pipeline import slam2d as tslam, slam3d as tslam3d
from slam_tpu_torch.sim import world3d as tw3
from slam_tpu_torch.utils import metrics
from tests.test_reference_parity import _render_frames
from tests.torch_parity import assert_close, assert_equal, to_torch

torch.set_num_threads(1)

B = 3


def _writes(n, seed=0):
    """n ring writes of three robots from alternating sites, each setting
    a different subset of channels (bools, ints and floats)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        step = np.full(B, t, np.int32)
        if t % 3 == 2:
            out.append(("graph_update", dict(
                step=step, graph_nodes=rng.integers(0, 32, B).astype(np.int32),
                graph_edges=rng.integers(0, 128, B).astype(np.int32))))
        else:
            out.append(("slam_step" if t % 3 == 0 else "slam_step_3d", dict(
                step=step, icp_ok=rng.random(B) < 0.8,
                num_corr=rng.integers(0, 400, B).astype(np.int32),
                mean_residual=rng.random(B).astype(np.float32),
                scene_points=rng.integers(0, 384, B).astype(np.int32))))
    out.append(("somewhere", dict(step=np.full(B, n, np.int32))))
    return out


@pytest.mark.parametrize("n", [5, 19])       # 19 writes wrap a ring of 8
def test_ring_write_and_drain_match_jax(n):
    writes = _writes(n)
    jring = jax.tree.map(lambda x: np.stack([np.asarray(x)] * B),
                         jmetrics.init_ring(8))
    tring = metrics.init_ring(B, 8, "cpu")
    for site, vals in writes:
        jring = jax.vmap(lambda r, v: jmetrics.ring_write(r, site=site, **v))(
            jring, vals)
        tring = metrics.ring_write(tring, site=site, **{
            k: to_torch(v) for k, v in vals.items()})
    assert_equal(tring[0], jring[0])
    assert_equal(tring[1], jring[1])
    assert metrics.drain_ring(tring) == jmetrics.drain_ring(jring)
    assert metrics.drain_ring(tring)[0]["name"] in jmetrics.RING_SITES
    assert metrics.RING_CHANNELS == jmetrics.RING_CHANNELS
    assert metrics.RING_SITES == jmetrics.RING_SITES


def test_ring_write_numbers_and_none():
    ring = metrics.init_ring(2, 4, "cpu")
    buf0 = ring[0].clone()
    new = metrics.ring_write(ring, site="graph_update", graph_nodes=3,
                             step=torch.tensor([5, 6], dtype=torch.int32))
    assert_equal(ring[0], buf0)                  # pure: the input is kept
    recs = metrics.drain_ring(new)
    assert recs == [{"name": "graph_update", "step": 5.0, "graph_nodes": 3.0},
                    {"name": "graph_update", "step": 6.0, "graph_nodes": 3.0}]
    assert metrics.ring_write(None, site="slam_step", step=1) is None
    assert metrics.drain_ring(None) == []


class _Untouchable:
    """A scalar that fails on any use: emit must not read it while
    disabled."""

    def __getattr__(self, name):
        raise AssertionError(f"read {name} while metrics are disabled")

    def __array__(self, *a, **k):
        raise AssertionError("read while metrics are disabled")


def test_emit_disabled_reads_nothing_enabled_matches_jax_records():
    metrics.disable()
    metrics.clear()
    metrics.emit("slam_step", icp_ok=_Untouchable())
    assert metrics.records() == [] and not metrics.enabled()
    seen = []
    vals = dict(icp_ok=np.array([True, False, True]),
                num_corr=np.array([10, 20, 60], np.int32),
                mean_residual=np.float32(0.25))
    assert metrics.enable(seen.append)
    try:
        metrics.emit("slam_step", **{k: to_torch(v) for k, v in vals.items()})
        metrics.emit("slam_step", num_corr=4)
    finally:
        metrics.disable()
    jmetrics.clear()
    jmetrics._record("slam_step", **vals)
    jmetrics._record("slam_step", num_corr=4)
    assert metrics.records() == jmetrics.records() == seen
    assert metrics.summary() == jmetrics.summary()
    jmetrics.clear()
    metrics.clear()
    metrics.emit("slam_step", num_corr=1)
    assert metrics.records() == []


def test_ate_aligned_matches_jax():
    """Trajectories rigidly moved off the truth (rotation and offset) plus
    noise, one robot a reflection-free identity, one nearly straight."""
    rng = np.random.default_rng(2)
    T = 50
    true = np.cumsum(rng.normal(0, 0.2, (4, T, 3)), 1).astype(np.float32)
    true[3, :, 1] = 0.01 * np.arange(T)
    th = rng.uniform(-0.3, 0.3, 4)
    th[0] = 0.0
    c, s = np.cos(th)[:, None], np.sin(th)[:, None]
    est = true.copy()
    est[..., 0] = c * true[..., 0] - s * true[..., 1] + 1.5
    est[..., 1] = s * true[..., 0] + c * true[..., 1] - 0.7
    est += rng.normal(0, 0.02, est.shape).astype(np.float32)
    want = jax.vmap(jslam.ate_aligned)(est, true)
    got = tslam.ate_aligned(to_torch(est), to_torch(true))
    assert_close(got, want, atol=1e-5)
    assert (got < tslam.ate(to_torch(est), to_torch(true))).all()
    assert (got < 0.05).all()


def _direct_sq_dist(q, m):
    d = q[..., :, None, :] - m[..., None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]


def test_tick_ring_matches_jax():
    """Three "points" ticks on external frames, each side from the same
    JAX start state carrying a ring: the rows they write agree."""
    cfg = sim2d_config()
    cfg = dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp,
                                                           matcher="points"))
    world = jw.make_world(jax.random.PRNGKey(42), cfg.sim)
    ranges, hits, cmds, _ = _render_frames(cfg, world, 3)
    st = jslam.init_state(jax.random.PRNGKey(0), cfg, calibrate_gyro=False,
                          with_metrics_ring=True, metrics_ring_capacity=4)
    ts = interop.state_from_numpy(jax.tree.map(lambda x: np.asarray(x)[None],
                                               st), "cpu")
    ang = np.arange(cfg.sim.num_beams) * (2 * np.pi / cfg.sim.num_beams)
    step = jax.jit(lambda s, sc, h, g, c: jslam.slam_step_io(s, sc, h, g, c,
                                                            cfg))
    for t in range(3):
        scan = np.stack([ranges[t] * np.cos(ang), ranges[t] * np.sin(ang),
                         np.zeros_like(ranges[t])], -1).astype(np.float32)
        gyro = np.float32(cmds[t][2])
        with mock.patch.object(jnn, "pairwise_sq_dist", _direct_sq_dist):
            st = step(st, scan, hits[t], gyro, cmds[t])
        ts = tslam.slam_step_io(
            ts, to_torch(scan)[None], to_torch(np.array(hits[t]))[None],
            torch.tensor([gyro]), to_torch(np.array(cmds[t], np.float32))[None],
            cfg)
    want, got = np.asarray(st.metrics_ring[0]), ts.metrics_ring[0][0].numpy()
    res = jmetrics.RING_CHANNELS.index("mean_residual")
    assert_close(got[..., res], want[..., res], atol=1e-4)
    got[..., res] = want[..., res]
    assert_equal(got, want)
    assert int(ts.metrics_ring[1][0]) == int(st.metrics_ring[1]) == 3
    assert [r["name"] for r in metrics.drain_ring(ts.metrics_ring)] == \
        ["slam_step"] * 3


def test_3d_tick_writes_its_ring_row():
    """The 3D tick writes one slam_step_3d row per robot with the four
    registration channels (slam3d.py's site); the graph ones stay unset."""
    cfg = sim3d_config()
    gen = torch.Generator().manual_seed(0)
    world = tw3.make_world(gen, cfg.sim, device="cpu")
    st = tslam3d.init_state_3d(cfg, 1, world, device="cpu", generator=gen)
    st = st.replace(metrics_ring=metrics.init_ring(1, 4, "cpu"))
    st, _ = tslam3d.slam_step_3d(st, world,
                                 tslam3d.init_ground_map(cfg, 1, "cpu"), cfg,
                                 gen)
    (rec,) = metrics.drain_ring(st.metrics_ring)
    assert rec["name"] == "slam_step_3d" and rec["step"] == 0.0
    assert set(rec) == {"name", "step", "icp_ok", "num_corr",
                        "mean_residual", "scene_points"}
    assert rec["scene_points"] == float(st.prev_scene.valid.sum())
