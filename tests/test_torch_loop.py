"""cfg.icp.loop in the port's three fits (slam_tpu_torch vs slam_tpu, CPU):
icp_fit ("points"), icp_fit_grid ("grid") and icp3d_fit (the 6-DoF
edges).

For each fit, on the problems of its parity file:
- "while" and "scan" give bit-identical results (converged problems are
  frozen in both forms);
- each form equals slam_tpu's under the same cfg.loop, to that file's
  tolerances: icp_fit pose and mean residual 1e-4
  (tests/test_torch_nn_icp.py), icp_fit_grid pose, delta and mean
  residual 1e-5 (tests/test_torch_grid_icp.py), icp3d_fit R and t 1e-4
  and mean residual 1e-6 + 1e-3 relative (tests/test_torch_icp3d.py);
  ok and num_corr exact;
- the form is honoured: a spy on the step function counts the steps.
  "scan" runs exactly max_iterations; "while" stops after the first step
  at which every problem has converged (a delta below min_delta or no
  correspondence, or not ok from the start), which these problems reach
  before max_iterations.
"""

import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from slam_tpu.config import IcpConfig
from slam_tpu.ops import grid_icp as jg
from slam_tpu.ops import icp as jicp
from slam_tpu.ops import icp3d as jicp3d
from slam_tpu_torch.ops import grid_icp as tg
from slam_tpu_torch.ops import icp as ticp
from slam_tpu_torch.ops import icp3d as ticp3d
from tests.test_torch_grid_icp import (RES, _blobs, _ga_of_cells, _jax_field,
                                       _jax_grids)
from tests.test_torch_icp3d import ICP, _icp3d_problems, direct_nn
from tests.test_torch_nn_icp import _problem
from tests.torch_parity import assert_close, assert_equal, to_torch

torch.set_num_threads(1)

LOOPS = ("while", "scan")


class StepSpy:
    """Wraps a fit's step function: counts its calls and keeps each call's
    delta (out[d_at])."""

    def __init__(self, fn, d_at: int):
        self.fn, self.d_at, self.deltas = fn, d_at, []

    def __call__(self, *a, **k):
        out = self.fn(*a, **k)
        self.deltas.append(out[self.d_at].clone())
        return out


def _first_all_converged(ok, deltas, min_delta) -> int:
    """The step after which every problem has converged: a problem that is
    not ok starts converged, and one converges at its first delta below
    min_delta (or -1, no correspondence)."""
    conv = ~ok
    for k, d in enumerate(deltas):
        conv = conv | (d < min_delta) | (d < 0)
        if bool(conv.all()):
            return k + 1
    return len(deltas)


def _fit_both(module, step_name, d_at, fit, cfg):
    """{loop: (result, steps' deltas)} of fit(cfg with each loop form)."""
    out = {}
    for loop in LOOPS:
        spy = StepSpy(getattr(module, step_name), d_at)
        with mock.patch.object(module, step_name, spy):
            res = fit(dataclasses.replace(cfg, loop=loop))
        out[loop] = (res, spy.deltas)
    return out


def _check_forms(runs, ok, cfg):
    (w, w_d), (s, s_d) = runs["while"], runs["scan"]
    for a, b in zip(w, s):
        assert torch.equal(a, b)
    assert len(s_d) == cfg.max_iterations
    k = _first_all_converged(ok, s_d, cfg.min_delta)
    assert len(w_d) == k < cfg.max_iterations, (len(w_d), k)


def test_icp_fit_follows_loop():
    cfg = IcpConfig(max_iterations=20, inlier_dist=1.0)
    q, q_valid, q_ga, m, m_valid, m_ga = _problem(B=3, seed=4)
    q_valid[2] = False
    q_valid[2, :3] = True                # below min_scene_points
    init = np.zeros((3, 3), np.float32)
    args = [to_torch(a) for a in (q, q_valid, q_ga, m, m_valid, m_ga, init)]
    runs = _fit_both(ticp, "fit_update", 1,
                     lambda c: ticp.icp_fit(*args, c), cfg)
    ok = (args[1].sum(-1) >= cfg.min_scene_points) & (args[4].sum(-1) >= 5)
    _check_forms(runs, ok, cfg)
    for loop in LOOPS:
        c = dataclasses.replace(cfg, loop=loop)
        want = jax.jit(jax.vmap(lambda *a: jicp.icp_fit(*a, c)))(
            q, q_valid, q_ga, m, m_valid, m_ga, init)
        got = runs[loop][0]
        assert_close(got.pose, want.pose, atol=1e-4)
        assert_equal(got.ok, want.ok)
        assert_equal(got.num_corr, want.num_corr)
        assert_close(got.mean_residual, want.mean_residual, atol=1e-4)
    assert runs["while"][0].ok.tolist() == [True, True, False]


def test_icp_fit_grid_follows_loop():
    """The three robots of tests/test_torch_grid_icp.py's fit: a known
    transform, too few scene points, and a class with <= 3 map cells."""
    G = 96
    rng = np.random.default_rng(2)
    x, y = _blobs(rng, 3, 600, G)
    x[2, :300] = rng.uniform(-20, 20, 300)
    y[2, :300] = rng.uniform(-20, 20, 300)
    jgrid, tgrid = _jax_grids(x, y, np.ones(x.shape, bool), G)
    jfield = _jax_field(jgrid)
    field = tg.nearest_point_field(tgrid, RES)
    S = 256
    pts = np.stack([x[:, :S], y[:, :S]], -1)
    ci = np.floor(pts / RES).astype(int) + G // 2
    ga = np.stack([_ga_of_cells(np.asarray(jgrid.count[b]))[
        ci[b, :, 0], ci[b, :, 1]] for b in range(3)])
    th, t = 0.04, np.array([0.25, -0.15], np.float32)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                 np.float32)
    scene = ((pts - t) @ R).astype(np.float32)
    valid = np.ones((3, S), bool)
    valid[1, 3:] = False
    init = np.zeros((3, 3), np.float32)
    cfg = IcpConfig(inlier_dist=1.0, max_iterations=20, min_scene_points=5)
    args = (to_torch(scene), to_torch(valid), to_torch(ga), field,
            to_torch(init))
    runs = _fit_both(tg, "fit_step_grid", 1,
                     lambda c: tg.icp_fit_grid(*args, c), cfg)
    ok = (args[1].sum(-1) >= cfg.min_scene_points) & \
        (field.n_class.sum(-1) >= 5)
    _check_forms(runs, ok, cfg)
    for loop in LOOPS:
        c = dataclasses.replace(cfg, loop=loop)
        want = jax.jit(jax.vmap(lambda sc, va, g, f, p: jg.icp_fit_grid(
            sc, va, g, f, p, c)))(scene, valid, ga, jfield, init)
        got = runs[loop][0]
        assert_equal(got.ok, want.ok)
        assert_equal(got.num_corr, want.num_corr)
        assert_close(got.pose, want.pose, atol=1e-5)
        assert_close(got.mean_residual, want.mean_residual, atol=1e-5)
        assert_close(got.delta, want.delta, atol=1e-5)
    assert runs["while"][0].ok.tolist() == [True, False, True]


def test_icp3d_fit_follows_loop():
    args = _icp3d_problems(4)
    cfg = dataclasses.replace(ICP, max_iterations=30)
    targs = [to_torch(a) for a in args]
    runs = _fit_both(ticp3d, "fit_step_3d", 2,
                     lambda c: ticp3d.icp3d_fit(*targs, c), cfg)
    ok = (targs[1].sum(-1) >= cfg.min_scene_points) & \
        (targs[4].sum(-1) >= 5)
    _check_forms(runs, ok, cfg)
    for loop in LOOPS:
        c = dataclasses.replace(cfg, loop=loop)
        with direct_nn():
            want = jax.jit(jax.vmap(lambda *a: jicp3d.icp3d_fit(*a, c)))(
                *args)
        got = runs[loop][0]
        assert_equal(got.ok, want.ok, "ok")
        assert_equal(got.num_corr, want.num_corr, "num_corr")
        assert_close(got.R, want.R, atol=1e-4, what="R")
        assert_close(got.t, want.t, atol=1e-4, what="t")
        assert_close(got.mean_residual, want.mean_residual, atol=1e-6,
                     rtol=1e-3, what="mean_residual")
    assert runs["while"][0].ok.tolist() == [True, True, False]


@pytest.mark.parametrize("loop", LOOPS)
def test_config_loop_default_and_forms(loop):
    """The port's default is slam_tpu's ("while"), and a sweep override
    reaches every fit's config."""
    from slam_tpu_torch.config import apply_sweep_overrides, sim2d_config
    assert sim2d_config().icp.loop == "while"
    cfg = apply_sweep_overrides(sim2d_config(), f"icp.loop={loop}")
    assert cfg.icp.loop == loop
