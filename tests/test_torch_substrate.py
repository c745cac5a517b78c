"""Port parity, substrate: geometry, inv3 and the EKF updates
(slam_tpu_torch vs slam_tpu on the same numpy-seeded inputs, CPU).

Tolerances: elementwise f32 math agrees to a few ulps across the two
frameworks' sin/cos/atan2 implementations (atol 1e-6 on O(1) values);
small matmuls sum in another order (EKF states to 1e-5 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu import geometry as jgeo
from slam_tpu.config import EkfConfig
from slam_tpu.models import ekf as jekf
from slam_tpu.ops import linalg as jlinalg
from slam_tpu_torch import geometry as tgeo
from slam_tpu_torch.models import ekf as tekf
from slam_tpu_torch.ops import linalg as tlinalg
from slam_tpu_torch.types import EkfState
from tests.torch_parity import assert_close, assert_equal, to_torch

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["angle_wrap", "subtract_yaw", "rot2",
                                  "se2_apply", "se2_apply_xy"])
def test_geometry_matches_jax(name):
    rng = np.random.default_rng(0)
    a = rng.uniform(-10, 10, (3, 5)).astype(np.float32)
    b = rng.uniform(-10, 10, (3, 5)).astype(np.float32)
    pose = np.stack([rng.uniform(-40, 40, 3), rng.uniform(-40, 40, 3),
                     rng.uniform(-4, 4, 3)], -1).astype(np.float32)
    pts = rng.uniform(-45, 45, (3, 7, 2)).astype(np.float32)
    if name == "angle_wrap":
        got, want = tgeo.angle_wrap(to_torch(a)), jgeo.angle_wrap(a)
    elif name == "subtract_yaw":
        got = tgeo.subtract_yaw(to_torch(a), to_torch(b))
        want = jgeo.subtract_yaw(a, b)
    elif name == "rot2":
        got, want = tgeo.rot2(to_torch(a)), jgeo.rot2(a)
    elif name == "se2_apply":
        got = tgeo.se2_apply(to_torch(pose), to_torch(pts))
        want = jax.vmap(jgeo.se2_apply)(pose, pts)
    else:
        got = torch.stack(tgeo.se2_apply_xy(
            to_torch(pose), to_torch(pts[..., 0]), to_torch(pts[..., 1])))
        want = jnp.stack(jgeo.se2_apply_xy(pose, pts[..., 0], pts[..., 1]))
    # 45 m coordinates: a few f32 ulps there are ~1e-5 m
    assert_close(got, want, atol=2e-5 if name.startswith("se2") else 1e-6)


def test_inv3_matches_jax():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(4, 3, 3)).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1) + 10 * np.eye(3)).astype(np.float32)
    got = tlinalg.inv3(to_torch(M))
    assert_close(got, jlinalg.inv3(jnp.asarray(M)), atol=0, rtol=1e-5)
    assert_close(got @ to_torch(M), np.broadcast_to(np.eye(3), (4, 3, 3)),
                 atol=1e-5)


def _ekf_inputs(seed=2, B=3):
    rng = np.random.default_rng(seed)
    mu = rng.normal(0, 1, (B, 8)).astype(np.float32)
    A = rng.normal(0, 0.1, (B, 8, 8)).astype(np.float32)
    sigma = (A @ A.transpose(0, 2, 1) + 0.01 * np.eye(8)).astype(np.float32)
    bias = rng.normal(0, 0.01, B).astype(np.float32)
    cmd = rng.uniform(-4, 4, (B, 3)).astype(np.float32)
    cmd[1, 2] = np.nan                       # a rejected command
    gyro = rng.normal(0, 0.3, B).astype(np.float32)
    gyro[2] = np.inf                         # a dropped gyro sample
    meas = rng.normal(0, 1, (B, 3)).astype(np.float32)
    meas[:, 2] *= 4.0                        # yaw innovation across +-pi
    return mu, sigma, bias, cmd, gyro, meas


def test_ekf_updates_match_jax():
    cfg = EkfConfig()
    mu, sigma, bias, cmd, gyro, meas = _ekf_inputs()
    has = np.array([True, False, True])
    js = jekf.EkfState(mu=jnp.asarray(mu), sigma=jnp.asarray(sigma),
                       gyro_bias=jnp.asarray(bias))
    ts = EkfState(mu=to_torch(mu), sigma=to_torch(sigma),
                  gyro_bias=to_torch(bias))
    steps = [
        ("motion", lambda s: jax.vmap(lambda e, c: jekf.motion_update(
            e, c, 0.1, cfg))(s, jnp.asarray(cmd)),
         lambda s: tekf.motion_update(s, to_torch(cmd), 0.1, cfg)),
        ("gyro", lambda s: jax.vmap(lambda e, g: jekf.yaw_rate_update(
            e, g, cfg))(s, jnp.asarray(gyro)),
         lambda s: tekf.yaw_rate_update(s, to_torch(gyro), cfg)),
        ("slam", lambda s: jax.vmap(lambda e, m, h: jekf.slam_update(
            e, m, cfg, has_meas=h))(s, jnp.asarray(meas), jnp.asarray(has)),
         lambda s: tekf.slam_update(s, to_torch(meas), cfg,
                                    has_meas=to_torch(has))),
    ]
    for what, jf, tf in steps:
        js, ts = jf(js), tf(ts)
        assert_close(ts.mu, js.mu, atol=1e-5, rtol=1e-5, what=f"{what} mu")
        assert_close(ts.sigma, js.sigma, atol=1e-6, rtol=1e-5,
                     what=f"{what} sigma")
    # the NaN command moved nothing but the yaw prior; the inf gyro sample
    # and the masked SLAM measurement left robots 2 and 1 alone
    assert np.isfinite(ts.mu.numpy()).all()


def test_clamp_cmd_and_gyro_bias():
    cfg = EkfConfig()
    cmd = np.array([[5.0, -5.0, 2.0], [np.nan, 0.3, 0.1], [0.5, 0.2, -0.1]],
                   np.float32)
    assert_equal(tekf.clamp_cmd(to_torch(cmd), cfg),
                 jax.vmap(lambda c: jekf.clamp_cmd(c, cfg))(jnp.asarray(cmd)))
    s = np.random.default_rng(3).normal(0.01, 0.002, (3, 200)).astype(
        np.float32)
    assert_close(tekf.estimate_gyro_bias(to_torch(s)),
                 jekf.estimate_gyro_bias(jnp.asarray(s)), atol=1e-8)


def test_init_ekf():
    cfg = EkfConfig()
    st = tekf.init_ekf(cfg, 2, gyro_bias=torch.tensor([0.01, 0.02]),
                       device="cpu")
    want = jekf.init_ekf(cfg, gyro_bias=0.01)
    assert_equal(st.mu[0], want.mu)
    assert_equal(st.sigma[1], want.sigma)
    assert_equal(st.gyro_bias, np.float32([0.01, 0.02]))
