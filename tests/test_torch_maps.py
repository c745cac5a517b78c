"""Port parity, maps: the rolling point map (update, shift, export) and the
occupancy grid (slam_tpu_torch vs slam_tpu, CPU).

Counts, drivability, export selection and GA flags match exactly; centroid
coordinates to 1e-5 (sums of cell offsets in another order). The export
case has more occupied cells than capacity, with many equal counts, so it
pins the tie order: equal counts go to the lower flat cell index, as in
jax.lax.top_k and, off the TPU, approx_max_k."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import sim2d_config
from slam_tpu.mapping import occupancy as jocc
from slam_tpu.mapping import point_map as jpm
from slam_tpu_torch.mapping import occupancy as tocc
from slam_tpu_torch.mapping import point_map as tpm
from tests.torch_parity import assert_close, assert_equal, to_torch

torch.set_num_threads(1)

CFG = sim2d_config()
G = 32
RES = 0.5


def _points(B=2, N=200, seed=0, spread=6.0):
    rng = np.random.default_rng(seed)
    qx = rng.normal(0, spread, (B, N)).astype(np.float32)
    qy = rng.normal(0, spread, (B, N)).astype(np.float32)
    valid = rng.random((B, N)) < 0.9
    return qx, qy, valid


def _both_maps(B=2, steps=3, seed=0):
    """Drive both point maps through updates and rolling shifts."""
    jg = jax.vmap(lambda _: jpm.init_point_map(G, RES))(jnp.arange(B))
    tg = tpm.init_point_map(B, G, RES, device="cpu")
    rng = np.random.default_rng(seed + 100)
    for k in range(steps):
        qx, qy, valid = _points(B, seed=seed + k)
        jg = jax.vmap(lambda g, a, b, c: jpm.update_point_map_xy(
            g, a, b, None, c, RES))(jg, qx, qy, valid)
        tg = tpm.update_point_map_xy(tg, to_torch(qx), to_torch(qy), None,
                                     to_torch(valid), RES)
        new_c = rng.uniform(-2.0, 2.0, (B, 2)).astype(np.float32)
        jg = jax.vmap(lambda g, c: jpm.shift_point_map(g, c, RES))(jg, new_c)
        tg = tpm.shift_point_map(tg, to_torch(new_c), RES)
    return jg, tg


def test_point_map_update_and_shift_match_jax():
    jg, tg = _both_maps()
    assert_equal(tg.count, jg.count)
    assert_close(tg.sum_x, jg.sum_x, atol=1e-5)
    assert_close(tg.sum_y, jg.sum_y, atol=1e-5)
    assert_equal(tg.sum_z, jg.sum_z)
    assert_close(tg.center, jg.center, atol=0)


def test_update_point_map_cloud_form_matches_jax():
    """update_point_map folds (B, N, 3) world points, z included, as
    slam_tpu's does on (N, 3); it is update_point_map_xy with the z
    plane."""
    qx, qy, valid = _points(B=2, seed=7)
    qz = np.random.default_rng(8).normal(0, 1, qx.shape).astype(np.float32)
    xyz = np.stack([qx, qy, qz], -1)
    jg = jax.vmap(lambda p, v: jpm.update_point_map(
        jpm.init_point_map(G, RES), p, v, RES))(xyz, valid)
    tg = tpm.update_point_map(tpm.init_point_map(2, G, RES, device="cpu"),
                              to_torch(xyz), to_torch(valid), RES)
    assert_equal(tg.count, jg.count)
    assert_close(tg.sum_x, jg.sum_x, atol=1e-5)
    assert_close(tg.sum_y, jg.sum_y, atol=1e-5)
    assert_close(tg.sum_z, jg.sum_z, atol=1e-5)
    xy = tpm.update_point_map_xy(tpm.init_point_map(2, G, RES, device="cpu"),
                                 to_torch(qx), to_torch(qy), to_torch(qz),
                                 to_torch(valid), RES)
    for f in ("count", "sum_x", "sum_y", "sum_z"):
        assert_equal(getattr(tg, f), getattr(xy, f))


@pytest.mark.parametrize("recall", [1.0, 0.8])
def test_export_overflow_tie_order_matches_jax(recall):
    jg, tg = _both_maps(steps=4, seed=7)
    occupied = int((tg.count[0] >= 1).sum())
    cap = 64
    assert occupied > 2 * cap      # overflow, with many tied counts
    got = tpm.export_point_planes(tg, cap, ga_threshold=2)
    want = jax.vmap(lambda g: jpm.export_point_planes(
        g, cap, ga_threshold=2, recall=recall))(jg)
    for k, name in ((3, "ga"), (4, "valid")):
        assert_equal(got[k], want[k], name)
    for k, name in ((0, "x"), (1, "y"), (2, "z")):
        assert_close(got[k], want[k], atol=1e-5, what=name)

    cloud = tpm.export_points(tg, cap)
    assert_close(cloud.xyz[..., 0], got[0], atol=0)
    assert_equal(cloud.is_ga(), got[3])


def test_export_under_capacity_matches_jax():
    jg, tg = _both_maps(steps=1, seed=3)
    cap = 512
    got = tpm.export_point_planes(tg, cap)
    want = jax.vmap(lambda g: jpm.export_point_planes(g, cap))(jg)
    assert_equal(got[4], want[4])
    assert_equal(got[3], want[3])
    assert_close(got[0], want[0], atol=1e-5)


def test_occupancy_matches_jax():
    mls = CFG.mls
    B = 2
    jgrid = jax.vmap(lambda _: jocc.init_occupancy(mls))(jnp.arange(B))
    tgrid = tocc.init_occupancy(mls, B, device="cpu")
    rng = np.random.default_rng(9)
    for k in range(4):
        lx, ly, valid = _points(B, N=360, seed=20 + k, spread=25.0)
        # hit the same cells repeatedly so cells cross the occupied threshold
        lx[:, :100] = 3.1
        ly[:, :100] = -7.6
        jgrid = jax.vmap(lambda g, a, b, c: jocc.add_to_occupancy_xy(
            g, a, b, c, mls))(jgrid, lx, ly, valid)
        tgrid = tocc.add_to_occupancy_xy(tgrid, to_torch(lx), to_torch(ly),
                                         to_torch(valid), mls)
        new_c = rng.uniform(-3.0, 3.0, (B, 2)).astype(np.float32)
        jgrid = jax.vmap(lambda g, c: jocc.shift_origin(g, c, mls))(jgrid,
                                                                   new_c)
        tgrid = tocc.shift_origin(tgrid, to_torch(new_c), mls)
    assert_equal(tgrid.counts, jgrid.counts)
    assert_equal(tgrid.drivable, jgrid.drivable)
    assert_equal(tgrid.center, jgrid.center)
    assert (tgrid.drivable == 0).any() and (tgrid.drivable == 1).any()
