"""Port parity, the tiled fused matcher: K3's plain version against
slam_tpu's streaming Pallas kernel (`_icp_batched_planes_tiled`, interpret
mode on the CPU), against K1's plain version, and fused_register's choice
between K1 and K3 (slam_tpu_torch vs slam_tpu, CPU).

Bounds: pose <= 1e-4, num_corr and ok exact against the Pallas kernel (the
moment sums add in another order, and XLA:CPU fuses multiply-adds where
the port rounds each step); K3's plain version vs K1's, which find the
same tie sets, pose <= 1e-5 (measured 2.4e-7), num_corr and ok exact."""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from slam_tpu.config import IcpConfig
from slam_tpu.ops import icp_pallas as jip
from slam_tpu_torch.ops import icp_fused as tip
from tests.torch_parity import (assert_close, assert_equal, pallas_interpret,
                                to_torch)

torch.set_num_threads(1)

CFG = IcpConfig(max_iterations=12, inlier_dist=2.0, min_delta=1e-6)


def _problem(B=3, S=700, C=1500, dup=512, seed=0):
    """Noisy, moved subsets of each robot's model, ragged against every
    block size; model points i and i + dup are equal (nearest-point ties
    across model blocks of dup points). Robot B-1's scene has fewer valid
    points than min_scene_points."""
    rng = np.random.default_rng(seed)
    mx = rng.uniform(-20, 20, (B, C)).astype(np.float32)
    my = rng.uniform(-20, 20, (B, C)).astype(np.float32)
    mx[:, dup:2 * dup] = mx[:, :dup]
    my[:, dup:2 * dup] = my[:, :dup]
    mga = rng.random((B, C)) < 0.4
    mga[:, dup:2 * dup] = mga[:, :dup]
    mval = rng.random((B, C)) < 0.95
    idx = rng.integers(0, C, (B, S))
    th = rng.uniform(-0.05, 0.05, (B, 1))
    sx0 = np.take_along_axis(mx, idx, 1) + rng.normal(0, 0.03, (B, S)) - 0.3
    sy0 = np.take_along_axis(my, idx, 1) + rng.normal(0, 0.03, (B, S)) + 0.2
    sx = (np.cos(th) * sx0 + np.sin(th) * sy0).astype(np.float32)
    sy = (-np.sin(th) * sx0 + np.cos(th) * sy0).astype(np.float32)
    sga = np.take_along_axis(mga, idx, 1)
    sval = rng.random((B, S)) < 0.97
    sval[-1] = False
    sval[-1, :4] = True
    sc = np.asarray(jip.encode_scene_class(sval, sga))
    mc = np.asarray(jip.encode_model_class(mval, mga))
    init = np.zeros((B, 3), np.float32)
    init[0] = [0.1, -0.05, 0.01]
    return sx, sy, sc, mx, my, mc, init


@pytest.fixture(scope="module")
def pallas_tiled():
    """slam_tpu's tiled kernel on the problem, S and C over several
    (256, 512) blocks."""
    ops = _problem()
    with pallas_interpret():
        want = jip._icp_batched_planes_tiled(*ops, CFG, 256, 512)
    return ops, want


@pytest.mark.parametrize("c_blk", [tip.TILE_C, 512, 384])
def test_k3_plain_matches_pallas_interpret(pallas_tiled, c_blk):
    """c_blk 2048 holds the model in one block; 512 puts each tied pair in
    two blocks, as the Pallas kernel does; 384 cuts the blocks elsewhere."""
    ops, want = pallas_tiled
    args = [to_torch(a) for a in ops]
    slab, iters = tip._tiled_reference_slab(*args[:6],
                                            tip._pack_init4(args[6]), CFG,
                                            c_blk=c_blk)
    got = tip._decode(slab)
    assert_close(got.pose, want.pose, atol=1e-4)
    assert_equal(got.num_corr, want.num_corr)
    assert_equal(got.ok, want.ok)
    assert_close(got.mean_residual, want.mean_residual, atol=1e-5)
    assert got.ok[:-1].all() and not got.ok[-1]
    assert (iters[:-1] > 1).all() and iters[-1] == 0
    assert_close(got.pose[-1], ops[6][-1], atol=0)


def test_k3_wrapper_runs_plain_version_on_cpu(pallas_tiled):
    ops, want = pallas_tiled
    got = tip.icp_fused_planes_tiled(*map(to_torch, ops), CFG)
    assert_close(got.pose, want.pose, atol=1e-4)
    assert_equal(got.num_corr, want.num_corr)
    assert tip.tiled_launches == 0


def test_k3_plain_matches_k1_plain():
    ops = [to_torch(a) for a in _problem(S=384, C=1500, seed=3)]
    tiled = tip.icp_fused_planes_tiled_reference(*ops, CFG)
    resident = tip.icp_fused_planes_reference(*ops, CFG)
    assert_close(tiled.pose, resident.pose, atol=1e-5)
    assert_equal(tiled.num_corr, resident.num_corr)
    assert_equal(tiled.ok, resident.ok)
    assert_equal(tip.fit_iterations(*ops, CFG),
                 tip._reference_slab(*ops[:6], tip._pack_init4(ops[6]),
                                     CFG)[1])


@pytest.mark.parametrize("C,kernel", [
    (tip.RESIDENT_TILE_LIMIT // 512, "icp_fused_planes"),
    (tip.RESIDENT_TILE_LIMIT // 512 + 8, "icp_fused_planes_tiled"),
])
def test_fused_register_routes_by_limit(C, kernel):
    """S * C above RESIDENT_TILE_LIMIT takes K3, at or below it K1, as
    slam_tpu's fused_register decides; the result matches slam_tpu's
    (its kernels in interpret mode), pose 1e-4."""
    assert tip.RESIDENT_TILE_LIMIT == jip.RESIDENT_TILE_LIMIT
    sx, sy, sc, mx, my, mc, _ = _problem(B=2, S=512, C=C, dup=2048, seed=5)
    sval, sga = sc >= 0, sc == 1
    mval, mga = mc < 2, mc == 1
    mx[:, :40] += 60.0                       # outside the +-55 m crop box
    pred = np.array([[0.3, -0.1, 0.02], [-0.2, 0.2, -0.03]], np.float32)
    cfg = IcpConfig(max_iterations=8, inlier_dist=1.0, crop_dist=55.0)
    with pallas_interpret():
        want = jax.vmap(lambda a, b, c, d, e, f, g, h, p: jip.fused_register(
            a, b, c, d, (e, f, g, h), None, p, cfg))(
            sx, sy, sval, sga, mx, my, mga, mval, pred)
    spies = {name: mock.Mock(wraps=getattr(tip, name))
             for name in ("icp_fused_planes", "icp_fused_planes_tiled")}
    with mock.patch.multiple(tip, **spies):
        got = tip.fused_register(
            to_torch(sx), to_torch(sy), to_torch(sval), to_torch(sga),
            tuple(map(to_torch, (mx, my, mga, mval))), None, to_torch(pred),
            cfg)
    assert [n for n, s in spies.items() if s.called] == [kernel]
    assert_close(got.pose, want.pose, atol=1e-4)
    assert_equal(got.num_corr, want.num_corr)
    assert_equal(got.ok, want.ok)
    assert bool(got.ok[0]) and not bool(got.ok[1])
