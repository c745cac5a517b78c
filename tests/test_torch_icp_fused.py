"""Port parity, the fused matcher: K1's plain version against slam_tpu's
Pallas kernel (`_icp_batched_planes`, run in interpret mode on the CPU),
fused_register's crop and class encoding, K2's packed adapter against
`_icp_batched` (interpret mode) and register_scan_to_scan (CPU).

Bounds: pose <= 1e-4, num_corr and ok exact. The two sum the Kabsch
moments in different orders, and XLA:CPU fuses multiply-adds where the
port rounds each step; ties (d2 <= rowmin) are averaged by both. The
"points" form of register_scan_to_scan (icp_fit on both sides) is held to
the same bound."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import sim2d_config
from slam_tpu.ops import icp_pallas as jip
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.sim import world2d as jw
from slam_tpu.types import PointCloud as JCloud
from slam_tpu_torch import interop
from slam_tpu_torch.ops import icp_fused as tip
from slam_tpu_torch.pipeline import slam2d as tslam
from slam_tpu_torch.types import PointCloud
from slam_tpu_torch.utils import profiling as tprof
from tests.torch_parity import (assert_close, assert_equal, numpy_tree,
                                pallas_interpret, to_torch)

torch.set_num_threads(1)

CFG = sim2d_config().icp


def _problem(B=3, S=384, C=512, seed=0):
    """Noisy, moved subsets of each robot's model; robot B-1 has too few
    valid scene points (below min_scene_points)."""
    rng = np.random.default_rng(seed)
    mx = rng.uniform(-20, 20, (B, C)).astype(np.float32)
    my = rng.uniform(-20, 20, (B, C)).astype(np.float32)
    mga = rng.random((B, C)) < 0.4
    mval = rng.random((B, C)) < 0.95
    idx = rng.integers(0, C, (B, S))
    th = rng.uniform(-0.05, 0.05, (B, 1))
    sx0 = np.take_along_axis(mx, idx, 1) + rng.normal(0, 0.03, (B, S)) - 0.2
    sy0 = np.take_along_axis(my, idx, 1) + rng.normal(0, 0.03, (B, S)) + 0.1
    sx = (np.cos(th) * sx0 + np.sin(th) * sy0).astype(np.float32)
    sy = (-np.sin(th) * sx0 + np.cos(th) * sy0).astype(np.float32)
    sga = np.take_along_axis(mga, idx, 1)
    sval = rng.random((B, S)) < 0.97
    sval[-1] = False
    sval[-1, :4] = True
    # exact ties: duplicate model points, so tie averaging is exercised
    mx[:, 1::7], my[:, 1::7] = mx[:, ::7][:, :mx[:, 1::7].shape[1]], \
        my[:, ::7][:, :my[:, 1::7].shape[1]]
    init = np.zeros((B, 3), np.float32)
    return sx, sy, sval, sga, mx, my, mval, mga, init


def test_k1_plain_matches_pallas_interpret():
    sx, sy, sval, sga, mx, my, mval, mga, init = _problem()
    sc = jip.encode_scene_class(sval, sga)
    mc = jip.encode_model_class(mval, mga)
    with pallas_interpret():
        want = jip._icp_batched_planes(sx, sy, sc, mx, my, mc, init, CFG)
    got = tip.icp_fused_planes(to_torch(sx), to_torch(sy), to_torch(sc),
                               to_torch(mx), to_torch(my), to_torch(mc),
                               to_torch(init), CFG)
    assert_close(got.pose, want.pose, atol=1e-4)
    assert_equal(got.num_corr, want.num_corr)
    assert_equal(got.ok, want.ok)
    assert_close(got.mean_residual, want.mean_residual, atol=1e-5)
    assert got.ok[:-1].all() and not got.ok[-1]
    assert_close(got.pose[-1], init[-1], atol=0)


def test_k2_plain_matches_pallas_interpret():
    sx, sy, sval, sga, mx, my, mval, mga, init = _problem(seed=4)
    init[0] = [0.1, -0.05, 0.01]
    s_xy = np.stack([sx, sy], -1)
    m_xy = np.stack([mx, my], -1)
    with pallas_interpret():
        want = jax.vmap(jip.make_icp_fused(CFG))(
            s_xy, sval, sga, m_xy, mval, mga, init)
    args = tuple(map(to_torch, (s_xy, sval, sga, m_xy, mval, mga, init)))
    got = tip.icp_fused(*args, CFG)
    assert_close(got.pose, want.pose, atol=1e-4)
    assert_equal(got.num_corr, want.num_corr)
    assert_equal(got.ok, want.ok)
    assert_close(got.mean_residual, want.mean_residual, atol=1e-5)
    assert got.ok[:-1].all() and not got.ok[-1]
    assert_equal(tip.icp_fused_reference(*args, CFG).pose, got.pose)
    assert tprof.count_of("k2.launches") == 0
    assert tprof.count_of("k1.launches") == 0


def _consecutive_scenes(cfg):
    """Two consecutive ticks of a JAX rollout for two robots: (state
    before, state after)."""
    world = jw.make_world(jax.random.PRNGKey(42), cfg.sim)
    st = jax.vmap(lambda k: jslam.init_state(k, cfg))(
        jax.random.split(jax.random.PRNGKey(3), 2))
    step = jax.jit(jax.vmap(lambda s: jslam.slam_step(s, world, cfg)))
    for _ in range(3):
        st = step(st)
    return st, step(st)


@pytest.mark.parametrize("matcher", ["fused", "points"])
def test_register_scan_to_scan_matches_jax(matcher):
    cfg = sim2d_config()
    cfg = dataclasses.replace(cfg, icp=dataclasses.replace(
        cfg.icp, matcher=matcher))
    prev, cur = _consecutive_scenes(cfg)
    init = prev.pose[:, :3]

    def jax_s2s():
        return jax.vmap(lambda s, p, pp, i: jslam.register_scan_to_scan(
            s, p, pp, i, cfg))(cur.prev_scene, prev.prev_scene, prev.pose,
                               init)
    if matcher == "fused":
        # slam_tpu takes the fused kernel only on a TPU
        spy = mock.Mock(wraps=jip.make_icp_fused)
        with pallas_interpret(), mock.patch.object(
                jax, "default_backend", lambda: "tpu"), \
                mock.patch.object(jip, "make_icp_fused", spy):
            want = jax_s2s()
        assert spy.called
    else:
        want = jax_s2s()
    tprev = interop.state_from_numpy(numpy_tree(prev), "cpu")
    tcur = interop.state_from_numpy(numpy_tree(cur), "cpu")
    got = tslam.register_scan_to_scan(tcur.prev_scene, tprev.prev_scene,
                                      tprev.pose, to_torch(init), cfg)
    assert_close(got.pose, want.pose, atol=1e-4)
    assert_equal(got.num_corr, want.num_corr)
    assert_equal(got.ok, want.ok)
    assert bool(got.ok.all())
    # the scan-to-scan answer lands near the rollout's own registration
    assert_close(got.pose[:, :2], cur.pose[:, :2], atol=0.05)


def test_fused_register_matches_jax():
    sx, sy, sval, sga, mx, my, mval, mga, _ = _problem(B=2, seed=1)
    mx[:, :40] += 60.0                   # outside the +-55 m crop box
    pred = np.array([[0.3, -0.1, 0.02], [-0.2, 0.2, -0.03]], np.float32)
    planes = (mx, my, mga, mval)
    with pallas_interpret():
        want = jax.vmap(lambda a, b, c, d, e, f, g, h, p: jip.fused_register(
            a, b, c, d, (e, f, g, h), None, p, CFG))(
            sx, sy, sval, sga, *planes, pred)
    got = tip.fused_register(to_torch(sx), to_torch(sy), to_torch(sval),
                             to_torch(sga), tuple(map(to_torch, planes)),
                             None, to_torch(pred), CFG)
    assert_close(got.pose, want.pose, atol=1e-4)
    assert_equal(got.num_corr, want.num_corr)
    assert_equal(got.ok, want.ok)

    # without target planes the map cloud's columns are the target
    xyz = np.stack([mx, my, np.zeros_like(mx)], -1)
    flags = np.where(mga, JCloud.FLAG_GA, 0).astype(np.int32)
    cloud = PointCloud(to_torch(xyz), to_torch(mval), to_torch(flags))
    again = tip.fused_register(to_torch(sx), to_torch(sy), to_torch(sval),
                               to_torch(sga), None, cloud, to_torch(pred),
                               CFG)
    assert_equal(again.pose, got.pose)


def test_class_encodings_match_jax():
    rng = np.random.default_rng(2)
    valid = rng.random(50) < 0.7
    ga = rng.random(50) < 0.5
    assert_equal(tip.encode_scene_class(to_torch(valid), to_torch(ga)),
                 jip.encode_scene_class(jnp.asarray(valid), jnp.asarray(ga)))
    assert_equal(tip.encode_model_class(to_torch(valid), to_torch(ga)),
                 jip.encode_model_class(jnp.asarray(valid), jnp.asarray(ga)))


def test_resident_limit_names_k3():
    """K1 takes problems up to the limit and names K3 for larger ones
    (fused_register routes those to K3 itself)."""
    assert tip.RESIDENT_TILE_LIMIT == jip.RESIDENT_TILE_LIMIT
    S, C = 2048, tip.RESIDENT_TILE_LIMIT // 2048 + 1
    z = torch.zeros(1, S)
    m = torch.zeros(1, C)
    with pytest.raises(ValueError, match="K3"):
        tip.icp_fused_planes(z, z, z, m, m, m, torch.zeros(1, 3), CFG)


def test_wrappers_refuse_other_devices():
    """CPU tensors take the plain version; any other device gets the kernel
    or an error, never a silent fallback."""
    from slam_tpu_torch.ops import nn as tnn
    z = torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tip.icp_fused_planes(z, z, z, z, z, z, torch.zeros(1, 3,
                                                           device="meta"),
                             CFG)
    with pytest.raises(ValueError, match="unsupported device"):
        tnn.nearest_neighbor_planes(z, z, z, z, z, z)
    with pytest.raises(ValueError, match="unsupported device"):
        tip.icp_fused_planes_tiled(z, z, z, z, z, z,
                                   torch.zeros(1, 3, device="meta"), CFG)
    assert tprof.count_of("k1.launches") == 0
    assert tprof.count_of("k4.launches") == 0
    assert tprof.count_of("k3.launches") == 0


def test_k1_shared_memory_follows_the_packed_layout():
    """K1 stages S + C packed (x, y) points; the wrapper refuses what does
    not fit beside the kernel's static part."""
    from slam_tpu_torch import cuda_build
    assert tip.k1_shared_bytes(384, 512) == 8 * (384 + 512)
    assert tip._MAX_SMEM < cuda_build.MAX_SMEM
    assert tip.k1_shared_bytes(4096, 512) <= tip._MAX_SMEM
    assert tip.k1_shared_bytes(8, tip.RESIDENT_TILE_LIMIT // 8) > tip._MAX_SMEM


@pytest.mark.parametrize("off", ["ga", "nga"])
def test_k1_algorithm_with_a_class_off_and_separated_duplicates(off):
    """The kernels' grouped algorithm on K1's shapes: robot 0's model holds
    3 points of one class (that class is off), and the `_problem`
    duplicates (model points 7k and 7k + 1 equal, classes independent) and
    a second set (14k + 2 and 14k + 9) put equal points of one class on
    both sides of other-class points; splits of 100 model points."""
    sx, sy, sval, sga, mx, my, mval, mga, init = _problem(seed=6)
    cls = mga[0] if off == "ga" else ~mga[0]
    mval[0, np.flatnonzero(mval[0] & cls)[3:]] = False
    mx[:, 9::14], my[:, 9::14] = mx[:, 2::14][:, :mx[:, 9::14].shape[1]], \
        my[:, 2::14][:, :my[:, 9::14].shape[1]]
    args = [to_torch(a) for a in (
        sx, sy, np.asarray(jip.encode_scene_class(sval, sga)), mx, my,
        np.asarray(jip.encode_model_class(mval, mga)))]
    init4 = tip._pack_init4(to_torch(init))
    want = tip._decode(tip._reference_slab(*args, init4, CFG)[0])
    got = tip._decode(tip._grouped_split_slab(*args, init4, CFG, 100)[0])
    assert_equal(got.ok, want.ok)
    assert_equal(got.num_corr, want.num_corr)
    assert_close(got.pose, want.pose, atol=1e-6)
    on_rows = ((sga[0] != (off == "ga")) & sval[0]).sum()
    assert 0 < int(want.num_corr[0]) <= on_rows
