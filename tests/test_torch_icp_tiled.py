"""Port parity, the tiled fused matcher: K3's plain version against
slam_tpu's streaming Pallas kernel (`_icp_batched_planes_tiled`, interpret
mode on the CPU), against K1's plain version, and fused_register's choice
between K1 and K3 (slam_tpu_torch vs slam_tpu, CPU); the kernels'
algorithm in plain PyTorch (class grouping, model splits merged in split
order) against the same Pallas kernel and against the plain versions.

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
from slam_tpu_torch import cuda_build
from slam_tpu_torch.ops import icp_fused as tip
from slam_tpu_torch.utils import profiling as tprof
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
    assert tprof.count_of("k3.launches") == 0


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


def _sparse_problem(B=5, S=256, C=1024, seed=7):
    """What the reference scale's data looks like, small: a few valid
    points scattered over the slots. Robot 1's model holds 3 GA points (its
    GA class is off, NGA on); robot 2's model repeats every valid point 8
    slots later, points of the other class between the two copies; robot 3
    has no valid scene point; robot 4 is dense."""
    rng = np.random.default_rng(seed)
    mx = rng.uniform(-20, 20, (B, C)).astype(np.float32)
    my = rng.uniform(-20, 20, (B, C)).astype(np.float32)
    mga = rng.random((B, C)) < 0.4
    mval = rng.random((B, C)) < 0.09
    mval[4] = rng.random(C) < 0.95
    keep = np.flatnonzero(mval[1] & mga[1])[3:]
    mga[1, keep] = False
    src = np.flatnonzero(mval[2])
    src = src[src + 8 < C]
    mx[2, src + 8], my[2, src + 8] = mx[2, src], my[2, src]
    mga[2, src + 8], mval[2, src + 8] = mga[2, src], True
    for k in range(1, 8):                    # other-class points in between
        mga[2, src + k] = ~mga[2, src]
    sx = np.zeros((B, S), np.float32)
    sy = np.zeros((B, S), np.float32)
    sga = np.zeros((B, S), bool)
    for b in range(B):
        pick = rng.choice(np.flatnonzero(mval[b]), S)
        sx[b] = mx[b, pick] + rng.normal(0, 0.03, S) - 0.2
        sy[b] = my[b, pick] + rng.normal(0, 0.03, S) + 0.1
        sga[b] = mga[b, pick]
    sval = rng.random((B, S)) < 0.15
    sval[4] = rng.random(S) < 0.97
    sval[3] = False
    sc = np.asarray(jip.encode_scene_class(sval, sga))
    mc = np.asarray(jip.encode_model_class(mval, mga))
    init = np.zeros((B, 3), np.float32)
    init[0] = [0.1, -0.05, 0.01]
    return sx, sy, sc, mx, my, mc, init


def _plain(ops, slab_fn, **kw):
    args = [to_torch(a) for a in ops]
    slab, iters = slab_fn(*args[:6], tip._pack_init4(args[6]), CFG, **kw)
    return tip._decode(slab), iters


def _assert_same_fit(got, want, atol=1e-6):
    """ok and num_corr exact, pose <= atol (the same tie sets; only the
    order of the moment sums differs)."""
    assert_equal(got.ok, want.ok)
    assert_equal(got.num_corr, want.num_corr)
    assert_close(got.pose, want.pose, atol=atol)
    assert_close(got.mean_residual, want.mean_residual, atol=atol)


@pytest.mark.parametrize("problem", ["sparse", "ties"])
def test_fit_on_grouped_operands_equals_fit_on_originals(problem):
    """Grouping scene and model by class, stably, changes nothing the fit
    computes: scattered sparse slots, a class that is off, duplicate points
    of one class with the other class between them, an all-invalid robot."""
    ops = _sparse_problem() if problem == "sparse" else _problem(S=300,
                                                                 C=900,
                                                                 dup=256)
    t = [to_torch(a) for a in ops]
    gsx, gsy, gsc, n1, n0 = tip.group_by_class(*t[:3])
    gmx, gmy, gmc, m1, m0 = tip.group_by_class(*t[3:6])
    for cls, a, b in ((gsc, n1, n0), (gmc, m1, m0)):
        for r in range(cls.shape[0]):
            assert (cls[r, :a[r]] == 1).all()
            assert (cls[r, a[r]:a[r] + b[r]] == 0).all()
            assert not ((cls[r, a[r] + b[r]:] == 0) |
                        (cls[r, a[r] + b[r]:] == 1)).any()
    # stable: a class's points keep the input's order
    r = 2 if problem == "sparse" else 0
    assert_equal(gmx[r, :m1[r]], t[3][r][t[5][r] == 1])
    assert_equal(gmy[r, m1[r]:m1[r] + m0[r]], t[4][r][t[5][r] == 0])
    want, _ = _plain(ops, tip._reference_slab)
    got, _ = _plain((gsx, gsy, gsc, gmx, gmy, gmc, ops[6]),
                    tip._reference_slab)
    _assert_same_fit(got, want)
    if problem == "sparse":
        assert want.ok.tolist() == [True, True, True, False, True]
        assert (want.num_corr[:3] > 5).all()


@pytest.mark.parametrize("split_len", [64, 200, 10 ** 6])
@pytest.mark.parametrize("problem", ["sparse", "ties"])
def test_split_merge_equals_unsplit(problem, split_len):
    """The kernels' algorithm (grouped segments, minimum started at
    inlier_dist, splits merged per scene point in split order) equals the
    plain version: "ties" puts equal model points 256 slots apart, in
    different splits at 64 and 200 and in one at 10^6. Pose <= 5e-6: the
    moments add robot by robot in another order than the plain version's
    whole-tile sums, and a sparse robot's ~15 correspondences carry that
    through up to 12 fit iterations (measured 1.4e-6)."""
    ops = _sparse_problem() if problem == "sparse" else _problem(S=300,
                                                                 C=900,
                                                                 dup=256)
    want, want_iters = _plain(ops, tip._reference_slab)
    got, iters = _plain(ops, tip._grouped_split_slab, split_len=split_len)
    _assert_same_fit(got, want, atol=5e-6)
    assert_equal(iters, want_iters)
    tiled, _ = _plain(ops, tip._tiled_reference_slab)
    _assert_same_fit(got, tiled, atol=5e-6)


@pytest.fixture(scope="module", params=["sparse", "ties"])
def pallas_tiled_grouping(request):
    """slam_tpu's tiled kernel (interpret mode) on the grouping problems:
    scattered sparse slots with a class off, separated duplicates and an
    empty robot; and equal model points 256 slots apart."""
    ops = (_sparse_problem() if request.param == "sparse"
           else _problem(S=300, C=900, dup=256))
    with pallas_interpret():
        want = jip._icp_batched_planes_tiled(*ops, CFG, 128, 256)
    return ops, want


@pytest.mark.parametrize("split_len", [64, 200, 10 ** 6])
def test_grouped_split_fit_matches_pallas_interpret(pallas_tiled_grouping,
                                                    split_len):
    """The kernels' algorithm against the JAX package on the same inputs:
    pose <= 1e-4, ok and num_corr exact (the bounds of K3's plain version
    against the same Pallas kernel)."""
    ops, want = pallas_tiled_grouping
    got, _ = _plain(ops, tip._grouped_split_slab, split_len=split_len)
    assert_close(got.pose, want.pose, atol=1e-4)
    assert_equal(got.num_corr, want.num_corr)
    assert_equal(got.ok, want.ok)
    assert_close(got.mean_residual, want.mean_residual, atol=1e-5)
    assert int(got.ok.sum()) >= 2 and not bool(got.ok.all())


def test_split_bounds_cover_evenly():
    for n, split_len in ((1, 4096), (4096, 4096), (4097, 4096), (15000, 4096),
                         (139, 64)):
        b = tip.split_bounds(n, split_len)
        assert b[0][0] == 0 and b[-1][1] == n
        assert all(p[1] == q[0] for p, q in zip(b, b[1:]))
        assert all(0 < e - a <= split_len for a, e in b)
    assert tip.split_bounds(0, 4096) == []


@pytest.mark.parametrize("B,S,C", [(16, 4096, 40960), (8, 700, 6000),
                                   (2, 512, 4104)])
def test_k3_scratch_holds_every_split(B, S, C):
    """K3's scratch: one slot per (robot, split, scene point) for the most
    splits a class's model segment can have, and S + C grouped points."""
    shapes = tip.k3_scratch_shapes(B, S, C)
    assert shapes["state"] == (B, 8) and shapes["plan"] == (B, 12)
    assert shapes["grouped"] == (B, S + C, 2)
    n_splits = shapes["partial"][1]
    assert shapes["partial"] == (B, n_splits, S, 4)
    assert n_splits == len(tip.split_bounds(C, tip.K3_SPLIT_LEN))
    for m in (0, 1, C // 2, C):
        assert len(tip.split_bounds(m, tip.K3_SPLIT_LEN)) <= n_splits


def test_k3_scratch_constants_are_the_kernel_source_s():
    """The wrapper sizes K3's scratch by the kernel's own constants."""
    import re
    src = (cuda_build.CSRC / "icp_tiled.cu").read_text()

    def const(pattern):
        return int(re.search(pattern, src).group(1))
    assert const(r"constexpr int kSplit = (\d+);") == tip.K3_SPLIT_LEN
    assert const(r"constexpr int kState = (\d+);") == tip._K3_STATE
    assert const(r"kPlan = (\d+) \}") == tip._K3_PLAN
