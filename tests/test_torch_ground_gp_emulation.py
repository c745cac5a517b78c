"""The ground GP sector kernel (slam_tpu_torch/csrc/ground_gp.cu) has no CPU
mode. Its block's algorithm is emulated here in plain torch, one (robot,
sector) at a time, as the kernel runs it: the bins ranked by height as the
stable argsort orders them (invalid bins last, ties by index) with the
first C kept as slots, the seeds, and the sweeps on the model's slots
alone, compacted in slot order (a right-looking Cholesky, then a forward
substitution row by row), ending when the sector stops adopting. The
emulation is held against the plain version (`gp_sectors_reference`, every
sweep in full over the whole C x C system) and, through segment_ground,
against slam_tpu's segment_ground, on upright scans at the reference
scale's 72 x 200 grid with 64 slots (5,120 rays, as
tests/test_torch_slam3d.py's reference-scale test) and at sim3d's 16 x 32
with 32 slots, and on chip_smoke's ramp clouds (`ramp_scans`), whose
sectors adopt over several sweeps (the scans' sectors adopt all they will
in their first sweep) and whose prototypes tie on a 1 cm raster: at the
reference grid with 64 and 128 slots (the kernel's widest) and at sim3d's.

Tolerances: sufficiency, model masks, table flags and point labels exact;
f_s 1e-5 (the plain version's library Cholesky, slam_tpu's unrolled one
and the emulation's right-looking one round their sums in three orders).
The emulation rounds each product on its own where the kernel fuses
multiply-adds, and multiplies the squared distance by the f32 reciprocal
of 2 l^2 as the plain version does on the card (on the CPU it divides).

slam_tpu runs compiled without XLA's optimizing passes, as in
tests/test_torch_slam3d.py; its reference-scale GP is cut to 2 sweeps (its
unrolled solver's compile time).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ramp_scans
from slam_tpu import geometry as jgeo
from slam_tpu.config import ref_scale_config, sim3d_config
from slam_tpu.ops import ground as jground
from slam_tpu.sim import world3d as jw3
from slam_tpu.types import cloud_from_xyz as j_cloud_from_xyz
from slam_tpu_torch.ops import ground as tground
from slam_tpu_torch.types import cloud_from_xyz
from slam_tpu_torch.utils import profiling
from tests.torch_parity import assert_close, assert_equal, to_torch

torch.set_num_threads(1)

F_TOL = 1e-5
REF_AZIMUTH = 160        # 32 rings x 160 = 5,120 rays at the reference scale
JAX_REF_SWEEPS = 2


@pytest.fixture(scope="module", autouse=True)
def _unfused_xla():
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


# ramp clouds: (grid, signal slots, robots, seed)
RAMPS = {"ramps.ref.64": ("ref", 64, 2, 3),
         "ramps.ref.128": ("ref", 128, 1, 4),
         "ramps.sim3d": ("sim3d", 32, 4, 5)}


def _config(scale):
    cfg = ref_scale_config() if scale == "ref" else sim3d_config()
    if scale == "ref":
        cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
            cfg.sim, num_azimuth=REF_AZIMUTH))
    return cfg


def _case(world, case):
    """(xyz, valid) numpy clouds of a case, and its ground config."""
    if case in RAMPS:
        grid, C, B, seed = RAMPS[case]
        gcfg = dataclasses.replace(_config(grid).ground, signal_capacity=C)
        xyz, valid = ramp_scans(gcfg, B, seed, device="cpu")
        return (xyz.numpy(), valid.numpy()), gcfg
    return _scans(world, case), _config(case).ground


@pytest.fixture(scope="module")
def world():
    return jw3.make_world(jax.random.PRNGKey(42), sim3d_config().sim)


_SCANS = {}


def _scans(world, scale):
    """Noise-free upright scans of two robots (tilted by the terrain and
    compensated by the true attitude, as process_frame_3d sees them)."""
    if scale not in _SCANS:
        sim = _config(scale).sim
        poses = jnp.asarray(np.array([[0.0, 0.0, 0.3], [9.0, -14.0, 2.1]],
                                     np.float32))
        roll, pitch = jax.jit(jax.vmap(
            lambda p: jw3.terrain_attitude(world, p)))(poses[:, :2])
        pts, hit = jax.jit(jax.vmap(lambda p, r, q: jw3.raycast(
            world, p, sim, roll=r, pitch=q)))(poses, roll, pitch)
        pts = jax.jit(jax.vmap(jgeo.rp_compensate))(
            jnp.where(hit[..., None], pts, 0.0), roll, pitch)
        _SCANS[scale] = (np.asarray(pts), np.asarray(hit))
    return _SCANS[scale]


def _cloud(pts, hit):
    return cloud_from_xyz(to_torch(pts), valid=to_torch(hit))


def _prototypes(clouds, gcfg):
    """segment_ground's (count, proto_r, proto_h) on the clouds, as it
    passes them to its sector stage."""
    seen = []
    plain = tground.gp_sectors

    def spy(*a):
        seen.append(a[:3])
        return plain(*a)
    with mock.patch.object(tground, "gp_sectors", spy):
        tground.segment_ground(_cloud(*clouds), gcfg)
    (args,) = seen
    return args


# ------------------------------------------------------------- emulation


def _se(a, b, cfg, inv_two_l2):
    d = a - b
    return cfg.gp_signal_var * torch.exp(-(d * d) * inv_two_l2)


def _cholesky_right_looking(A):
    """The lower factor's strict part in A's lower triangle and its diagonal,
    column by column: sqrt of the pivot, the column scaled, the trailing
    block updated."""
    n = A.shape[0]
    diag = torch.empty(n, dtype=A.dtype)
    for k in range(n):
        diag[k] = torch.sqrt(A[k, k])
        A[k + 1:, k] = A[k + 1:, k] / diag[k]
        col = A[k + 1:, k]
        A[k + 1:, k + 1:] -= col[:, None] * col[None, :]
    return A, diag


def emulate_block(count, proto_r, proto_h, cfg):
    """One block of the kernel on one sector's L bins: (slot of each bin,
    slot heights' validity, model mask, f_s, sufficient, sweeps run)."""
    L = count.shape[0]
    C = min(cfg.signal_capacity, L)
    inv_two_l2 = torch.tensor(np.float32(1.0) /
                              np.float32(2.0 * cfg.gp_length_scale ** 2))
    valid_bin = count > cfg.min_bin_points
    key = torch.where(valid_bin, proto_h, float("inf"))
    i = torch.arange(L)
    before = (key[None, :] < key[:, None]) | \
        ((key[None, :] == key[:, None]) & (i[None, :] < i[:, None]))
    slot_of_bin = before.sum(1)                  # the stable sort's rank
    bin_of_slot = torch.empty(C, dtype=torch.long)
    kept = slot_of_bin < C
    bin_of_slot[slot_of_bin[kept]] = i[kept]
    h, r = proto_h[bin_of_slot], proto_r[bin_of_slot]
    valid = valid_bin[bin_of_slot]

    qual = valid & (r < cfg.seed_max_range) & (h.abs() < cfg.seed_max_height)
    npt = min(int(valid.sum()), cfg.num_seed_points)
    model = qual & (torch.cumsum(qual.to(torch.int32), 0) <= npt)
    sufficient = int(model.sum()) >= 2
    active = sufficient and bool((valid & ~model).any())
    f_s = torch.zeros(C, dtype=proto_h.dtype)
    sweeps = 0
    while active and sweeps < cfg.max_insac_sweeps:
        sweeps += 1
        ids = torch.nonzero(model)[:, 0]         # model slots, slot order
        rm = r[ids]
        A = _se(rm[:, None], rm[None, :], cfg, inv_two_l2)
        A.diagonal().add_(cfg.gp_noise)
        Lf, diag = _cholesky_right_looking(A)
        rhs = torch.cat([h[ids][:, None],
                         _se(r[None, :], rm[:, None], cfg, inv_two_l2)], 1)
        Y = torch.empty_like(rhs)
        for a in range(len(ids)):
            Y[a] = (rhs[a] - Lf[a, :a] @ Y[:a]) / diag[a]
        f = (Y[:, 1:] * Y[:, :1]).sum(0)
        v = cfg.gp_signal_var - (Y[:, 1:] * Y[:, 1:]).sum(0)
        met = (h - f) / torch.sqrt(cfg.gp_noise + v * v)
        inlier = valid & ~model & (v < cfg.gp_model_confidence) & \
            (met.abs() < cfg.gp_data_confidence)
        model = model | inlier
        f_s = f
        active = bool(inlier.any()) and bool((valid & ~model).any())
    return slot_of_bin, valid, model, f_s, sufficient, sweeps


def emulate_sectors(count, proto_r, proto_h, cfg):
    """gp_sectors by the emulated block, sector by sector: its SectorStage
    and the (B, S) sweeps each block ran."""
    B, S, L = count.shape
    C = min(cfg.signal_capacity, L)
    table = torch.zeros(B, S * L + 1, tground.TABLE_COLUMNS)
    model = torch.zeros(B, S, C, dtype=torch.bool)
    f_s = torch.zeros(B, S, C)
    sufficient = torch.zeros(B, S, dtype=torch.bool)
    sweeps = torch.zeros(B, S, dtype=torch.int64)
    for b in range(B):
        for s in range(S):
            slot, valid, m, f, suff, n = emulate_block(
                count[b, s], proto_r[b, s], proto_h[b, s], cfg)
            model[b, s], f_s[b, s], sufficient[b, s], sweeps[b, s] = \
                m, f, suff, n
            rows = table[b, s * L:(s + 1) * L]
            rows[:, 2] = proto_h[b, s]
            rows[:, 4] = float(suff)
            in_slots = slot < C
            c = slot[in_slots]
            sig = valid[c]
            rows[in_slots, 0] = sig.float()
            rows[in_slots, 1] = (sig & m[c]).float()
            rows[in_slots, 3] = torch.where(sig, f[c], 0.0)
    return tground.SectorStage(table=table, sector_sufficient=sufficient,
                               model_mask=model, f_s=f_s), sweeps


def _assert_sectors_agree(got, want):
    assert_equal(got.sector_sufficient, want.sector_sufficient)
    assert_equal(got.model_mask, want.model_mask)
    assert_close(got.f_s, want.f_s, atol=F_TOL)
    flags = [0, 1, 2, 4]
    assert_equal(got.table[..., flags], want.table[..., flags])
    assert_close(got.table[..., 3], want.table[..., 3], atol=F_TOL)


# ----------------------------------------------------------------- tests


@pytest.mark.parametrize("case", ["ref", "sim3d", *RAMPS])
def test_emulated_block_matches_plain(world, case):
    """Every sweep the configuration allows: the block's compacted solves
    and early exit give the plain version's sectors. The scans' sufficient
    sectors run one sweep and stop (adopting everything they will at once,
    or nothing); the ramps' run from one sweep to all of them."""
    clouds, gcfg = _case(world, case)
    count, proto_r, proto_h = _prototypes(clouds, gcfg)
    want = tground.gp_sectors_reference(count, proto_r, proto_h, gcfg)
    got, sweeps = emulate_sectors(count, proto_r, proto_h, gcfg)
    _assert_sectors_agree(got, want)
    ran = sweeps[want.sector_sufficient]
    assert bool(want.sector_sufficient.any())
    assert bool((ran < gcfg.max_insac_sweeps).any())
    if case in RAMPS:
        assert int(ran.max()) >= 5 and int(ran.min()) <= 2
        assert int(want.model_mask.sum()) > 4 * int(
            want.sector_sufficient.sum()) * gcfg.num_seed_points // 10
    else:
        assert int(ran.max()) <= 1


@pytest.mark.parametrize("case", ["ref", "sim3d", "ramps.sim3d"])
def test_emulated_block_matches_jax(world, case):
    """segment_ground with its sector stage emulated against slam_tpu's
    segment_ground (at the reference scale slam_tpu's stable 2-key sort
    engine and 2 sweeps; at sim3d's grid its incidence engine and all 8)."""
    (pts, hit), gcfg = _case(world, case)
    ref = gcfg.num_sectors == ref_scale_config().ground.num_sectors
    if ref:
        gcfg = dataclasses.replace(gcfg, max_insac_sweeps=JAX_REF_SWEEPS)
    limit = 0 if ref else jground.INCIDENCE_LIMIT
    with mock.patch.object(jground, "INCIDENCE_LIMIT", limit):
        want = jax.jit(jax.vmap(lambda p, h: jground.segment_ground(
            j_cloud_from_xyz(p, valid=h), gcfg)))(pts, hit)
    with mock.patch.object(tground, "gp_sectors",
                           lambda *a: emulate_sectors(*a)[0]):
        got = tground.segment_ground(_cloud(pts, hit), gcfg)
    assert_equal(got.cloud.valid, want.cloud.valid)
    assert_equal(got.cloud.flags, want.cloud.flags)
    assert_equal(got.sector_sufficient, want.sector_sufficient)
    assert_equal(got.model_mask, want.model_mask)
    assert_close(got.f_s, want.f_s, atol=F_TOL)
    assert bool(got.sector_sufficient.any())
    assert int(got.cloud.is_ground().sum()) > 100


def test_cpu_sector_stage_is_the_plain_version(world):
    """On CPU tensors gp_sectors is gp_sectors_reference, bit for bit, and
    launches nothing."""
    clouds, gcfg = _case(world, "ramps.sim3d")
    count, proto_r, proto_h = _prototypes(clouds, gcfg)
    before = profiling.count_of("ground.launches")
    got = tground.gp_sectors(count, proto_r, proto_h, gcfg)
    want = tground.gp_sectors_reference(count, proto_r, proto_h, gcfg)
    for g, w in zip(got, want):
        assert_equal(g, w)
    assert profiling.count_of("ground.launches") == before


@pytest.mark.parametrize("case", ["wide signal", "strides"])
def test_kernel_wrapper_refuses(case):
    """The card path's checks, which run before anything reaches the card:
    more signal slots than the block holds, and bins whose strides differ
    or whose sectors are not rows."""
    gcfg = sim3d_config().ground
    B, S, L = 2, 4, 200
    count = torch.zeros(B, S, L)
    others = [torch.zeros(B, S, L), torch.zeros(B, S, L)]
    if case == "wide signal":
        gcfg = dataclasses.replace(
            gcfg, signal_capacity=tground.GP_MAX_SLOTS + 1)
        match = "signal slots"
    else:
        others[1] = torch.zeros(B, L, S).transpose(1, 2)
        match = "strides"
    with pytest.raises(ValueError, match=match):
        tground._gp_sectors_kernel(count, *others, gcfg)


def test_shared_bytes_fit_the_card():
    """The block's shared memory at the widest signal and the reference
    scale's 200 range bins fits one block's limit on sm_90."""
    from slam_tpu_torch import cuda_build
    assert tground.gp_shared_bytes(tground.GP_MAX_SLOTS, 200) <= \
        cuda_build.MAX_SMEM
    assert tground.gp_shared_bytes(64, 200) < 48 * 1024
