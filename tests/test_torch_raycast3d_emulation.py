"""The 3D raycast kernel's per-ray algorithm (slam_tpu_torch/csrc/
raycast3d.cu), emulated one ray at a time in plain torch from what the
wrapper hands the kernel, against the port's CPU path (world3d.raycast,
which runs raycast_reference) and against slam_tpu's world3d.raycast.

The emulation is the kernel's thread: the march to the first crossing and
no further, regula falsi only where a crossing exists, the cylinders
visited in order keeping the least valid t; the terrain's sines summed in
torch.sum's order on the card and b_half as one fused multiply-add onto
the rounded first product (what the card's batched product computes).

Tolerances: hit flags equal but on grazing rays (a march sample's margin
within 1e-5 m of 0, or the discriminant of a circle whose wall the ray
meets within its height within 1e-5 of 0); points 1e-4 m + 1e-5 relative,
tests/test_torch_slam3d.py's bound for the port against slam_tpu (the CPU
sums the sines in another order and its sin rounds otherwise; regula falsi
carries those ulps into the range), and on a ray that meets a wall 4 ulps
of that wall's b_half^2 more: the range moves by ~ulp(b_half^2) /
(2 sqrt(disc) a) for one, 2.4e-4 m for a wall met 40 m off nearly
tangent, where the port's own plain version parts from slam_tpu alike
(slam_tpu's b_half rounds its two products apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import ref_scale_config, sim3d_config
from slam_tpu.sim import world3d as jw3
from slam_tpu_torch import interop
from slam_tpu_torch.sim import world3d as tw3
from slam_tpu_torch.utils import profiling
from tests.torch_parity import assert_equal, numpy_tree, to_torch

torch.set_num_threads(1)

GRAZE = 1e-5
POSES = np.array([[0.0, 0.0, 0.3], [9.0, -14.0, 2.1]], np.float32)


def _terrain(terr, x, y):
    """The kernel's terrain_at: each sine's term, summed as torch.sum
    reduces a row of K on the card (lane x of last_pow2(K) lanes sums
    terms x, x + lanes, ...; the lanes fold with halving offsets)."""
    K = terr.shape[0]
    v = [terr[k, 3] * torch.sin(x * terr[k, 0] + y * terr[k, 1] + terr[k, 2])
         for k in range(K)]
    lanes = 1 << (K.bit_length() - 1)
    for lane in range(lanes):
        for j in range(lane + lanes, K, lanes):
            v[lane] = v[lane] + v[j]
    off = lanes // 2
    while off:
        for lane in range(off):
            v[lane] = v[lane] + v[lane + off]
        off //= 2
    return v[0]


def _fma(a, b, c):
    """a * b + c rounded once to f32 (a float32 product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _falsi(lo, hi, m_lo, m_hi):
    return lo + (hi - lo) * m_lo / torch.clamp(m_lo - m_hi, min=1e-12)


def _cylinders(world, o):
    """The block's staged terms of one robot: (ocx, ocy, c_term, ground,
    top) a cylinder, in the world's order."""
    out = []
    for m in range(world.centers.shape[0]):
        cx, cy = world.centers[m]
        r = world.radii[m]
        ocx, ocy = o[0] - cx, o[1] - cy
        ground = _terrain(world.terrain, cx, cy)
        out.append((ocx, ocy, (ocx * ocx + ocy * ocy) - r * r, ground,
                    ground + world.heights[m]))
    return out


def _ray(o, d, dl, ts, terr, cyl, refine_steps, tmax, range_noise, noise):
    """One thread of the kernel: the ray o + t * d (0-dim f32 tensors).
    Returns (point (3,), hit, the march samples taken)."""
    ox, oy, oz = o
    dx, dy, dz = d

    def margin(t):
        return (oz + t * dz) - _terrain(terr, ox + t * dx, oy + t * dy)

    t_terr = torch.tensor(float("inf"))
    m_prev = margin(ts[0])
    taken = 1
    for k in range(1, ts.shape[0]):
        mk = margin(ts[k])
        taken += 1
        if m_prev > 0 and not mk > 0:       # the first crossing: stop here
            lo, hi, m_lo, m_hi = ts[k - 1], ts[k], m_prev, mk
            for _ in range(refine_steps):
                mid = _falsi(lo, hi, m_lo, m_hi)
                m_mid = margin(mid)
                if m_mid > 0:
                    lo, m_lo = mid, m_mid
                else:
                    hi, m_hi = mid, m_mid
            t_terr = _falsi(lo, hi, m_lo, m_hi)
            break
        m_prev = mk

    a = dx * dx + dy * dy
    a_c = torch.clamp(a, min=1e-9)
    t_cyl = torch.tensor(float("inf"))
    for ocx, ocy, c_term, ground, top in cyl:   # in order, the least valid t
        b_half = _fma(dy, ocy, dx * ocx)
        disc = b_half * b_half - a * c_term
        tc = (-b_half - torch.sqrt(torch.clamp(disc, min=0.0))) / a_c
        pz = oz + tc * dz
        if disc > 0 and tc > 1e-3 and pz > ground and pz < top and tc < t_cyl:
            t_cyl = tc

    t = torch.minimum(t_terr, t_cyl)
    hit = bool(torch.isfinite(t)) and bool(t < tmax)
    t = t if hit else torch.tensor(tmax)
    if noise is not None:
        t = t + torch.tensor(range_noise) * noise
    return t * dl, hit, taken


def _grazing(world, o, d, ts):
    """(B, N) rays whose hit may flip on the last bit, and each ray's
    range tolerance beyond 1e-4 m + 1e-5 relative: 4 ulps of b_half^2 of
    the walls it meets, carried into the range (module docstring); the
    march's margins."""
    pts = o[:, None, None, :] + ts[:, None] * d[:, :, None, :]
    marg = pts[..., 2] - tw3.terrain_height(world, pts[..., :2])
    oc = o[:, None, :2] - world.centers
    dxy = d[..., :2]
    a = (dxy * dxy).sum(-1)[..., None]
    bh = torch.einsum("bni,bmi->bnm", dxy, oc)
    disc = bh * bh - a * ((oc * oc).sum(-1)[:, None, :] - world.radii ** 2)
    tc = (-bh - torch.sqrt(torch.clamp(disc, min=0.0))) / \
        torch.clamp(a, min=1e-9)
    pz = o[:, None, 2:3] + tc * d[..., 2:3]
    ground = tw3.terrain_height(world, world.centers)
    wall = (tc > 1e-3) & (pz > ground) & (pz < ground + world.heights)
    grazing = (marg.abs() < GRAZE).any(-1) | \
        ((disc.abs() < GRAZE) & wall).any(-1)
    ulps = 4 * 2.0 ** -23 * bh * bh / (2 * torch.sqrt(disc) * a)
    extra = torch.where(wall & (disc > 0), ulps, 0.0).amax(-1)
    return grazing, extra, marg


def _assert_points(got, want, extra, what=""):
    """Points within 1e-4 m + 1e-5 relative + each ray's `extra`."""
    err = (got - want).abs()
    bound = 1e-4 + 1e-5 * want.abs() + extra[:, None]
    assert bool((err <= bound).all()), (
        f"{what}: {int((err > bound).any(-1).sum())} rays beyond the bound, "
        f"worst {float((err - bound).max())} m over it")


def _rays(world, o, d, ts, marg, per_robot=48):
    """A few hundred rays (robot, ray) of every kind: an even spread over
    the rings (rays that cross the terrain, rays that never do), rays that
    meet a cylinder wall, and rays whose march crosses more than once."""
    above = marg > 0
    crossed = above[..., :-1] & ~above[..., 1:]
    oc = o[:, None, :2] - world.centers
    dxy = d[..., :2]
    a = (dxy * dxy).sum(-1)[..., None]
    bh = torch.einsum("bni,bmi->bnm", dxy, oc)
    disc = bh * bh - a * ((oc * oc).sum(-1)[:, None, :] - world.radii ** 2)
    tc = (-bh - torch.sqrt(torch.clamp(disc, min=0.0))) / a
    pz = o[:, None, 2:3] + tc * d[..., 2:3]
    ground = tw3.terrain_height(world, world.centers)
    wall = ((disc > 0) & (tc > 1e-3) & (pz > ground) &
            (pz < ground + world.heights)).any(-1)
    picks = []
    N = d.shape[1]
    for b in range(d.shape[0]):
        kinds = (torch.arange(0, N, max(N // per_robot, 1)),
                 torch.nonzero(wall[b])[:, 0],
                 torch.nonzero(crossed[b].sum(-1) > 1)[:, 0])
        for idx in kinds:
            step = max(len(idx) // per_robot, 1)
            picks += [(b, int(n)) for n in idx[::step][:per_robot]]
    return sorted(set(picks)), crossed


def _emulate(tworld, poses, sim, roll, pitch, noise, march_steps=16,
             refine_steps=5):
    o, dl, d = tw3.sensor_rays(tworld, poses, sim, roll, pitch)
    ts = torch.linspace(0.0, sim.beam_max_range, march_steps)
    grazing, extra, marg = _grazing(tworld, o, d, ts)
    picks, crossed = _rays(tworld, o, d, ts, marg)
    cyl = [_cylinders(tworld, o[b]) for b in range(o.shape[0])]
    pts, hits, taken = [], [], []
    for b, n in picks:
        p, h, k = _ray(o[b], d[b, n], dl[n], ts, tworld.terrain, cyl[b],
                       refine_steps, sim.beam_max_range, sim.range_noise,
                       None if noise is None else noise[b, n])
        pts.append(p)
        hits.append(h)
        taken.append(k)
    bi, ni = (torch.tensor(x) for x in zip(*picks))
    return dict(points=torch.stack(pts), hit=torch.tensor(hits), b=bi, n=ni,
                taken=torch.tensor(taken), grazing=grazing[bi, ni],
                extra=extra[bi, ni],
                crossings=crossed[bi, ni].sum(-1))


# config, tilted, the terrain's amplitudes scaled by ("rugged": sines of
# 3.6 m in all, so that near-level rays cross the terrain more than once)
CASES = {"sim3d": (sim3d_config, True, 1.0),
         "sim3d_level": (sim3d_config, False, 1.0),
         "ref_scale": (ref_scale_config, True, 1.0),
         "rugged": (sim3d_config, False, 6.0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_raycast3d_emulation_matches_plain_and_jax(case):
    """The emulated kernel on a few hundred rays of two robots' noise-free
    scans, tilted by the terrain or level: equal hit flags and points
    within tolerance of the CPU path and of slam_tpu; the rays cover the
    early exit (a march that stops before its last sample and, on the
    rugged terrain, one that crosses the terrain again beyond the first
    crossing), no crossing at all, and the cylinders."""
    make_cfg, tilt, amp = CASES[case]
    sim = make_cfg().sim
    world = jw3.make_world(jax.random.PRNGKey(42), sim)
    world = world._replace(terrain=world.terrain.at[:, 3].multiply(amp))
    tworld = interop.world3d_from_numpy(numpy_tree(world), "cpu")
    if tilt:
        roll, pitch = jax.vmap(lambda p: jw3.terrain_attitude(world, p))(
            POSES[:, :2])
    else:
        roll = pitch = jnp.zeros(len(POSES), jnp.float32)
    troll, tpitch = to_torch(roll), to_torch(pitch)
    em = _emulate(tworld, to_torch(POSES), sim, troll, tpitch, None)
    before = profiling.count_of("raycast3d.launches")
    plain_p, plain_h = tw3.raycast(tworld, to_torch(POSES), sim, roll=troll,
                                   pitch=tpitch)
    assert profiling.count_of("raycast3d.launches") == before
    jp, jh = jax.jit(jax.vmap(lambda p, r, q: jw3.raycast(
        world, p, sim, roll=r, pitch=q)))(jnp.asarray(POSES), roll, pitch)
    b, n, off = em["b"], em["n"], ~em["grazing"]
    for what, (pts, hit) in (("plain", (plain_p, plain_h)),
                             ("slam_tpu", (to_torch(jp), to_torch(jh)))):
        assert_equal(em["hit"][off], hit[b, n][off], what)
        _assert_points(em["points"][off], pts[b, n][off], em["extra"][off],
                       what)
    assert int(em["grazing"].sum()) <= 1
    T = 16
    assert len(b) >= 150
    assert ((em["crossings"] > 0) & (em["taken"] < T)).any()   # early exit
    assert (em["crossings"] == 0).any()       # the march runs out, no refine
    assert em["hit"][em["crossings"] == 0].any()   # ... and a cylinder hit
    if case == "rugged":
        assert (em["crossings"] > 1).any()    # a later crossing left alone


def test_raycast3d_emulation_with_noise():
    """The range noise passed in, added after the hit test as the kernel
    adds it: the emulation equals the CPU path given the same draw."""
    sim = dataclasses.replace(sim3d_config().sim, range_noise=0.05)
    tworld = interop.world3d_from_numpy(
        numpy_tree(jw3.make_world(jax.random.PRNGKey(7), sim)), "cpu")
    poses = to_torch(POSES)
    roll, pitch = tw3.terrain_attitude(tworld, poses[:, :2])
    noise = torch.randn(2, sim.num_rings * sim.num_azimuth,
                        generator=torch.Generator().manual_seed(3))
    em = _emulate(tworld, poses, sim, roll, pitch, noise)
    pts, hit = tw3.raycast(tworld, poses, sim, noise=noise, roll=roll,
                           pitch=pitch)
    b, n, off = em["b"], em["n"], ~em["grazing"]
    assert_equal(em["hit"][off], hit[b, n][off])
    _assert_points(em["points"][off], pts[b, n][off], em["extra"][off])
    exact, _ = tw3.raycast(tworld, poses, sim, roll=roll, pitch=pitch)
    assert float((pts - exact).abs().max()) > 0.05
