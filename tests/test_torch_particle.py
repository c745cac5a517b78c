"""Port parity, the particle matcher (BASELINE config 5): K5's plain
version and pf_match against slam_tpu's particle scorer (CPU), and one
config-5 tick.

Tolerances:
- Scores: the port's plain scorer against JAX `score_particles` with
  "gather" and with "pallas" (interpret mode): hit counts exact, or off by
  at most one point per particle where XLA:CPU contracts c*x - s*y into a
  fused multiply-add and a point on a cell edge changes cell. Measured on
  these inputs: 0 flips against either engine.
- pf_match with JAX's own draws: pose 1e-6 (the bound of slam_tpu's own
  engine-agreement test), score and ok exact; resampled particles equal
  wherever a resampling point is not within 1e-6 of a CDF step.
- One config-5 tick (process_frame_planes against a shared grid), both
  packages from the same state, frame and draws: poses 1e-5, occupancy
  counts exact.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import PfConfig as JPf, sim2d_config
from slam_tpu.mapping import point_map as jpm
from slam_tpu.ops import particle as jpart
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.sim import world2d as jw
from slam_tpu.types import PointCloud as JCloud
from slam_tpu_torch import interop
from slam_tpu_torch.config import PfConfig
from slam_tpu_torch.mapping.point_map import PointMapGrid
from slam_tpu_torch.ops import particle as tpart
from slam_tpu_torch.pipeline import slam2d as tslam
from slam_tpu_torch.types import PointCloud
from slam_tpu_torch.utils import profiling as tprof
from tests.torch_parity import (assert_close, assert_equal, numpy_tree,
                                pallas_interpret, to_np, to_torch)

torch.set_num_threads(1)

G = 64
RES = 0.5


def _world_points(rng, n=400, spread=14.0):
    return rng.uniform(-spread, spread, (n, 2)).astype(np.float32)


def _jax_grid(pts, center=(0.0, 0.0)):
    g = jpm.init_point_map(G, RES)
    g = g.replace(center=jnp.asarray(center, jnp.float32))
    return jpm.update_point_map_xy(g, jnp.asarray(pts[:, 0]),
                                   jnp.asarray(pts[:, 1]), None,
                                   jnp.ones(len(pts), bool), RES)


def _port_grid(jgrids):
    """Port PointMapGrid from a list of unbatched JAX grids."""
    def st(name):
        return to_torch(np.stack([np.asarray(getattr(g, name))
                                  for g in jgrids]))
    return PointMapGrid(count=st("count"), sum_x=st("sum_x"),
                        sum_y=st("sum_y"), sum_z=st("sum_z"),
                        center=st("center"), resolution=RES)


def _problem(B=3, N=96, P=40, seed=0, shared=True):
    """Scans of each robot's world seen from a true pose, particles around
    it (some thrown off the grid), robot B-1 with no valid points."""
    rng = np.random.default_rng(seed)
    worlds = [_world_points(rng) for _ in range(1 if shared else B)]
    centers = [(0.0, 0.0)] if shared else \
        [tuple(rng.uniform(-1, 1, 2)) for _ in range(B)]
    jgrids = [_jax_grid(w, c) for w, c in zip(worlds, centers)]
    true = np.stack([rng.uniform(-2, 2, B), rng.uniform(-2, 2, B),
                     rng.uniform(-0.5, 0.5, B)], -1).astype(np.float32)
    scans, valid = [], []
    for b in range(B):
        w = worlds[0 if shared else b]
        c, s = np.cos(true[b, 2]), np.sin(true[b, 2])
        local = (w - true[b, :2]) @ np.array([[c, -s], [s, c]], np.float32)
        scans.append(local[:N])
        valid.append(rng.random(N) < 0.9)
    scans = np.stack(scans).astype(np.float32)
    valid = np.stack(valid)
    valid[-1] = False
    parts = true[:, None] + rng.normal(0, 0.3, (B, P, 3)).astype(np.float32)
    parts[:, 0] = true
    parts[:, 1, :2] += 40.0                      # off the grid
    return jgrids, scans, valid, parts.astype(np.float32)


def _jax_scores(jgrids, scans, valid, parts, engine):
    cfg = JPf(scorer=engine)
    if len(jgrids) == 1:
        g = jgrids[0]
        return jax.vmap(lambda s, v, p: jpart.score_particles(
            g, s, v, p, RES, cfg))(scans, valid, parts)
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *jgrids)
    return jax.vmap(lambda g, s, v, p: jpart.score_particles(
        g, s, v, p, RES, cfg))(stacked, scans, valid, parts)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_robot"])
@pytest.mark.parametrize("engine", ["gather", "pallas"])
def test_scores_match_jax(engine, shared):
    jgrids, scans, valid, parts = _problem(shared=shared, seed=int(shared))
    if engine == "pallas":
        with pallas_interpret():
            want = _jax_scores(jgrids, scans, valid, parts, engine)
    else:
        want = _jax_scores(jgrids, scans, valid, parts, engine)
    grid = _port_grid(jgrids)
    got = tpart.score_particles(grid, to_torch(scans), to_torch(valid),
                                to_torch(parts), RES, PfConfig())
    denom = np.maximum(valid.sum(-1, keepdims=True), 1)
    flips = np.abs(np.rint((to_np(got) - np.asarray(want)) * denom))
    assert flips.max() <= 1
    assert int((flips > 0).sum()) == 0     # measured: no flips here
    assert to_np(got)[:-1, 0].min() > 0.5  # the true pose scores
    assert_equal(got[:, 1], 0.0)           # off the grid
    assert_equal(got[-1], 0.0)             # no valid points: 0 / 1
    for scorer in ("gather", "dense", "kernel", "pallas"):
        assert_equal(tpart.score_particles(
            grid, to_torch(scans), to_torch(valid), to_torch(parts), RES,
            PfConfig(scorer=scorer)), got)
    assert tprof.count_of("k5.launches") == 0


def test_score_pose_matches_jax():
    jgrids, scans, valid, parts = _problem(shared=True, seed=5)
    g = jgrids[0]
    want = jax.vmap(lambda s, v, p: jpart.score_pose(g, s, v, p, RES))(
        scans, valid, parts[:, 0])
    got = tpart.score_pose(_port_grid(jgrids), to_torch(scans),
                           to_torch(valid), to_torch(parts[:, 0]), RES)
    assert_equal(got, want)


def _cloud(scans, valid):
    xyz = np.concatenate([scans, np.zeros_like(scans[..., :1])], -1)
    return xyz, valid


def test_pf_match_matches_jax_draws():
    B, P = 3, 48
    jgrids, scans, valid, parts = _problem(B=B, N=200, seed=3)
    valid[-1] = True                        # every robot can match here
    g = jgrids[0]
    pred = parts[:, 0] + np.array([0.2, -0.15, 0.03], np.float32)
    cfg = PfConfig(num_particles=P, score_stride=2)
    jcfg = JPf(num_particles=P, score_stride=2, scorer="gather")
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    xyz, _ = _cloud(scans, valid)
    # eager, not jitted: under jit XLA:CPU fuses pred + noise * sigma into
    # one multiply-add and the particles move by an ulp
    want = jax.vmap(lambda k, x, v, p: jpart.pf_match(
        k, g, JCloud(xyz=x, valid=v, flags=jnp.zeros(v.shape, jnp.int32)),
        p, RES, jcfg))(keys, xyz, valid, pred)
    k12 = jax.vmap(jax.random.split)(keys)
    noise = jax.vmap(lambda k: jax.random.normal(k, (P, 3)))(k12[:, 0])
    u = jax.vmap(jax.random.uniform)(k12[:, 1])

    cloud = PointCloud(xyz=to_torch(xyz), valid=to_torch(valid),
                       flags=torch.zeros(valid.shape, dtype=torch.int32))
    got = tpart.pf_match(_port_grid(jgrids), cloud, to_torch(pred), RES,
                         cfg, noise=to_torch(noise), u=to_torch(u))
    assert_close(got.pose, want.pose, atol=1e-6)
    assert_equal(got.score, want.score)
    assert_equal(got.ok, want.ok)
    assert bool(got.ok.all())

    # resampled particles agree away from CDF steps
    parts_j = pred[:, None] + np.asarray(noise) * np.array(
        [cfg.pos_sigma, cfg.pos_sigma, cfg.yaw_sigma], np.float32)
    parts_j[:, 0] = pred
    scores = np.asarray(jax.vmap(lambda s, v, p: jpart.score_particles(
        g, s[::2, :2], v[::2], p, RES, jcfg))(xyz, valid, parts_j))
    w = np.asarray(jax.nn.softmax(scores / cfg.temperature, -1))
    cdf = np.cumsum(w, -1)
    grid_u = (np.asarray(u)[:, None] + np.arange(P)) / P
    clear = np.abs(grid_u[:, :, None] - cdf[:, None, :]).min(-1) > 1e-6
    assert clear.mean() > 0.9
    gp, wp = to_np(got.particles), np.asarray(want.particles)
    np.testing.assert_array_equal(gp[clear], wp[clear])


def test_pf_config_is_jaxs_and_drives_pf_match():
    """ops/particle.PFConfig has slam_tpu's fields and defaults, and
    pf_match reads it as it reads config.PfConfig (its default)."""
    assert tpart.PFConfig._fields == jpart.PFConfig._fields
    assert tpart.PFConfig() == tuple(jpart.PFConfig())
    assert tpart.PFConfig._fields == tuple(
        f.name for f in dataclasses.fields(PfConfig))
    jgrids, scans, valid, parts = _problem(B=2, N=120, seed=6)
    cloud = PointCloud(xyz=to_torch(_cloud(scans, valid)[0]),
                       valid=to_torch(valid),
                       flags=torch.zeros(valid.shape, dtype=torch.int32))
    pred = to_torch(parts[:, 0])
    P = tpart.PFConfig().num_particles
    noise = torch.randn(2, P, 3, generator=torch.Generator().manual_seed(1))
    u = torch.rand(2, generator=torch.Generator().manual_seed(2))
    a = tpart.pf_match(_port_grid(jgrids), cloud, pred, RES, noise=noise,
                       u=u)
    b = tpart.pf_match(_port_grid(jgrids), cloud, pred, RES, PfConfig(),
                       noise=noise, u=u)
    for x, y in zip(a, b):
        assert_equal(x, y)


def test_pf_match_needs_draws():
    jgrids, scans, valid, parts = _problem(B=2, seed=4)
    cloud = PointCloud(xyz=to_torch(_cloud(scans, valid)[0]),
                       valid=to_torch(valid),
                       flags=torch.zeros(valid.shape, dtype=torch.int32))
    with pytest.raises(ValueError, match="generator"):
        tpart.pf_match(_port_grid(jgrids), cloud, to_torch(parts[:, 0]),
                       RES, PfConfig())
    a = tpart.pf_match(_port_grid(jgrids), cloud, to_torch(parts[:, 0]), RES,
                       PfConfig(), generator=torch.Generator().manual_seed(1))
    b = tpart.pf_match(_port_grid(jgrids), cloud, to_torch(parts[:, 0]), RES,
                       PfConfig(), generator=torch.Generator().manual_seed(1))
    assert_equal(a.pose, b.pose)
    with pytest.raises(ValueError, match="scorer"):
        tpart.score_particles(_port_grid(jgrids), to_torch(scans),
                              to_torch(valid), to_torch(parts), RES,
                              PfConfig(scorer="nope"))


def _pf_cfg():
    c = sim2d_config()
    return dataclasses.replace(
        c, icp=dataclasses.replace(c.icp, matcher="particle"),
        pf=dataclasses.replace(c.pf, score_stride=4))


def test_config5_tick_matches_jax():
    """process_frame_planes against a shared grid that holds the fleet's
    first scans (robots at the origin), one tick later."""
    cfg = _pf_cfg()
    B = 2
    world = jw.make_world(jax.random.PRNGKey(42), cfg.sim)
    st = jax.vmap(lambda k: jslam.init_state(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), B)).replace(map_grid=None)
    shared = jpm.init_point_map(cfg.mls.size_x, RES)
    r0, h0 = jw.raycast(world, jnp.zeros(3), cfg.sim)
    x0, y0, h0 = jw.scan_to_planes(r0, h0)
    shared = jpm.update_point_map_xy(shared, x0, y0, None, h0, RES)

    cmd = jax.vmap(lambda s: jw.drive_cmd(s, cfg.sim.dt))(st.step)
    true2 = jax.vmap(lambda p, c: jw.unicycle_step(p, c, cfg.sim.dt))(
        st.true_pose[:, :3], cmd)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    ranges, hit = jax.vmap(lambda p, k: jw.raycast(
        world, p, cfg.sim, noise_key=k))(true2, keys)
    sx, sy, hit = jax.vmap(jw.scan_to_planes)(ranges, hit)
    gyro = cmd[:, 2] + cfg.sim.gyro_bias

    want = jax.jit(jax.vmap(
        lambda s, a, b, h, gy, c: jslam.process_frame_planes(
            s, a, b, h, gy, c, cfg, incremental_map=False, refresh_map=False,
            shift_maps=False, pf_target=shared)))(st, sx, sy, hit, gyro, cmd)

    P = cfg.pf.num_particles
    pf_keys = jax.vmap(jax.random.fold_in)(st.rng, st.step)
    k12 = jax.vmap(jax.random.split)(pf_keys)
    noise = jax.vmap(lambda k: jax.random.normal(k, (P, 3)))(k12[:, 0])
    u = jax.vmap(jax.random.uniform)(k12[:, 1])
    # the port's matcher takes JAX's draws in place of its generator's
    draws = dict(noise=to_torch(noise), u=to_torch(u))
    with mock.patch.object(tslam, "pf_match", lambda *a, generator, **k:
                           tpart.pf_match(*a, **k, **draws)):
        got = tslam.process_frame_planes(
            interop.state_from_numpy(numpy_tree(st), "cpu"), to_torch(sx),
            to_torch(sy), to_torch(hit), to_torch(gyro), to_torch(cmd), cfg,
            incremental_map=False, refresh_map=False, shift_maps=False,
            pf_target=interop.point_map_from_numpy(numpy_tree(shared),
                                                   "cpu"))
    assert bool(want.scan_reg_ok.all())
    assert_equal(got.scan_reg_ok, want.scan_reg_ok)
    assert_close(got.scan_reg_pose, want.scan_reg_pose, atol=1e-5)
    assert_close(got.pose, want.pose, atol=1e-5)
    assert_close(got.ekf.sigma, want.ekf.sigma, atol=1e-5)
    assert_equal(got.local_map.counts, want.local_map.counts)
    assert got.map_grid is None and want.map_grid is None
    assert tprof.count_of("k5.launches") == 0


def test_rollout_particle_form_tracks():
    """slam2d.rollout with the particle matcher and per-robot grids (no
    export; one shift per macro) on the CPU."""
    cfg = _pf_cfg()
    gen = torch.Generator().manual_seed(0)
    world = interop.world_from_numpy(numpy_tree(jw.make_world(
        jax.random.PRNGKey(42), cfg.sim)), "cpu")
    st = tslam.init_state(cfg, 2, device="cpu", generator=gen)
    fin, (est, true) = tslam.rollout(st, world, cfg, 8, gen)
    assert est.shape == (2, 8, 3)
    assert (tslam.ate(est, true) < 0.1).all()
    assert fin.scan_reg_ok.all() and (fin.map_grid.count > 0).any()
    assert not fin.map_cloud.valid.any()   # the particle form never exports
    assert tprof.count_of("k5.launches") == 0


# ---- K5's pieces: the bit table, the scale, the strided reads --------------

def _unpack(words, G):
    """(Bg, W) int32 words -> (Bg, G*G) bools, bit k % 32 of word k // 32."""
    w = words.numpy().view(np.uint32)
    bits = (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(len(w), -1)[:, :G * G].astype(bool)


@pytest.mark.parametrize("G", [192, 100])
def test_occupancy_bits_packing(G):
    """The bit table holds count > 0 cell by cell (G*G a multiple of 32 and
    not); a NaN count, the mark of a misaligned merge, is not occupied."""
    rng = np.random.default_rng(G)
    count = rng.integers(0, 3, (2, G, G)).astype(np.float32)
    count[rng.random((2, G, G)) < 0.05] = np.nan
    count[1, -1, -1] = 1.0                      # the last, partial word
    words = tpart.occupancy_bits_reference(to_torch(count))
    assert words.dtype == torch.int32
    assert words.shape == (2, (G * G + 31) // 32)
    np.testing.assert_array_equal(_unpack(words, G),
                                  (count > 0).reshape(2, -1))
    grid = PointMapGrid(count=to_torch(count), sum_x=None, sum_y=None,
                        sum_z=None, center=torch.zeros(2, 2))
    assert_equal(tpart.occupancy_bits(grid), words)
    assert tprof.count_of("k5.pack_launches") == 0


def test_scale_power_of_two_identity():
    """For a power-of-two resolution x / r and x * cell_scale(r) are the
    same f32 bits (random, edge and subnormal values): the card's multiply
    equals the CPU's division. For 0.3 they differ, and the card's plain
    version multiplies (PyTorch's rule for a tensor over a Python float)."""
    rng = np.random.default_rng(0)
    info = np.finfo(np.float32)
    x = np.concatenate([
        rng.uniform(-100, 100, 200_000).astype(np.float32),
        (rng.standard_normal(20_000) * 1e-38).astype(np.float32),
        rng.integers(1, 2 ** 23, 20_000).astype(np.float32) * info.smallest_subnormal,
        np.array([0.0, -0.0, info.max, -info.max, info.tiny, -info.tiny,
                  info.smallest_subnormal, np.inf, -np.inf], np.float32)])
    with np.errstate(over="ignore", under="ignore"):
        for r in (0.5, 0.25, 1.0, 2.0, 0.125, 2.0 ** -20):
            s = np.float32(tpart.cell_scale(r))
            np.testing.assert_array_equal((x / np.float32(r)).view(np.int32),
                                          (x * s).view(np.int32))
        s = np.float32(tpart.cell_scale(0.3))
        assert s == np.float32(1) / np.float32(0.3)
        assert ((x / np.float32(0.3)) != (x * s)).any()


def _k5_emulated(words, grid, scan_xy, valid, parts, resolution):
    """K5's scoring in numpy from what the wrapper hands the kernel: the
    bit table, the operands read back through score_layout's strides, the
    reciprocal scale; fractions of hits over the valid count."""
    G = grid.count.shape[-1]
    lay = tpart.score_layout(scan_xy, valid, parts, grid.center)

    def back(t, k0, k1):
        return torch.as_strided(t, t.shape, lay[k0:k1],
                                t.storage_offset()).numpy()
    sxy, v, p, ctr = (back(scan_xy, 0, 3), back(valid, 3, 5),
                      back(parts, 5, 8), back(grid.center, 8, 10))
    occ = _unpack(words, G)
    s = np.float32(tpart.cell_scale(resolution))
    B, P, _ = p.shape
    out = np.zeros((B, P), np.float32)
    for b in range(B):
        tb = 0 if len(occ) == 1 else b
        c = to_np(torch.cos(torch.from_numpy(p[b, :, 2:3])))
        sn = to_np(torch.sin(torch.from_numpy(p[b, :, 2:3])))
        x, y = sxy[b, :, 0][None], sxy[b, :, 1][None]
        wx = (c * x - sn * y) + p[b, :, 0:1]
        wy = (sn * x + c * y) + p[b, :, 1:2]
        fx = np.floor((wx - ctr[tb, 0]) * s)
        fy = np.floor((wy - ctr[tb, 1]) * s)
        inb = (fx >= -(G // 2)) & (fx < G - G // 2) & \
            (fy >= -(G // 2)) & (fy < G - G // 2)
        k = np.where(inb, (fx + G // 2) * G + (fy + G // 2), 0).astype(int)
        hits = (occ[tb][k] & inb & v[b][None]).sum(-1)
        out[b] = np.float32(hits) / np.float32(max(int(v[b].sum()), 1))
    return out


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_robot"])
def test_k5_emulation_matches_plain_and_jax(shared):
    """The scan read at stride 4 from a (B, 4N, 3) cloud and the particles
    and pose views read through score_layout's strides, scored from the bit
    table: equal to the plain version and to JAX's gather engine."""
    jgrids, scans, valid, parts = _problem(shared=shared, seed=7, N=48)
    B, N = valid.shape
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-5, 5, (B, 4 * N, 3)).astype(np.float32)
    xyz[:, ::4, :2] = scans
    mask = rng.random((B, 4 * N)) < 0.5
    mask[:, ::4] = valid
    grid = _port_grid(jgrids)
    scan_v, valid_v = to_torch(xyz)[:, ::4, :2], to_torch(mask)[:, ::4]
    words = tpart.occupancy_bits_reference(grid.count)
    want = _jax_scores(jgrids, scans, valid, parts, "gather")
    for p in (to_torch(parts), to_torch(parts)[:, :1]):
        got = _k5_emulated(words, grid, scan_v, valid_v, p, RES)
        assert_equal(torch.from_numpy(got), tpart.score_particles_reference(
            grid, scan_v, valid_v, p, RES))
        assert_equal(torch.from_numpy(got), np.asarray(want)[:, :p.shape[1]])
    pose = to_torch(parts[:, 0])[:, None, :]
    assert tpart.score_layout(scan_v, valid_v, pose, grid.center)[:8] == [
        12 * N, 12, 1, 4 * N, 4, 3, 3, 1]
