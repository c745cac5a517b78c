"""Port parity, simulator: world2d raycast (noise passed in), scan planes,
drive pattern and kinematics (slam_tpu_torch vs slam_tpu, CPU).

jax.random and torch generators give different streams, so the world and
the range noise come from the JAX side and are handed to the port.
Ranges agree to 1e-4 m + 1e-5 relative: ulp-level differences of the two
frameworks' sin/cos grow through the ray/circle discriminant b^2 - c,
which cancels near grazing hits (measured max 1.8e-4 m at 43 m)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from slam_tpu.config import sim2d_config
from slam_tpu.sim import world2d as jw
from slam_tpu_torch import interop
from slam_tpu_torch.sim import world2d as tw
from tests.torch_parity import (assert_close, assert_equal, numpy_tree,
                                to_torch)

torch.set_num_threads(1)

CFG = sim2d_config()


def _poses(B=3, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-30, 30, B), rng.uniform(-30, 30, B),
                     rng.uniform(-3, 3, B)], -1).astype(np.float32)


def test_raycast_with_noise_matches_jax():
    world = jw.make_world(jax.random.PRNGKey(42), CFG.sim)
    pose = _poses()
    keys = jax.random.split(jax.random.PRNGKey(5), len(pose))
    want_r, want_h = jax.vmap(lambda p, k: jw.raycast(
        world, p, CFG.sim, noise_key=k))(jnp.asarray(pose), keys)
    noise = jax.vmap(lambda k: jax.random.normal(
        k, (CFG.sim.num_beams,)))(keys)
    got_r, got_h = tw.raycast(interop.world_from_numpy(numpy_tree(world), "cpu"),
                              to_torch(pose), CFG.sim, noise=to_torch(noise))
    assert_equal(got_h, want_h)
    assert_close(got_r, want_r, atol=1e-4, rtol=1e-5)


def test_raycast_generator_noise():
    cfg = dataclasses.replace(CFG.sim, range_noise=0.05)
    world = tw.make_world(torch.Generator().manual_seed(1), cfg,
                          device="cpu")
    pose = to_torch(_poses(B=4, seed=1))
    exact, hit = tw.raycast(world, pose, cfg)
    a, _ = tw.raycast(world, pose, cfg,
                      generator=torch.Generator().manual_seed(3))
    b, _ = tw.raycast(world, pose, cfg,
                      generator=torch.Generator().manual_seed(3))
    assert_equal(a, b)
    d = (a - exact).numpy()
    assert abs(d.mean()) < 0.01 and 0.04 < d.std() < 0.06
    assert hit.any()


def test_make_world_layout():
    w = tw.make_world(torch.Generator().manual_seed(0), CFG.sim,
                      device="cpu")
    M = CFG.sim.num_obstacles
    assert w.centers.shape == (M, 2) and w.radii.shape == (M,)
    assert (w.centers.norm(dim=-1) >= 8.0 - 1e-4).all()
    assert (w.centers.abs() <= CFG.sim.world_extent * 0.9 + 1e-3).all()
    assert (w.radii >= CFG.sim.obstacle_radius_min).all()
    assert (w.radii <= CFG.sim.obstacle_radius_max).all()


def test_scan_drive_kinematics_match_jax():
    rng = np.random.default_rng(4)
    ranges = rng.uniform(1, 50, (2, CFG.sim.num_beams)).astype(np.float32)
    hit = rng.random((2, CFG.sim.num_beams)) < 0.8
    gx, gy, gh = tw.scan_to_planes(to_torch(ranges), to_torch(hit))
    wx, wy, wh = jw.scan_to_planes(jnp.asarray(ranges), jnp.asarray(hit))
    assert_close(gx, wx, atol=2e-5)
    assert_close(gy, wy, atol=2e-5)
    assert_equal(gh, wh)

    step = np.array([0, 7, 123], np.int32)
    cmd = tw.drive_cmd(to_torch(step), CFG.sim.dt)
    assert_close(cmd, jax.vmap(lambda s: jw.drive_cmd(s, CFG.sim.dt))(
        jnp.asarray(step)), atol=1e-6)
    pose = _poses(B=3, seed=6)
    assert_close(tw.unicycle_step(to_torch(pose), cmd, CFG.sim.dt),
                 jax.vmap(lambda p, c: jw.unicycle_step(p, c, CFG.sim.dt))(
                     jnp.asarray(pose), jnp.asarray(cmd.numpy())),
                 atol=1e-5)


def test_place_obstacles_is_make_worlds_placement():
    """place_obstacles draws the centres, then the radii, as make_world
    did before it was split out (the seed-0 and seed-42 worlds are
    unchanged), world3d places its cylinders with it, and its placement
    follows slam_tpu's rule: centres within 0.9 of the extent, pushed out
    of the 8 m spawn disk, radii within the configured range."""
    from slam_tpu_torch.config import sim3d_config as tsim3d_config
    from slam_tpu_torch.sim import world3d as tw3
    for seed in (0, 42):
        pos, radii = tw.place_obstacles(torch.Generator().manual_seed(seed),
                                        CFG.sim, "cpu")
        w = tw.make_world(torch.Generator().manual_seed(seed), CFG.sim,
                          device="cpu")
        assert_equal(pos, w.centers)
        assert_equal(radii, w.radii)
        c3 = tsim3d_config().sim
        w3 = tw3.make_world(torch.Generator().manual_seed(seed), c3,
                            device="cpu")
        p3, r3 = tw.place_obstacles(torch.Generator().manual_seed(seed), c3,
                                    "cpu")
        assert_equal(p3, w3.centers)
        assert_equal(r3, w3.radii)
    g = torch.Generator().manual_seed(42)
    e = torch.rand(CFG.sim.num_obstacles, 2, generator=g) * (
        2 * CFG.sim.world_extent * 0.9) - CFG.sim.world_extent * 0.9
    r = e.norm(dim=-1, keepdim=True)
    assert_close(tw.place_obstacles(torch.Generator().manual_seed(42),
                                    CFG.sim, "cpu")[0],
                 torch.where(r < 8.0, e * (8.0 / (r + 1e-6)), e), atol=0)
    jpos, jrad = jw.place_obstacles(*jax.random.split(
        jax.random.PRNGKey(42)), CFG.sim)
    for p, rad in ((np.asarray(jpos), np.asarray(jrad)),
                   (pos.numpy(), radii.numpy())):
        assert (np.linalg.norm(p, axis=-1) >= 8.0 - 1e-4).all()
        assert (np.abs(p) <= CFG.sim.world_extent * 0.9 + 1e-3).all()
        assert (rad >= CFG.sim.obstacle_radius_min).all()
        assert (rad <= CFG.sim.obstacle_radius_max).all()

