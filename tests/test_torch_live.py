"""Port parity, the live-frame path: replay frame synthesis, scan points,
20 frames of the live consumer and the card's 200, and the native runtime's
ring, loader and profiler through the port's own bindings (slam_tpu_torch
vs slam_tpu, CPU).

Tolerances:
- synth_frames: hit masks (ranges < beam_max_range) equal, misses at
  exactly the cap in both; ranges to 1e-4 m + 1e-5 relative (the rule of
  tests/test_torch_sim.py) plus, on a beam that hits an obstacle, 16 ulps
  of the ray / circle term c over sqrt(disc): the f32 discriminant
  b*b - c cancels, and slam_tpu's compiled scan rounds it as one
  multiply-add where the port rounds each step, so a grazing ray (disc
  near 0) moves by up to mm (measured 2.1 mm on 1 of 7,920 beams,
  disc 0.09 m^2); gyro and commands to 1e-6. The drive loop's poses
  agree to 1e-5 (measured 6e-8).
- scan_to_points: 2e-5 m (sin / cos ulps at 50 m).
- consume: fused poses within 1e-3 m and 1e-3 rad of slam_tpu's jitted
  consume (examples/run_live.py's step) over 20 frames, with the direct
  nearest-neighbour form patched into slam_tpu (its CPU expanded form
  flips near-tied correspondences by up to 7.1 mm a frame); the same
  bounds over 200 frames (chip_smoke.py [live]'s from the card, and
  examples/run_live.py's), whose median position errors against the true
  poses agree within 1e-3 m.
- the transport (ring, loader, staging) moves frames bit for bit: the
  consumer fed through it equals the direct loop exactly.
"""

import gc
import os
import threading
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import sim2d_config
from slam_tpu.geometry import se2_apply as jse2_apply
from slam_tpu.mapping import point_map as jpm
from slam_tpu.models import ekf as jekf
from slam_tpu.ops import nn as jnn
from slam_tpu.ops.icp import icp_fit as jicp_fit
from slam_tpu.ops.voxel import crop_box as jcrop_box
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.sim import replay as jreplay
from slam_tpu.sim import world2d as jw
from slam_tpu.types import make_cloud as jmake_cloud
from slam_tpu_torch import interop, live
from slam_tpu_torch.config import sim2d_config as tsim2d_config
from slam_tpu_torch.runtime import native
from slam_tpu_torch.sim import replay as treplay
from slam_tpu_torch.sim import world2d as tw
from tests.torch_parity import assert_close, assert_equal, numpy_tree

torch.set_num_threads(1)

CFG = sim2d_config()
TCFG = tsim2d_config()
B = CFG.sim.num_beams
FRAMES = 20


def _direct_sq_dist(q, m):
    d = q[..., :, None, :] - m[..., None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]


def _jax_consume(carry, ranges, gyro, cmd):
    """examples/run_live.py's consumer step."""
    cfg = CFG
    ekf, map_grid, map_cloud = carry
    ekf = jekf.motion_update(ekf, cmd, cfg.sim.dt, cfg.ekf)
    ekf = jekf.yaw_rate_update(ekf, gyro, cfg.ekf)
    pred = jnp.stack([ekf.mu[0], ekf.mu[1], ekf.mu[6]])
    xyz, hit = jw.scan_to_points(ranges, ranges < cfg.sim.beam_max_range,
                                 cfg.sim)
    scene = jslam.build_scene(xyz, hit, cfg)
    target = jcrop_box(map_cloud, pred[:2], cfg.icp.crop_dist)
    icp = jicp_fit(scene.xyz[..., :2], scene.valid, scene.is_ga(),
                   target.xyz[..., :2], target.valid, target.is_ga(),
                   pred, cfg.icp)
    ekf = jekf.slam_update(ekf, icp.pose, cfg.ekf, has_meas=icp.ok)
    fused = jnp.stack([ekf.mu[0], ekf.mu[1], ekf.mu[6]])
    pose = jnp.where(icp.ok, icp.pose, pred)
    wxy = jse2_apply(pose, scene.xyz[..., :2])
    mg = jpm.shift_point_map(map_grid, fused[:2])
    mg = jpm.update_point_map(
        mg, jnp.concatenate([wxy, scene.xyz[..., 2:]], -1), scene.valid)
    mc = jpm.export_points(mg, map_cloud.capacity,
                           ga_threshold=cfg.icp.ga_threshold)
    return (ekf, mg, mc), fused


_jax_consume_jit = jax.jit(_jax_consume)


@pytest.fixture(scope="module")
def world():
    return jw.make_world(jax.random.PRNGKey(42), CFG.sim)


@pytest.fixture(scope="module")
def frames(world):
    return jreplay.synth_frames(world, CFG.sim, FRAMES + 2, seed=0)


def _jax_drive(n):
    def body(pose, step):
        cmd = jw.drive_cmd(step, CFG.sim.dt)
        pose = jw.unicycle_step(pose, cmd, CFG.sim.dt)
        return pose, (cmd, pose)

    _, (cmds, poses) = jax.lax.scan(body, jnp.zeros(3), jnp.arange(n))
    return cmds, poses


def _range_tolerance(world, poses, ranges):
    """Per beam: 1e-4 m + 1e-5 relative, plus the cancellation error of the
    f32 ray / circle discriminant disc = b*b - c on the circle the beam
    hits: 16 ulps of |c| over sqrt(disc) (computed in f64). A grazing ray
    (disc near 0) amplifies last-bit differences without bound."""
    ctr = np.asarray(world.centers, np.float64)
    rad = np.asarray(world.radii, np.float64)
    B_ = ranges.shape[1]
    extra = np.zeros(ranges.shape)
    for i, p in enumerate(np.asarray(poses, np.float64)):
        ang = p[2] + np.arange(B_) * (2 * np.pi / B_)
        d = np.stack([np.cos(ang), np.sin(ang)], -1)
        oc = p[:2] - ctr
        b = d @ oc.T
        c = (oc * oc).sum(-1)[None] - rad[None] ** 2
        disc = b * b - c
        t = np.where(disc > 0, -b - np.sqrt(np.maximum(disc, 0)), np.inf)
        t = np.where(t > 1e-3, t, np.inf)
        k = t.argmin(1)
        cs = np.abs(c[0, k])
        ds = disc[np.arange(B_), k]
        hit = np.isfinite(t.min(1))
        extra[i] = np.where(hit, 16 * np.spacing(cs.astype(np.float32))
                            / np.sqrt(np.maximum(ds, 1e-12)), 0.0)
    return 1e-4 + 1e-5 * np.abs(ranges) + extra


def test_synth_frames_match_jax(world, frames):
    got = treplay.synth_frames(
        interop.world_from_numpy(numpy_tree(world), "cpu"), TCFG.sim,
        FRAMES + 2, seed=0)
    assert got.dtype == np.dtype("<f4") and got.shape == frames.shape
    assert treplay.frame_floats(TCFG.sim) == jreplay.frame_floats(CFG.sim)
    assert_equal(got[:, :B] < CFG.sim.beam_max_range,
                 frames[:, :B] < CFG.sim.beam_max_range)
    # misses are written at exactly the cap in both
    assert_equal(got[:, :B] == CFG.sim.beam_max_range,
                 frames[:, :B] == CFG.sim.beam_max_range)
    _, poses = _jax_drive(FRAMES + 2)
    tol = _range_tolerance(world, poses, frames[:, :B])
    err = np.abs(got[:, :B].astype(np.float64) - frames[:, :B])
    assert (err <= tol).all(), (err - tol).max()
    assert_close(got[:, B:], frames[:, B:], atol=1e-6)


def test_drive_poses_match_jax():
    cmds, poses = _jax_drive(FRAMES)
    tc, tp = treplay.drive_poses(FRAMES, TCFG.sim.dt, "cpu")
    assert_close(tc, cmds, atol=1e-6)
    assert_close(tp, poses, atol=1e-5)


@pytest.mark.parametrize("with_yaw", [False, True])
def test_scan_to_points_matches_jax(with_yaw):
    rng = np.random.default_rng(3)
    ranges = rng.uniform(1, 50, (2, B)).astype(np.float32)
    hit = rng.random((2, B)) < 0.8
    yaw = rng.uniform(-3, 3, 2).astype(np.float32)
    want = [jw.scan_to_points(jnp.asarray(ranges[i]), jnp.asarray(hit[i]),
                              CFG.sim, jnp.asarray(yaw[i]) if with_yaw
                              else None) for i in range(2)]
    got, ghit = tw.scan_to_points(torch.from_numpy(ranges),
                                  torch.from_numpy(hit),
                                  torch.from_numpy(yaw) if with_yaw else None)
    assert_close(got, np.stack([w[0] for w in want]), atol=2e-5)
    assert_equal(ghit, np.stack([w[1] for w in want]))


def _port_loop(frames):
    carry = live.init_carry(TCFG, "cpu")
    out = []
    for fr in frames:
        carry, f = live.consume(carry, *live.split_frame(
            torch.from_numpy(fr), B), TCFG)
        out.append(f[0].numpy())
    return np.stack(out)


def _jax_loop(frames):
    carry = (jekf.init_ekf(CFG.ekf, gyro_bias=CFG.sim.gyro_bias),
             jpm.init_point_map(CFG.mls.size_x),
             jmake_cloud(CFG.cloud.map_capacity))
    want = []
    with mock.patch.object(jnn, "pairwise_sq_dist", _direct_sq_dist):
        for fr in frames:
            carry, f = _jax_consume_jit(carry, jnp.asarray(fr[:B]),
                                        jnp.asarray(fr[B]),
                                        jnp.asarray(fr[B + 1:B + 4]))
            want.append(np.asarray(f))
    return np.stack(want)


def test_consume_matches_jax(frames):
    want = _jax_loop(frames[:FRAMES])
    got = _port_loop(frames[:FRAMES])
    assert np.abs(got[:, :2] - want[:, :2]).max() <= 1e-3
    dyaw = np.arctan2(np.sin(got[:, 2] - want[:, 2]),
                      np.cos(got[:, 2] - want[:, 2]))
    assert np.abs(dyaw).max() <= 1e-3
    # the map registered: the last frames move with the drive loop
    _, poses = treplay.drive_poses(FRAMES, TCFG.sim.dt, "cpu")
    assert np.abs(got[-5:, :2] - poses[-5:, :2].numpy()).max() < 0.1


def _drift_frames(source):
    if source == "card":
        # chip_smoke.py [live]'s world, made on the card from seed 42, and
        # synth_frames' 200 frames there
        return np.load(os.path.join(os.path.dirname(__file__), "data",
                                    "live_world_card.npz"))["frames"]
    # examples/run_live.py's world (slam_tpu's, key 42)
    return jreplay.synth_frames(jw.make_world(jax.random.PRNGKey(42),
                                              CFG.sim), CFG.sim, 200, seed=0)


@pytest.mark.parametrize("source", ["card", "run_live"])
def test_200_frames_drift_as_slam_tpu_does(source):
    """200 frames of the live consumer, on chip_smoke.py [live]'s own
    frames and on examples/run_live.py's: slam_tpu's consume and the port's
    stay within 1e-3 m (and 1e-3 rad) of each other on every frame, so the
    position error against the drive loop's true poses (which [live]
    gates: median over frames >= 10 below 0.1 m) is the algorithm's own
    drift, the same curve in both packages (printed)."""
    frames = _drift_frames(source)
    assert frames.shape == (200, B + 4)
    want = _jax_loop(frames)
    got = _port_loop(frames)
    assert np.abs(got[:, :2] - want[:, :2]).max() <= 1e-3
    dyaw = np.arctan2(np.sin(got[:, 2] - want[:, 2]),
                      np.cos(got[:, 2] - want[:, 2]))
    assert np.abs(dyaw).max() <= 1e-3
    _, poses = treplay.drive_poses(len(frames), TCFG.sim.dt, "cpu")
    truth = poses[:, :2].numpy()
    err_jax = np.linalg.norm(want[:, :2] - truth, axis=1)
    err_port = np.linalg.norm(got[:, :2] - truth, axis=1)
    print(f"{source}: position error every 20 frames, slam_tpu / port (m):",
          [(k, round(float(err_jax[k]), 4), round(float(err_port[k]), 4))
           for k in range(0, len(frames), 20)],
          "median (frames >= 10):", float(np.median(err_jax[10:])),
          float(np.median(err_port[10:])), "max:", float(err_jax.max()),
          float(err_port.max()))
    assert abs(np.median(err_port[10:]) - np.median(err_jax[10:])) <= 1e-3


def test_transport_feeds_consume_bit_for_bit(frames, tmp_path):
    """Frames written as a replay file, read by the native loader into the
    ring and drained through the staging buffers give the direct loop's
    poses exactly."""
    path = tmp_path / "replay.bin"
    path.write_bytes(frames[:FRAMES].tobytes())
    ring = native.FrameRing(64, (treplay.frame_floats(TCFG.sim),))
    loader = native.ScanLoader(ring, path=str(path), loop=False)
    loader.start()
    deadline = time.time() + 5.0
    while loader.produced < FRAMES and time.time() < deadline:
        time.sleep(0.01)
    loader.stop()
    prof = native.Profiler()
    staging = live.Staging(treplay.frame_floats(TCFG.sim), "cpu")
    step = live.make_step(TCFG, "cpu", torch.from_numpy(frames[0]))
    assert isinstance(step, live.EagerStep)
    poses, done = live.drain(ring, step, FRAMES, prof, staging)
    assert done == FRAMES and ring.dropped == 0
    assert_equal(poses, _port_loop(frames[:FRAMES]))
    assert prof.stats("device_step")["calls"] == FRAMES


def test_main_needs_a_card():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        live.main(["--frames", "2"])


def test_profiler_probe_needs_a_card():
    from slam_tpu_torch import profiler_probe
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler_probe.main([])


# the ring, loader and profiler behaviours of tests/test_runtime.py,
# through the port's bindings

def test_runtime_builds_into_the_ports_build_dir():
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "slam_tpu_torch")
    assert path.name.startswith("libslamrt-") and path.exists()


def test_ring_push_pop_fifo():
    ring = native.FrameRing(slots=4, frame_shape=(8, 3))
    f0 = np.arange(24, dtype=np.float32).reshape(8, 3)
    assert ring.push(f0)
    assert ring.push(f0 * 2)
    seq1, out1 = ring.pop()
    seq2, out2 = ring.pop()
    assert (seq1, seq2) == (1, 2)
    assert_equal(out1, f0)
    assert_equal(out2, f0 * 2)
    assert ring.pop() == (0, None)


def test_ring_drop_oldest_and_pop_into():
    ring = native.FrameRing(slots=2, frame_shape=(4,))
    for i in range(5):
        ring.push(np.full(4, i, np.float32))
    assert ring.dropped == 3
    out = np.zeros(4, np.float32)
    assert ring.pop_into(out) > 0 and out[0] == 3.0
    with pytest.raises(ValueError, match="float32"):
        ring.pop_into(np.zeros(3, np.float32))


def test_synthetic_loader_threads():
    ring = native.FrameRing(slots=64, frame_shape=(128,))
    loader = native.ScanLoader(ring, seed=7, num_threads=4)
    loader.start()
    deadline = time.time() + 5.0
    while loader.produced < 1000 and time.time() < deadline:
        time.sleep(0.01)
    loader.stop()
    assert loader.produced >= 1000
    seq, frame = ring.pop()
    assert seq > 0 and np.isfinite(frame).all()
    assert (np.abs(frame) <= 50.0 + 1e-3).all()


def test_replay_loader_roundtrip(tmp_path):
    frames = np.stack([np.full(16, i, np.float32) for i in range(5)])
    path = tmp_path / "r.bin"
    path.write_bytes(frames.tobytes())
    ring = native.FrameRing(slots=16, frame_shape=(16,))
    loader = native.ScanLoader(ring, path=str(path), loop=False)
    loader.start()
    deadline = time.time() + 5.0
    got = []
    while len(got) < 5 and time.time() < deadline:
        seq, fr = ring.pop()
        if seq:
            got.append(fr[0])
    loader.stop()
    assert got == [0.0, 1.0, 2.0, 3.0, 4.0] and not loader.error


def test_profiler_scopes():
    prof = native.Profiler()
    for _ in range(10):
        with prof.scope("outer"):
            with prof.scope("inner"):
                time.sleep(0.001)
    s_out, s_in = prof.stats("outer"), prof.stats("inner")
    assert s_out["calls"] == 10 and s_in["calls"] == 10
    assert s_out["total_us"] >= s_in["total_us"] > 5000
    assert "outer" in prof.report()


def test_push_wrong_size_raises_without_deadlock():
    ring = native.FrameRing(4, (16,))
    with pytest.raises(ValueError, match="floats"):
        ring.push(np.zeros(7, np.float32))
    assert ring.push(np.arange(16, dtype=np.float32))
    seq, frame = ring.pop()
    assert seq == 1
    assert_equal(frame, np.arange(16, dtype=np.float32))


def test_replay_missing_or_short_file_raises(tmp_path):
    ring = native.FrameRing(4, (16,))
    with pytest.raises(FileNotFoundError):
        native.ScanLoader(ring, path=str(tmp_path / "missing.bin"))
    short = tmp_path / "short.bin"
    short.write_bytes(np.zeros(3, np.float32).tobytes())
    with pytest.raises(ValueError, match="smaller"):
        native.ScanLoader(ring, path=str(short))


def test_loader_holds_ring_reference():
    loader = native.ScanLoader(native.FrameRing(16, (32,)), seed=3,
                               num_threads=1)
    gc.collect()
    loader.start()
    deadline = time.time() + 5.0
    while loader.produced < 10 and time.time() < deadline:
        time.sleep(0.01)
    loader.stop()
    assert loader.produced >= 10
    seq, frame = loader._ring.pop()
    assert seq >= 1 and np.isfinite(frame).all()


def test_concurrent_drop_oldest_pop_never_tears():
    ring = native.FrameRing(4, (1024,))
    stop = threading.Event()

    def producer():
        i = 0
        while not stop.is_set():
            ring.push(np.full(1024, float(i % 1000), np.float32))
            i += 1

    t = threading.Thread(target=producer)
    t.start()
    torn = popped = 0
    deadline = time.time() + 2.0
    try:
        while time.time() < deadline and popped < 5000:
            seq, frame = ring.pop()
            if seq == 0:
                continue
            popped += 1
            torn += int(not (frame == frame[0]).all())
    finally:
        stop.set()
        t.join(timeout=5)
    assert not t.is_alive()
    assert popped > 100 and torn == 0, (torn, popped)


def test_build_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="compiler"):
        native.build()
    assert not os.listdir(tmp_path)
