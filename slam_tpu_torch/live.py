"""Live operation through the native host runtime — counterpart of
examples/run_live.py.

A producer thread publishes sensor frames ([ranges, gyro, cmd(3)], the
layout of sim/replay.py) into the lock-free frame ring (runtime/native.py),
and the consumer pops them and runs one SLAM step a frame on the card for
one robot: EKF predict and gyro update, the scan's scene, the map target
cropped around the prediction, `icp_fit` (on kernel K4), the EKF SLAM
update and the point-map upkeep (shift, fold, export).

    python3 -m slam_tpu_torch.live [--frames 100]

Only the consumer touches the card: the producer pushes numpy frames. A
frame goes from the ring straight into one of two pinned host buffers,
and from there to the card by an asynchronous copy; each buffer has an
event, and the consumer refills a buffer only once the copy out of it has
finished (the counterpart of JAX's double-buffered device_put).

One robot's step is ~1,000 small kernels, so on the card its pace is the
host's launch rate, not the device (where slam_tpu compiles the step into
one executable). `GraphedStep` therefore replays everything but the
nearest-neighbour kernel from CUDA graphs (the same kernels on the same
tensors): K4 is launched through its wrapper each fit iteration, and the
fit's once-an-iteration host read of its converged flags decides the
loop, as in icp_fit.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import threading
import time

import numpy as np
import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.geometry import se2_apply
from slam_tpu_torch.mapping.point_map import (export_points, init_point_map,
                                              shift_point_map,
                                              update_point_map_xy)
from slam_tpu_torch.models import ekf as ekf_mod
from slam_tpu_torch.ops import icp as icp_mod
from slam_tpu_torch.ops.voxel import crop_box
from slam_tpu_torch.pipeline import slam2d
from slam_tpu_torch.sim import world2d
from slam_tpu_torch.types import make_cloud
from slam_tpu_torch.utils import graphed, profiling


def init_carry(cfg, device=None):
    """(ekf, point map, map cloud) for one robot, on the card unless
    `device` says otherwise."""
    device = default_device(device)
    return (ekf_mod.init_ekf(cfg.ekf, 1, gyro_bias=cfg.sim.gyro_bias,
                             device=device),
            init_point_map(1, cfg.mls.size_x, device=device),
            make_cloud(1, cfg.cloud.map_capacity, device=device))


def _before_icp(carry, ranges, gyro, cmd, cfg):
    """EKF predict and gyro update, the scene, the cropped map target:
    (ekf, pred (1, 3), scene, target)."""
    ekf, _, map_cloud = carry
    ekf = ekf_mod.motion_update(ekf, cmd, cfg.sim.dt, cfg.ekf)
    ekf = ekf_mod.yaw_rate_update(ekf, gyro, cfg.ekf)
    pred = ekf_mod.pose_xyyaw(ekf)
    xyz, hit = world2d.scan_to_points(ranges,
                                      ranges < cfg.sim.beam_max_range)
    scene = slam2d.build_scene(xyz, hit, cfg)
    target = crop_box(map_cloud, pred[:, :2], cfg.icp.crop_dist)
    return ekf, pred, scene, target


def _after_icp(carry, ekf, pred, scene, icp_pose, icp_ok, cfg):
    """EKF SLAM update and the point-map upkeep: (new carry, fused)."""
    _, map_grid, map_cloud = carry
    ekf = ekf_mod.slam_update(ekf, icp_pose, cfg.ekf, has_meas=icp_ok)
    fused = ekf_mod.pose_xyyaw(ekf)
    pose = torch.where(icp_ok[:, None], icp_pose, pred)
    wxy = se2_apply(pose, scene.xyz[..., :2])
    mg = shift_point_map(map_grid, fused[:, :2])
    mg = update_point_map_xy(mg, wxy[..., 0], wxy[..., 1], scene.xyz[..., 2],
                             scene.valid)
    mc = export_points(mg, map_cloud.capacity,
                       ga_threshold=cfg.icp.ga_threshold)
    return (ekf, mg, mc), fused


def consume(carry, ranges: torch.Tensor, gyro: torch.Tensor,
            cmd: torch.Tensor, cfg):
    """One live step: ranges (1, num_beams), gyro (1,), cmd (1, 3) ->
    (new carry, fused pose (1, 3)). Pure: the carry is not modified."""
    ekf, pred, scene, target = _before_icp(carry, ranges, gyro, cmd, cfg)
    icp = icp_mod.icp_fit(scene.xyz[..., :2], scene.valid, scene.is_ga(),
                          target.xyz[..., :2], target.valid, target.is_ga(),
                          pred, cfg.icp)
    return _after_icp(carry, ekf, pred, scene, icp.pose, icp.ok, cfg)


def split_frame(frame: torch.Tensor, num_beams: int):
    """A (num_beams + 4,) frame -> (ranges (1, N), gyro (1,), cmd (1, 3))."""
    return (frame[None, :num_beams], frame[num_beams:num_beams + 1],
            frame[None, num_beams + 1:num_beams + 4])


class EagerStep:
    """step(frame) -> fused pose (1, 3): consume over a carry it keeps
    (its fit is icp_fit's, counted there: `icp.fit_iterations`,
    `host_syncs`)."""

    def __init__(self, carry, cfg):
        self.carry, self.cfg = carry, cfg

    def __call__(self, frame: torch.Tensor) -> torch.Tensor:
        self.carry, fused = consume(self.carry, *split_frame(
            frame, self.cfg.sim.num_beams), self.cfg)
        return fused


def _tensors(x) -> list:
    """The tensors of a carry (tuples and dataclasses), in field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in _tensors(getattr(x, f.name))]
    return []


def _copy_into(dst, src) -> None:
    for d, s in zip(_tensors(dst), _tensors(src)):
        d.copy_(s)


class GraphedStep:
    """step(frame) -> fused pose (1, 3) on the card: consume's arithmetic
    with everything but K4 replayed from CUDA graphs over static tensors
    (the frame, the carry, the fit's loop state). icp_fit's loop runs here
    on its own pieces (ops/icp.py: icp_start, transform, fit_update,
    icp_advance, icp_result): each iteration reads the converged flags
    (icp_fit's host sync), replays the placing of the scene, calls
    nearest_neighbor eagerly (K4, through its wrapper) and replays the
    update. That is icp_fit's "while" form whatever cfg.icp.loop says:
    the loop is this class's own, and its early exit is what keeps a
    frame short. The same kernels on the same values as consume (but for
    the order of the map fold's float atomics). Warm-up and capture are
    utils/graphed.py's.

    A call's spans (utils/profiling.py) go around the replays: `live.pre`,
    one `live.iteration` a pass of the loop (the converged read, K4 and
    the update's replay) and `live.post`; the loop's steps count as
    `icp.fit_iterations`, its reads as `host_syncs`, as icp_fit's do."""

    def __init__(self, carry, cfg, frame: torch.Tensor):
        self.cfg = cfg
        dev = frame.device
        self.frame = frame.clone()
        self.carry = tuple(dataclasses.replace(c, **{
            f.name: getattr(c, f.name).clone()
            for f in dataclasses.fields(c)
            if isinstance(getattr(c, f.name), torch.Tensor)})
            for c in carry)
        start = [t.clone() for t in _tensors(self.carry)]

        def step():
            self.pre = self._pre()
            self._iterate(self._place, self._update)
            self._post()
        graphed.warm_up(step, dev)
        self.g_pre, self.pre = graphed.capture(self._pre)
        self.g_place, self.q = graphed.capture(self._place)
        S = self.q.shape[-2]
        self.idx = torch.zeros(1, S, dtype=torch.int32, device=dev)
        self.d2 = torch.zeros(1, S, device=dev)
        self.g_update, _ = graphed.capture(
            lambda: self._update(self.q, self.idx, self.d2))
        self.g_post, self.fused = graphed.capture(self._post)
        for t, s0 in zip(_tensors(self.carry), start):
            t.copy_(s0)

    def _pre(self):
        """consume's stages before the fit, and the fit's start."""
        ekf, pred, scene, target = _before_icp(self.carry, *split_frame(
            self.frame, self.cfg.sim.num_beams), self.cfg)
        scene_ga, target_ga = scene.is_ga(), target.is_ga()
        ok, participate, loop = icp_mod.icp_start(
            scene.valid, scene_ga, target.valid, target_ga, pred,
            self.cfg.icp)
        # the loop state is updated in place: its pose must not be pred
        loop = loop._replace(pose=loop.pose.clone())
        return dict(ekf=ekf, pred=pred, scene=scene, target=target,
                    scene_ga=scene_ga, target_ga=target_ga, ok=ok,
                    participate=participate, loop=loop)

    def _place(self):
        p = self.pre
        return icp_mod.transform(p["scene"].xyz[..., :2], p["loop"].pose)

    def _nearest(self, q):
        p = self.pre
        return icp_mod.nearest_neighbor(
            q, p["target"].xyz[..., :2], p["target"].valid,
            q_class=p["scene_ga"], m_class=p["target_ga"])

    def _update(self, q, idx, d2):
        """One fit step's update, written into the loop state."""
        p = self.pre
        loop = icp_mod.icp_advance(p["loop"], icp_mod.fit_update(
            q, idx, d2, p["participate"], p["target"].xyz[..., :2],
            p["loop"].pose, self.cfg.icp.inlier_dist), self.cfg.icp.min_delta)
        for d, s in zip(p["loop"], loop):
            d.copy_(s)

    def _iterate(self, place, update):
        """icp_fit's loop over the loop state in self.pre."""
        for _ in range(self.cfg.icp.max_iterations):
            with profiling.stage("live.iteration"):
                profiling.count("host_syncs")
                if bool(self.pre["loop"].converged.all()):
                    break
                profiling.count("icp.fit_iterations")
                q = place()
                update(q, *self._nearest(q))

    def _post(self):
        """The fit's result and consume's stages after it."""
        p = self.pre
        icp = icp_mod.icp_result(p["ok"], p["loop"], p["pred"])
        carry, fused = _after_icp(self.carry, p["ekf"], p["pred"], p["scene"],
                                  icp.pose, icp.ok, self.cfg)
        _copy_into(self.carry, carry)
        return fused

    def _replayed_update(self, q, idx, d2):
        self.idx.copy_(idx)
        self.d2.copy_(d2)
        self.g_update.replay()

    def __call__(self, frame: torch.Tensor) -> torch.Tensor:
        with profiling.stage("live.pre"):
            self.frame.copy_(frame)
            self.g_pre.replay()

        def place():
            self.g_place.replay()
            return self.q
        self._iterate(place, self._replayed_update)
        with profiling.stage("live.post"):
            self.g_post.replay()
            return self.fused.clone()


def make_step(cfg, device, frame: torch.Tensor):
    """The live step for a fresh carry: GraphedStep on the card (given a
    frame to capture with), EagerStep on the CPU."""
    carry = init_carry(cfg, device)
    if torch.device(device).type == "cuda":
        return GraphedStep(carry, cfg, frame)
    return EagerStep(carry, cfg)


class Staging:
    """Two host buffers the ring pops into and their device copies. On the
    card the host buffers are pinned and each copy is asynchronous, with an
    event that must have completed before its buffer is refilled; on the
    CPU the popped buffer is used as it is. A refill that waits for its
    copy counts as `live.staging_waits` and `host_syncs`."""

    def __init__(self, floats: int, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.host = [torch.empty(floats, dtype=torch.float32,
                                 pin_memory=self.cuda) for _ in range(2)]
        self.dev = [torch.empty(floats, device=self.device)
                    for _ in range(2)] if self.cuda else self.host
        self.events = [None, None]
        self.i = 0

    def pop(self, ring):
        """The next frame on the device, or None when the ring is empty."""
        i = self.i
        ev = self.events[i]
        if ev is not None and not ev.query():
            profiling.count("live.staging_waits")
            profiling.count("host_syncs")
            ev.synchronize()
        if not ring.pop_into(self.host[i].numpy()):
            return None
        if self.cuda:
            self.dev[i].copy_(self.host[i], non_blocking=True)
            self.events[i] = torch.cuda.Event()
            self.events[i].record()
        self.i ^= 1
        return self.dev[i]


def drain(ring, step, n: int, prof, staging: Staging,
          feed_alive=lambda: False, timeout: float = 120.0):
    """Run step (EagerStep, GraphedStep) on up to n frames from the ring.
    Stops early when the ring is empty and feed_alive() is False, or after
    `timeout` seconds. Returns (fused poses (k, 3) on the device, k).
    `prof` times each pop and step (scopes "pop" and "device_step"); a
    poll of an empty ring counts as `live.empty_polls`
    (utils/profiling.py)."""
    fused = []
    t0 = time.perf_counter()
    # no cyclic garbage collection while frames arrive: a full collection
    # stalls the consumer for milliseconds; cycles wait until the end
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        while len(fused) < n and time.perf_counter() - t0 < timeout:
            with prof.scope("pop"):
                frame = staging.pop(ring)
            if frame is None:
                profiling.count("live.empty_polls")
                if not feed_alive() and ring.available == 0:
                    break
                time.sleep(0.0005)
                continue
            with prof.scope("device_step"):
                f = step(frame)
            fused.append(f[0])
    finally:
        if gc_was_on:
            gc.enable()
    poses = torch.stack(fused) if fused else torch.zeros(0, 3)
    return poses, len(fused)


def warm_up(frames: np.ndarray, cfg, device, n: int = 4) -> None:
    """Run the step on the first n frames, chained, and drop the result
    (consume is pure): the first call builds the kernel library, and the
    first frames with a map target load the fit's kernels, so a cold
    consumer would overflow the ring."""
    carry = init_carry(cfg, device)
    for fr in frames[:n]:
        carry, _ = consume(carry, *split_frame(
            torch.from_numpy(fr).to(device), cfg.sim.num_beams), cfg)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    args = ap.parse_args(argv)

    from slam_tpu_torch.config import sim2d_config
    from slam_tpu_torch.runtime import native
    from slam_tpu_torch.sim.replay import frame_floats, synth_frames

    cfg = sim2d_config()
    device = default_device()
    world = world2d.make_world(torch.Generator(device).manual_seed(42),
                               cfg.sim, device=device)
    floats = frame_floats(cfg.sim)
    ring = native.FrameRing(slots=32, frame_shape=(floats,))
    prof = native.Profiler()
    # the producer pushes plain numpy frames, rendered here up front
    frames = synth_frames(world, cfg.sim, args.frames + 8, seed=0)
    stop = threading.Event()

    def sensor_thread():
        for fr in frames:
            if stop.is_set():
                return
            ring.push(fr)
            time.sleep(0.001)

    warm_up(frames, cfg, device)       # before the producer starts
    step = make_step(cfg, device, torch.from_numpy(frames[0]).to(device))

    producer = threading.Thread(target=sensor_thread, daemon=True)
    producer.start()
    try:
        fused, done = drain(ring, step, args.frames, prof,
                            Staging(floats, device),
                            feed_alive=producer.is_alive)
    finally:
        stop.set()
        # join before teardown: a live producer at exit races the ring's
        # destructor
        producer.join(timeout=5)
    pose = fused[-1].cpu().numpy() if done else np.zeros(3)
    print(f"consumed {done} live frames; pose={pose.round(2)}; "
          f"ring dropped={ring.dropped}")
    print(prof.report().strip())
    print("counters:", " ".join(f"{k}={v}" for k, v in
                                sorted(profiling.counters().items())))


if __name__ == "__main__":
    main()
