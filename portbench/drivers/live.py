"""Open-loop driver of one rover's live frames (slam_tpu_torch.live).

The world and the frames come from --seed (portbench/reference's frame
maker, on the device). Set-up writes the window's frames to a replay file
in TMPDIR, runs the program's own warm-up (live.warm_up) and builds its
graphed step (live.make_step). The window: the native ScanLoader offers
the frames from the file at `rate_hz` into a FrameRing of `slots` slots,
on its own schedule whatever the consumer does (open loop), for
--seconds; live.drain consumes them through live.Staging into the step.
A frame's latency runs from when it was due (the loader's first publish
plus its sequence times the period) to when its fused pose is on the
host, as a controller reads it; the loader's own lateness (publish
against due) is printed on standard error. A frame fails when the ring
dropped it or its pose came more than one period after it was due.

With --trace 1, `trace_frames` more frames are offered the same way after
the window, under the profiler and with the host syncs counted.

The check: the plain reference consumes the same frames, in the order the
program consumed them, from the same first carry, and every frame's fused
pose is compared, then the final point map and target.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys
import tempfile
import time
import warnings

from portbench.harness import checks, core, timing, tracing
from portbench.reference import slam2d as ref


class TimedRing:
    """The FrameRing as live.drain and Staging use it, keeping each popped
    frame's sequence id and publish time (the ring's steady clock)."""

    def __init__(self, ring, native):
        self.ring, self.native = ring, native
        self.popped = []

    def pop_into(self, out):
        t = ctypes.c_uint64(0)
        seq = self.native.lib().slamrt_ring_pop(
            self.ring._r, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(t))
        if seq:
            self.popped.append((int(seq), int(t.value)))
        return seq

    @property
    def available(self):
        return self.ring.available


def carry_view(carry) -> dict:
    """The live step's carry (EKF, point map, target cloud) as the
    reference's dict, cloned."""
    ekf, mg, mc = carry
    d = dict(mu=ekf.mu, sigma=ekf.sigma, gyro_bias=ekf.gyro_bias,
             pm_count=mg.count, pm_sx=mg.sum_x, pm_sy=mg.sum_y,
             pm_sz=mg.sum_z, pm_center=mg.center, tgt_x=mc.xyz[..., 0],
             tgt_y=mc.xyz[..., 1], tgt_z=mc.xyz[..., 2],
             tgt_ga=mc.is_ga(), tgt_valid=mc.valid)
    return {k: v.clone() for k, v in d.items()}


class TimedStep:
    """The live step, with each fused pose read to the host and the time
    it arrived there; with `keep`, the carry after each frame is cloned
    once its pose is on the host (after the frame's clock has stopped),
    for the check."""

    def __init__(self, step, keep):
        self.step, self.keep = step, keep
        self.poses, self.done_ns, self.carries = [], [], []

    def __call__(self, frame):
        fused = self.step(frame)
        self.poses.append(fused.cpu())
        self.done_ns.append(time.monotonic_ns())
        if self.keep:
            self.carries.append(carry_view(self.step.carry))
        return fused


def offer(native, ring, path, rate_hz, n, live, step, staging, timeout,
          keep):
    """Offer the n frames of `path` at rate_hz and drain them: (popped
    (seq, publish ns), poses, done ns, window seconds, carries after each
    frame where `keep`)."""
    tr, ts = TimedRing(ring, native), TimedStep(step, keep)
    loader = native.ScanLoader(ring, path=path, rate_hz=rate_hz, loop=False,
                               num_threads=1)
    prof = native.Profiler()
    t0 = time.perf_counter()
    loader.start()
    try:
        live.drain(tr, ts, n, prof, staging,
                   feed_alive=lambda: loader.produced < n, timeout=timeout)
    finally:
        loader.stop()
    return (tr.popped, ts.poses, ts.done_ns, time.perf_counter() - t0,
            ts.carries)


def latencies(popped, done_ns, period_ns, first_seq, n, t_end):
    """Latency ms of each consumed frame from when it was due (the
    loader's schedule: the first popped frame's publish time less its
    place times the period, plus each frame's place times the period),
    and of each dropped one to the window's end. Returns (latencies, late
    frames, dropped frames, the loader's worst lateness in ms)."""
    if not popped:
        return [float(t_end) / 1e6] * n, 0, n, 0.0
    s0, t0 = popped[0]
    t_first = t0 - (s0 - first_seq) * period_ns

    def due(s):
        return t_first + (s - first_seq) * period_ns
    lat = [(d - due(s)) / 1e6 for (s, _), d in zip(popped, done_ns)]
    late = sum(1 for x in lat if x > period_ns / 1e6)
    seen = {s for s, _ in popped}
    dropped = [s for s in range(first_seq, first_seq + n) if s not in seen]
    lat += [(t_end - due(s)) / 1e6 for s in dropped]
    lateness = max((t - due(s)) / 1e6 for s, t in popped)
    return lat, late, len(dropped), lateness


def run(ctx) -> dict:
    import torch
    from slam_tpu_torch import live
    from slam_tpu_torch.runtime import native
    cfg = ctx.slam_config()
    vals = ctx.config_values
    p = ctx.traffic
    dev = ctx.device
    rate = float(p["rate_hz"])
    period_ns = int(round(1e9 / rate))
    n_win = int(round(rate * ctx.seconds))
    n_tr = p["trace_frames"] if ctx.trace else 0

    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    w = ref.make_world(gen, vals["sim"], dev)
    frames = ref.make_frames(gen, w, vals["sim"], n_win + n_tr, dev)
    host = frames.cpu().numpy().astype("<f4")
    tmp = tempfile.mkdtemp(prefix="portbench-live-")
    try:
        paths = [os.path.join(tmp, n) for n in ("window.bin", "trace.bin")]
        host[:n_win].tofile(paths[0])
        host[n_win:].tofile(paths[1])
        t_warm = time.perf_counter()
        live.warm_up(host, cfg, dev, n=p["warmup_frames"])
        step = live.make_step(cfg, dev, torch.from_numpy(host[0]).to(dev))
        start = carry_view(step.carry)
        floats = host.shape[1]
        ring = native.FrameRing(slots=p["slots"], frame_shape=(floats,))
        staging = live.Staging(floats, dev)
        timing.sync(dev)
        setup_s = time.perf_counter() - ctx.t_start
        print(f"portbench: set-up: {t_warm - ctx.t_start:.3f} s to the "
              f"frames, {time.perf_counter() - t_warm:.3f} s of warm-up and "
              "graph capture", file=sys.stderr)

        popped, poses, done, window_s, carries = offer(
            native, ring, paths[0], rate, n_win, live, step, staging,
            ctx.seconds + 60, True)
        lat, late, dropped, lateness = latencies(
            popped, done, period_ns, 1, n_win, time.monotonic_ns())
        peak = timing.peak_bytes(dev)
        print(f"portbench: live window {len(popped)} of {n_win} frames "
              f"consumed, {dropped} dropped, {late} late; the loader "
              f"published at most {lateness:.3f} ms after due",
              file=sys.stderr)
        out = dict(
            attempted=n_win, failed=dropped + late,
            device=core.device_info(dev, 1, peak),
            end_to_end=dict(frame_ms_p95=timing.p95(lat), setup_s=setup_s),
            window=dict(frames=len(popped), seconds=window_s))
        order = [s for s, _ in popped]
        if ctx.trace:
            traced = {}

            def run_slice():
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    if dev != "cpu":
                        torch.cuda.set_sync_debug_mode("warn")
                    try:
                        traced["r"] = offer(native, ring, paths[1], rate,
                                            n_tr, live, step, staging, 60,
                                            False)
                    finally:
                        if dev != "cpu":
                            torch.cuda.set_sync_debug_mode(0)
                traced["syncs"] = sum("called a synchronizing" in
                                      str(c.message) for c in caught)
            data = tracing.profile(run_slice, ctx.cell.readers(), dev)
            tp, tposes, tdone, _, _ = traced["r"]
            tlat = latencies(tp, tdone, period_ns, n_win + 1, n_tr,
                             time.monotonic_ns())[0][:len(tp)]
            data.update(frames=len(tp), latency_ms=sum(tlat),
                        syncs=traced["syncs"])
            out["trace"] = data
        out["checks"] = check(ctx, frames, order, poses, start, carries)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check(ctx, frames, order, poses, start, carries) -> dict:
    """The reference follows the program frame by frame: from the
    program's carry before each consumed frame (the first carry, then the
    carry after the frame before), it consumes the frame, and its fused
    pose, point map and target are compared with the program's. Frames
    whose fit met a near-tie in the reference (reference/slam2d.py NEAR)
    are left out of the pose and map comparison. The first carry is
    checked against the reference's own."""
    vals = ctx.config_values
    rows, near = [], 0
    pre = start
    for seq, pose, post in zip(order, poses, carries):
        want, fused = ref.consume(pre, frames[seq - 1], vals)
        pre = post
        if bool(want["near"].any()):
            near += 1
            continue
        rows.append(compare(post, pose.to(fused.device), want, fused))
    print(f"portbench: {near} of {len(order)} frames met a near-tie in the "
          "reference's fit and were left out of the comparison",
          file=sys.stderr)
    out = worst_of(rows)
    first = ref.live_init(vals, ctx.device)
    out["start"] = max(checks.worst(start[k], first[k]) for k in
                       ("mu", "sigma", "gyro_bias", "pm_count", "tgt_x"))
    return out


def compare(post, pose, want, fused) -> dict:
    tv = post["tgt_valid"] & want["tgt_valid"]
    return dict(
        pose_m=checks.xy_gap(pose, fused), yaw_rad=checks.yaw_gap(pose, fused),
        map_cells=checks.share_differing(post["pm_count"], want["pm_count"]),
        target_m=max(checks.worst(post["tgt_x"], want["tgt_x"], tv),
                     checks.worst(post["tgt_y"], want["tgt_y"], tv)),
        target_slots=checks.share_differing(
            post["tgt_valid"] | (post["tgt_ga"] << 1),
            want["tgt_valid"] | (want["tgt_ga"] << 1)))


def worst_of(rows: list) -> dict:
    keys = ("pose_m", "yaw_rad", "map_cells", "target_m", "target_slots")
    return {k: max((r[k] for r in rows), default=0.0) for k in keys}


def control(ctx, frames_n: int) -> dict:
    """The control's readings: along the reference's own trajectory over
    the seed's first `frames_n` frames, each frame consumed from the same
    carry by the reference with TF32 on and by the reference."""
    import torch
    vals = ctx.config_values
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    w = ref.make_world(gen, vals["sim"], ctx.device)
    frames = ref.make_frames(gen, w, vals["sim"], frames_n, ctx.device)
    st = ref.live_init(vals, ctx.device)
    rows = []
    for k in range(frames_n):
        want, fused = ref.consume(st, frames[k], vals)
        with checks.tf32():
            got, gf = ref.consume(st, frames[k], vals)
        st = want
        if not bool(want["near"].any()):
            rows.append(compare(got, gf, want, fused))
    out = worst_of(rows)
    out["start"] = 0.0
    return out
