"""The port's spans and counters (slam_tpu_torch/utils/profiling.py) on the
CPU: `stage` opens no range unless a profiler records; one 2D and one 3D
macro under a CPU profile show every stage span, nested under their tick
and rollout; the counter registry; the live consumer's counters (its fit
iterations and host reads, the ring's frames and wait, drain's empty
polls); `recorded_counter`, the address a kernel counts into while a
profiler records; and `attribute`, the chrome-trace reduction
profile_tick prints, on a hand-built trace. On the card only: the counted host reads against
the syncs torch.cuda.set_sync_debug_mode sees (K1's and K3's device
counters: tests/test_torch_kernels_cuda.py)."""

import json
import time

import numpy as np
import pytest
import torch

from slam_tpu_torch import config as tcfg
from slam_tpu_torch import live
from slam_tpu_torch.pipeline import slam2d, slam3d
from slam_tpu_torch.runtime import native
from slam_tpu_torch.sim import replay, world2d, world3d
from slam_tpu_torch.utils import profiling

torch.set_num_threads(1)

STAGES_2D = {"raycast": "slam2d.tick", "ekf": "slam2d.tick",
             "scene_build": "slam2d.tick", "registration": "slam2d.tick",
             "map_update": "slam2d.tick", "slam2d.tick": "slam2d.rollout",
             "map_macro": "slam2d.rollout", "slam2d.rollout": None}
STAGES_3D = {"raycast": "slam3d.tick", "ekf": "slam3d.tick",
             "ground_seg": "scene_build", "scene_build": "slam3d.tick",
             "registration": "slam3d.tick", "height": "slam3d.tick",
             "map_update": "slam3d.tick", "slam3d.tick": "slam3d.rollout_3d",
             "map_macro": "slam3d.rollout_3d", "slam3d.rollout_3d": None}


def profiled_spans(fn, tmp_path):
    """Run fn under a CPU profile: {(name, its innermost enclosing span's
    name or None)}, the user annotations of the chrome trace."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [(e["ts"], e["ts"] + e["dur"], e["name"])
          for e in json.loads(path.read_text())["traceEvents"]
          if e.get("cat") == "user_annotation"]
    out = set()
    for i, (a, b, name) in enumerate(ev):
        holders = [(d - c, n) for j, (c, d, n) in enumerate(ev)
                   if j != i and c <= a and b <= d]
        out.add((name, min(holders)[1] if holders else None))
    return out


def test_stage_opens_no_range_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiling.recording()
    assert profiling.stage("a") is profiling.stage("b")
    gen = torch.Generator().manual_seed(0)
    cfg = tcfg.sim2d_config()
    world = world2d.make_world(gen, cfg.sim, device="cpu")
    state = slam2d.init_state(cfg, 2, device="cpu", generator=gen)
    slam2d.rollout(state, world, cfg, 4, gen)


def test_a_2d_and_a_3d_macro_show_every_span_nested(tmp_path):
    gen = torch.Generator().manual_seed(0)
    cfg = tcfg.sim2d_config()
    world = world2d.make_world(gen, cfg.sim, device="cpu")
    state = slam2d.init_state(cfg, 2, device="cpu", generator=gen)
    got = profiled_spans(lambda: slam2d.rollout(state, world, cfg, 4, gen),
                         tmp_path)
    assert got == set(STAGES_2D.items())
    c3 = tcfg.sim3d_config()
    w3 = world3d.make_world(gen, c3.sim, device="cpu")
    s3 = slam3d.init_state_3d(c3, 2, w3, device="cpu", generator=gen)
    gm = slam3d.init_ground_map(c3, 2, device="cpu")
    got = profiled_spans(lambda: slam3d.rollout_3d(s3, w3, gm, c3, 4, gen),
                         tmp_path)
    assert got == set(STAGES_3D.items())


def test_recorded_counter_only_while_a_profiler_records():
    """A kernel gets its device counter's address, and the call's problems
    are counted, only inside a profiler session; the counter is made (and
    zeroed) at the first call either way."""
    before = profiling.count_of("test.problems")
    assert profiling.recorded_counter("test.steps", "test.problems", 3,
                                      "cpu") is None
    assert profiling.count_of("test.problems") == before
    ctr = profiling.device_counter("test.steps", "cpu")
    assert int(ctr.item()) == 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ptr = profiling.recorded_counter("test.steps", "test.problems", 3,
                                         "cpu")
    assert ptr == ctr.data_ptr()
    assert profiling.count_of("test.problems") == before + 3


def test_counter_registry():
    before = profiling.counters()
    profiling.count("test.a")
    profiling.count("test.a", 4)
    after = profiling.counters()
    assert after["test.a"] - before.get("test.a", 0) == 5
    assert profiling.count_of("test.a") == after["test.a"]
    after["test.a"] = -1                       # a snapshot, not the registry
    assert profiling.counters()["test.a"] == before.get("test.a", 0) + 5
    profiling.reset_counters()
    assert profiling.counters().get("test.a", 0) == 0
    assert profiling.count_of("test.a") == 0


@pytest.fixture(scope="module")
def frames():
    cfg = tcfg.sim2d_config()
    world = world2d.make_world(torch.Generator().manual_seed(42), cfg.sim,
                               device="cpu")
    return replay.synth_frames(world, cfg.sim, 8, seed=0)


def test_eager_step_counts_its_fit_and_host_reads(frames):
    cfg = tcfg.sim2d_config()
    step = live.make_step(cfg, "cpu", torch.from_numpy(frames[0]))
    assert isinstance(step, live.EagerStep) and cfg.icp.loop == "while"
    names = ("icp.fit_iterations", "host_syncs")
    before = [profiling.count_of(k) for k in names]
    for fr in frames:
        step(torch.from_numpy(fr))
    # every fit reads its converged flags once an iteration and once more
    # to stop, unless it ran every iteration
    iters, syncs = (profiling.count_of(k) - b for k, b in zip(names, before))
    assert iters > len(frames)
    assert iters <= syncs <= iters + len(frames)


def test_ring_fed_by_the_loader_counts_frames_and_wait(frames, tmp_path):
    path = tmp_path / "replay.bin"
    path.write_bytes(frames.tobytes())
    floats = replay.frame_floats(tcfg.sim2d_config().sim)
    ring = native.FrameRing(16, (floats,))
    loader = native.ScanLoader(ring, path=str(path), loop=False)
    frames0 = profiling.count_of("live.frames")
    wait0 = profiling.count_of("live.ring_wait_ns")
    t0 = time.monotonic_ns()
    loader.start()
    deadline = time.time() + 5.0
    while loader.produced < len(frames) and time.time() < deadline:
        time.sleep(0.01)
    loader.stop()
    out = np.empty(floats, np.float32)
    seqs = []
    while (seq := ring.pop_into(out)):
        seqs.append(seq)
    waited = time.monotonic_ns() - t0
    assert len(seqs) == len(frames) and ring.dropped == 0
    assert profiling.count_of("live.frames") - frames0 == len(seqs)
    wait = profiling.count_of("live.ring_wait_ns") - wait0
    assert 0 <= wait <= len(seqs) * waited


def test_drain_counts_frames_and_empty_polls(frames):
    cfg = tcfg.sim2d_config()
    floats = replay.frame_floats(cfg.sim)
    ring = native.FrameRing(16, (floats,))
    for fr in frames[:3]:
        ring.push(fr)
    step = live.make_step(cfg, "cpu", torch.from_numpy(frames[0]))
    staging = live.Staging(floats, "cpu")
    polls = profiling.count_of("live.empty_polls")
    popped = profiling.count_of("live.frames")
    alive = iter([True])            # one sleep on the empty ring, then done
    _, done = live.drain(ring, step, 4, native.Profiler(), staging,
                         feed_alive=lambda: next(alive, False))
    assert done == 3
    assert profiling.count_of("live.frames") == popped + 3
    assert profiling.count_of("live.empty_polls") == polls + 2


def test_attribute_by_innermost_span():
    """Kernels count under the innermost span open at their launch, gaps
    under the one open at their middle; self time leaves out the
    children."""
    def span(name, ts, dur):
        return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur)

    def kernel(name, ts, dur, launched, corr):
        return [dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur,
                     args=dict(correlation=corr)),
                dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                     ts=launched, dur=1, args=dict(correlation=corr))]
    trace = dict(traceEvents=[
        span("tick", 0, 100), span("raycast", 10, 20),
        span("step", 50, 40), span("ekf", 60, 10),
        *kernel("k_a", 12, 10, 11, 1), *kernel("k_b", 40, 5, 25, 2),
        *kernel("k_c", 70, 10, 65, 3), *kernel("k_d", 200, 5, 150, 4)])
    r = profiling.attribute(trace)
    assert r["kernel_us"] == {"raycast": 15, "ekf": 10, "other": 5}
    # gaps 22-40 (middle 31, in tick), 45-70 (57.5, step), 80-200
    assert r["gaps_us"] == {"tick": 18, "step": 25,
                            "outside the spans": 120}
    assert r["self_us"] == {"tick": 40, "raycast": 20, "step": 30,
                            "ekf": 10}
    assert r["calls"]["step"] == 1 and r["ops"] == 4
    assert r["busy_us"] == 30 and r["timeline_us"] == 193


@pytest.mark.cuda
def test_counted_host_reads_are_every_sync():
    """On the card: each host sync that set_sync_debug_mode sees in a 2D
    macro (K1 and the "points" matcher's while loop), a 3D macro (K3) and
    live frames (GraphedStep, Staging) is one the program counts as
    `host_syncs`, and no more, so an unmarked sync fails here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the syncs are the card's")
    import chip_smoke
    for case, r in chip_smoke.check_sync_counts().items():
        assert r["outside"] == r["counted"], (case, r)
