"""Tracing and throughput — counterpart of slam_tpu/utils/profiling.py.

The port's spans and counters, in one place:

  - `stage(name)`: a named range in torch profiles
    (`torch.profiler.record_function`), where slam_tpu names an XLA scope.
    A range is opened only while a torch.profiler session records; its
    start and end then sit in the same chrome trace as the kernels it
    launched, on one clock. Otherwise it returns a shared no-op context:
    one flag read, no dispatcher call, no allocation, no kernel.
  - the counter registry: `count(name, n=1)` adds to a process-wide host
    integer (always on; counted from the thread that runs the program),
    `count_of(name)` reads one host counter (never the card),
    `counters()` returns a snapshot, `reset_counters()` zeroes every
    counter. A kernel adds its own counts on the card into
    `device_counter(name, device)`, an int64 that only `counters()` reads
    to the host (that read waits for the card), never a tick. Inside
    `uncounted()` (a CUDA graph's capture, utils/graphed.py) every count
    raises: a replay would never make it.
  - `attribute(trace)`: a chrome trace reduced over the program's spans:
    device microseconds and idle gaps by the innermost span open at each
    kernel's launch or gap, and each span's host time and self time.
  - `trace(log_dir)`: a `torch.profiler.profile` of the CPU and, when a
    card is present, CUDA activity, exported as a Chrome trace
    (`<log_dir>/trace.json`) on exit
  - `Throughput`: steps/s and robot-steps/s; reading a rate waits for the
    card (`torch.cuda.synchronize`) when CUDA is in use, since kernels
    return before they finish

Counter names: `k1.launches`, `k2.launches`, `k3.launches`, `k4.launches`,
`k5.launches`, `k5.pack_launches`, `raycast3d.launches`,
`ground.launches` (kernel launches on the card path);
`k1.fit_iterations` / `k3.fit_iterations` (device: every robot's fit
iterations, added by K1 and K3 while a profiler records) and
`k1.fit_problems` / `k3.fit_problems` (robots in those calls);
`ground.gp_sweeps` (device: the INSAC sweeps of every (robot, sector),
added by the ground GP kernel while a profiler records) and
`ground.gp_problems` (the sectors of those calls);
`icp.fit_iterations` (steps of icp_fit's loop, one a step of the batch,
and of the live consumer's loop); `live.frames` and `live.ring_wait_ns`
(frames popped from a FrameRing and their time from publish to pop),
`live.empty_polls` (live.drain's polls of an empty ring; these three are
the operator's readout that `python3 -m slam_tpu_torch.live` prints),
`live.staging_waits` (refills that waited for their copy);
`host_syncs` (deliberate host reads of device values, each counted where
it is made: the fits' converged reads, the relocalization gate's flag,
the staging's event wait, metrics.check_finite under nan_debug,
metrics.emit when enabled).

Host-side scoped wall timing is the native runtime's Profiler
(runtime/native.py).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_NULL = contextlib.nullcontext()
_counts: collections.Counter = collections.Counter()
_device: dict = {}
_refused = False


def recording() -> bool:
    """True while a torch.profiler session records."""
    return _autograd_profiler._is_profiler_enabled


def stage(name: str):
    """Named range for pipeline stages: shows up in torch profiles, and
    costs a flag read when none records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the host counter `name`."""
    if _refused:
        _refuse(name)
    _counts[name] += n


def _refuse(name: str):
    raise RuntimeError(f"counter {name!r} counted inside a CUDA graph's "
                       "capture: a replay would never count it")


@contextlib.contextmanager
def uncounted():
    """Refuse counts inside (a CUDA graph's capture, utils/graphed.py: a
    replay runs no Python, so a count made there would be made once and
    never again): `count` and `recorded_counter` raise RuntimeError."""
    global _refused
    was, _refused = _refused, True
    try:
        yield
    finally:
        _refused = was


def count_of(name: str) -> int:
    """The host counter `name` (0 before its first count); reads no device
    counter, so it never waits for the card."""
    return _counts[name]


def device_counter(name: str, device) -> torch.Tensor:
    """The (1,) int64 counter on `device` that a kernel adds `name`'s counts
    into; made (zeroed on the card) at the first call."""
    key = (name, str(device))
    t = _device.get(key)
    if t is None:
        t = _device[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return t


def recorded_counter(name: str, problems: str, n: int, device):
    """The address a kernel adds its counts of `name` to: the device
    counter `name` while a profiler records, with the host counter
    `problems` counting the call's n problems; None (the kernel counts
    nothing) otherwise. The device counter is made at the first call, so
    that no fill of it lands in a profiled slice."""
    if _refused:
        _refuse(name)
    ctr = device_counter(name, device)
    if not recording():
        return None
    count(problems, n)
    return ctr.data_ptr()


def counters() -> dict:
    """A snapshot of every counter: the host counts, and each device
    counter read to the host (summed over devices)."""
    out = dict(_counts)
    for (name, _), t in list(_device.items()):
        out[name] = out.get(name, 0) + int(t.item())
    return out


def reset_counters() -> None:
    """Zero every host and device counter."""
    _counts.clear()
    for t in list(_device.values()):
        t.zero_()


def attribute(trace: dict) -> dict:
    """A chrome trace reduced over the program's spans (the user
    annotations stage() opens): device microseconds by the innermost span open at each
    device operation's launch (`kernel_us`, "other" outside every span)
    and by operation name (`by_name_us`), the idle gaps between device
    operations by the innermost span open at each gap's middle (`gaps_us`,
    "outside the spans"), each span's host microseconds and self time
    (less the time its child spans cover; `host_us`, `self_us`, `calls`),
    the device's busy union, its timeline (first start to last end) and
    its operation count."""
    ev = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: e["ts"] for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    # by start, a parent before the children that start with it
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                    for e in ev if e.get("cat") == "user_annotation"),
                   key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in spans]

    def innermost(t):
        # spans of one thread nest: the latest to start of those that hold
        # t is the innermost
        for k in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if t <= spans[k][1]:
                return spans[k][2]
        return None

    host = collections.Counter()
    self_us = collections.Counter()
    calls = collections.Counter()
    for i, (s0, s1, name) in enumerate(spans):
        host[name] += s1 - s0
        calls[name] += 1
        child, reach = 0.0, s0
        for c0, c1, _ in spans[i + 1:bisect.bisect_left(starts, s1)]:
            if c1 <= s1 and c1 > reach:     # direct and nested children
                child += c1 - max(c0, reach)
                reach = c1
        self_us[name] += s1 - s0 - child
    gpu = [e for e in ev if e.get("cat") in DEVICE_CATS]
    kernel = collections.Counter()
    by_name = collections.Counter()
    for e in gpu:
        t = launch.get(e.get("args", {}).get("correlation"))
        kernel[(innermost(t) if t is not None else None) or "other"] += \
            e["dur"]
        by_name[e["name"][:120]] += e["dur"]
    merged = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in gpu):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = collections.Counter()
    for (_, b), (a, _) in zip(merged, merged[1:]):
        gaps[innermost((a + b) / 2) or "outside the spans"] += a - b
    return dict(kernel_us=dict(kernel), by_name_us=dict(by_name),
                gaps_us=dict(gaps), host_us=dict(host),
                self_us=dict(self_us), calls=dict(calls),
                busy_us=sum(b - a for a, b in merged),
                timeline_us=merged[-1][1] - merged[0][0] if merged else 0.0,
                ops=len(gpu))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed code and write `<log_dir>/trace.json`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Throughput:
    """steps/s and aggregate robot-steps/s."""

    def __init__(self, batch: int = 1):
        self.batch = batch
        self.reset()

    def reset(self):
        self._sync()
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1):
        self._steps += n

    @staticmethod
    def _sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @property
    def steps_per_sec(self) -> float:
        self._sync()
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return self._steps / dt

    @property
    def robot_steps_per_sec(self) -> float:
        return self.steps_per_sec * self.batch
