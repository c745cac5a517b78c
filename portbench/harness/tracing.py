"""The traced slice of a --trace 1 run: the program's stage functions are
wrapped from outside in torch.profiler ranges (the program carries no
spans), the calls the roofline readers need are recorded, and the
profiler's chrome trace is reduced to kernel time by stage (a kernel
counts toward the innermost range it was launched in), by kernel name,
the device's busy union, its operation count and its idle gaps by what
the host was doing. The attribution is the method of the port's
profile_tick, written again here so that the yardstick stays fixed.

A per-layer metric's reader (portbench/metrics/<name>.py) may declare
  STAGES = {label: ["module:function", ...]}   ranges to wrap
  CALLS = {key: "module:function"}             calls whose arguments to keep
and defines read(data) -> float | None, None where it finds nothing.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import importlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _resolve(spec: str):
    mod, fn = spec.split(":")
    return importlib.import_module(mod), fn


@contextlib.contextmanager
def patched(stages: dict, calls: dict, captured: dict):
    """Wrap each stage function in a record_function range of its label
    and each recorded call in an argument keeper; restore on exit."""
    import torch
    undo = []
    try:
        for label, specs in stages.items():
            for spec in sorted(specs):
                mod, fn = _resolve(spec)
                orig = getattr(mod, fn)

                @functools.wraps(orig)
                def ranged(*a, _orig=orig, _label=label, **k):
                    with torch.profiler.record_function(_label):
                        return _orig(*a, **k)
                setattr(mod, fn, ranged)
                undo.append((mod, fn, orig))
        for key, spec in calls.items():
            mod, fn = _resolve(spec)
            orig = getattr(mod, fn)

            @functools.wraps(orig)
            def kept(*a, _orig=orig, _key=key, **k):
                captured.setdefault(_key, []).append((a, k))
                return _orig(*a, **k)
            setattr(mod, fn, kept)
            undo.append((mod, fn, orig))
        yield
    finally:
        for mod, fn, orig in reversed(undo):
            setattr(mod, fn, orig)


def _merge(iv):
    """Union of sorted (start, end) intervals."""
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def attribute(trace: dict, labels) -> dict:
    """Kernel microseconds by stage label and by kernel name (and each
    launch's, by name), the busy union, the device operations, and the
    idle gaps between device operations by the innermost host range open
    at each gap's middle."""
    ev = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: e["ts"] for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                   if e.get("cat") == "user_annotation"
                   and e["name"] in labels)
    starts = [s[0] for s in spans]

    def innermost(t):
        best = None
        for s0, s1, name in spans[:bisect.bisect_right(starts, t)]:
            if s0 <= t <= s1 and (best is None or s1 - s0 < best[0]):
                best = (s1 - s0, name)
        return best[1] if best else None

    gpu = [e for e in ev if e.get("cat") in DEVICE_CATS]
    by_stage = collections.Counter()
    by_name = collections.Counter()
    each = collections.defaultdict(list)
    for e in gpu:
        t = launch.get(e.get("args", {}).get("correlation"))
        stage = innermost(t) if t is not None else None
        by_stage[stage or "other"] += e["dur"]
        by_name[e["name"][:120]] += e["dur"]
        each[e["name"][:120]].append(e["dur"])
    merged = _merge(sorted((e["ts"], e["ts"] + e["dur"]) for e in gpu))
    busy = sum(b - a for a, b in merged)
    gaps = collections.Counter()
    for (_, b), (a, _) in zip(merged, merged[1:]):
        gaps[innermost((a + b) / 2) or "outside the stages"] += a - b
    return dict(by_stage_us=dict(by_stage), by_name_us=dict(by_name),
                launches_us=dict(each), busy_us=busy, ops=len(gpu),
                gaps_us=dict(gaps))


def specs(readers: dict):
    stages, calls = {}, {}
    for r in readers.values():
        for label, fns in getattr(r, "STAGES", {}).items():
            stages.setdefault(label, set()).update(fns)
        calls.update(getattr(r, "CALLS", {}))
    return stages, calls


def profile(run_slice, readers: dict, device: str) -> dict:
    """Run `run_slice()` under the profiler with the readers' stages
    wrapped and calls kept. Returns the attribution, the slice's result
    ("slice"), the kept calls, busy_s, window_s and the breakdown."""
    import torch
    stages, calls = specs(readers)
    captured = {}
    cuda = device != "cpu"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with patched(stages, calls, captured):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            info = run_slice()
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    r = attribute(trace, set(stages))
    top = sorted(r["by_name_us"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(r["gaps_us"].items(), key=lambda kv: -kv[1])[:10]
    r.update(slice=info, calls=captured, window_s=window_s,
             busy_s=r["busy_us"] / 1e6,
             breakdown={"device_ops": [[n, us / 1e6] for n, us in top],
                        "idle_gaps": [[n, us / 1e6] for n, us in gaps]})
    return r


def read_metrics(readers: dict, data: dict) -> dict:
    out = {}
    for name, r in readers.items():
        v = r.read(data)
        if v is not None:
            out[name] = float(v)
    return out
