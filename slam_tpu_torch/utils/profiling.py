"""Tracing and throughput — counterpart of slam_tpu/utils/profiling.py.

  - `stage(name)`: a named range in torch profiles
    (`torch.profiler.record_function`), where slam_tpu names an XLA scope
  - `trace(log_dir)`: a `torch.profiler.profile` of the CPU and, when a
    card is present, CUDA activity, exported as a Chrome trace
    (`<log_dir>/trace.json`) on exit
  - `Throughput`: steps/s and robot-steps/s; reading a rate waits for the
    card (`torch.cuda.synchronize`) when CUDA is in use, since kernels
    return before they finish
Host-side scoped wall timing is the native runtime's Profiler
(runtime/native.py).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def stage(name: str):
    """Named range for pipeline stages: shows up in torch profiles."""
    return torch.profiler.record_function(name)


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
