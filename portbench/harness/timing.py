"""Clocks of the measured window."""

from __future__ import annotations

import statistics
import time


def sync(device: str) -> None:
    if device != "cpu":
        import torch
        torch.cuda.synchronize()


class Marks:
    """Boundaries recorded on the device's stream with no host wait (CUDA
    events), read once the window has closed; on the CPU, host times."""

    def __init__(self, device: str):
        self.cuda = device != "cpu"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            import torch
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        """Milliseconds between consecutive marks (after a sync)."""
        if self.cuda:
            return [a.elapsed_time(b) for a, b in
                    zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, 'inclusive')."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def median(values) -> float:
    return float(statistics.median(values))


def peak_bytes(device: str) -> int:
    if device == "cpu":
        return 0
    import torch
    return int(torch.cuda.max_memory_allocated())
