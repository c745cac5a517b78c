"""Peaks and the least time of a kernel's work."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def bound_s(moved_bytes: float, ops: float) -> float:
    """The least time: bytes at the memory's peak or f32 operations at
    the peak outside the tensor cores, whichever is longer."""
    return max(moved_bytes / PEAKS["hbm_bytes_per_s"],
               ops / PEAKS["f32_ops_per_s"])


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)
