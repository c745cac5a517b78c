"""Shared arithmetic of the per-layer readers."""

from __future__ import annotations


def stage_ms(data: dict, label: str):
    """Kernel ms a tick launched inside the stage's ranges, or None where
    the slice ran none of it."""
    us = data["by_stage_us"].get(label)
    if not us or not data.get("ticks"):
        return None
    return us / 1e3 / data["ticks"]


def kernel_us(data: dict, pattern: str) -> float:
    """Device microseconds of the kernels whose name holds `pattern`."""
    return sum(us for name, us in data["by_name_us"].items()
               if pattern in name)


def roofline_share(data: dict, kernel, key: str):
    """Percent of the least time (peaks in portbench/roofline/peaks.json)
    that the kept calls' kernels took on the device; None without calls
    or kernel time."""
    calls = data["calls"].get(key)
    t_us = kernel_us(data, kernel.KERNEL)
    if not calls or t_us <= 0:
        return None
    bound_s = sum(kernel.bound_s(*kernel.count(a, k, data))
                  for a, k in calls)
    return 100.0 * bound_s / (t_us / 1e6)


def collective_us(data: dict) -> float:
    """Device microseconds of the collectives' kernels (NCCL): a rank's
    kernel spins there until the slowest rank arrives."""
    return kernel_us(data, "nccl")
