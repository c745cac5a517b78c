"""The verdict on a run's outputs: each number compared against the plain
reference, beside its limit. A run is correct when every limit of the
cell has its number and no number exceeds its limit; a number that is not
finite exceeds every limit."""

from __future__ import annotations

import math


def judge(numbers: dict, limits: dict) -> dict:
    out, correct = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        if v is None:
            correct = False
            out[name] = {"value": None, "limit": limit}
            continue
        v = float(v)
        if not math.isfinite(v) or v > limit:
            correct = False
        # JSON has no infinity: a number that is not finite is written
        # as its name ("inf", "nan")
        out[name] = {"value": v if math.isfinite(v) else str(v),
                     "limit": limit}
    return {"correct": correct, "numbers": out}


def worst(a, b, mask=None) -> float:
    """Largest |a - b| (over `mask` where given); inf where either side is
    not finite; 0 over an empty mask."""
    import torch
    d = (a.double() - b.double()).abs()
    bad = ~(torch.isfinite(a) & torch.isfinite(b))
    d = torch.where(bad, float("inf"), d)
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def xy_gap(a, b) -> float:
    """Largest planar distance between two (B, >=2) pose sets."""
    import torch
    d = (a[:, :2].double() - b[:, :2].double()).norm(dim=-1)
    d = torch.where(torch.isfinite(d), d, float("inf"))
    return float(d.max()) if d.numel() else 0.0


def yaw_gap(a, b) -> float:
    import torch
    d = torch.remainder(a[:, 2].double() - b[:, 2].double() + math.pi,
                        2 * math.pi) - math.pi
    d = torch.where(torch.isfinite(d), d.abs(), float("inf"))
    return float(d.max()) if d.numel() else 0.0


def share_differing(a, b) -> float:
    """Share of entries that differ (exactly), over all entries."""
    return float((a != b).double().mean()) if a.numel() else 0.0


class tf32:
    """The control, inside the block: TF32, the nearest precision below
    the float32 the configurations state, for every matrix product (the
    reference's own rounding of their operands, and PyTorch's flags)."""

    def __enter__(self):
        import torch

        from portbench.reference import slam2d
        self.was = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32, slam2d.TF32[0])
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        slam2d.TF32[0] = True

    def __exit__(self, *a):
        import torch

        from portbench.reference import slam2d
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, slam2d.TF32[0]) = self.was
