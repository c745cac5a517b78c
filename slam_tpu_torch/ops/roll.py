"""Rolling-grid shifts — counterpart of slam_tpu/ops/roll.py (`roll_2d`,
`shift_step`, `fresh_mask`), batched over robots.

The JAX package rolls with one-hot permutation matmuls because vmapped
dynamic rolls unroll into thousands of slices on a TPU. Each robot here has
its own shift, and `torch.roll` takes one shift for the whole tensor, so the
roll is one indexed gather: the same permutation, exactly.
"""

from __future__ import annotations

import torch

from slam_tpu_torch import true_div


def roll_2d(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Per-robot `roll(a[b], shift=(-d[b, 0], -d[b, 1]), dims=(0, 1))`:
    out[b, i, j, ...] = a[b, (i + d0) % G0, (j + d1) % G1, ...].
    a: (B, G0, G1, ...); d: (B, 2) integer shifts."""
    B, G0, G1 = a.shape[:3]
    dev = a.device
    i0 = (torch.arange(G0, device=dev)[None, :] + d[:, 0:1]) % G0
    i1 = (torch.arange(G1, device=dev)[None, :] + d[:, 1:2]) % G1
    b = torch.arange(B, device=dev)[:, None, None]
    return a[b, i0[:, :, None], i1[:, None, :]]


def shift_step(center: torch.Tensor, new_center_xy: torch.Tensor,
               resolution: float):
    """Whole-cell rolling step: d = round((new - center) / res) (half to
    even, as jnp.round), returned as (d (B, 2) int32, new_center)."""
    d = torch.round(true_div(new_center_xy - center, resolution)).to(torch.int32)
    return d, center + d.to(center.dtype) * resolution


def fresh_mask(d: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, H, W) cells that wrapped in under roll_2d(a, d): their pre-shift
    index fell outside the window, so they must be cleared."""
    ii = torch.arange(H, device=d.device)[None, :, None]
    jj = torch.arange(W, device=d.device)[None, None, :]
    d0 = d[:, 0, None, None]
    d1 = d[:, 1, None, None]
    return (ii + d0 < 0) | (ii + d0 >= H) | (jj + d1 < 0) | (jj + d1 >= W)
