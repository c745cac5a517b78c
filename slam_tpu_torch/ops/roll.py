"""Rolling-grid shifts — counterpart of slam_tpu/ops/roll.py (`roll_2d`,
`shift_step`, `fresh_mask`), batched over robots.

The JAX package rolls with one-hot permutation matmuls because vmapped
dynamic rolls unroll into thousands of slices on a TPU. Each robot here has
its own shift, and `torch.roll` takes one shift for the whole tensor, so the
roll is one indexed gather: the same permutation, exactly.

On a grid split by rows (parallel/rows.py) the roll is a ring of sp - 1
steps over the sp group: each rank keeps, from every slab that passes by,
the rows its robots' shifts take from it (a robot's slab draws on at most
two source slabs, but which two depends on its shift, and no exchange reads
a shift to the host). It is exact for any shift, one slab's height or more
included, and holds one extra slab at a time.
"""

from __future__ import annotations

import torch

from slam_tpu_torch import true_div
from slam_tpu_torch.parallel.rows import row_index, whole_rows


def take_rows(out, held: torch.Tensor, k: int, src: torch.Tensor,
              i1: torch.Tensor) -> torch.Tensor:
    """Local half of a split roll: `held` (B, h, W, ...) is block k's slab;
    the rows of the rolled slab whose whole-grid source row src (B, h) lies
    in block k are taken from it (columns rolled by i1 (B, W)), the others
    kept from `out` (None: the first block taken fills every row)."""
    B, h = held.shape[:2]
    b = torch.arange(B, device=held.device)[:, None, None]
    loc = (src - k * h).clamp(0, h - 1)
    got = held[b, loc[:, :, None], i1[:, None, :]]
    if out is None:
        return got
    mine = (src // h == k).view(B, h, *([1] * (got.dim() - 2)))
    return torch.where(mine, got, out)


def roll_2d(a: torch.Tensor, d: torch.Tensor, rows=None) -> torch.Tensor:
    """Per-robot `roll(a[b], shift=(-d[b, 0], -d[b, 1]), dims=(0, 1))`:
    out[b, i, j, ...] = a[b, (i + d0) % G0, (j + d1) % G1, ...].
    a: (B, G0, G1, ...); d: (B, 2) integer shifts. With `rows` (a is then
    a slab of the whole grid's rows) the ring over the sp group."""
    B, G0, G1 = a.shape[:3]
    dev = a.device
    i1 = (torch.arange(G1, device=dev)[None, :] + d[:, 1:2]) % G1
    if rows is None:
        i0 = (torch.arange(G0, device=dev)[None, :] + d[:, 0:1]) % G0
        b = torch.arange(B, device=dev)[:, None, None]
        return a[b, i0[:, :, None], i1[:, None, :]]
    src = (row_index(rows, G0, dev)[None, :] + d[:, 0:1]) % rows.H
    out, held = None, a
    for t in range(rows.sp):
        if t:
            held = rows.comm.ring(held, 1)
        out = take_rows(out, held, (rows.j - t) % rows.sp, src, i1)
    return out


def roll_cells(channels: tuple, d: torch.Tensor, rows=None) -> list:
    """roll_2d of each of a grid's channels (B, G0, G1, ...) by the same
    shifts. Split by rows, the channels travel packed as one byte tensor
    a cell, so that one ring carries them all."""
    if rows is None:
        return [roll_2d(c, d) for c in channels]
    B, h, W = channels[0].shape[:3]
    cells = [c.reshape(B, h, W, -1).contiguous().view(torch.uint8)
             for c in channels]
    rolled = roll_2d(torch.cat(cells, -1), d, rows)
    out, o = [], 0
    for c, x in zip(channels, cells):
        n = x.shape[-1]
        out.append(rolled[..., o:o + n].contiguous().view(c.dtype)
                   .reshape(c.shape))
        o += n
    return out


def shift_step(center: torch.Tensor, new_center_xy: torch.Tensor,
               resolution: float):
    """Whole-cell rolling step: d = round((new - center) / res) (half to
    even, as jnp.round), returned as (d (B, 2) int32, new_center)."""
    d = torch.round(true_div(new_center_xy - center, resolution)).to(torch.int32)
    return d, center + d.to(center.dtype) * resolution


def fresh_mask(d: torch.Tensor, H: int, W: int, rows=None) -> torch.Tensor:
    """(B, H, W) cells that wrapped in under roll_2d(a, d): their pre-shift
    index fell outside the window, so they must be cleared. H, W: the
    grid's shape as held (with `rows`, a slab of H of the whole grid's
    rows.H rows)."""
    ii = row_index(rows, H, d.device)[None, :, None]
    jj = torch.arange(W, device=d.device)[None, None, :]
    d0 = d[:, 0, None, None]
    d1 = d[:, 1, None, None]
    return (ii + d0 < 0) | (ii + d0 >= whole_rows(rows, H)) | \
        (jj + d1 < 0) | (jj + d1 >= W)
