"""Batched 2D grid scatter-add and cell gather — counterpart of
slam_tpu/ops/scatter2d.py (`scatter_add_2d_multi`, `gather_cells_2d`,
`scatter_max_2d`).

The JAX package writes these as one-hot matmuls because TPU scatters and
gathers serialize; here they are `index_add_` and indexing. Counts are exact
either way. Float sums agree to ulps only: the order of additions differs,
and on the card `index_add_` of floats is atomic, so its order changes from
run to run; `deterministic` asks for a scatter whose sums are the same on
every run (the card's sort-based accumulate), for per-robot state that
several ranks compute and must hold bit for bit alike.

On a grid split by rows (parallel/rows.py) a scatter keeps the points
whose row lies in the slab, offset by the slab's first row, and drops the
rest: the points are the same on every rank of the sp group, so a scatter
needs no exchange.
"""

from __future__ import annotations

import torch


def _index_add(acc: torch.Tensor, flat: torch.Tensor, vv: torch.Tensor,
               deterministic: bool) -> None:
    if deterministic and acc.is_cuda:
        was = torch.are_deterministic_algorithms_enabled()
        warn = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            acc.index_put_((flat,), vv, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(was, warn_only=warn)
    else:
        acc.index_add_(0, flat, vv)


def scatter_add_2d_multi(cx: torch.Tensor, cy: torch.Tensor, values: tuple,
                         valid: torch.Tensor, shape: tuple, rows=None,
                         deterministic: bool = False) -> tuple:
    """Per-robot scatter-add of (B, N) value planes at cells (cx, cy) into
    (B, H, W) grids, one per channel; a `None` channel counts points.
    Points that are invalid or outside the grid are dropped (a masked point
    may carry NaN coordinates: it never reaches a sum). With `rows`, shape
    is the slab's and cx the whole grid's row."""
    H, W = shape
    B, N = cx.shape
    if rows is not None:
        cx = cx - rows.r0
    inb = valid & (cx >= 0) & (cy >= 0) & (cx < H) & (cy < W)
    base = torch.arange(B, device=cx.device)[:, None] * (H * W)
    # a dropped point adds 0 to a cell of its own robot's grid, cell n for
    # point n: sending them all to one spare slot made every dropped point
    # an atomic add on the same address, which the card serializes
    spread = torch.arange(N, device=cx.device) % (H * W)
    flat = (base + torch.where(inb, cx * W + cy, spread)).reshape(-1)
    outs = []
    for v in values:
        vv = inb.to(torch.float32) if v is None else \
            torch.where(inb, v, 0.0).to(torch.float32)
        acc = torch.zeros(B * H * W, dtype=torch.float32, device=cx.device)
        _index_add(acc, flat, vv.reshape(-1), deterministic)
        outs.append(acc.view(B, H, W))
    return tuple(outs)


def gather_cells_2d(grids: tuple, ci: torch.Tensor,
                    cj: torch.Tensor) -> tuple:
    """Per-cell reads grid[b, ci, cj] of each (B, H, W) grid at (B, N) cell
    indices clamped into the grid -> tuple of (B, N) planes. (slam_tpu's
    version stacks channels as (H, W, C) because one one-hot matmul reads
    them all; here each channel is one indexed read, and stacking whole
    grids would only copy them.)"""
    B, H, W = grids[0].shape
    flat = (ci.clamp(0, H - 1) * W + cj.clamp(0, W - 1)).long()
    return tuple(torch.gather(g.reshape(B, H * W), 1, flat) for g in grids)


def scatter_max_2d(cx: torch.Tensor, cy: torch.Tensor, values: torch.Tensor,
                   valid: torch.Tensor, shape: tuple,
                   rows=None) -> torch.Tensor:
    """(..., H, W) max of per-point scalars (..., N) at cells (cx, cy);
    cells no valid in-grid point touches read 0.0 (for "touched" flags pass
    values of 1.0 and compare > 0). One `scatter_reduce_` "amax" into a
    grid of float32's lowest value, with include_self, so a cell's first
    point competes with that floor as slam_tpu's `.at[].max` does. With
    `rows`, as scatter_add_2d_multi."""
    H, W = shape
    lead = cx.shape[:-1]
    if rows is not None:
        cx = cx - rows.r0
    inb = valid & (cx >= 0) & (cy >= 0) & (cx < H) & (cy < W)
    flat = torch.where(inb, cx * W + cy, H * W).to(torch.int64)
    neg = torch.finfo(torch.float32).min
    vv = torch.where(inb, values.to(torch.float32), neg)
    acc = torch.full(lead + (H * W + 1,), neg, dtype=torch.float32,
                     device=cx.device)
    acc.scatter_reduce_(-1, flat, vv, "amax", include_self=True)
    out = acc[..., :H * W].reshape(lead + (H, W))
    return torch.where(out == neg, 0.0, out)
