"""Class-constrained 2D nearest neighbour — counterpart of slam_tpu/ops/nn.py
and the dispatch in slam_tpu/ops/nn_pallas.py, with kernel K4
(`csrc/nn.cu`, replacing nn_pallas.py's `_nn_kernel`).

`nearest_neighbor` and `nearest_neighbor_planes` launch K4 for CUDA tensors
(one launch, the operands read as they lie: no copy, cast or mask op) and
run `nearest_neighbor_reference`, the plain PyTorch version, for CPU
tensors.

The plain version follows the Pallas kernel's direct form
`d2 = dx*dx + dy*dy` with `where(bad, BIG + d2, d2)`, not slam_tpu/ops/nn.py's
expanded `|q|^2 - 2 q.m + |m|^2`, which is what JAX runs on a CPU. The two
forms round differently: against the JAX CPU path, distances agree to
~4 f32 ulps of |q|^2 + |m|^2 (1e-3 m^2 at 50 m coordinates), and indices
agree wherever the best distance is unique by more than that.
"""

from __future__ import annotations

import ctypes

import torch

from slam_tpu_torch import cuda_build

BIG = 1e30

# kernel launches made by K4's wrapper (the card path only)
launches = 0

MAX_QCHUNK = 2048     # queries a block stages (24 bytes each)

# class plane types K4 reads (the value is the class's f32 cast)
CLASS_KINDS = {torch.float32: 1, torch.bool: 2}


def nn_tiles(S: int, C: int) -> tuple[int, int]:
    """(model points staged at once, queries a block): 24 bytes a model
    point and 24 a query in shared memory; a model that does not fit is
    walked tile after tile, in order."""
    qchunk = min(S, MAX_QCHUNK)
    return min(C, (cuda_build.MAX_SMEM - 24 * qchunk) // 24), qchunk


def nn_layout(*planes) -> list[int]:
    """K4's element strides, (batch, point) of each (B, n) plane in turn;
    (0, 0) for a plane that is None."""
    return [x for p in planes for x in (p.stride() if p is not None
                                        else (0, 0))]


def nearest_neighbor_reference(qx, qy, qc, mx, my, mc):
    """Plain version of K4. qx/qy/qc: (B, S) query planes and classes
    (-1 pad / 0 / 1); mx/my/mc: (B, C) model planes and classes (2 = invalid).
    Returns (idx (B, S) int32 of the first minimum, dist (B, S) f32)."""
    dx = qx[..., :, None] - mx[..., None, :]
    dy = qy[..., :, None] - my[..., None, :]
    d2 = dx * dx + dy * dy
    m = mc[..., None, :]
    bad = (m >= 2.0) | (qc[..., :, None] != m)
    d2 = torch.where(bad, BIG + d2, d2)
    idx = torch.argmin(d2, dim=-1)
    dist = torch.gather(d2, -1, idx[..., None])[..., 0]
    return idx.to(torch.int32), dist


def _launch(qx, qy, qc, mx, my, mv, mc, tile=None):
    """K4 on (B, S) query and (B, C) model planes of any strides. qc / mc:
    class planes (f32 or bool; None: unconstrained when both are);
    mv: bool validity or None; model classes >= 2 are invalid. `tile` caps
    the model points staged at once (default: what shared memory holds)."""
    global launches
    if qx.dim() != 2 or mx.dim() != 2 or qx.shape[0] != mx.shape[0]:
        raise ValueError(f"expected (B, S) and (B, C) planes, got "
                         f"{tuple(qx.shape)} and {tuple(mx.shape)}")
    B, S = qx.shape
    C = mx.shape[1]
    if C < 1 or B > 2 ** 31 - 1:
        raise ValueError(f"K4 takes C >= 1, got B={B}, C={C}")
    given = [(p, (B, n), dt) for p, n, dt in (
        (qx, S, torch.float32), (qy, S, torch.float32), (mx, C, torch.float32),
        (my, C, torch.float32), (mv, C, torch.bool),
        (qc, S, qc.dtype if qc is not None else None),
        (mc, C, mc.dtype if mc is not None else None)) if p is not None]
    cuda_build.check_operands("K4", *zip(*given),
                              contiguous=(False,) * len(given))
    kinds = []
    for c in (qc, mc):
        if c is not None and c.dtype not in CLASS_KINDS:
            raise ValueError(f"K4 takes class planes of {list(CLASS_KINDS)}"
                             f", got {c.dtype}")
        kinds.append(0 if c is None else CLASS_KINDS[c.dtype])
    fit, qchunk = nn_tiles(S, C)
    tile = min(fit, tile or fit)
    dev = qx.device
    idx = torch.empty((B, S), dtype=torch.int32, device=dev)
    dist = torch.empty((B, S), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 14)(*nn_layout(qx, qy, qc, mx, my, mv, mc))

    def ptr(p):
        return None if p is None else p.data_ptr()
    err = cuda_build.library().slam_nn(
        *map(ptr, (qx, qy, qc, mx, my, mv, mc)), idx.data_ptr(),
        dist.data_ptr(), B, S, C, *kinds, strides, tile, qchunk,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "slam_nn")
    launches += 1
    return idx, dist


def nearest_neighbor_planes(qx, qy, qc, mx, my, mc):
    """K4 on CUDA tensors, its plain version on CPU tensors (same contract as
    nearest_neighbor_reference)."""
    dev = qx.device
    if dev.type == "cpu":
        return nearest_neighbor_reference(qx, qy, qc, mx, my, mc)
    if dev.type != "cuda":
        raise ValueError(f"nearest_neighbor_planes: unsupported device {dev}")
    return _launch(qx, qy, qc, mx, my, None, mc)


def nearest_neighbor(q, m, m_valid, q_class=None, m_class=None):
    """For each query (B, S, 2) return (index, squared distance) of its
    nearest valid model point (B, C, 2), restricted to its own class when
    both class planes are given (one-sided classes mean unconstrained)."""
    if q.shape[-1] != 2 or m.shape[-1] != 2:
        raise ValueError(f"nearest_neighbor is 2D-only (got q D={q.shape[-1]}"
                         f", m D={m.shape[-1]})")
    if q_class is None or m_class is None:
        q_class = m_class = None
    if q.device.type == "cuda":
        return _launch(q[..., 0], q[..., 1], q_class, m[..., 0], m[..., 1],
                       m_valid, m_class)
    if q_class is None:
        qc = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
        mc = torch.zeros(m.shape[:-1], dtype=torch.float32, device=m.device)
    else:
        qc = q_class.to(torch.float32)
        mc = m_class.to(torch.float32)
    mc = torch.where(m_valid, mc, 2.0)
    return nearest_neighbor_planes(q[..., 0], q[..., 1], qc, m[..., 0],
                                   m[..., 1], mc)
