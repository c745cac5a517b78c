"""Class-constrained nearest neighbour — counterpart of slam_tpu/ops/nn.py
and the dispatch in slam_tpu/ops/nn_pallas.py, with kernel K4
(`csrc/nn.cu`, replacing nn_pallas.py's `_nn_kernel`).

In 2D, `nearest_neighbor` and `nearest_neighbor_planes` launch K4 for
CUDA tensors (one launch, the operands read as they lie: no copy, cast or
mask op) and run `nearest_neighbor_reference`, the plain PyTorch version,
for CPU tensors. In any other dimension (the 3D keyframe edges) no TPU
kernel stands behind slam_tpu's function, and `nearest_neighbor` is plain
PyTorch on every device: slam_tpu's masks (BIG added for an invalid model
point and again for another class) on the direct form, its queries in
chunks that keep each (B, chunk, C) temporary near NN_CHUNK_ELEMENTS.
`nearest_neighbor_tiled`, slam_tpu's query-chunked form, is therefore
`nearest_neighbor` itself.

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
from slam_tpu_torch.utils import profiling

BIG = 1e30

MAX_QCHUNK = 2048     # queries a block stages (24 bytes each)

# elements of one (B, chunk, C) distance temporary of the plain N-D form:
# 512 MiB of f32, a few such live at once
NN_CHUNK_ELEMENTS = 1 << 27

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
    the model points staged at once (default: what shared memory holds).
    Each launch counts as `k4.launches` (utils/profiling.py)."""
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
    profiling.count("k4.launches")
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


def _nearest_direct(q, m, m_valid, q_class, m_class):
    """slam_tpu's nearest_neighbor on the direct form, any dimension D:
    d2 = sum over axes of (q - m)^2, plus BIG for an invalid model point
    and BIG for another class, first minimum. (B, s, D) queries against
    (B, C, D) models -> (idx (B, s) int32, d2 (B, s))."""
    d2 = None
    for k in range(q.shape[-1]):
        d = q[..., :, None, k] - m[..., None, :, k]
        d2 = d.mul_(d) if d2 is None else d2.add_(d.mul_(d))
    d2.add_(torch.where(m_valid, 0.0, BIG)[..., None, :])
    if q_class is not None:
        d2.add_(torch.where(q_class[..., :, None] != m_class[..., None, :],
                            BIG, 0.0))
    idx = torch.argmin(d2, dim=-1)
    return idx.to(torch.int32), torch.gather(d2, -1, idx[..., None])[..., 0]


def _by_query_chunks(fn, q, q_class, chunk):
    """fn(q, q_class) over chunks of `chunk` queries, results joined."""
    S = q.shape[-2]
    if S <= chunk:
        return fn(q, q_class)
    parts = [fn(q[..., s:s + chunk, :],
                None if q_class is None else q_class[..., s:s + chunk])
             for s in range(0, S, chunk)]
    return tuple(torch.cat(r, -1) for r in zip(*parts))


def _nearest_2d(q, m, m_valid, q_class, m_class):
    """2D: K4 for CUDA tensors, its plain version for CPU tensors."""
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


def nearest_neighbor(q, m, m_valid, q_class=None, m_class=None):
    """For each query (B, S, D) return (index int32, squared distance) of
    its nearest valid model point (B, C, D), restricted to its own class
    when both class planes are given (one-sided classes mean
    unconstrained). D = 2: K4 on the card, its plain version on the CPU;
    any other D: plain PyTorch in query chunks on every device."""
    if q.shape[-1] != m.shape[-1]:
        raise ValueError(f"query D={q.shape[-1]} and model D={m.shape[-1]}")
    if q_class is None or m_class is None:
        q_class = m_class = None
    if q.shape[-1] == 2:
        return _nearest_2d(q, m, m_valid, q_class, m_class)
    rows = q.numel() // q.shape[-1] // q.shape[-2] * m.shape[-2]
    chunk = max(1, NN_CHUNK_ELEMENTS // max(1, rows))
    return _by_query_chunks(
        lambda qq, qc: _nearest_direct(qq, m, m_valid, qc, m_class),
        q, q_class, chunk)


# slam_tpu's query-chunked form: nearest_neighbor already walks the queries
# in chunks of NN_CHUNK_ELEMENTS (any D other than 2) or the model in tiles
# (K4), so it is the same function
nearest_neighbor_tiled = nearest_neighbor
