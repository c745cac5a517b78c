"""Class-constrained 2D nearest neighbour — counterpart of slam_tpu/ops/nn.py
and the dispatch in slam_tpu/ops/nn_pallas.py, with kernel K4
(`csrc/nn.cu`, replacing nn_pallas.py's `_nn_kernel`).

`nearest_neighbor_planes` launches K4 for CUDA tensors and runs
`nearest_neighbor_reference`, the plain PyTorch version, for CPU tensors.

The plain version follows the Pallas kernel's direct form
`d2 = dx*dx + dy*dy` with `where(bad, BIG + d2, d2)`, not slam_tpu/ops/nn.py's
expanded `|q|^2 - 2 q.m + |m|^2`, which is what JAX runs on a CPU. The two
forms round differently: against the JAX CPU path, distances agree to
~4 f32 ulps of |q|^2 + |m|^2 (1e-3 m^2 at 50 m coordinates), and indices
agree wherever the best distance is unique by more than that.
"""

from __future__ import annotations

import torch

from slam_tpu_torch import cuda_build

BIG = 1e30

# kernel launches made by nearest_neighbor_planes (the card path only)
launches = 0

_MAX_SMEM = cuda_build.MAX_SMEM


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


def nearest_neighbor_planes(qx, qy, qc, mx, my, mc):
    """K4 on CUDA tensors, its plain version on CPU tensors (same contract as
    nearest_neighbor_reference)."""
    global launches
    planes = (qx, qy, qc, mx, my, mc)
    dev = qx.device
    if dev.type == "cpu":
        return nearest_neighbor_reference(*planes)
    if dev.type != "cuda":
        raise ValueError(f"nearest_neighbor_planes: unsupported device {dev}")
    if qx.dim() != 2 or mx.dim() != 2 or qx.shape[0] != mx.shape[0]:
        raise ValueError(f"expected (B, S) and (B, C) planes, got "
                         f"{tuple(qx.shape)} and {tuple(mx.shape)}")
    B, S = qx.shape
    C = mx.shape[1]
    cuda_build.check_operands("K4", planes, [(B, S)] * 3 + [(B, C)] * 3)
    if C < 1 or B > 65535 or 12 * C > _MAX_SMEM:
        raise ValueError(f"K4 takes 1 <= C <= {_MAX_SMEM // 12} and "
                         f"B <= 65535; got B={B}, C={C}")
    idx = torch.empty((B, S), dtype=torch.int32, device=dev)
    dist = torch.empty((B, S), dtype=torch.float32, device=dev)
    lib = cuda_build.library()
    err = lib.slam_nn(*(p.data_ptr() for p in planes), idx.data_ptr(),
                      dist.data_ptr(), B, S, C,
                      torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "slam_nn")
    launches += 1
    return idx, dist


def nearest_neighbor(q, m, m_valid, q_class=None, m_class=None):
    """For each query (B, S, 2) return (index, squared distance) of its
    nearest valid model point (B, C, 2), restricted to its own class when
    both class planes are given (one-sided classes mean unconstrained)."""
    if q.shape[-1] != 2 or m.shape[-1] != 2:
        raise ValueError(f"nearest_neighbor is 2D-only (got q D={q.shape[-1]}"
                         f", m D={m.shape[-1]})")
    if q_class is None or m_class is None:
        qc = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
        mc = torch.zeros(m.shape[:-1], dtype=torch.float32, device=m.device)
    else:
        qc = q_class.to(torch.float32)
        mc = m_class.to(torch.float32)
    mc = torch.where(m_valid, mc, 2.0)
    return nearest_neighbor_planes(
        q[..., 0].contiguous(), q[..., 1].contiguous(), qc.contiguous(),
        m[..., 0].contiguous(), m[..., 1].contiguous(), mc.contiguous())
