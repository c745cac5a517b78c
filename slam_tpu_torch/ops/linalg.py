"""Small-matrix linear algebra — counterpart of slam_tpu/ops/linalg.py:
`inv3` for the EKF's 3x3 innovation covariance and the edge information,
and the batched SPD solves of the ground segmentation GP's plain version
(`ops/ground.py` `gp_sectors_reference`; on the card the GP runs in its
own kernel) and the pose graph's Gauss-Newton step (`cholesky`,
`forward_substitute`, `back_substitute`, `cho_solve`).

The JAX package unrolls Cholesky and substitution column by column because
XLA's TPU lowering of small batched factorizations is slow; here each is one
batched library call over every robot and sector (a column loop would issue
hundreds of tiny launches a tick). The factors agree to rounding. None of
them checks for errors, so none waits for the card: torch.linalg.cholesky
and torch.linalg.solve report a failed factorization to the host.
"""

from __future__ import annotations

import torch


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3) matrices. Intended for
    well-conditioned matrices (S = C Sigma C^T + Q with Q = 10 I)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, c * h - b * i, b * f - c * e], -1),
        torch.stack([B, a * i - c * g, c * d - a * f], -1),
        torch.stack([C, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj * (1.0 / det)[..., None, None]


def cholesky(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of batched SPD matrices (..., C, C). Checks
    nothing, so it never waits for the card; the GP system (kernel plus
    noise on the model, identity elsewhere) is SPD, where slam_tpu's
    diagonal floor of sqrt(1e-12) never binds."""
    return torch.linalg.cholesky_ex(M, check_errors=False).L


def forward_substitute(L: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Solve L Y = R for batched lower-triangular L (..., C, C) and
    right-hand sides R (..., C, Q)."""
    return torch.linalg.solve_triangular(L, R, upper=False)


def back_substitute(L: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Solve L^T X = Y for batched lower-triangular L (..., C, C) and
    right-hand sides Y (..., C, Q)."""
    return torch.linalg.solve_triangular(L.mT, Y, upper=True)


def cho_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with M x = b for batched SPD M (..., C, C) and b (..., C): one
    Cholesky factorization and two triangular solves."""
    L = cholesky(M)
    return back_substitute(L, forward_substitute(L, b[..., None]))[..., 0]
