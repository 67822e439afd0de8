"""Small batched Cholesky factor/solve for robot-scale systems.

Counterpart of humanoid_mujoco_tpu/ops/linalg.py (same diagonal clamp),
on batch-leading tensors. The factor loops over columns with batched
vector ops; the solves are triangular solves.
"""

from __future__ import annotations

import torch

_JITTER = 1e-10


def chol_factor(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD A (..., n, n), A = L Lᵀ.

    The pivot is clamped at `_JITTER` so near-singular inputs degrade
    instead of producing NaNs (the step's divergence guard handles them).
    A loop over columns, each computed from row j down (seven batched
    ops a column).
    """
    n = A.shape[-1]
    zero = A.new_zeros(A.shape[:-1])
    cols = []
    for j in range(n):
        s = A[..., j:, j]
        if j:
            Lp = torch.stack(cols, dim=-1)                  # (..., n, j)
            s = s - (Lp[..., j:, :] @ Lp[..., j, :, None])[..., 0]
        d = torch.sqrt(torch.clamp(s[..., :1], min=_JITTER))
        cols.append(torch.cat([zero[..., :j], d, s[..., 1:] / d], dim=-1))
    return torch.stack(cols, dim=-1)


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given L = chol_factor(A); b is (..., n) or (..., n, m)."""
    vec = b.ndim == L.ndim - 1
    bb = b[..., None] if vec else b
    y = torch.linalg.solve_triangular(L, bb, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0] if vec else x


def mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product, (..., n, m) x (..., m) -> (..., n)."""
    return (A @ v[..., None])[..., 0]


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD A x = b (factor + solve)."""
    return chol_solve(chol_factor(A), b)


def symmetrize(A: torch.Tensor) -> torch.Tensor:
    """(A + Aᵀ) / 2 over the last two axes."""
    return 0.5 * (A + A.transpose(-1, -2))
