"""Box-constrained quadratic program: the mju_boxQP analog.

Counterpart of humanoid_mujoco_tpu/ops/boxqp.py. The iLQG backward pass
solves, at every Riccati step under control limits
(mjpc/planners/ilqg/backward_pass.cc:158-196),

    min_x  0.5 xᵀ H x + gᵀ x   s.t.  lower <= x <= upper

by a fixed-iteration projected Newton method on a masked dense
factorization: the clamped rows and columns of H are replaced by the
identity, so the matrix keeps its size and stays SPD, and the solve has
no data-dependent branch. The free-subspace factor then gives the
feedback gains with the clamped rows zeroed. Every function takes
leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import linalg
from .linalg import mv


class BoxQPResult(NamedTuple):
    x: torch.Tensor      # (..., n) solution, inside [lower, upper]
    free: torch.Tensor   # (..., n) 1 = free, 0 = clamped
    chol: torch.Tensor   # (..., n, n) Cholesky factor of the masked Hessian
    grad: torch.Tensor   # (..., n) objective gradient at x



def _masked_hessian(H: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """H with the clamped rows and columns zeroed and a unit diagonal
    there: SPD iff the free-free block is."""
    M = free[..., :, None] * free[..., None, :]
    return H * M + torch.diag_embed(1.0 - free)


def box_qp(H: torch.Tensor, g: torch.Tensor, lower: torch.Tensor,
           upper: torch.Tensor, x0: Optional[torch.Tensor] = None,
           iters: int = 8) -> BoxQPResult:
    """Fixed-iteration projected-Newton box QP. Each iteration: the
    clamped set (at a bound with the gradient pushing outward), a Newton
    solve of the free subspace with the clamped variables pinned, a clip
    back into the box."""
    eps = 1e-7 * torch.clamp(torch.amax(upper - lower, dim=-1,
                                        keepdim=True), min=1.0)
    x = torch.zeros_like(g) if x0 is None else x0
    x = torch.minimum(torch.maximum(x, lower), upper)
    free = L = None
    for _ in range(iters):
        grad = g + mv(H, x)
        clamped = ((x <= lower + eps) & (grad > 0)) | \
            ((x >= upper - eps) & (grad < 0))
        free = 1.0 - clamped.to(g.dtype)
        L = linalg.chol_factor(_masked_hessian(H, free))
        # the free-subspace Newton target x_f = -Hff⁻¹ (g_f + Hfc x_c)
        sol = linalg.chol_solve(L, (g + mv(H, x * (1.0 - free))) * free)
        x = torch.where(free > 0, -sol, x)
        x = torch.minimum(torch.maximum(x, lower), upper)
    return BoxQPResult(x=x, free=free, chol=L, grad=g + mv(H, x))


def free_solve(res: BoxQPResult, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the free subspace against a matrix rhs (..., n, k); the
    clamped rows of the result are zero (the gain extraction of the
    reference's backward pass, backward_pass.cc:178-196)."""
    f = res.free[..., :, None]
    return linalg.chol_solve(res.chol, rhs * f) * f
