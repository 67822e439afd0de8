"""The LQR backward pass in O(log T) depth, and its sequential oracle.

Counterpart of humanoid_mujoco_tpu/planners/parallel_riccati.py, the
temporal parallelization of dynamic programming (Särkkä and
García-Fernández): each step's conditional value function

    R_k(x, y) = 1/2 (y - A x - b)' C^+ (y - A x - b)
                + 1/2 x' J x - eta' x

is an element (A, b, C, eta, J); composing two (minimizing over the
intermediate state) is associative:

    A_ij = A_j (I + C_i J_j)^-1 A_i
    b_ij = A_j (I + C_i J_j)^-1 (b_i + C_i eta_j) + b_j
    C_ij = A_j (I + C_i J_j)^-1 C_i A_j' + C_j
    eta_ij = A_i' (I + J_j C_i)^-1 (eta_j - J_j b_i) + eta_i
    J_ij = A_i' (I + J_j C_i)^-1 J_j A_i + J_i

The JAX package reduces the elements with `lax.associative_scan(reverse
=True)`; here a Hillis-Steele suffix scan does: in round r every element
k with k + 2^r in range is composed with element k + 2^r, all of them
as one batch (batched `torch.linalg.solve` for the two resolvents), so
ceil(log2(T + 1)) rounds give every suffix value function V_k(x) =
1/2 x' J_k x - eta_k' x. The LQR gains follow per step. Control limits
are not handled: iLQG's sequential boxQP pass (planners/ilqg.py) stays
the limit-aware default, and no planner of the package calls this pass.

Products run in the inputs' dtype at full precision: on the card,
`torch.get_float32_matmul_precision()` must stay "highest" (TF32 would
round the float32 products to 10 mantissa bits).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.linalg import symmetrize


class _Elem(NamedTuple):
    A: torch.Tensor      # (N, n, n)
    b: torch.Tensor      # (N, n)
    C: torch.Tensor      # (N, n, n)
    eta: torch.Tensor    # (N, n)
    J: torch.Tensor      # (N, n, n)


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _solve(S: torch.Tensor, R: torch.Tensor, refine: int = 1
           ) -> torch.Tensor:
    """S^-1 R by one LU factorization and `refine` steps of iterative
    refinement: the resolvents (I + C J) of the humanoid's linearization
    reach condition numbers ~1e7 (C = B cuu^-1 B' with cuu ~0.025), and
    a plain solve there leaves the suffix values ~1e-10 from the
    sequential pass in float64; one step brings them to ~2e-11."""
    LU, piv = torch.linalg.lu_factor(S)
    X = torch.linalg.lu_solve(LU, piv, R)
    for _ in range(refine):
        X = X + torch.linalg.lu_solve(LU, piv, R - S @ X)
    return X


def _combine(ei: _Elem, ej: _Elem) -> _Elem:
    """e_i then e_j (i earlier in time), minimized over the shared
    intermediate state; batched over the leading axis."""
    n = ei.A.shape[-1]
    eye = torch.eye(n, dtype=ei.A.dtype, device=ei.A.device)
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    M = _solve(eye + Ci @ Jj, torch.cat(
        [Ai, (bi + (Ci @ etaj[..., None])[..., 0])[..., None], Ci], dim=-1))
    MAi, Mb, MCi = M[..., :n], M[..., n], M[..., n + 1:]
    N = _solve(eye + Jj @ Ci, torch.cat(
        [(etaj - (Jj @ bi[..., None])[..., 0])[..., None], Jj @ Ai],
        dim=-1))
    Nv, NJAi = N[..., 0], N[..., 1:]
    return _Elem(Aj @ MAi, (Aj @ Mb[..., None])[..., 0] + bj,
                 symmetrize(Aj @ MCi @ _t(Aj) + Cj),
                 (_t(Ai) @ Nv[..., None])[..., 0] + etai,
                 symmetrize(_t(Ai) @ NJAi + Ji))


def suffix_scan(elems: _Elem) -> _Elem:
    """Every suffix composition e_k ∘ e_{k+1} ∘ ... ∘ e_last, by
    Hillis-Steele rounds (log depth, each round one batched combine)."""
    cur = elems
    n, d = elems.A.shape[0], 1
    while d < n:
        head = _combine(_Elem(*(x[:n - d] for x in cur)),
                        _Elem(*(x[d:] for x in cur)))
        cur = _Elem(*(torch.cat([h, x[n - d:]]) for h, x in zip(head, cur)))
        d *= 2
    return cur


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def parallel_riccati(A, B, c, cxx, cxu, cuu, cx, cu, PT, pT
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The LQR backward pass in O(log T) depth.

    Inputs (T steps): dynamics x' = A x + B u + c; stage cost
    1/2 x'cxx x + cx'x + 1/2 u'cuu u + cu'u + x'cxu u; terminal
    1/2 x'PT x + pT'x. Returns (K (T, nu, n), k (T, nu), P (T+1, n, n),
    p (T+1, n)): the affine policy u_t = -K_t x_t - k_t and the value
    expansion V_t = 1/2 x'P x + p'x at every step and the end.
    """
    n = A.shape[-1]
    cuu_inv_cu = torch.linalg.solve(cuu, cu[..., None])[..., 0]  # (T, nu)
    cuu_inv_cxuT = torch.linalg.solve(cuu, _t(cxu))
    # complete the square in u: u = v - cuu^-1 (cu + cxu' x)
    At = A - B @ cuu_inv_cxuT
    ct = c - _mv(B, cuu_inv_cu)
    Xt = cxx - cxu @ cuu_inv_cxuT
    xt = cx - _mv(cxu, cuu_inv_cu)
    Cq = B @ torch.linalg.inv(cuu) @ _t(B)                  # B cuu^-1 B'
    z = A.new_zeros((1, n, n))
    # the steps' elements (each step's cost before its transition) and
    # the terminal element
    suffix = suffix_scan(_Elem(
        A=torch.cat([At, z]), b=torch.cat([ct, A.new_zeros((1, n))]),
        C=torch.cat([Cq, z]), eta=torch.cat([-xt, -pT[None]]),
        J=torch.cat([Xt, PT[None]])))
    # the cost-to-go after step k is the suffix starting at k + 1
    P_next, p_next = suffix.J[1:], -suffix.eta[1:]
    BtP = _t(B) @ P_next
    Quu = cuu + BtP @ B
    Qux = _t(cxu) + BtP @ A
    qu = cu + _mv(BtP, c) + _mv(_t(B), p_next)
    K = torch.linalg.solve(Quu, Qux)
    k = torch.linalg.solve(Quu, qu[..., None])[..., 0]
    return K, k, suffix.J, -suffix.eta


def sequential_riccati(A, B, c, cxx, cxu, cuu, cx, cu, PT, pT):
    """The O(T)-depth backward pass (iLQG's recursion without limits),
    a loop from the last step to the first: the oracle the parallel
    pass is held against. Returns (K, k, P, p), each (T, ...)."""
    P, p = PT, pT
    out = [None] * A.shape[0]
    for t in reversed(range(A.shape[0])):
        BtP = B[t].T @ P
        Quu = cuu[t] + BtP @ B[t]
        Qux = cxu[t].T + BtP @ A[t]
        qu = cu[t] + BtP @ c[t] + B[t].T @ p
        K = torch.linalg.solve(Quu, Qux)
        kk = torch.linalg.solve(Quu, qu)
        AtP = A[t].T @ P
        P = symmetrize(cxx[t] + AtP @ A[t] - Qux.T @ K)
        p = cx[t] + AtP @ c[t] + A[t].T @ p - Qux.T @ kk
        out[t] = (K, kk, P, p)
    return tuple(torch.stack(x) for x in zip(*out))
