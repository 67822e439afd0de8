"""The constraint stage of the step: kernels B2 and B3 and their plain
PyTorch twins.

Counterpart of humanoid_mujoco_tpu/physics/pallas_solver.py. Both
kernels run the Newton constraint solve and the implicit-damping Euler
update (M + h diag(damping)) dv = h (qfrc_smooth + qfrc_constraint):

- `solve_step_raw` (B2, csrc/solver.cu) builds the condim-6 pyramid rows
  from the raw contact and limit data of the smooth stage; its twin is
  `solve_step_raw_reference` (the counterpart of `_jax_single_raw`);
- `solve_constraints_euler` (B3, csrc/euler.cu) takes explicit rows
  J (B, ne, nv) with per-row pos, k, b, d, as for a model without
  contact slots; its twin is `solve_constraints_euler_reference` (the
  counterpart of `_jax_single`).

For CPU tensors each entry point runs its twin; for CUDA tensors it
launches its kernel, or raises. As in the JAX package, the kernels serve
rollouts only; derivative callers will use the twins.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import linalg
from .solver import Rows, finish_efc, ls_grid, newton_solve, rows_from_raw

# kernel launches since import (or since the caller reset it): B2, B3
LAUNCHES = 0
EULER_LAUNCHES = 0
LS_MAX = 16          # line-search grid capacity of the kernel


def solve_step_raw_reference(M, qf, qv, cdof, rel, nrm, dist, mu3, dmask,
                             kc, bc, dc, lpos, kl, bl, dl, hdamp, dt,
                             lim_tab=(), niter: int = 8, ls_iter: int = 16):
    """Plain PyTorch twin of kernel B2 (counterpart of
    pallas_solver._jax_single_raw): rows_from_raw, then the B3 twin
    (finish_efc + newton_solve + Euler). Returns (qacc, qvel_new, fslot,
    qfrc_c)."""
    B, nv = qf.shape
    K, nlim = dist.shape[1], lpos.shape[1]
    rows = rows_from_raw(cdof, dmask, rel, nrm, dist, mu3, kc, bc, dc,
                         lim_tab, lpos, kl, bl, dl)
    qacc, qvn, f, qfc = solve_constraints_euler_reference(
        M, qf, qv, rows.J, rows.pos, rows.k, rows.b, rows.d, hdamp, dt,
        niter, ls_iter)
    fslot = f[:, nlim:].reshape(B, 10, K).sum(dim=1)
    return qacc, qvn, fslot, qfc


@functools.lru_cache(maxsize=None)
def _lim_csr(lim_tab, device):
    """Static limit-row Jacobian nonzeros as CSR: (ptr, dof, coef)."""
    tab = np.asarray(lim_tab, dtype=np.float64).reshape(len(lim_tab), -1)
    ptr, dof, coef = [0], [], []
    for row in tab:
        nz = np.nonzero(row)[0]
        dof.extend(int(v) for v in nz)
        coef.extend(float(row[v]) for v in nz)
        ptr.append(len(dof))
    # keep one element so every pointer is valid when there are no rows
    dof = dof or [0]
    coef = coef or [0.0]
    return (torch.tensor(ptr, dtype=torch.int32, device=device),
            torch.tensor(dof, dtype=torch.int32, device=device),
            torch.tensor(coef, dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=None)
def _grid(ls_iter, device):
    return ls_grid(ls_iter, torch.float32, device)


def scratch_floats(nv: int, K: int, nlim: int) -> int:
    """Per-env scratch of the kernel (the Carver layout in solver.cu)."""
    return 4 * nv * nv + 18 * nv + 36 * K + 3 * nlim


def solve_step_raw(M, qf, qv, cdof, rel, nrm, dist, mu3, dmask,
                   kc, bc, dc, lpos, kl, bl, dl, hdamp, dt,
                   lim_tab=(), niter: int = 8, ls_iter: int = 16):
    """Row-building contact solve + implicit-damping Euler from raw data.

    Batch-leading inputs: M (B, nv, nv), qf/qv (B, nv), cdof (B, nv, 6),
    rel/nrm/mu3 (B, K, 3), dist/kc/bc/dc (B, K), dmask (K, nv) static,
    lpos/kl/bl/dl (B, nlim), hdamp (nv,) and dt () shared by the batch;
    lim_tab the static (nlim, nv) limit Jacobian (solver.
    limit_rows_static). Returns (qacc, qvel_new, fslot, qfrc_constraint)
    with fslot (B, K) the per-slot summed normal force.
    """
    global LAUNCHES
    if M.device.type == "cpu":
        return solve_step_raw_reference(
            M, qf, qv, cdof, rel, nrm, dist, mu3, dmask, kc, bc, dc,
            lpos, kl, bl, dl, hdamp, dt, lim_tab, niter, ls_iter)
    from .. import kernels
    B, nv = qf.shape
    K, nlim = dist.shape[1], lpos.shape[1]
    dev = M.device
    args = (M, qf, qv, cdof, rel, nrm, dist, mu3, dmask, kc, bc, dc,
            lpos, kl, bl, dl)
    shapes = ((B, nv, nv), (B, nv), (B, nv), (B, nv, 6), (B, K, 3),
              (B, K, 3), (B, K), (B, K, 3), (K, nv), (B, K), (B, K), (B, K),
              (B, nlim), (B, nlim), (B, nlim), (B, nlim))
    for t, shape in zip(args, shapes):
        if t.device != dev:
            raise ValueError("all kernel inputs must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"the solver kernel runs in float32, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"kernel input of shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if not 2 <= ls_iter <= LS_MAX:
        raise ValueError(f"ls_iter must be in [2, {LS_MAX}]")
    if len(lim_tab) != nlim or any(len(row) != nv for row in lim_tab):
        raise ValueError("lim_tab must be (nlim, nv) for this limit data")

    def lanes(x):
        """(B, a, b) -> (b, a, B) for the contact arrays, (B, ...) ->
        (..., B) otherwise; contiguous (free for the smooth kernel's
        batch-last views)."""
        return x.permute(tuple(range(x.ndim - 1, 0, -1)) + (0,)).contiguous()

    def rows_last(x):
        return x.permute(tuple(range(1, x.ndim)) + (0,)).contiguous()

    f32 = torch.float32
    Mt, cdoft = rows_last(M), rows_last(cdof)
    qft, qvt = qf.t().contiguous(), qv.t().contiguous()
    relt, nrmt, mut = lanes(rel), lanes(nrm), lanes(mu3)
    distt, kct, bct, dct = (x.t().contiguous() for x in (dist, kc, bc, dc))
    if nlim:
        limt = [x.t().contiguous() for x in (lpos, kl, bl, dl)]
    else:
        limt = [torch.zeros((1, B), dtype=f32, device=dev)] * 4
    hd = torch.as_tensor(hdamp, dtype=f32, device=dev).reshape(nv)
    hd = hd.contiguous()
    dtt = torch.as_tensor(dt, dtype=f32, device=dev).reshape(1)
    dm = dmask.contiguous()
    lim_ptr, lim_dof, lim_coef = _lim_csr(tuple(lim_tab), dev)
    grid = _grid(ls_iter, dev)

    qacc = torch.empty((nv, B), dtype=f32, device=dev)
    qvn = torch.empty((nv, B), dtype=f32, device=dev)
    fslot = torch.empty((K, B), dtype=f32, device=dev)
    qfc = torch.empty((nv, B), dtype=f32, device=dev)
    scratch = torch.empty((scratch_floats(nv, K, nlim), B), dtype=f32,
                          device=dev)
    ins = (Mt, qft, qvt, cdoft, relt, nrmt, distt, mut, dm, kct, bct, dct,
           *limt, hd, dtt, lim_ptr, lim_dof, lim_coef, grid)
    outs = (qacc, qvn, fslot, qfc, scratch)
    kernels.launch("solver", *(t.data_ptr() for t in ins + outs),
                   B, nv, K, nlim, niter, ls_iter)
    LAUNCHES += 1
    return qacc.t(), qvn.t(), fslot.t(), qfc.t()


def solve_constraints_euler_reference(M, qf, qv, J, pos, k, b, d, hdamp,
                                      dt, niter: int = 8,
                                      ls_iter: int = 16):
    """Plain PyTorch twin of kernel B3 (counterpart of
    pallas_solver._jax_single): finish_efc + newton_solve + Euler.
    Returns (qacc, qvel_new, efc_force, qfrc_constraint)."""
    Mchol = linalg.chol_factor(M)
    efc = finish_efc(Rows(J=J, pos=pos, k=k, b=b, d=d), qv, Mchol)
    qacc, f, qfc = newton_solve(M, Mchol, qf, efc, niter=niter,
                                ls_iter=ls_iter)
    MhD = M + torch.diag(torch.as_tensor(hdamp, dtype=M.dtype,
                                         device=M.device))
    dv = dt * linalg.solve_psd(MhD, qf + qfc)
    return qacc, qv + dv, f, qfc


def euler_scratch_floats(nv: int, ne: int) -> int:
    """Per-env scratch of kernel B3 (the Carver layout in euler.cu)."""
    return 2 * nv * nv + 6 * nv + 3 * ne


def solve_constraints_euler(M, qf, qv, J, pos, k, b, d, hdamp, dt,
                            niter: int = 8, ls_iter: int = 16):
    """Constraint Newton solve + implicit-damping Euler on explicit rows.

    Batch-leading inputs: M (B, nv, nv), qf/qv (B, nv), J (B, ne, nv),
    pos/k/b/d (B, ne); hdamp (nv,) and dt () shared by the batch.
    Returns (qacc, qvel_new, efc_force (B, ne), qfrc_constraint).
    """
    global EULER_LAUNCHES
    if M.device.type == "cpu":
        return solve_constraints_euler_reference(
            M, qf, qv, J, pos, k, b, d, hdamp, dt, niter, ls_iter)
    from .. import kernels
    B, ne, nv = J.shape
    dev = M.device
    args = (M, qf, qv, J, pos, k, b, d)
    shapes = ((B, nv, nv), (B, nv), (B, nv), (B, ne, nv), (B, ne),
              (B, ne), (B, ne), (B, ne))
    for t, shape in zip(args, shapes):
        if t.device != dev:
            raise ValueError("all kernel inputs must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"the explicit-row solve kernel runs in "
                            f"float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"kernel input of shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if not 2 <= ls_iter <= LS_MAX:
        raise ValueError(f"ls_iter must be in [2, {LS_MAX}]")
    f32 = torch.float32
    hd = torch.as_tensor(hdamp, dtype=f32, device=dev)
    dtt = torch.as_tensor(dt, dtype=f32, device=dev)
    if hd.shape != (nv,) or dtt.numel() != 1:
        raise ValueError("hdamp must be (nv,) and dt one value, shared by "
                         "the batch")
    ins = (M.permute(1, 2, 0).contiguous(), qf.t().contiguous(),
           qv.t().contiguous(), J.permute(1, 2, 0).contiguous(),
           *(x.t().contiguous() for x in (pos, k, b, d)),
           hd.contiguous(), dtt.reshape(1).contiguous(),
           _grid(ls_iter, dev))
    qacc = torch.empty((nv, B), dtype=f32, device=dev)
    qvn = torch.empty((nv, B), dtype=f32, device=dev)
    f = torch.empty((ne, B), dtype=f32, device=dev)
    qfc = torch.empty((nv, B), dtype=f32, device=dev)
    scratch = torch.empty((euler_scratch_floats(nv, ne), B), dtype=f32,
                          device=dev)
    outs = (qacc, qvn, f, qfc, scratch)
    kernels.launch("euler", *(t.data_ptr() for t in ins + outs),
                   B, nv, ne, niter, ls_iter)
    EULER_LAUNCHES += 1
    return qacc.t(), qvn.t(), f.t(), qfc.t()
