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
from torch.utils.weak import WeakIdKeyDictionary

from ..ops import linalg
from .solver import Rows, finish_efc, ls_grid, newton_solve, rows_from_raw

# kernel launches since import (or since the caller reset it): B2, B3
LAUNCHES = 0
EULER_LAUNCHES = 0
LS_MAX = 16          # line-search grid capacity of the kernel


def solve_step_raw_reference(M, qf, qv, cdof, rel, nrm, dist, mu3, dmask,
                             kc, bc, dc, lpos, kl, bl, dl, hdamp, dt,
                             lim_tab=(), niter: int = 8, ls_iter: int = 16,
                             chain_max=None):
    """Plain PyTorch twin of kernel B2 (counterpart of
    pallas_solver._jax_single_raw): rows_from_raw, then the B3 twin
    (finish_efc + newton_solve + Euler). dmask static (K, nv) or per env
    (B, K, nv); `chain_max`, the kernel's chain-area size, plays no part
    here. Returns (qacc, qvel_new, fslot, qfrc_c)."""
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
    """Static limit-row Jacobian nonzeros as CSR: (ptr, dof, row, coef),
    with each entry's row; then kernel B2's Hessian pairs of one row's
    entries with dof_k <= dof_i: (lower-triangle index of (dof_i,
    dof_k), row, c_i c_k in float32)."""
    tab = np.asarray(lim_tab, dtype=np.float64).reshape(len(lim_tab), -1) \
        if lim_tab else np.zeros((0, 1))
    ptr, dof, row_of, coef = [0], [], [], []
    ptri, prow, pcoef = [], [], []
    for r, row in enumerate(tab):
        nz = np.nonzero(row)[0]
        dof.extend(int(v) for v in nz)
        row_of.extend(r for _ in nz)
        coef.extend(float(row[v]) for v in nz)
        ptr.append(len(dof))
        for u in nz:
            for v in nz:
                if v <= u:
                    ptri.append(int(u * (u + 1) // 2 + v))
                    prow.append(r)
                    pcoef.append(float(np.float32(row[u])
                                       * np.float32(row[v])))

    def ints(x):
        # one element at least, so that every pointer is valid
        return torch.tensor(x or [0], dtype=torch.int32, device=device)

    def floats(x):
        return torch.tensor(x or [0.0], dtype=torch.float32, device=device)
    return (ints(ptr), ints(dof), ints(row_of), floats(coef), ints(ptri),
            ints(prow), floats(pcoef), len(ptri))


@functools.lru_cache(maxsize=None)
def _grid(ls_iter, device):
    return ls_grid(ls_iter, torch.float32, device)


SMEM_MAX = 232_448    # dynamic shared memory one block may use (H100)
ENVS_PER_BLOCK = 4    # B2, B3: one warp per env, at most this many a block
NV_MAX = 64           # kernel B2: two matrix rows per lane above 32 dofs
_CHAINS = WeakIdKeyDictionary()


def chain_layout(dmask: torch.Tensor):
    """The static chain mask (K, nv) compressed per slot, as kernel B2
    stores its base rows: (ptr (K+1,), dof (C,), sign (C,)) int32 /
    float32 numpy arrays, slot c's chain dofs at ptr[c]:ptr[c+1] in
    ascending order with their ±1 mask values, and the same three as
    tensors on the mask's device. Cached per mask tensor (the mask is
    static: `solver.contact_dmask` returns one tensor per model), so the
    host reads it once."""
    hit = _CHAINS.get(dmask)
    if hit is None:
        tab = dmask.detach().cpu().double().numpy()
        ptr, dof, sgn = [0], [], []
        for row in tab:
            nz = np.nonzero(row)[0]
            dof.extend(int(v) for v in nz)
            sgn.extend(float(row[v]) for v in nz)
            ptr.append(len(dof))
        arrays = (np.asarray(ptr, np.int32), np.asarray(dof, np.int32),
                  np.asarray(sgn, np.float32))
        # one element at least, so that every pointer is valid
        hit = arrays + tuple(
            torch.as_tensor(x if len(x) else np.zeros(1, x.dtype),
                            device=dmask.device) for x in arrays)
        _CHAINS[dmask] = hit
    return hit


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def solver_smem_bytes(nv: int, K: int, nlim: int, chain: int,
                      envs: int = 1, per_env: bool = False) -> int:
    """Dynamic shared memory of one block of kernel B2 with `envs` warps
    (csrc/solver.cu make_layout): the block's tables (with a static
    mask: slot offsets, compressed dofs, (slot, dof) positions; always
    the lower-triangle pairs), then per env M and H (row stride nv | 1),
    the six base rows over the `chain` compressed chain dofs, D, aref
    and r of the 10 K pyramid edges, friction, a work area, the limit
    rows' D, aref and r, six nv-vectors and the active-slot list, all
    float32 / int32; with a per-env mask also the env's own chain
    tables (signs, slot offsets, dofs and positions as bytes), `chain`
    entries long."""
    ld = nv | 1
    static = 0 if per_env else 4 * (K + 1) + chain + K * nv
    tables = _round_up(_round_up(static, 2) + nv * (nv + 1), 16)
    work = max(17 * K, 10 * K + nlim, nv * ld, 6 * nv)
    env = (2 * nv * ld + 6 * chain + 33 * K + work + 3 * nlim + 6 * nv
           + K)
    if per_env:
        env += chain + K + 1 + -(-chain // 4) + -(-K * nv // 4)
    return tables + 4 * envs * _round_up(env, 4)


def solver_block_shape(nv: int, K: int, nlim: int, chain: int,
                       per_env: bool = False):
    """(envs per block, shared bytes per block) of kernel B2, or a
    ValueError when nv exceeds the kernel's cap or one env's working
    set does not fit a block."""
    if nv > NV_MAX:
        raise ValueError(f"kernel B2 takes at most {NV_MAX} dofs, got {nv}")
    one = solver_smem_bytes(nv, K, nlim, chain, 1, per_env)
    if one > SMEM_MAX:
        raise ValueError(f"kernel B2 needs {one} bytes of shared memory for "
                         f"one env (nv {nv}, {K} slots, {nlim} limit rows, "
                         f"{chain} chain dofs); a block has {SMEM_MAX}")
    envs = ENVS_PER_BLOCK
    while solver_smem_bytes(nv, K, nlim, chain, envs, per_env) > SMEM_MAX:
        envs -= 1
    return envs, solver_smem_bytes(nv, K, nlim, chain, envs, per_env)


def chain_bound(dmask: torch.Tensor, k: int) -> int:
    """The most chain entries any k slots of the static mask (K, nv)
    hold: the sum of its k longest slot chains (read on the host once
    per mask, `chain_layout`). Kernel B2 sizes a per-env mask's chain
    area by it."""
    ptr = chain_layout(dmask)[0]
    return int(np.sort(np.diff(ptr))[::-1][:k].sum())


@functools.lru_cache(maxsize=None)
def _no_chain(device):
    """Placeholders for the static-mask pointers of a per-env launch."""
    return (torch.zeros(1, dtype=torch.int32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device),
            torch.zeros(1, dtype=torch.float32, device=device))


def _solver_launch_args(M, qf, qv, cdof, rel, nrm, dist, mu3, dmask,
                        kc, bc, dc, lpos, kl, bl, dl, hdamp, dt, lim_tab,
                        niter, ls_iter, chain_max=None):
    """Kernel B2's C arguments for checked inputs: (pointer tensors,
    ints, outputs (qacc, qvn, fslot, qfc) batch-last). A static mask
    (K, nv) goes compressed (`chain_layout`); a per-env mask (B, K, nv)
    dense and batch-last, its chain area `chain_max` entries an env
    (K nv if None). Raises ValueError before any launch when the model
    does not fit the kernel."""
    B, nv = qf.shape
    K, nlim = dist.shape[1], lpos.shape[1]
    dev = M.device
    per_env = dmask.ndim == 3
    if per_env:
        chain = _no_chain(dev)
        ndof = K * nv if chain_max is None else int(chain_max)
        if not 0 <= ndof <= K * nv:
            raise ValueError(f"chain_max must be in [0, {K * nv}]")
    else:
        _, dof, _, *chain = chain_layout(dmask)
        ndof = len(dof)
    envs, smem = solver_block_shape(nv, K, nlim, ndof, per_env)

    def lanes(x):
        """(B, a, b) -> (b, a, B) for the contact arrays, (B, ...) ->
        (..., B) otherwise; contiguous (free for the smooth kernel's
        batch-last views)."""
        return x.permute(tuple(range(x.ndim - 1, 0, -1)) + (0,)).contiguous()

    def rows_last(x):
        return x.permute(tuple(range(1, x.ndim)) + (0,)).contiguous()

    lim = _lim_csr(tuple(lim_tab), dev)
    f32 = torch.float32
    if nlim:
        limt = [x.t().contiguous() for x in (lpos, kl, bl, dl)]
    else:
        limt = [torch.zeros((1, B), dtype=f32, device=dev)] * 4
    hd = torch.as_tensor(hdamp, dtype=f32, device=dev).reshape(nv)
    dtt = torch.as_tensor(dt, dtype=f32, device=dev).reshape(1)
    outs = tuple(torch.empty((n, B), dtype=f32, device=dev)
                 for n in (nv, nv, K, nv))
    dm = rows_last(dmask) if per_env else chain[2]
    ins = (rows_last(M), qf.t().contiguous(), qv.t().contiguous(),
           rows_last(cdof), lanes(rel), lanes(nrm), dist.t().contiguous(),
           lanes(mu3), *(x.t().contiguous() for x in (kc, bc, dc)), *limt,
           hd.contiguous(), dtt,
           *chain, dm, *lim[:7], _grid(ls_iter, dev))
    ints = (B, nv, K, nlim, ndof, lim[7], niter, ls_iter, envs,
            int(per_env), smem)
    return ins, ints, outs


def solver_occupancy(nv: int, K: int, nlim: int, chain: int,
                     per_env: bool = False):
    """Kernel B2's occupancy on the current card at the block shape the
    wrapper launches: envs per block, shared bytes per env and per
    block, blocks per SM, registers and local (spill) bytes per thread
    of the instantiation it takes (R = 1 or 2, static or per-env
    mask)."""
    import ctypes
    from .. import kernels
    envs, smem = solver_block_shape(nv, K, nlim, chain, per_env)
    fn = kernels.load("solver").hm_solve_occupancy
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    out = (ctypes.c_int * 3)()
    err = fn(nv, K, nlim, chain, envs, int(per_env), smem,
             ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"hm_solve_occupancy failed: cudaError {err}")
    return {"envs_per_block": envs,
            "smem_per_env": solver_smem_bytes(nv, K, nlim, chain, 1, per_env)
            - solver_smem_bytes(nv, K, nlim, chain, 0, per_env),
            "smem_per_block": smem, "blocks_per_sm": out[0],
            "registers": out[1], "local_bytes": out[2]}


def solve_step_raw(M, qf, qv, cdof, rel, nrm, dist, mu3, dmask,
                   kc, bc, dc, lpos, kl, bl, dl, hdamp, dt,
                   lim_tab=(), niter: int = 8, ls_iter: int = 16,
                   chain_max=None):
    """Row-building contact solve + implicit-damping Euler from raw data.

    Batch-leading inputs: M (B, nv, nv), qf/qv (B, nv), cdof (B, nv, 6),
    rel/nrm/mu3 (B, K, 3), dist/kc/bc/dc (B, K), dmask (K, nv) static
    or (B, K, nv) per env (the selected slots' masks after a top-k
    selection), lpos/kl/bl/dl (B, nlim), hdamp (nv,) and dt () shared by
    the batch; lim_tab the static (nlim, nv) limit Jacobian (solver.
    limit_rows_static). With a per-env mask, `chain_max` bounds the
    nonzero entries of one env's mask (`chain_bound` of the model's
    static mask; K nv if None): the kernel sizes its chain area by it
    and flags an env over it as diverged (NaN qacc). Returns (qacc,
    qvel_new, fslot, qfrc_constraint) with fslot (B, K) the per-slot
    summed normal force.
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
              (B, K, 3), (B, K), (B, K, 3),
              (B, K, nv) if dmask.ndim == 3 else (K, nv), (B, K), (B, K),
              (B, K), (B, nlim), (B, nlim), (B, nlim), (B, nlim))
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
    ins, ints, outs = _solver_launch_args(
        M, qf, qv, cdof, rel, nrm, dist, mu3, dmask, kc, bc, dc, lpos, kl,
        bl, dl, hdamp, dt, lim_tab, niter, ls_iter, chain_max)
    kernels.launch("solver", *(t.data_ptr() for t in ins + outs), *ints)
    LAUNCHES += 1
    return tuple(x.t() for x in outs)


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


EULER_NV_MAX = 64    # kernel B3: two matrix rows per lane in its warp solves


def euler_smem_bytes(nv: int, ne: int, envs: int = 1) -> int:
    """Dynamic shared memory of one block of kernel B3 with `envs` warps
    (csrc/euler.cu make_layout): per env M and H (row stride nv | 1), J
    (ne rows at the same stride), D, aref and r per row, a work area for
    L⁻¹ or two floats per row, six nv-vectors and the active-row list,
    all float32 / int32, rounded up to 16 bytes."""
    ld = nv | 1
    env = (2 * nv * ld + ne * ld + 3 * ne + max(nv * ld, 2 * ne) + 6 * nv
           + ne)
    return 4 * envs * _round_up(env, 4)


def euler_block_shape(nv: int, ne: int):
    """(envs per block, shared bytes per block) of kernel B3, or a
    ValueError when nv exceeds the kernel's or one env's working set
    does not fit a block."""
    if not 1 <= nv <= EULER_NV_MAX:
        raise ValueError(f"kernel B3 takes 1 to {EULER_NV_MAX} dofs, got {nv}")
    one = euler_smem_bytes(nv, ne)
    if one > SMEM_MAX:
        raise ValueError(f"kernel B3 needs {one} bytes of shared memory for "
                         f"one env (nv {nv}, {ne} rows); a block has "
                         f"{SMEM_MAX}")
    envs = ENVS_PER_BLOCK
    while euler_smem_bytes(nv, ne, envs) > SMEM_MAX:
        envs -= 1
    return envs, euler_smem_bytes(nv, ne, envs)


def _euler_launch_args(M, qf, qv, J, pos, k, b, d, hdamp, dt, niter,
                       ls_iter):
    """Kernel B3's C arguments for checked inputs: (pointer tensors,
    ints, outputs (qacc, qvn, f, qfc) batch-first). The inputs are read
    in place at their strides (an int32 host tensor, the first pointer
    after the outputs): no copies. Raises ValueError before any launch
    when the model does not fit the kernel."""
    B, ne, nv = J.shape
    dev = M.device
    envs, smem = euler_block_shape(nv, ne)
    f32 = torch.float32
    hd = torch.as_tensor(hdamp, dtype=f32, device=dev)
    dtt = torch.as_tensor(dt, dtype=f32, device=dev)
    if hd.shape != (nv,) or dtt.numel() != 1:
        raise ValueError("hdamp must be (nv,) and dt one value, shared by "
                         "the batch")
    ins = (M, qf, qv, J, pos, k, b, d)
    strides = torch.tensor([s for x in ins for s in x.stride()],
                           dtype=torch.int32)
    outs = tuple(torch.empty(shape, dtype=f32, device=dev)
                 for shape in ((B, nv), (B, nv), (B, ne), (B, nv)))
    ins = ins + (hd.contiguous(), dtt.reshape(1), _grid(ls_iter, dev))
    return ins, (strides, B, nv, ne, niter, ls_iter, envs, smem), outs


def euler_occupancy(nv: int, ne: int):
    """Kernel B3's occupancy on the current card at the block shape the
    wrapper launches: envs per block, shared bytes per env and per
    block, blocks per SM, registers and local (spill) bytes per thread."""
    import ctypes
    from .. import kernels
    envs, smem = euler_block_shape(nv, ne)
    fn = kernels.load("euler").hm_solve_euler_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    out = (ctypes.c_int * 3)()
    err = fn(nv, ne, envs, smem, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"hm_solve_euler_occupancy failed: cudaError "
                           f"{err}")
    return {"envs_per_block": envs, "smem_per_env": euler_smem_bytes(nv, ne),
            "smem_per_block": smem, "blocks_per_sm": out[0],
            "registers": out[1], "local_bytes": out[2]}


def solve_constraints_euler(M, qf, qv, J, pos, k, b, d, hdamp, dt,
                            niter: int = 8, ls_iter: int = 16):
    """Constraint Newton solve + implicit-damping Euler on explicit rows.

    Batch-leading inputs: M (B, nv, nv), qf/qv (B, nv), J (B, ne, nv),
    pos/k/b/d (B, ne), at any strides (on the card the kernel reads them
    in place: an expanded static J costs nothing); hdamp (nv,) and dt ()
    shared by the batch. Returns (qacc, qvel_new, efc_force (B, ne),
    qfrc_constraint), contiguous.
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
    ins, (strides, *ints), outs = _euler_launch_args(
        M, qf, qv, J, pos, k, b, d, hdamp, dt, niter, ls_iter)
    kernels.launch("euler", *(t.data_ptr() for t in ins + outs + (strides,)),
                   *ints)
    EULER_LAUNCHES += 1
    return outs
