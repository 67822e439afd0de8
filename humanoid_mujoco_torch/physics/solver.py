"""Constraint rows + Newton solver for contact/limit forces, batched.

Counterpart of humanoid_mujoco_tpu/physics/solver.py for the kernel
path: raw contact data -> condim-6 pyramid rows (edge-major) -> the
soft-constraint Newton solve

    min_x 0.5 |x - a_smooth|²_M + Σ_i 0.5 D_i [r_i < 0] r_i²,
    r_i = J_i x - aref_i,  aref = -b (J qvel) - k d pos,
    D_i = 1 / R_i,  R_i = (1-d)/d · diag(J M⁻¹ Jᵀ)_i

with a fixed iteration count and a 16-point parallel line search.
Forward only; the implicit-function derivative path comes later.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import linalg
from ..ops.linalg import mv
from .collision import Contacts, tangent_frame
from .engine import Kin
from .model import JointType, Model
from . import math as pm


@dataclasses.dataclass(frozen=True)
class Efc:
    """Finished constraint rows (the mjData.efc_* analog)."""

    J: torch.Tensor      # (B, ne, nv)
    aref: torch.Tensor   # (B, ne)
    D: torch.Tensor      # (B, ne)
    pos: torch.Tensor    # (B, ne)


@dataclasses.dataclass(frozen=True)
class Rows:
    """Raw constraint rows before the mass-matrix-dependent finish."""

    J: torch.Tensor      # (B, ne, nv)
    pos: torch.Tensor    # (B, ne)
    k: torch.Tensor
    b: torch.Tensor
    d: torch.Tensor


def impedance(solimp: torch.Tensor, violation: torch.Tensor) -> torch.Tensor:
    """MuJoCo solimp sigmoid (power 2, midpoint 0.5): dmin -> dmax."""
    dmin, dmax, width = solimp[0], solimp[1], solimp[2]
    x = torch.clamp(violation / torch.clamp(width, min=1e-9), 0.0, 1.0)
    y = torch.where(x < 0.5, 2.0 * x * x, 1.0 - 2.0 * (1.0 - x) ** 2)
    return dmin + y * (dmax - dmin)


def _kb(solref: torch.Tensor, solimp: torch.Tensor, d: torch.Tensor, dt):
    """(k, b) from solref/solimp, timeconst clamped at 2 dt."""
    tc, dr = solref[0], solref[1]
    tc = torch.maximum(tc, 2.0 * dt)
    dmax = solimp[1]
    b = 2.0 / torch.clamp(dmax * tc, min=1e-9)
    k = d / torch.clamp(dmax * dmax * tc * tc * dr * dr, min=1e-12)
    return k, b


def _limited_joints(m: Model):
    s = m.struct
    return [j for j in range(s.njnt) if s.jnt_limited[j]
            and s.jnt_type[j] in (JointType.HINGE, JointType.SLIDE)]


def limit_rows_static(m: Model):
    """Static limit-row Jacobian table (nlim, nv) as a nested tuple, in
    the JAX make_rows order: ±e_vadr per limited scalar joint, then ± the
    coefficient combination of each fixed tendon."""
    s = m.struct
    rows = []
    for j in _limited_joints(m):
        r = np.zeros(s.nv)
        r[s.jnt_vadr[j]] = 1.0
        rows.append(r)
        rows.append(-r)
    for jnts, coefs in zip(s.tendon_jnt, s.tendon_coef):
        r = np.zeros(s.nv)
        for j, c in zip(jnts, coefs):
            r[s.jnt_vadr[j]] += c
        rows.append(r)
        rows.append(-r)
    tab = np.stack(rows) if rows else np.zeros((0, s.nv))
    return tuple(tuple(float(x) for x in row) for row in tab)


def limit_rows_data(m: Model, qpos: torch.Tensor):
    """(pos, k, b, d) of the limit rows, each (B, nlim): the joint
    limits, then the fixed-tendon lengths against their ranges."""
    s = m.struct
    pos = []
    for j in _limited_joints(m):
        qadr = s.jnt_qadr[j]
        # shared (njnt, 2) or per env (B, njnt, 2)
        lo, hi = m.jnt_range[..., j, 0], m.jnt_range[..., j, 1]
        mg = m.jnt_margin[..., j]
        pos.append(qpos[:, qadr] - lo - mg)
        pos.append(hi - mg - qpos[:, qadr])
    for t, (jnts, coefs) in enumerate(zip(s.tendon_jnt, s.tendon_coef)):
        length = sum(c * qpos[:, s.jnt_qadr[j]] for j, c in zip(jnts, coefs))
        lo, hi = m.tendon_range[..., t, 0], m.tendon_range[..., t, 1]
        pos.append(length - lo)
        pos.append(hi - length)
    if not pos:
        z = qpos.new_zeros((qpos.shape[0], 0))
        return z, z, z, z
    pos = torch.stack(pos, dim=-1)
    d = impedance(m.limit_solimp, -pos)
    k, b = _kb(m.limit_solref, m.limit_solimp, d, m.dt)
    return pos, k, b.expand(pos.shape), d


def make_rows(m: Model, qpos: torch.Tensor) -> Rows:
    """Raw constraint rows of a model without contact slots: the joint
    and tendon limits, two rows each (the limit block of the JAX
    make_rows). J is the static table broadcast to (B, nlim, nv);
    pos, k, b, d are (B, nlim), with k and b from the model's dt."""
    if m.ncon:
        raise NotImplementedError(
            "a model with contact slots takes make_contact_rows")
    lim_tab = m.struct_static("lim_tab", lambda: limit_rows_static(m))
    J = m.struct_static(
        ("lim_J", qpos.dtype, qpos.device), lambda: torch.tensor(
            lim_tab, dtype=qpos.dtype, device=qpos.device).reshape(
                len(lim_tab), m.nv))
    pos, k, b, d = limit_rows_data(m, qpos)
    return Rows(J=J.expand(qpos.shape[0], -1, -1), pos=pos, k=k, b=b, d=d)


def contact_dmask(m: Model) -> torch.Tensor:
    """Static chain-difference dof mask (ncon, nv): body_b's chain minus
    body_a's chain per slot (floor side = no dofs), as floats."""
    def build():
        s = m.struct
        # float64 before differencing: body_dof is uint8 and would wrap
        body_dof = np.asarray(s.body_dof, dtype=np.float64)
        zero = np.zeros(s.nv)
        tab = np.stack([
            (body_dof[b] if b >= 0 else zero)
            - (body_dof[a] if a >= 0 else zero)
            for a, b in zip(s.slot_body_a, s.slot_body_b)])
        return torch.as_tensor(tab, dtype=m.dtype, device=m.device)
    return m.struct_static(("contact_dmask", m.dtype, m.device), build)


def contact_raw(m: Model, kin: Kin, contacts: Contacts, sel=None):
    """(dmask, rel, mu3, kcon, bcon, dcon) of `contacts`: rel (B, K, 3)
    contact point minus anchor, mu3 (B, K, 3) [slide, torsion, roll],
    k/b/d (B, K). Over the full slot set (sel None) dmask is the static
    (K, nv) mask; after a top-k selection (collision.select_contacts)
    with `sel` (B, k), the per-env mask contact_dmask(m)[sel] (B, k, nv),
    as JAX solver.py:322-323."""
    rel = contacts.pos - kin.anchor[:, None]
    mu3 = torch.stack([contacts.friction, contacts.friction_tor,
                       contacts.friction_roll], dim=-1)
    dcon = impedance(m.solimp, -contacts.dist)
    kcon, bcon = _kb(m.solref, m.solimp, dcon, m.dt)
    dmask = contact_dmask(m).to(rel.dtype)
    if sel is not None:
        dmask = dmask[sel]
    return dmask, rel, mu3, kcon, bcon.expand(dcon.shape), dcon


def rows_from_raw(cdof, dmask, rel, normal, dist, mu3, kcon, bcon, dcon,
                  lim_tab, lim_pos, lim_k, lim_b, lim_d) -> Rows:
    """Constraint rows from raw contact data, edge-major:
    [limits; edge0 c0..cK-1; edge1 c0..cK-1; ...]. cdof (B, nv, 6),
    dmask (K, nv) static or (B, K, nv) per env (after a top-k
    selection), contact arrays (B, K, ...), limit arrays (B, nlim)."""
    B, nv = cdof.shape[:2]
    ang, lin = cdof[:, None, :, :3], cdof[:, None, :, 3:]     # (B,1,nv,3)
    jac_pt = lin + pm.cross(ang, rel[:, :, None, :])          # (B,K,nv,3)
    dm = (dmask if dmask.ndim == 3 else dmask[None])[..., None]
    jac = dm * jac_pt
    jac_ang = dm * ang
    t1, t2 = tangent_frame(normal)

    def proj(j, d):
        return torch.einsum("bcvk,bck->bcv", j, d)

    Jn, Jt1, Jt2 = proj(jac, normal), proj(jac, t1), proj(jac, t2)
    Js, Jr1, Jr2 = proj(jac_ang, normal), proj(jac_ang, t1), \
        proj(jac_ang, t2)
    mu, mu_t, mu_r = mu3[..., 0:1], mu3[..., 1:2], mu3[..., 2:3]
    blocks = [Jn + mu * Jt1, Jn - mu * Jt1,
              Jn + mu * Jt2, Jn - mu * Jt2,
              Jn + mu_t * Js, Jn - mu_t * Js,
              Jn + mu_r * Jr1, Jn - mu_r * Jr1,
              Jn + mu_r * Jr2, Jn - mu_r * Jr2]
    lim_J = torch.as_tensor(np.asarray(lim_tab, dtype=np.float64).reshape(
        -1, nv), dtype=cdof.dtype, device=cdof.device).expand(B, -1, nv)
    n = len(blocks)
    return Rows(J=torch.cat([lim_J] + blocks, dim=1),
                pos=torch.cat([lim_pos] + [dist] * n, dim=1),
                k=torch.cat([lim_k] + [kcon] * n, dim=1),
                b=torch.cat([lim_b] + [bcon] * n, dim=1),
                d=torch.cat([lim_d] + [dcon] * n, dim=1))


def make_contact_rows(m: Model, kin: Kin, qpos: torch.Tensor,
                      contacts: Contacts, sel=None) -> Rows:
    """Raw constraint rows of a model with contact slots: the joint
    limits, then the condim-6 pyramid edges of `contacts` (the contact
    block of the JAX make_rows). `contacts` is the full slot set or a
    top-k reduced one from collision.select_contacts, whose `sel` (B, k)
    gathers the static per-slot dof masks. Rows are edge-major, as
    `rows_from_raw` builds them; the JAX make_rows orders them contact-
    major, which changes no solve (every consumer reduces over rows)."""
    dmask, rel, mu3, kc, bc, dc = contact_raw(m, kin, contacts, sel)
    lim_tab = m.struct_static("lim_tab", lambda: limit_rows_static(m))
    lpos, kl, bl, dl = limit_rows_data(m, qpos)
    return rows_from_raw(kin.cdof, dmask, rel, contacts.normal,
                         contacts.dist, mu3, kc, bc, dc, lim_tab, lpos, kl,
                         bl, dl)


def finish_efc(rows: Rows, qvel: torch.Tensor, Mchol: torch.Tensor) -> Efc:
    """aref = -b (J qvel) - k d pos;  D = 1 / ((1-d)/d · diag(J M⁻¹ Jᵀ))."""
    vel = (rows.J @ qvel[..., None])[..., 0]
    aref = -rows.b * vel - rows.k * rows.d * rows.pos
    Jt = rows.J.transpose(-1, -2)                         # (B, nv, ne)
    MiJt = linalg.chol_solve(Mchol, Jt)
    diagA = torch.clamp(torch.sum(Jt * MiJt, dim=-2), min=1e-10)
    R = torch.clamp((1.0 - rows.d) / torch.clamp(rows.d, min=1e-4),
                    min=1e-6) * diagA
    return Efc(J=rows.J, aref=aref, D=1.0 / R, pos=rows.pos)


def make_efc(m: Model, kin: Kin, qpos: torch.Tensor, qvel: torch.Tensor,
             contacts, Mchol: torch.Tensor, sel=None) -> Efc:
    """Finished constraint rows: make_contact_rows (edge-major, over
    `contacts` and the top-k `sel`) on a model with contact slots, else
    make_rows (`contacts` unused), then finish_efc."""
    rows = (make_contact_rows(m, kin, qpos, contacts, sel) if m.ncon
            else make_rows(m, qpos))
    return finish_efc(rows, qvel, Mchol)


def ls_grid(ls_iter: int, dtype, device) -> torch.Tensor:
    """{0} ∪ logspace(-3, log10 4, ls_iter - 1), the line-search grid."""
    g = np.concatenate([[0.0], np.logspace(-3.0, math.log10(4.0),
                                           ls_iter - 1)])
    return torch.as_tensor(g, dtype=dtype, device=device)



def newton_solve(M: torch.Tensor, Mchol: torch.Tensor,
                 qfrc_smooth: torch.Tensor, efc: Efc, niter: int = 8,
                 ls_iter: int = 16, trace: list | None = None,
                 ift: bool = False):
    """Minimize the soft-constraint objective over qacc.

    Returns (qacc, efc_force, qfrc_constraint), batch-leading. Each
    iteration: active set, gradient, H = M + Jᵀ Da J, Cholesky, search
    direction, then the line search on the fixed grid with linear
    interpolation of the sign crossing of the (monotone) dphi. A `trace`
    list receives each iteration's (r, J p), both (B, ne).

    `ift=True`, the implicit-function derivative (JAX solver.py:490-
    500): the iterations run on detached inputs, then one Newton step
    that carries derivatives is taken at the converged, frozen active
    set. Its value moves only by the solver's residual step; its
    derivative is the exact sensitivity -H⁻¹ ∂g/∂θ at that active set,
    not that of a truncated iteration and line search. Forward-mode
    tangents (planners/derivatives.py) pass through this step only.
    """
    a_s = linalg.chol_solve(Mchol, qfrc_smooth)
    J, aref, D = efc.J, efc.aref, efc.D
    if J.shape[1] == 0:
        return a_s, aref, torch.zeros_like(qfrc_smooth)
    Jt = J.transpose(-1, -2)
    grid = ls_grid(ls_iter, M.dtype, M.device)
    if ift:
        Md, a_sd, Jd, arefd, Dd = (t.detach() for t in (M, a_s, J, aref, D))
        xh = _newton_iterations(Md, a_sd, Jd, arefd, Dd, niter, grid, trace)
        act = (mv(Jd, xh) - arefd < 0).to(D.dtype)
        Da = D * act
        g = mv(M, xh - a_s) + mv(Jt, Da * (mv(J, xh) - aref))
        H = M + Jt @ (J * Da[..., None])
        x = xh - linalg.chol_solve(linalg.chol_factor(H), g)
    else:
        x = _newton_iterations(M, a_s, J, aref, D, niter, grid, trace)
    r = mv(J, x) - aref
    f = torch.clamp(-D * r, min=0.0) * (r < 0).to(D.dtype)
    return x, f, mv(Jt, f)


def _newton_iterations(M, a_s, J, aref, D, niter, grid, trace):
    """`niter` Newton iterations with the grid line search from a_s."""
    Jt = J.transpose(-1, -2)
    ls_iter = grid.shape[0]
    x = a_s
    for _ in range(niter):
        r = mv(J, x) - aref
        Da = D * (r < 0).to(D.dtype)
        Mx = mv(M, x - a_s)
        g = Mx + mv(Jt, Da * r)
        H = M + Jt @ (J * Da[..., None])
        p = -linalg.chol_solve(linalg.chol_factor(H), g)
        Jp = mv(J, p)
        if trace is not None:
            trace.append((r, Jp))
        pMp = torch.sum(p * mv(M, p), dim=-1)
        b0 = torch.sum(p * Mx, dim=-1)
        ra = r[:, None, :] + grid[None, :, None] * Jp[:, None, :]
        dphi = (b0[:, None] + grid * pMp[:, None]
                + torch.sum((D * Jp)[:, None, :]
                            * torch.clamp(ra, max=0.0), dim=-1))
        neg = dphi < 0
        i_lo = torch.clamp(neg.sum(-1) - 1, min=0)
        i_hi = torch.clamp(i_lo + 1, max=ls_iter - 1)
        d_lo = dphi.gather(1, i_lo[:, None])[:, 0]
        d_hi = dphi.gather(1, i_hi[:, None])[:, 0]
        a_lo, a_hi = grid[i_lo], grid[i_hi]
        frac = torch.clamp(d_lo / torch.clamp(d_lo - d_hi, max=-1e-12),
                           0.0, 1.0)
        alpha = torch.where(neg[:, -1], grid[-1], a_lo + frac * (a_hi - a_lo))
        alpha = torch.where(neg[:, 0], alpha, torch.zeros_like(alpha))
        x = x + alpha[:, None] * p
    return x
