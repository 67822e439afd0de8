"""The physics step: the mj_step analog on a batch of states.

Counterpart of humanoid_mujoco_tpu/physics/step.py (step.py:245-350),
with its four routes (`route`):

- "smooth", models in kernel B1's family (`fused_smooth.supported`: the
  cap humanoid, Walker, Quadruped Flat): the smooth stage (kernel B1,
  fused_smooth.smooth_raw), then the row-building contact solve +
  implicit-damping Euler (kernel B2, fused_solver.solve_step_raw),
  selection-free over all slots as on the JAX kernel path;
- "contact", models with contact slots outside B1's family (Quadruped
  Hill, whose 64 x 64 heightfield is over B1's 1024-cell gate; every
  model with capsules, boxes, fixed tendons, gravcomp or site actuators:
  the upstream humanoid, OP3, Panda, PickAndPlace, FreeFingers, the
  Quadrotor, the bimanual Handover, Insert and Reorient, Allegro,
  Shadow, Humanoid Interact, Rubik): the plain smooth stage
  `engine.prepare_smooth`, `collide`, the raw contact and limit data
  (solver.contact_raw, limit_rows_data), then kernel B2, as JAX
  step.py:288-319 does. Selection-free when nv·(nlim + 10 ncon) <= 16384,
  as there, also where the model keeps a top-k cap (`max_contacts`) in
  `forward`: B2 takes the static (ncon, nv) mask. Above that gate (the
  hands, Insert, Reorient, Interact, Rubik) the step keeps the top-k
  selection (`select_contacts`, a stable sort of the gaps): B2 solves
  the k selected slots with their per-env mask (B, k, nv), its chain
  area sized by the model's k longest slot chains, and the per-slot
  forces scatter back to the full slot layout; `contact_dist` stays the
  full slot set;
- "rows", models with no contact slots and at least one constraint row
  (the Swimmer, Cartpole): the plain smooth stage, the joint-limit rows
  (solver.make_rows), then the explicit-row solve + Euler (kernel B3,
  fused_solver.solve_constraints_euler);
- "free", models with no contact slots and no rows (Acrobot, Particle):
  the plain smooth stage, qacc = M⁻¹ qfrc_smooth and the update
  (M + h diag(damping)) dv = h qfrc_smooth, plain PyTorch on every
  device, as JAX runs this route without a kernel
  (pallas_solver.py:295-305, :317, :331).

Then position integration on the configuration manifold. CPU tensors
run the kernels' plain PyTorch twins; CUDA tensors run the kernels.
`step_rk4` is the JAX package's explicit RK4 on `forward`, plain PyTorch
on every device as there.

`forward` is the JAX package's forward dynamics (qacc, qfrc_total, M,
StepInfo) without the Euler update, plain PyTorch on every device as in
the JAX package (it has no kernel there): the smooth stage, collision,
top-k contact selection when 0 < max_contacts < ncon, the rows, their
Newton solve on M. Its users are the serving path's root-height search
(serving/state_estimation.py) and, with `ift=True`, the derivative path
of the iLQG planner (`step(ift=True)`, planners/derivatives.py).

Divergence guard: `StepInfo.diverged` flags non-finite or exploding
states, and `step` freezes such an environment (qpos kept, qvel zeroed)
so a diverged rollout stays finite.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops import linalg
from . import engine, fused_smooth, fused_solver
from . import math as pm
from .collision import collide, select_contacts
from .model import JointType, Model, State
from .solver import (contact_dmask, contact_raw, finish_efc,
                     limit_rows_data, limit_rows_static, make_contact_rows,
                     make_rows, newton_solve)

_QVEL_LIMIT = 1e4


@dataclasses.dataclass(frozen=True)
class StepInfo:
    """Per-step observables for costs and sensors, batch-leading."""

    xpos: torch.Tensor           # (B, nbody, 3)
    xquat: torch.Tensor          # (B, nbody, 4)
    xipos: torch.Tensor          # (B, nbody, 3) body COMs
    site_xpos: torch.Tensor      # (B, nsite, 3)
    com: torch.Tensor            # (B, 3) whole-model COM
    com_vel: torch.Tensor        # (B, 3) whole-model COM velocity
    body_com_vel: torch.Tensor   # (B, nbody, 3)
    contact_dist: torch.Tensor   # (B, ncon) signed gaps
    contact_force: torch.Tensor  # (B, ncon) normal force per slot
    qacc: torch.Tensor           # (B, nv)
    actuator_force: torch.Tensor  # (B, nu) joint torques after gear
    qfrc_total: torch.Tensor     # (B, nv) smooth + constraint force
    diverged: torch.Tensor       # (B,) bool


def integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor, dt
                  ) -> torch.Tensor:
    """Position integration (mj_integratePos): free-joint quaternions
    through the exponential map with local-frame omega."""
    s = m.struct
    cols = []
    for j in range(s.njnt):
        qadr, vadr = s.jnt_qadr[j], s.jnt_vadr[j]
        t = s.jnt_type[j]
        if t == JointType.FREE:
            cols.append(qpos[:, qadr:qadr + 3] + dt * qvel[:, vadr:vadr + 3])
            cols.append(pm.quat_integrate(
                pm.quat_normalize(qpos[:, qadr + 3:qadr + 7]),
                qvel[:, vadr + 3:vadr + 6], dt))
        elif t == JointType.BALL:
            cols.append(pm.quat_integrate(
                pm.quat_normalize(qpos[:, qadr:qadr + 4]),
                qvel[:, vadr:vadr + 3], dt))
        else:
            cols.append(qpos[:, qadr:qadr + 1] + dt * qvel[:, vadr:vadr + 1])
    return torch.cat(cols, dim=-1)


def _contact_forces(efc_f: torch.Tensor, nlim: int, sel, ncon: int
                    ) -> torch.Tensor:
    """Per-slot normal forces (B, ncon): the sum of each slot's 10
    pyramid-edge forces (every condim-6 edge has a unit normal
    coefficient; rows edge-major after `nlim` limit rows), scattered back
    to the full slot layout when a top-k selection `sel` (B, k) is
    active."""
    B = efc_f.shape[0]
    k = (efc_f.shape[1] - nlim) // 10
    cf = efc_f[:, nlim:nlim + 10 * k].reshape(B, 10, k).sum(dim=1)
    if sel is None:
        return cf
    return cf.new_zeros((B, ncon)).scatter(1, sel, cf)


def forward(m: Model, state: State, ctrl: torch.Tensor,
            xfrc: Optional[torch.Tensor] = None, solver_iters: int = 8,
            ift: bool = False):
    """Forward dynamics on a batch: (qacc (B, nv), qfrc_total (B, nv),
    M (B, nv, nv), StepInfo), qacc = the constrained acceleration on M
    (no implicit damping; `step` re-solves with it).

    Plain PyTorch on the CPU and the card alike, as the JAX `forward`
    is plain XLA everywhere: with 0 < max_contacts < ncon it solves only
    the max_contacts slots with the smallest gaps (the humanoid: 32 of
    67), which the kernels' selection-free step does not.

    `ift=True` takes the Newton solve's implicit-function derivative
    (solver.newton_solve): the path of derivative callers.
    """
    qpos, qvel = state.qpos, state.qvel
    if qpos.dtype != m.dtype or qpos.device != m.device:
        raise ValueError(f"state ({qpos.dtype}, {qpos.device}) does not "
                         f"match the model ({m.dtype}, {m.device})")
    s = m.struct
    kin, vel, M, qfrc_smooth = engine.prepare_smooth(m, qpos, qvel, ctrl,
                                                     xfrc)
    contacts, sel = None, None
    if m.ncon:
        contacts = collide(m, kin.xpos, kin.xmat)
        dist = contacts.dist
        if 0 < s.max_contacts < m.ncon:
            contacts, sel = select_contacts(contacts, s.max_contacts)
    else:
        dist = qpos.new_zeros((qpos.shape[0], 0))
    Mchol = linalg.chol_factor(M)
    rows = (make_contact_rows(m, kin, qpos, contacts, sel) if m.ncon
            else make_rows(m, qpos))
    efc = finish_efc(rows, qvel, Mchol)
    qacc, efc_f, qfrc_constraint = newton_solve(M, Mchol, qfrc_smooth, efc,
                                                niter=solver_iters, ift=ift)
    nlim = len(m.struct_static("lim_tab", lambda: limit_rows_static(m)))
    cf = _contact_forces(efc_f, nlim, sel, m.ncon)
    qfrc_total = qfrc_smooth + qfrc_constraint
    diverged = (~torch.isfinite(qacc).all(dim=-1)
                | (qvel.abs().amax(dim=-1) > _QVEL_LIMIT))
    info = StepInfo(
        xpos=kin.xpos, xquat=kin.xquat, xipos=kin.xipos,
        site_xpos=kin.site_xpos, com=kin.anchor, com_vel=vel.com_vel,
        body_com_vel=engine.body_com_velocities(kin, vel),
        contact_dist=dist, contact_force=cf, qacc=qacc,
        actuator_force=engine.actuator_force(m, qpos, qvel, ctrl),
        qfrc_total=qfrc_total, diverged=diverged)
    return qacc, qfrc_total, M, info


_SELECTION_FREE_MAX = 16384   # nv·ne of JAX step's selection-free gate


def route(m: Model) -> str:
    """The route `step` takes for this model: "smooth" (B1 + B2),
    "contact" (plain smooth stage + B2), "rows" (plain smooth stage +
    B3) or "free" (no kernel); see the module docstring."""
    return m.struct_static("step_route", lambda: _route(m))


def _route(m: Model) -> str:
    if fused_smooth.supported(m):
        return "smooth"
    nlim = len(m.struct_static("lim_tab", lambda: limit_rows_static(m)))
    if m.ncon:
        return "contact"
    return "rows" if nlim else "free"


def keeps_selection(m: Model) -> bool:
    """Whether the step's "contact" route keeps the top-k contact
    selection, as the JAX step does (step.py:303-305): a cap 0 <
    max_contacts < ncon and nv·(nlim + 10 ncon) over 16384."""
    def build():
        s = m.struct
        nlim = len(m.struct_static("lim_tab",
                                   lambda: limit_rows_static(m)))
        return bool(0 < s.max_contacts < m.ncon
                    and s.nv * (nlim + 10 * m.ncon) > _SELECTION_FREE_MAX)
    return m.struct_static("keeps_selection", build)


def step(m: Model, state: State, ctrl: torch.Tensor,
         xfrc: Optional[torch.Tensor] = None, solver_iters: int = 8,
         ift: bool = False) -> Tuple[State, StepInfo]:
    """Semi-implicit Euler with implicit joint damping (mj_Euler analog)
    on a batch: state (B, ...), ctrl (B, nu), xfrc (B, nbody, 6).

    `ift=True` is the derivative callers' step (JAX step.py:230-240):
    `forward` with the implicit-function derivative of its Newton solve
    (top-k contact selection where the model has one), then the
    implicit-damping update (M + h·diag(damping)) dv = h·qfrc_total.
    It is plain PyTorch on every device by design, as the JAX ift path
    never enters a Pallas kernel: the kernels serve rollouts only, and
    forward-mode tangents run through the plain twin.
    """
    h = m.dt
    s = m.struct
    qpos, qvel = state.qpos, state.qvel
    if qpos.dtype != m.dtype or qpos.device != m.device:
        raise ValueError(f"state ({qpos.dtype}, {qpos.device}) does not "
                         f"match the model ({m.dtype}, {m.device})")
    way = "ift" if ift else route(m)
    if way == "ift":
        _, qfrc_total, M, info = forward(m, state, ctrl, xfrc, solver_iters,
                                         ift=True)
        MhD = M + torch.diag_embed(h * m.dof_damping)
        qvel_new = qvel + h * linalg.solve_psd(MhD, qfrc_total)
    elif way == "smooth":
        (M, qfrc_smooth, cdof, rel, nrm, dist, mu3, kc, bc, dc,
         lpos, kl, bl, dl, xpos, xquat, xipos, bcv, sitex, anchor,
         com_vel, actf) = fused_smooth.smooth_raw(m, qpos, qvel, ctrl, xfrc)
        lim_tab = m.struct_static("lim_tab", lambda: limit_rows_static(m))
        qacc, qvel_new, cf, qfrc_constraint = fused_solver.solve_step_raw(
            M, qfrc_smooth, qvel, cdof, rel, nrm, dist, mu3,
            contact_dmask(m), kc, bc, dc, lpos, kl, bl, dl,
            h * m.dof_damping, h, lim_tab=lim_tab, niter=solver_iters)
        info = StepInfo(
            xpos=xpos, xquat=xquat, xipos=xipos, site_xpos=sitex,
            com=anchor, com_vel=com_vel, body_com_vel=bcv,
            contact_dist=dist, contact_force=cf, qacc=qacc,
            actuator_force=actf, qfrc_total=qfrc_smooth + qfrc_constraint,
            diverged=None)
    else:
        kin, vel, M, qfrc_smooth = engine.prepare_smooth(m, qpos, qvel, ctrl,
                                                         xfrc)
        hdamp = h * m.dof_damping
        dist = cf = qpos.new_zeros((qpos.shape[0], 0))
        if way == "contact":
            full = collide(m, kin.xpos, kin.xmat)
            contacts, sel, chain_max = full, None, None
            if keeps_selection(m):
                k = s.max_contacts
                contacts, sel = select_contacts(full, k)
                chain_max = m.struct_static(
                    ("topk_chain", k), lambda: fused_solver.chain_bound(
                        contact_dmask(m), k))
            dmask, rel, mu3, kc, bc, dc = contact_raw(m, kin, contacts, sel)
            lpos, kl, bl, dl = limit_rows_data(m, qpos)
            lim_tab = m.struct_static("lim_tab",
                                      lambda: limit_rows_static(m))
            dist = full.dist
            qacc, qvel_new, cf, qfrc_constraint = \
                fused_solver.solve_step_raw(
                    M, qfrc_smooth, qvel, kin.cdof, rel, contacts.normal,
                    contacts.dist, mu3, dmask, kc, bc, dc, lpos, kl, bl,
                    dl, hdamp, h, lim_tab=lim_tab, niter=solver_iters,
                    chain_max=chain_max)
            if sel is not None:
                cf = cf.new_zeros(dist.shape).scatter(1, sel, cf)
        elif way == "rows":
            rows = make_rows(m, qpos)
            qacc, qvel_new, _, qfrc_constraint = \
                fused_solver.solve_constraints_euler(
                    M, qfrc_smooth, qvel, rows.J, rows.pos, rows.k, rows.b,
                    rows.d, hdamp, h, niter=solver_iters)
        else:
            qacc = linalg.chol_solve(linalg.chol_factor(M), qfrc_smooth)
            qfrc_constraint = torch.zeros_like(qfrc_smooth)
            qvel_new = qvel + h * linalg.solve_psd(
                M + torch.diag_embed(hdamp), qfrc_smooth)
        info = StepInfo(
            xpos=kin.xpos, xquat=kin.xquat, xipos=kin.xipos,
            site_xpos=kin.site_xpos, com=kin.anchor, com_vel=vel.com_vel,
            body_com_vel=engine.body_com_velocities(kin, vel),
            contact_dist=dist, contact_force=cf, qacc=qacc,
            actuator_force=engine.actuator_force(m, qpos, qvel, ctrl),
            qfrc_total=qfrc_smooth + qfrc_constraint, diverged=None)
    qpos_new = integrate_pos(m, qpos, qvel_new, h)
    diverged = (~torch.isfinite(info.qacc).all(dim=-1)
                | (qvel.abs().amax(dim=-1) > _QVEL_LIMIT)
                | ~torch.isfinite(qvel_new).all(dim=-1))
    # freeze diverged environments so downstream stays finite
    qpos_new = torch.where(diverged[:, None], qpos, qpos_new)
    qvel_new = torch.where(diverged[:, None], torch.zeros_like(qvel_new),
                           qvel_new)
    return (State(qpos=qpos_new, qvel=qvel_new, time=state.time + h),
            dataclasses.replace(info, diverged=diverged))


def step_rk4(m: Model, state: State, ctrl: torch.Tensor,
             xfrc: Optional[torch.Tensor] = None, solver_iters: int = 8
             ) -> Tuple[State, StepInfo]:
    """Classic RK4 (mj_RungeKutta analog) on `forward`, explicit, as the
    JAX step_rk4: plain PyTorch on every device. Returns the new state
    and the StepInfo of the first stage."""
    h = m.dt

    def deriv(st):
        qacc, _, _, info = forward(m, st, ctrl, xfrc, solver_iters)
        return st.qvel, qacc, info

    v1, a1, info = deriv(state)
    s2 = State(integrate_pos(m, state.qpos, v1, 0.5 * h),
               state.qvel + 0.5 * h * a1, state.time)
    v2, a2, _ = deriv(s2)
    s3 = State(integrate_pos(m, state.qpos, v2, 0.5 * h),
               state.qvel + 0.5 * h * a2, state.time)
    v3, a3, _ = deriv(s3)
    s4 = State(integrate_pos(m, state.qpos, v3, h),
               state.qvel + h * a3, state.time)
    v4, a4, _ = deriv(s4)
    vavg = (v1 + 2 * v2 + 2 * v3 + v4) / 6.0
    aavg = (a1 + 2 * a2 + 2 * a3 + a4) / 6.0
    return (State(integrate_pos(m, state.qpos, vavg, h),
                  state.qvel + h * aavg, state.time + h), info)
