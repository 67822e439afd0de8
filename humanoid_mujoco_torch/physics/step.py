"""The physics step: the mj_step analog on a batch of states.

Counterpart of humanoid_mujoco_tpu/physics/step.py (step.py:245-350),
with its two kernel paths:

- models in kernel B1's family (`fused_smooth.supported`, the cap
  humanoid): the smooth stage (kernel B1, fused_smooth.smooth_raw), then
  the row-building contact solve + implicit-damping Euler (kernel B2,
  fused_solver.solve_step_raw), selection-free over all slots as on the
  JAX kernel path;
- models with no contact slots and at least one constraint row (the
  Swimmer): the plain smooth stage `engine.prepare_smooth` (plain
  PyTorch, as the JAX package runs it in XLA for such models), the
  joint-limit rows (solver.make_rows), then the explicit-row solve +
  Euler (kernel B3, fused_solver.solve_constraints_euler).

Then position integration on the configuration manifold. CPU tensors
run the kernels' plain PyTorch twins; CUDA tensors run the kernels.
Other models (contacts outside B1's family, no constraint rows at all)
come with slice 4 of the port and raise.

Divergence guard: `StepInfo.diverged` flags non-finite or exploding
states, and `step` freezes such an environment (qpos kept, qvel zeroed)
so a diverged rollout stays finite.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import engine, fused_smooth, fused_solver
from . import math as pm
from .model import ActuatorType, JointType, Model, State
from .solver import contact_dmask, limit_rows_static, make_rows

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


def _check(m: Model, qpos: torch.Tensor, ift: bool) -> bool:
    """Validate the call; True for B1's family, False for the explicit-
    row path."""
    if ift:
        raise NotImplementedError(
            "step(ift=True), the implicit-function derivative path, comes "
            "with slice 5 of the port")
    if qpos.dtype != m.dtype or qpos.device != m.device:
        raise ValueError(f"state ({qpos.dtype}, {qpos.device}) does not "
                         f"match the model ({m.dtype}, {m.device})")
    if m.struct_static("smooth_supported",
                       lambda: fused_smooth.supported(m)):
        return True
    s = m.struct
    if m.ncon or s.ntendon or s.has_gravcomp or any(
            t == ActuatorType.SITE_THRUST for t in s.act_type):
        raise NotImplementedError(
            "this model is outside the kernel family (capsules, boxes, "
            "tendons, gravcomp, site actuators); its step comes with "
            "slice 4 of the port")
    if not m.struct_static("lim_tab", lambda: limit_rows_static(m)):
        raise NotImplementedError(
            "a model without contact slots or constraint rows (Acrobot, "
            "Particle) takes the solver-free step of slice 4 of the port")
    return False


def step(m: Model, state: State, ctrl: torch.Tensor,
         xfrc: Optional[torch.Tensor] = None, solver_iters: int = 8,
         ift: bool = False) -> Tuple[State, StepInfo]:
    """Semi-implicit Euler with implicit joint damping (mj_Euler analog)
    on a batch: state (B, ...), ctrl (B, nu), xfrc (B, nbody, 6)."""
    kernel_family = _check(m, state.qpos, ift)
    h = m.dt
    qpos, qvel = state.qpos, state.qvel
    if kernel_family:
        (M, qfrc_smooth, cdof, rel, nrm, dist, mu3, kc, bc, dc,
         lpos, kl, bl, dl, xpos, xquat, xipos, bcv, sitex, anchor,
         com_vel, actf) = fused_smooth.smooth_raw(m, qpos, qvel, ctrl, xfrc)
        lim_tab = m.struct_static("lim_tab", lambda: limit_rows_static(m))
        qacc, qvel_new, cf, qfrc_constraint = fused_solver.solve_step_raw(
            M, qfrc_smooth, qvel, cdof, rel, nrm, dist, mu3,
            contact_dmask(m), kc, bc, dc, lpos, kl, bl, dl,
            h * m.dof_damping, h, lim_tab=lim_tab, niter=solver_iters)
    else:
        kin, vel, M, qfrc_smooth = engine.prepare_smooth(m, qpos, qvel, ctrl,
                                                         xfrc)
        rows = make_rows(m, qpos)
        qacc, qvel_new, _, qfrc_constraint = \
            fused_solver.solve_constraints_euler(
                M, qfrc_smooth, qvel, rows.J, rows.pos, rows.k, rows.b,
                rows.d, h * m.dof_damping, h, niter=solver_iters)
        xpos, xquat, xipos = kin.xpos, kin.xquat, kin.xipos
        sitex, anchor, com_vel = kin.site_xpos, kin.anchor, vel.com_vel
        bcv = engine.body_com_velocities(kin, vel)
        dist = cf = qpos.new_zeros((qpos.shape[0], 0))
        actf = engine.actuator_force(m, qpos, qvel, ctrl)
    qpos_new = integrate_pos(m, qpos, qvel_new, h)
    diverged = (~torch.isfinite(qacc).all(dim=-1)
                | (qvel.abs().amax(dim=-1) > _QVEL_LIMIT)
                | ~torch.isfinite(qvel_new).all(dim=-1))
    # freeze diverged environments so downstream stays finite
    qpos_new = torch.where(diverged[:, None], qpos, qpos_new)
    qvel_new = torch.where(diverged[:, None], torch.zeros_like(qvel_new),
                           qvel_new)
    info = StepInfo(
        xpos=xpos, xquat=xquat, xipos=xipos, site_xpos=sitex, com=anchor,
        com_vel=com_vel, body_com_vel=bcv, contact_dist=dist,
        contact_force=cf, qacc=qacc, actuator_force=actf,
        qfrc_total=qfrc_smooth + qfrc_constraint, diverged=diverged)
    return State(qpos=qpos_new, qvel=qvel_new, time=state.time + h), info
