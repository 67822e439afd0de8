"""Forward kinematics + smooth (unconstrained) dynamics, batched.

Counterpart of humanoid_mujoco_tpu/physics/engine.py: free, ball,
hinge and slide joints; motor, position and site (thrust or Cartesian
wrench) actuators; joint springs and damping, per-body gravity
compensation and the inertia-box fluid drag of the Swimmer's medium.
Every
function takes batch-leading tensors; loops run over the static
structure, and the per-body recursions are masked contractions over
the static (nbody, nv) chain mask, as in the JAX package.

Spatial algebra: 6-vectors [angular; linear] in world axes about the
whole-model COM (the anchor).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from . import math as pm
from .model import ActuatorType, JointType, Model


@dataclasses.dataclass(frozen=True)
class Kin:
    """Position-stage quantities, batch-leading."""

    xpos: torch.Tensor      # (B, nbody, 3)
    xquat: torch.Tensor     # (B, nbody, 4)
    xmat: torch.Tensor      # (B, nbody, 3, 3)
    xipos: torch.Tensor     # (B, nbody, 3) body COM
    xanchor: torch.Tensor   # (B, njnt, 3) joint anchors
    anchor: torch.Tensor    # (B, 3) whole-model COM
    cdof: torch.Tensor      # (B, nv, 6) motion subspaces about the anchor
    cinert: torch.Tensor    # (B, nbody, 6, 6)
    total_mass: torch.Tensor  # () or (B,) with per-env masses
    site_xpos: torch.Tensor   # (B, nsite, 3)


@dataclasses.dataclass(frozen=True)
class Vel:
    """Velocity-stage quantities, batch-leading."""

    cvel: torch.Tensor      # (B, nbody, 6)
    cdof_dot: torch.Tensor  # (B, nv, 6)
    com_vel: torch.Tensor   # (B, 3)


def fwd_position(m: Model, qpos: torch.Tensor) -> Kin:
    s = m.struct
    B = qpos.shape[0]
    xpos = [None] * s.nbody
    xquat = [None] * s.nbody
    xanchor = [None] * s.njnt
    for b in range(s.nbody):
        p = s.body_parent[b]
        if p < 0:
            pos = m.body_pos[b].expand(B, 3)
            quat = m.body_quat[b].expand(B, 4)
        else:
            pos = xpos[p] + pm.quat_rotate(xquat[p], m.body_pos[b])
            quat = pm.quat_mul(xquat[p], m.body_quat[b])
        for j in s.body_joints[b]:
            qadr = s.jnt_qadr[j]
            t = s.jnt_type[j]
            if t == JointType.FREE:
                pos = qpos[:, qadr:qadr + 3]
                quat = pm.quat_normalize(qpos[:, qadr + 3:qadr + 7])
                xanchor[j] = pos
            else:
                anchor_w = pos + pm.quat_rotate(quat, m.jnt_pos[j])
                xanchor[j] = anchor_w
                if t == JointType.BALL:
                    qj = pm.quat_normalize(qpos[:, qadr:qadr + 4])
                    quat = pm.quat_mul(quat, qj)
                    pos = anchor_w - pm.quat_rotate(quat, m.jnt_pos[j])
                elif t == JointType.HINGE:
                    qj = pm.axis_angle_to_quat(m.jnt_axis[j], qpos[:, qadr])
                    quat = pm.quat_mul(quat, qj)
                    pos = anchor_w - pm.quat_rotate(quat, m.jnt_pos[j])
                elif t == JointType.SLIDE:
                    pos = pos + pm.quat_rotate(
                        quat, m.jnt_axis[j] * qpos[:, qadr:qadr + 1])
        xpos[b] = pos
        xquat[b] = quat

    xpos = torch.stack(xpos, dim=1)
    xquat = torch.stack(xquat, dim=1)
    xmat = pm.quat_to_mat(xquat)
    xanchor = (torch.stack(xanchor, dim=1) if s.njnt
               else qpos.new_zeros((B, 0, 3)))

    xipos = xpos + torch.einsum("nbij,bj->nbi", xmat, m.body_ipos)
    # body_mass is shared (nbody,) or per env (B, nbody)
    total_mass = torch.sum(m.body_mass, dim=-1)
    anchor = torch.sum(m.body_mass[..., None] * xipos, dim=1) / torch.clamp(
        total_mass, min=1e-12)[..., None]

    cdof = _compute_cdof(m, xquat, xmat, xanchor, anchor)

    imat = pm.quat_to_mat(m.body_iquat)            # inertial frame in body
    R = xmat @ imat                                # inertial frame in world
    inertia_w = R @ (m.body_inertia[..., None] * R.transpose(-1, -2))
    cinert = pm.spatial_inertia(m.body_mass, inertia_w,
                                xipos - anchor[:, None])

    if s.site_names:
        site_xpos = torch.stack([
            xpos[:, b] + pm.quat_rotate(xquat[:, b], m.site_pos[i])
            for i, b in enumerate(s.site_body)], dim=1)
    else:
        site_xpos = qpos.new_zeros((B, 0, 3))
    return Kin(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
               xanchor=xanchor, anchor=anchor, cdof=cdof, cinert=cinert,
               total_mass=total_mass, site_xpos=site_xpos)


def _compute_cdof(m: Model, xquat, xmat, xanchor, anchor) -> torch.Tensor:
    s = m.struct
    B = anchor.shape[0]
    z3 = anchor.new_zeros((B, 3))
    eye = torch.eye(3, dtype=anchor.dtype, device=anchor.device)
    rows = []
    for j in range(s.njnt):
        t = s.jnt_type[j]
        b = s.jnt_body[j]
        arm = anchor - xanchor[:, j]
        if t == JointType.FREE:
            for k in range(3):          # translation dofs: world axes
                rows.append(torch.cat([z3, eye[k].expand(B, 3)], dim=-1))
            for k in range(3):          # rotation dofs: body-frame axes
                ax = xmat[:, b, :, k]
                rows.append(torch.cat([ax, pm.cross(ax, arm)], dim=-1))
        elif t == JointType.BALL:
            for k in range(3):
                ax = xmat[:, b, :, k]
                rows.append(torch.cat([ax, pm.cross(ax, arm)], dim=-1))
        elif t == JointType.HINGE:
            ax = pm.quat_rotate(xquat[:, b], m.jnt_axis[j])
            rows.append(torch.cat([ax, pm.cross(ax, arm)], dim=-1))
        elif t == JointType.SLIDE:
            ax = pm.quat_rotate(xquat[:, b], m.jnt_axis[j])
            rows.append(torch.cat([z3, ax], dim=-1))
    if not rows:
        return anchor.new_zeros((B, 0, 6))
    return torch.stack(rows, dim=1)


def fwd_velocity(m: Model, kin: Kin, qvel: torch.Tensor) -> Vel:
    s = m.struct
    body_dof = m.body_dof_t(qvel.dtype)                  # (nbody, nv)
    cvel = (body_dof * qvel[:, None, :]) @ kin.cdof      # (B, nbody, 6)

    # body-fixed subspaces: S_dot = v_body ×m S; free translation: 0
    cdof_dot = [None] * s.nv
    for j in range(s.njnt):
        b = s.jnt_body[j]
        v0 = s.jnt_vadr[j]
        t = s.jnt_type[j]
        nvj = {JointType.FREE: 6, JointType.BALL: 3}.get(t, 1)
        for k in range(v0, v0 + nvj):
            if t == JointType.FREE and k < v0 + 3:
                cdof_dot[k] = torch.zeros_like(kin.cdof[:, k])
            else:
                cdof_dot[k] = pm.motion_cross(cvel[:, b], kin.cdof[:, k])
    cdof_dot = (torch.stack(cdof_dot, dim=1) if s.nv
                else torch.zeros_like(kin.cdof))

    v_com_b = body_com_velocities(kin, Vel(cvel, cdof_dot, None))
    com_vel = torch.sum(m.body_mass[..., None] * v_com_b,
                        dim=1) / torch.clamp(kin.total_mass,
                                             min=1e-12)[..., None]
    return Vel(cvel=cvel, cdof_dot=cdof_dot, com_vel=com_vel)


def body_com_velocities(kin: Kin, vel: Vel) -> torch.Tensor:
    """Per-body COM linear velocities (B, nbody, 3)."""
    return vel.cvel[..., 3:] + pm.cross(vel.cvel[..., :3],
                                        kin.xipos - kin.anchor[:, None])


def crb_mass_matrix(m: Model, kin: Kin) -> torch.Tensor:
    """Joint-space inertia M (B, nv, nv) = Σ_b Wbᵀ I_b Wb + diag(armature),
    Wb the chain-masked cdof of body b."""
    body_dof = m.body_dof_t(kin.cdof.dtype)
    W = body_dof[None, :, :, None] * kin.cdof[:, None, :, :]  # (B,nb,nv,6)
    M = torch.einsum("nbik,nbkl,nbjl->nij", W, kin.cinert, W)
    return 0.5 * (M + M.transpose(-1, -2)) + torch.diag_embed(
        m.dof_armature)


def rnea_bias(m: Model, kin: Kin, vel: Vel, qvel: torch.Tensor
              ) -> torch.Tensor:
    """qfrc_bias = C(q, qvel) qvel + gravity load (RNEA with qacc = 0)."""
    body_dof = m.body_dof_t(qvel.dtype)
    a0 = torch.cat([m.gravity.new_zeros(3), -m.gravity])
    cacc = a0 + (body_dof * qvel[:, None, :]) @ vel.cdof_dot   # (B, nb, 6)
    Iv = torch.einsum("nbij,nbj->nbi", kin.cinert, vel.cvel)
    f = torch.einsum("nbij,nbj->nbi", kin.cinert, cacc) \
        + pm.force_cross(vel.cvel, Iv)
    fsum = torch.einsum("bv,nbk->nvk", body_dof, f)            # (B, nv, 6)
    return torch.sum(kin.cdof * fsum, dim=-1)


def kinetic_energy(M: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """0.5 qvelᵀ M qvel per env: M (B, nv, nv), qvel (B, nv) -> (B,)."""
    return 0.5 * torch.einsum("ni,nij,nj->n", qvel, M, qvel)


def inverse_dynamics(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                     qacc: torch.Tensor) -> torch.Tensor:
    """Smooth inverse dynamics (the mj_inverse analog without contacts):
    the generalized force that gives (qpos, qvel, qacc), tau = M qacc +
    bias - passive, the passive force with the fluid drag and gravity
    compensation where the model has them; (B, nv)."""
    kin = fwd_position(m, qpos)
    vel = fwd_velocity(m, kin, qvel)
    M = crb_mass_matrix(m, kin)
    return ((M @ qacc[..., None])[..., 0] + rnea_bias(m, kin, vel, qvel)
            - total_passive(m, kin, vel, qpos, qvel))


def point_jacobian(m: Model, kin: Kin, body: int, point: torch.Tensor
                   ) -> torch.Tensor:
    """Translational Jacobians of world points rigidly on `body`: point
    (B, ..., 3) -> (B, ..., 3, nv). The body's chain mask is a float
    tensor before any arithmetic (Structure.body_dof is uint8)."""
    mask = m.body_dof_t(kin.cdof.dtype)[body]              # (nv,)
    lead = (1,) * (point.ndim - 2)
    B, nv = kin.cdof.shape[:2]
    cdof = kin.cdof.reshape((B,) + lead + (nv, 6))
    rel = point - kin.anchor.reshape((B,) + lead + (3,))
    lin = cdof[..., 3:] + pm.cross(cdof[..., :3], rel[..., None, :])
    return (mask[:, None] * lin).transpose(-1, -2)


def actuator_force(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                   ctrl: torch.Tensor) -> torch.Tensor:
    """Per-actuator forces after gear (B, nu): joint torques of motor
    and position actuators, gear · ctrl of site actuators."""
    s = m.struct
    c = pm.clip(ctrl, m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1])
    forces = []
    for a in range(s.nu):
        j = s.act_jnt[a]
        if s.act_type[a] in (ActuatorType.MOTOR, ActuatorType.SITE_THRUST):
            force = c[:, a]
        else:  # POSITION
            force = (m.act_kp[..., a] * (c[:, a] - qpos[:, s.jnt_qadr[j]])
                     - m.act_kv[a] * qvel[:, s.jnt_vadr[j]])
        forces.append(m.act_gear[a] * pm.clip(
            force, m.act_forcerange[..., a, 0], m.act_forcerange[..., a, 1]))
    if not forces:
        return qpos.new_zeros((qpos.shape[0], 0))
    return torch.stack(forces, dim=-1)


def _joint_acts(m: Model):
    return [a for a in range(m.nu)
            if m.struct.act_type[a] != ActuatorType.SITE_THRUST]


def actuation(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
              ctrl: torch.Tensor) -> torch.Tensor:
    """Joint actuators' forces -> qfrc_actuator (B, nv); site actuators
    act through `thrust_qfrc`."""
    s = m.struct
    qfrc = qpos.new_zeros((qpos.shape[0], s.nv))
    acts = _joint_acts(m)
    if not acts:
        return qfrc
    idx = m.struct_static(("act_vadr", qpos.device), lambda: torch.as_tensor(
        [s.jnt_vadr[s.act_jnt[a]] for a in acts], device=qpos.device))
    f = actuator_force(m, qpos, qvel, ctrl)
    if len(acts) < s.nu:
        f = f[:, m.struct_static(("joint_acts", qpos.device),
                                 lambda: torch.as_tensor(
                                     acts, device=qpos.device))]
    return qfrc.index_add(1, idx, f)


def has_thrust(m: Model) -> bool:
    return any(t == ActuatorType.SITE_THRUST for t in m.struct.act_type)


def thrust_qfrc(m: Model, kin: Kin, ctrl: torch.Tensor) -> torch.Tensor:
    """Site actuators -> qfrc (B, nv): each applies the wrench
    ctrl · gear6 at its site point, in the site body's frame or, for a
    world-frame actuator, in the world frame; moved to its body's COM
    and mapped as an external wrench."""
    s = m.struct
    B = ctrl.shape[0]
    c = pm.clip(ctrl, m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1])
    cols = [kin.xpos.new_zeros((B, 6)) for _ in range(s.nbody)]
    for a in range(s.nu):
        if s.act_type[a] != ActuatorType.SITE_THRUST:
            continue
        site = s.act_site[a]
        b = s.site_body[site]
        u = pm.clip(c[:, a], m.act_forcerange[..., a, 0],
                    m.act_forcerange[..., a, 1])[:, None]
        f = m.act_gear6[a, :3] * u
        t = m.act_gear6[a, 3:] * u
        if not (s.act_site_world and s.act_site_world[a]):
            R = kin.xmat[:, b]
            f = torch.einsum("nij,nj->ni", R, f)
            t = torch.einsum("nij,nj->ni", R, t)
        t = t + pm.cross(kin.site_xpos[:, site] - kin.xipos[:, b], f)
        cols[b] = cols[b] + torch.cat([f, t], dim=-1)
    return xfrc_to_qfrc(m, kin, torch.stack(cols, dim=1))


def gravcomp_qfrc(m: Model, kin: Kin) -> torch.Tensor:
    """Per-body gravity compensation (MJCF body gravcomp): the force
    gravcomp · mass · (-gravity) at each body's COM, (B, nv)."""
    frc = (m.body_gravcomp * m.body_mass)[..., None] * (-m.gravity)
    frc = frc.expand(kin.xpos.shape[0], -1, -1)
    return xfrc_to_qfrc(m, kin, torch.cat([frc, torch.zeros_like(frc)],
                                          dim=-1))


def passive_force(m: Model, qpos: torch.Tensor, qvel: torch.Tensor
                  ) -> torch.Tensor:
    """Joint springs + explicit damping (mj_passive analog), (B, nv)."""
    s = m.struct
    cols = list((-m.dof_damping * qvel).unbind(-1))
    for j in range(s.njnt):
        t = s.jnt_type[j]
        qadr, vadr = s.jnt_qadr[j], s.jnt_vadr[j]
        k = m.jnt_stiffness[..., j]
        if t in (JointType.HINGE, JointType.SLIDE):
            cols[vadr] = cols[vadr] - k * (qpos[:, qadr] - m.qpos_spring[qadr])
        elif t == JointType.FREE:
            # world-frame translational spring + rotational spring on the
            # local-frame angular dofs (engine_passive.c semantics)
            for i in range(3):
                cols[vadr + i] = cols[vadr + i] - k * (
                    qpos[:, qadr + i] - m.qpos_spring[qadr + i])
            dif = pm.quat_sub(qpos[:, qadr + 3:qadr + 7],
                              m.qpos_spring[qadr + 3:qadr + 7])
            for i in range(3):
                cols[vadr + 3 + i] = cols[vadr + 3 + i] - k * dif[:, i]
        elif t == JointType.BALL:
            dif = pm.quat_sub(qpos[:, qadr:qadr + 4],
                              m.qpos_spring[qadr:qadr + 4])
            for i in range(3):
                cols[vadr + i] = cols[vadr + i] - k * dif[:, i]
    return torch.stack(cols, dim=-1)


def fluid_force(m: Model, kin: Kin, vel: Vel) -> torch.Tensor:
    """Inertia-box fluid drag (mj_inertiaBoxFluidModel analog), (B, nv).

    Each body is replaced by the box with its mass and diagonal inertia,
    full dims d_i = sqrt(6 (I_j + I_k - I_i) / mass); Stokes viscous drag
    and quadratic density drag act on its body-frame velocity at the COM:

      viscous:  F = -3 pi d_mean mu v,  T = -pi d_mean^3 mu w
      density:  F_i = -1/2 rho d_j d_k |v_i| v_i
                T_i = -rho d_i (d_j^4 + d_k^4) |w_i| w_i / 64

    Massless bodies get no drag.
    """
    s = m.struct
    rho, mu = s.fluid_density, s.fluid_viscosity
    w_com = vel.cvel[..., :3]
    v_com = vel.cvel[..., 3:] + pm.cross(w_com,
                                         kin.xipos - kin.anchor[:, None])
    Ri = kin.xmat @ pm.quat_to_mat(m.body_iquat)       # (B, nbody, 3, 3)
    # body-frame velocities: Riᵀ v
    lv = torch.einsum("nbji,nbj->nbi", Ri, v_com)
    lw = torch.einsum("nbji,nbj->nbi", Ri, w_com)

    mass = torch.clamp(m.body_mass, min=1e-12)[..., None]
    inertia = m.body_inertia
    isum = torch.sum(inertia, dim=-1, keepdim=True)
    d = torch.sqrt(torch.clamp(6.0 * (isum - 2.0 * inertia) / mass,
                               min=1e-12))                # (nbody, 3)
    dj = torch.roll(d, -1, dims=-1)
    dk = torch.roll(d, -2, dims=-1)

    frc = torch.zeros_like(lv)
    trq = torch.zeros_like(lw)
    if mu:
        diam = torch.mean(d, dim=-1, keepdim=True)
        frc = frc - 3.0 * math.pi * diam * mu * lv
        trq = trq - math.pi * diam ** 3 * mu * lw
    if rho:
        frc = frc - 0.5 * rho * dj * dk * torch.abs(lv) * lv
        trq = trq - rho * d * (dj ** 4 + dk ** 4) / 64.0 * torch.abs(lw) * lw

    live = (m.body_mass > 1e-12).to(lv.dtype)[..., None]
    frc_w = torch.einsum("nbij,nbj->nbi", Ri, frc) * live
    trq_w = torch.einsum("nbij,nbj->nbi", Ri, trq) * live
    return xfrc_to_qfrc(m, kin, torch.cat([frc_w, trq_w], dim=-1))


def total_passive(m: Model, kin: Kin, vel: Vel, qpos: torch.Tensor,
                  qvel: torch.Tensor) -> torch.Tensor:
    """The passive force (B, nv): springs and damping, with the fluid drag
    and gravity compensation where the model has them."""
    qfrc_passive = passive_force(m, qpos, qvel)
    if m.struct.fluid_density or m.struct.fluid_viscosity:
        qfrc_passive = qfrc_passive + fluid_force(m, kin, vel)
    if m.struct.has_gravcomp:
        qfrc_passive = qfrc_passive + gravcomp_qfrc(m, kin)
    return qfrc_passive


def xfrc_to_qfrc(m: Model, kin: Kin, xfrc: torch.Tensor) -> torch.Tensor:
    """Per-body world wrenches (B, nbody, 6) [force; torque] at the body
    COM -> generalized forces (B, nv)."""
    frc, trq = xfrc[..., :3], xfrc[..., 3:]
    w = torch.cat([trq + pm.cross(kin.xipos - kin.anchor[:, None], frc),
                   frc], dim=-1)
    wsum = torch.einsum("bv,nbk->nvk", m.body_dof_t(xfrc.dtype), w)
    return torch.sum(kin.cdof * wsum, dim=-1)


def prepare_smooth(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                   ctrl: torch.Tensor, xfrc: Optional[torch.Tensor] = None):
    """The plain smooth stage (counterpart of the JAX step's
    `_prepare_smooth` without collision): kinematics, M, the bias,
    actuation (joint and site actuators), passive, gravity-compensation
    and fluid forces and optional per-body wrenches.
    Returns (kin, vel, M, qfrc_smooth), batch-leading."""
    kin = fwd_position(m, qpos)
    vel = fwd_velocity(m, kin, qvel)
    M = crb_mass_matrix(m, kin)
    bias = rnea_bias(m, kin, vel, qvel)
    tau = actuation(m, qpos, qvel, ctrl)
    qfrc_smooth = tau + total_passive(m, kin, vel, qpos, qvel) - bias
    if has_thrust(m):
        qfrc_smooth = qfrc_smooth + thrust_qfrc(m, kin, ctrl)
    if xfrc is not None:
        qfrc_smooth = qfrc_smooth + xfrc_to_qfrc(m, kin, xfrc)
    return kin, vel, M, qfrc_smooth
