"""The smooth stage of the step: kernel B1 and its plain PyTorch twin.

Counterpart of humanoid_mujoco_tpu/physics/pallas_smooth.py. One call
computes, per environment, everything before the constraint solve:
forward kinematics, cdof, the CRB mass matrix, the RNEA bias, actuation,
passive springs and damping, optional per-body wrenches, sphere-vs-
heightfield and sphere-sphere collision, the raw contact rows, the
joint-limit row data and the StepInfo observables.

`smooth_raw` is the entry point. For CPU tensors it runs the twin
`smooth_raw_reference` (the counterpart of `jax_smooth_single`); for
CUDA tensors it launches the kernel in csrc/smooth.cu, or raises.

Output tuple, batch-leading:
  (M, qfrc_smooth, cdof, rel, nrm, dist, mu3, kc, bc, dc,
   lpos, kl, bl, dl, xpos, xquat, xipos, bcv, site_xpos, anchor,
   com_vel, actf)
"""

from __future__ import annotations

import torch

from . import engine
from .collision import collide
from .model import ActuatorType, JointType, Model
from .solver import contact_raw, limit_rows_data

# kernel launches since import (or since the caller reset it)
LAUNCHES = 0

NAMES = ("M", "qfrc_smooth", "cdof", "rel", "nrm", "dist", "mu3", "kc",
         "bc", "dc", "lpos", "kl", "bl", "dl", "xpos", "xquat", "xipos",
         "bcv", "site_xpos", "anchor", "com_vel", "actf")


def supported(m: Model) -> bool:
    """Static gate: can the kernel serve this model? (the same gates as
    pallas_smooth.supported)"""
    s = m.struct
    if s.ncap or s.nbox or s.ntendon:
        return False
    if s.pair_sc or s.pair_cc or s.pair_sb or s.pair_cb or s.pair_bb:
        return False
    if s.fluid_density or s.fluid_viscosity or s.has_gravcomp:
        return False
    if any(t not in (JointType.FREE, JointType.HINGE, JointType.SLIDE)
           for t in s.jnt_type):
        return False
    if any(t not in (ActuatorType.MOTOR, ActuatorType.POSITION)
           for t in s.act_type):
        return False
    if any(s.body_parent[b] >= b for b in range(s.nbody)):
        return False         # needs topological body order
    if m.ncon == 0 or s.nsph == 0:
        return False
    if s.nhrow * s.nhcol > 1024:
        return False
    nlim = 2 * sum(1 for j in range(s.njnt) if s.jnt_limited[j]
                   and s.jnt_type[j] in (JointType.HINGE, JointType.SLIDE))
    return s.nv * (nlim + 10 * m.ncon) <= 16384


def smooth_raw_reference(m: Model, qpos, qvel, ctrl, xfrc=None):
    """Plain PyTorch twin of kernel B1 (counterpart of
    pallas_smooth.jax_smooth_single): engine + collision +
    contact_raw + limit_rows_data, selection-free, batch-leading."""
    kin, vel, M, qfs = engine.prepare_smooth(m, qpos, qvel, ctrl, xfrc)
    contacts = collide(m, kin.xpos, kin.xmat)
    _dmask, rel, mu3, kc, bc, dc = contact_raw(m, kin, contacts)
    lpos, kl, bl, dl = limit_rows_data(m, qpos)
    bcv = engine.body_com_velocities(kin, vel)
    actf = engine.actuator_force(m, qpos, qvel, ctrl)
    return (M, qfs, kin.cdof, rel, contacts.normal, contacts.dist, mu3,
            kc, bc, dc, lpos, kl, bl, dl, kin.xpos, kin.xquat, kin.xipos,
            bcv, kin.site_xpos, kin.anchor, vel.com_vel, actf)


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------

_HEADER = 48       # int-table header; offsets from slot 16 (see smooth.cu)


def _int_table(m: Model) -> torch.Tensor:
    """The model structure as one int32 table for the kernel."""
    s = m.struct
    lim_jnt = [j for j in range(s.njnt) if s.jnt_limited[j]
               and s.jnt_type[j] in (JointType.HINGE, JointType.SLIDE)]
    jptr, jidx = [0], []
    for b in range(s.nbody):
        jidx.extend(s.body_joints[b])
        jptr.append(len(jidx))
    dims = [s.nq, s.nv, s.nu, s.nbody, s.njnt, s.nsph, s.npair,
            len(s.site_names), 2 * len(lim_jnt), s.nhrow, s.nhcol,
            int(s.has_floor), m.ncon]
    arrays = [s.body_parent, jptr, jidx, s.jnt_type, s.jnt_body,
              s.jnt_qadr, s.jnt_vadr, s.dof_body,
              s.body_dof.reshape(-1).tolist(), s.act_jnt, s.act_type,
              s.sph_body,
              [int(f) for f in s.sph_floor], s.pair_a, s.pair_b,
              s.site_body, lim_jnt]
    header = dims + [0] * (16 - len(dims))
    body, offs = [], []
    for arr in arrays:
        offs.append(_HEADER + len(body))
        body.extend(int(x) for x in arr)
    header = header + offs
    header += [0] * (_HEADER - len(header))
    return torch.tensor(header + body, dtype=torch.int32, device=m.device)


def _pack_params(m: Model):
    """Model float leaves as the kernel's nine f32 packs (the layout of
    pallas_smooth._pack_params), shared across the batch."""
    f = torch.float32
    s = m.struct

    def col(x):
        return x.to(f)[:, None]

    bodyp = torch.cat([m.body_pos, m.body_quat, m.body_ipos, m.body_iquat,
                       m.body_inertia, m.body_mass[:, None]], -1).to(f)
    jointp = torch.cat([m.jnt_pos, m.jnt_axis, m.jnt_stiffness[:, None],
                        m.jnt_range, m.jnt_margin[:, None]], -1).to(f)
    dofp = torch.stack([m.dof_armature, m.dof_damping], -1).to(f)
    qspr = m.qpos_spring.to(f)
    actp = (torch.cat([col(m.act_gear), col(m.act_kp), col(m.act_kv),
                       m.act_ctrlrange.to(f), m.act_forcerange.to(f)], -1)
            if s.nu else torch.zeros((1, 7), dtype=f, device=m.device))
    sphp = torch.cat([m.sph_pos.to(f), col(m.sph_radius),
                      col(m.sph_friction), col(m.sph_friction_tor),
                      col(m.sph_friction_roll)], -1)
    sitep = (m.site_pos.to(f) if s.site_names
             else torch.zeros((1, 3), dtype=f, device=m.device))
    misc = torch.stack([
        m.gravity[0], m.gravity[1], m.gravity[2],
        m.floor_z, m.floor_friction, m.floor_friction_tor,
        m.floor_friction_roll, m.hfield_halfsize[0], m.hfield_halfsize[1],
        m.solref[0], m.solref[1], m.solimp[0], m.solimp[1], m.solimp[2],
        m.limit_solref[0], m.limit_solref[1], m.limit_solimp[0],
        m.limit_solimp[1], m.limit_solimp[2], m.dt]).to(f)
    hf = m.hfield_data.to(f)
    return tuple(p.contiguous() for p in
                 (bodyp, jointp, dofp, qspr, actp, sphp, sitep, misc, hf))


def scratch_floats(m: Model) -> int:
    """Per-env scratch of the kernel (the Carver layout in smooth.cu)."""
    s = m.struct
    return 48 * s.nbody + 3 * s.njnt + 6 * s.nv + 3 * s.nsph


def _check_kernel_inputs(m: Model, *tensors):
    if not supported(m):
        raise NotImplementedError(
            "model outside the kernel family of the smooth kernel "
            "(capsules, boxes, tendons, ball joints, fluid, gravcomp and "
            "site actuators come with slice 4 of the port)")
    if m.struct.nhrow < 2 or m.struct.nhcol < 2:
        raise ValueError("the smooth kernel needs a heightfield of at "
                         "least 2 x 2 cells")
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError("all kernel inputs must be on the same CUDA "
                             "device")
        if t.dtype != torch.float32:
            raise TypeError(f"the smooth kernel runs in float32, got "
                            f"{t.dtype}")


def smooth_raw(m: Model, qpos, qvel, ctrl, xfrc=None):
    """The smooth stage + raw contact/limit rows (see module docstring).

    qpos (B, nq), qvel (B, nv), ctrl (B, nu), xfrc (B, nbody, 6) or
    None. CPU tensors take the twin; CUDA tensors launch kernel B1.
    """
    global LAUNCHES
    if qpos.device.type == "cpu":
        return smooth_raw_reference(m, qpos, qvel, ctrl, xfrc)
    _check_kernel_inputs(m, qpos, qvel, ctrl, xfrc, m.body_pos)
    from .. import kernels
    s = m.struct
    B = qpos.shape[0]
    nv, nu, nbody, K = s.nv, s.nu, s.nbody, m.ncon
    for name, t, shape in (("qpos", qpos, (B, s.nq)), ("qvel", qvel, (B, nv)),
                           ("ctrl", ctrl, (B, nu)),
                           ("xfrc", xfrc, (B, nbody, 6))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the "
                             f"kernel needs {shape}")
    nsite = len(s.site_names)
    nlim = 2 * sum(1 for j in range(s.njnt) if s.jnt_limited[j]
                   and s.jnt_type[j] in (JointType.HINGE, JointType.SLIDE))
    dev = qpos.device
    tab = m.static("smooth_tab", lambda: _int_table(m))
    packs = m.static("smooth_packs", lambda: _pack_params(m))

    def lanes(x):
        """(B, ...) -> (..., B) contiguous, batch-last."""
        return x.reshape(B, -1).t().contiguous()

    qpos_t, qvel_t = lanes(qpos), lanes(qvel)
    ctrl_t = lanes(ctrl) if nu else torch.zeros((1, B), device=dev)
    xfrc_t = lanes(xfrc) if xfrc is not None else None

    def out(*shape):
        return torch.empty(shape + (B,), dtype=torch.float32, device=dev)

    M, qfs, cdof = out(nv, nv), out(nv), out(nv, 6)
    rel, nrm, mu3, ckbd = out(3, K), out(3, K), out(3, K), out(4, K)
    limd = out(4, nlim) if nlim else torch.zeros((4, 1, B), device=dev)
    ipack, sitex = out(nbody, 13), out(max(nsite, 1), 3)
    vec6, actf = out(6), out(max(nu, 1))
    scratch = out(scratch_floats(m))

    def ptr(t):
        return None if t is None else t.data_ptr()

    kernels.launch(
        "smooth", ptr(qpos_t), ptr(qvel_t), ptr(ctrl_t), ptr(xfrc_t),
        int(xfrc_t is not None), *(ptr(p) for p in packs), ptr(tab),
        ptr(M), ptr(qfs), ptr(cdof), ptr(rel), ptr(nrm), ptr(mu3),
        ptr(ckbd), ptr(limd), ptr(ipack), ptr(sitex), ptr(vec6), ptr(actf),
        ptr(scratch), B)
    LAUNCHES += 1

    def back(x):
        """(..., B) -> (B, ...) view."""
        return x.permute((x.ndim - 1,) + tuple(range(x.ndim - 1)))

    ipack_b = back(ipack)
    return (back(M), back(qfs), back(cdof),
            rel.permute(2, 1, 0), nrm.permute(2, 1, 0), back(ckbd[0]),
            mu3.permute(2, 1, 0), back(ckbd[1]), back(ckbd[2]),
            back(ckbd[3]),
            back(limd[0, :nlim]), back(limd[1, :nlim]),
            back(limd[2, :nlim]), back(limd[3, :nlim]),
            ipack_b[..., 0:3], ipack_b[..., 3:7], ipack_b[..., 7:10],
            ipack_b[..., 10:13],
            back(sitex) if nsite else torch.zeros((B, 0, 3), device=dev),
            back(vec6[0:3]), back(vec6[3:6]),
            back(actf) if nu else torch.zeros((B, 0), device=dev))
