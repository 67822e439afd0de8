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

from typing import NamedTuple, Tuple

import torch

from . import engine
from .collision import collide
from .fused_solver import SMEM_MAX
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

_HEADER = 48        # int-table header; array offsets from slot 16 (smooth.cu)
ENVS_MAX = 8        # kernel B1: one warp per env, at most this many a block


def _limited_joints(s):
    return [j for j in range(s.njnt) if s.jnt_limited[j]
            and s.jnt_type[j] in (JointType.HINGE, JointType.SLIDE)]


def tree_tables(s):
    """Host tables of kernel B1 for a structure in the kernel family
    (bodies in topological order): the bodies grouped by depth, a
    level's bodies at lvl_body[lvl_ptr[L]:lvl_ptr[L + 1]] in ascending
    order; each body's children at ch_idx[ch_ptr[b]:ch_ptr[b + 1]] in
    ascending order (the order in which a parent sums them); the
    structurally nonzero lower-triangle entries of M as (u, w) pairs,
    u's body being w's or an ancestor of it; and each dof's actuators at
    dof_aidx[dof_aptr[v]:dof_aptr[v + 1]] in ascending order. Plain
    lists."""
    depth = []
    for b in range(s.nbody):
        p = s.body_parent[b]
        assert p < b, "the kernel needs bodies in topological order"
        depth.append(0 if p < 0 else depth[p] + 1)
    nlvl = max(depth) + 1 if depth else 0
    lvl_body = [b for L in range(nlvl) for b in range(s.nbody)
                if depth[b] == L]
    lvl_ptr = [0]
    for L in range(nlvl):
        lvl_ptr.append(lvl_ptr[-1] + depth.count(L))
    ch_ptr, ch_idx = [0], []
    for b in range(s.nbody):
        ch_idx.extend(c for c in range(s.nbody) if s.body_parent[c] == b)
        ch_ptr.append(len(ch_idx))
    body_dof = s.body_dof
    mnz = []
    for w in range(s.nv):
        for u in range(w + 1):
            if body_dof[s.dof_body[w], u]:
                mnz.append((u, w))
            elif body_dof[s.dof_body[u], w]:
                mnz.append((w, u))
    dof_aptr, dof_aidx = [0], []
    for v in range(s.nv):
        dof_aidx.extend(i for i in range(s.nu)
                        if s.jnt_vadr[s.act_jnt[i]] == v)
        dof_aptr.append(len(dof_aidx))
    return dict(lvl_ptr=lvl_ptr, lvl_body=lvl_body, ch_ptr=ch_ptr,
                ch_idx=ch_idx, mnz=mnz, dof_aptr=dof_aptr,
                dof_aidx=dof_aidx)


def _int_table(s, ncon: int) -> list:
    """The model structure as one int32 table for the kernel: the header
    (counts, then array offsets) and the arrays and records in the order
    of smooth.cu, each array starting at a multiple of 4 ints."""
    tt = tree_tables(s)
    lvl_body, ch_ptr, ch_idx = tt["lvl_body"], tt["ch_ptr"], tt["ch_idx"]
    jptr, jidx, bptr, bdof = [0], [], [0], []
    for b in range(s.nbody):
        jidx.extend(s.body_joints[b])
        jptr.append(len(jidx))
        for j in s.body_joints[b]:
            nvj = 6 if s.jnt_type[j] == JointType.FREE else 1
            bdof.extend(range(s.jnt_vadr[j], s.jnt_vadr[j] + nvj))
        bptr.append(len(bdof))
    lvl_rec = []
    for b in lvl_body:
        lvl_rec += [b, s.body_parent[b], bptr[b], bptr[b + 1], ch_ptr[b],
                    ch_ptr[b + 1], jptr[b], jptr[b + 1]]
    jnt_rec = []
    for j in range(s.njnt):
        jnt_rec += [s.jnt_type[j], s.jnt_qadr[j], s.jnt_vadr[j],
                    s.jnt_body[j]]
    dof_rec = []
    for v in range(s.nv):
        j = s.dof_jnt[v]
        dof_rec += [j, s.jnt_type[j], s.dof_body[v], v - s.jnt_vadr[j],
                    s.jnt_qadr[j], tt["dof_aptr"][v], tt["dof_aptr"][v + 1],
                    0]
    act_rec = []
    for i in range(s.nu):
        j = s.act_jnt[i]
        act_rec += [s.act_type[i], s.jnt_qadr[j], s.jnt_vadr[j], 0]
    lim_rec = []
    for j in _limited_joints(s):
        lim_rec += [j, s.jnt_qadr[j]]
    dims = [s.nq, s.nv, s.nu, s.nbody, s.njnt, s.nsph, s.npair,
            len(s.site_names), 2 * len(_limited_joints(s)), s.nhrow,
            s.nhcol, int(s.has_floor), ncon, len(tt["lvl_ptr"]) - 1,
            len(tt["mnz"])]
    arrays = [tt["lvl_ptr"], lvl_rec, bdof, ch_idx, jidx, jnt_rec, dof_rec,
              tt["dof_aidx"], act_rec, s.sph_body,
              [int(f) for f in s.sph_floor], s.pair_a, s.pair_b,
              s.site_body, lim_rec, [(u << 16) | w for u, w in tt["mnz"]]]
    header = dims + [0] * (16 - len(dims))
    body = []
    for arr in arrays:
        header.append(_HEADER + len(body))
        body.extend(int(x) for x in arr)
        body.extend([0] * (-len(body) % 4))
    return header + [0] * (_HEADER - len(header)) + body


# the model leaves of each of the kernel's nine packs, in pack order, and
# the rows a pack is laid out in (a leaf's row holds its values for one
# body, joint, dof, actuator, sphere or site; misc and hf are one row)
_PACKS = (
    (("body_pos", "body_quat", "body_ipos", "body_iquat", "body_inertia",
      "body_mass"), "nbody"),
    (("jnt_pos", "jnt_axis", "jnt_stiffness", "jnt_range", "jnt_margin"),
     "njnt"),
    (("dof_armature", "dof_damping"), "nv"),
    (("qpos_spring",), None),
    (("act_gear", "act_kp", "act_kv", "act_ctrlrange", "act_forcerange"),
     "nu"),
    (("sph_pos", "sph_radius", "sph_friction", "sph_friction_tor",
      "sph_friction_roll"), "nsph"),
    (("site_pos",), "nsite"),
    (("gravity", "floor_z", "floor_friction", "floor_friction_tor",
      "floor_friction_roll", "hfield_halfsize", "solref", "solimp",
      "limit_solref", "limit_solimp", "dt"), None),
    (("hfield_data",), None),
)


def _pack_params(m: Model):
    """Model float leaves as the kernel's nine f32 packs (the layout of
    pallas_smooth._pack_params). A pack is shared by the batch, (n,),
    unless one of its leaves is per env: then it is (B, n), contiguous,
    the shared leaves repeated in every env's row (the TPU kernel's
    `params_batched`)."""
    f = torch.float32
    s = m.struct
    B = m.env_batch
    counts = dict(nbody=s.nbody, njnt=s.njnt, nv=s.nv, nu=s.nu,
                  nsph=s.nsph, nsite=len(s.site_names))
    packs = []
    for names, rows in _PACKS:
        n = counts[rows] if rows else 1
        if n == 0:       # no actuators / sites: one zero row
            packs.append(torch.zeros(7 if rows == "nu" else 3, dtype=f,
                                     device=m.device))
            continue
        envs = B if any(m.per_env(k) for k in names) else None
        lead = (envs,) if envs else ()
        parts = []
        for k in names:
            x = getattr(m, k).to(f)
            if envs and not m.per_env(k):
                x = x.expand(lead + x.shape)
            parts.append(x.reshape(lead + (n, -1)))
        packs.append(torch.cat(parts, -1).reshape(lead + (-1,)))
    return tuple(p.contiguous() for p in packs)


class SmoothDims(NamedTuple):
    """What sizes a launch of kernel B1: the structure's counts, the
    int table's length, the nine packs' sizes (floats) and their env
    strides (0: shared by the batch)."""
    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    nsph: int
    npair: int
    nsite: int
    nlim: int
    K: int
    ntab: int
    psize: Tuple[int, ...]
    pstride: Tuple[int, ...]


def _tab(m: Model) -> list:
    """Kernel B1's int table, built once per structure."""
    return m.struct_static("smooth_tab", lambda: _int_table(m.struct, m.ncon))


def smooth_dims(m: Model) -> SmoothDims:
    """The launch sizes; a per-env pack (B, n) has env stride n."""
    s = m.struct
    packs = m.static("smooth_packs", lambda: _pack_params(m))
    return SmoothDims(s.nq, s.nv, s.nu, s.nbody, s.njnt, s.nsph, s.npair,
                      len(s.site_names), 2 * len(_limited_joints(s)),
                      m.ncon, len(_tab(m)),
                      tuple(p.shape[-1] for p in packs),
                      tuple(p.shape[-1] if p.ndim == 2 else 0
                            for p in packs))


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def smooth_smem_bytes(d: SmoothDims, envs: int = 1) -> int:
    """Dynamic shared memory of one block of kernel B1 with `envs` warps
    (csrc/smooth.cu make_layout): the int table and the shared packs,
    then per env its inputs (qpos, qvel, ctrl, the wrenches), its twelve
    outputs staged (M, qfrc_smooth, cdof, rel, normal, friction, the
    four slot rows, the four limit rows, the 13-float observables per
    body, sites, anchor and COM velocity, actuator forces), the
    intermediates (joint anchors; inertias, composite inertias, body
    velocities and accelerations or forces per body; cdof_dot and the
    CRB force per dof; sphere centres) and its per-env packs, the env
    stride rounded up to 4 mod 32 floats; all float32 / int32."""
    shared = sum(n for n, st in zip(d.psize, d.pstride) if st == 0)
    per_env = sum(n for n, st in zip(d.psize, d.pstride) if st != 0)
    blk = _round_up(_round_up(d.ntab, 4) + shared, 4)
    env = (d.nq + d.nv + d.nu + 6 * d.nbody
           + d.nv * d.nv + 7 * d.nv + 13 * d.K + 4 * d.nlim + 13 * d.nbody
           + 3 * d.nsite + 6 + d.nu
           + 3 * d.njnt + 32 * d.nbody + 12 * d.nv + 3 * d.nsph + per_env)
    return 4 * (blk + envs * (_round_up(env + 28, 32) - 28))


def smooth_block_shape(d: SmoothDims):
    """(envs per block, shared bytes per block) of kernel B1, or a
    ValueError when one env's working set does not fit a block."""
    one = smooth_smem_bytes(d)
    if one > SMEM_MAX:
        raise ValueError(f"kernel B1 needs {one} bytes of shared memory for "
                         f"one env (nv {d.nv}, {d.nbody} bodies, {d.K} "
                         f"slots); a block has {SMEM_MAX}")
    envs = ENVS_MAX
    while smooth_smem_bytes(d, envs) > SMEM_MAX:
        envs -= 1
    return envs, smooth_smem_bytes(d, envs)


def _smooth_meta(m: Model, d: SmoothDims, inputs) -> torch.Tensor:
    """Kernel B1's host int32 array (smooth.cu hm_smooth): the int
    table's header, the packs' sizes and env strides, the strides of
    qpos, qvel, ctrl and xfrc (batch first), the table's length and
    whether wrenches come."""
    qpos, qvel, ctrl, xfrc = inputs
    strides = (*qpos.stride(), *qvel.stride(), *ctrl.stride(),
               *(xfrc.stride() if xfrc is not None else (0, 0, 0)))
    if max(strides) >= 2 ** 31:
        raise ValueError("kernel B1 takes input strides below 2**31")
    return m.struct_static(("smooth_meta", d, strides, xfrc is not None),
                           lambda: torch.tensor(
                               _tab(m)[:_HEADER] + list(d.psize)
                               + list(d.pstride) + list(strides)
                               + [d.ntab, int(xfrc is not None)],
                               dtype=torch.int32))


def _smooth_launch_args(m: Model, qpos, qvel, ctrl, xfrc):
    """Kernel B1's C arguments for checked inputs: (input and pack
    tensors, the table; the twelve outputs batch-last in the order of the
    C entry: M, qfrc_smooth, cdof, rel, nrm, mu3, the slot rows, the
    limit rows, the body observables, sites, anchor and COM velocity,
    actuator forces; the host meta array; (B, envs, smem)). The inputs
    are read in place: no copies. Raises ValueError before any launch
    when the model does not fit the kernel."""
    d = m.static("smooth_dims", lambda: smooth_dims(m))
    envs, smem = m.struct_static(("smooth_shape", d),
                                 lambda: smooth_block_shape(d))
    B = qpos.shape[0]
    dev = qpos.device
    tab = m.struct_static(("smooth_tab", dev), lambda: torch.tensor(
        _tab(m), dtype=torch.int32, device=dev))
    packs = m.static("smooth_packs", lambda: _pack_params(m))
    if any(p.ndim == 2 and p.shape[0] != B for p in packs):
        raise ValueError(f"the model's per-env parameters are for "
                         f"{m.env_batch} envs, the inputs for {B}")
    K, nv = d.K, d.nv
    shapes = ((nv, nv), (nv,), (nv, 6), (3, K), (3, K), (3, K), (4, K),
              (4, d.nlim), (d.nbody, 13), (d.nsite, 3), (6,), (d.nu,))
    outs = tuple(torch.empty(sh + (B,), dtype=torch.float32, device=dev)
                 for sh in shapes)
    meta = _smooth_meta(m, d, (qpos, qvel, ctrl, xfrc))
    return ((qpos, qvel, ctrl, xfrc) + packs + (tab,), outs, meta,
            (B, envs, smem))


def smooth_occupancy(m: Model):
    """Kernel B1's occupancy on the current card at the block shape the
    wrapper launches: envs per block, shared bytes per env and per
    block, blocks per SM, registers and local (spill) bytes per thread."""
    import ctypes
    from .. import kernels
    d = smooth_dims(m)
    envs, smem = smooth_block_shape(d)
    z = torch.zeros((1, 1))
    meta = _smooth_meta(m, d, (z, z, z, None))
    fn = kernels.load("smooth").hm_smooth_occupancy
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    out = (ctypes.c_int * 3)()
    err = fn(meta.data_ptr(), envs, smem, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"hm_smooth_occupancy failed: cudaError {err}")
    return {"envs_per_block": envs,
            "smem_per_env": smooth_smem_bytes(d, 1) - smooth_smem_bytes(d, 0),
            "smem_per_block": smem, "blocks_per_sm": out[0],
            "registers": out[1], "local_bytes": out[2]}


def _check_kernel_inputs(m: Model, *tensors):
    if not m.struct_static("smooth_supported", lambda: supported(m)):
        raise NotImplementedError(
            "model outside the kernel family of the smooth kernel "
            "(capsules, boxes, tendons, ball joints, fluid, gravcomp and "
            "site actuators): physics.step routes it through the plain "
            "smooth stage")
    if m.struct.nhrow < 2 or m.struct.nhcol < 2:
        raise ValueError("the smooth kernel needs a heightfield of at "
                         "least 2 x 2 cells")
    dev = m.body_pos.device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev or dev.type != "cuda":
            raise ValueError("all kernel inputs must be on the model's "
                             "CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"the smooth kernel runs in float32, got "
                            f"{t.dtype}")


def smooth_raw(m: Model, qpos, qvel, ctrl, xfrc=None):
    """The smooth stage + raw contact/limit rows (see module docstring).

    qpos (B, nq), qvel (B, nv), ctrl (B, nu), xfrc (B, nbody, 6) or
    None, at any strides (on the card the kernel reads them in place).
    CPU tensors take the twin; CUDA tensors launch kernel B1.
    """
    global LAUNCHES
    if qpos.device.type == "cpu":
        return smooth_raw_reference(m, qpos, qvel, ctrl, xfrc)
    _check_kernel_inputs(m, qpos, qvel, ctrl, xfrc)
    from .. import kernels
    s = m.struct
    B = qpos.shape[0]
    for name, t, shape in (("qpos", qpos, (B, s.nq)),
                           ("qvel", qvel, (B, s.nv)),
                           ("ctrl", ctrl, (B, s.nu)),
                           ("xfrc", xfrc, (B, s.nbody, 6))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the "
                             f"kernel needs {shape}")
    ins, outs, meta, ints = _smooth_launch_args(m, qpos, qvel, ctrl, xfrc)

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    kernels.launch("smooth", *(ptr(t) for t in ins + outs), meta.data_ptr(),
                   *ints)
    LAUNCHES += 1

    def back(x):
        """(..., B) -> (B, ...) view."""
        return x.permute((x.ndim - 1,) + tuple(range(x.ndim - 1)))

    M, qfs, cdof, rel, nrm, mu3, ckbd, limd, ipack, sitex, vec6, actf = outs
    ip = back(ipack)
    return (back(M), back(qfs), back(cdof), rel.permute(2, 1, 0),
            nrm.permute(2, 1, 0), back(ckbd[0]), mu3.permute(2, 1, 0),
            back(ckbd[1]), back(ckbd[2]), back(ckbd[3]),
            *(back(limd[i]) for i in range(4)),
            ip[..., 0:3], ip[..., 3:7], ip[..., 7:10], ip[..., 10:13],
            back(sitex), back(vec6[0:3]), back(vec6[3:6]), back(actf))
