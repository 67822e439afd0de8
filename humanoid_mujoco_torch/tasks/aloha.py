"""The bimanual ALOHA tasks: Handover, Reorient and Insert, batched.

Counterpart of humanoid_mujoco_tpu/tasks/aloha.py (the reference's
mjpc/tasks/bimanual; Handover is its predictive-sampling showcase at
nsample 8191 x horizon 128). Two Interbotix ViperX-300s arms face each
other across a table plane: 6 hinge joints a side on position servos of
the XML's per-class kp, and two finger slides a side with a servo each
(nu 16); each finger carries two capsules and three grasp spheres, each
gripper a palm capsule.

- Handover: a free 0.03 m cube; 62 slots (12 sphere, 20 capsule-endpoint
  and 8 cube-corner floor slots, 12 sphere-box and 10 capsule-box
  pairs), `max_contacts` 16 in `forward`. nv 22 with 32 limit rows:
  nv·(nlim + 10 ncon) = 14,344 <= 16,384, so its step takes the
  "contact" route selection-free over all 62 slots, as the JAX step's
  kernel branch does.
- Reorient (the reorientation cross of three capsules) and Insert (two
  connector boxes) keep their top-16 selection in the step, as in the
  JAX step (nv·ne 23,584 and 26,656): kernel B2 solves the 16 smallest
  gaps with their per-env chain mask.

Handover residual: Reach L / R (3 each) the cube in each gripper-site
frame, y and z doubled [L2(0.01), w 0.1]; Grasp (1) the geometric mean
of each hand's "finger normals oppose" score [Null, w 0.05]; Bring (3)
cube - target [L2(0.003), w 0.4]. Its transition respawns the target
across the table once the cube is within 1 cm; the new point is drawn
from a `torch.Generator` seeded from the sim tick (the JAX package folds
the tick into `PRNGKey(11)`; the draws differ, the rule is the same).
The Reorient transition draws its goal orientation the same way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.norms import NormType
from ..physics.math import quat_mul, quat_rotate, quat_rotate_inv, quat_to_mat
from ..physics.model import (ActuatorType, JointType, Model, ModelBuilder,
                             State)
from ..physics.step import StepInfo
from .base import Task, TermSpec, constant, make_task

_CUBE_HALF = 0.015
_CUBE_START = (0.0, 0.0, _CUBE_HALF + 0.0008)
_TARGET_START = (0.4, -0.25, 0.3)
_GRASP_MARGIN = 0.02                   # grasp-sphere activation margin

_Q2 = 0.7071067811865476


def _euler_xyz(ex, ey, ez):
    """MJCF euler (default eulerseq xyz, intrinsic) -> quat wxyz."""

    def q_axis(axis, a):
        h = 0.5 * a
        q = np.zeros(4)
        q[0] = np.cos(h)
        q[1 + axis] = np.sin(h)
        return q

    def mul(a, b):
        w1, x1, y1, z1 = a
        w2, x2, y2, z2 = b
        return np.array([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])

    q = mul(mul(q_axis(0, ex), q_axis(1, ey)), q_axis(2, ez))
    return tuple(q / np.linalg.norm(q))


# joint class: (axis, range, damping, armature, frcrange, kp)
_JOINT_CLASS = {
    "waist": ((0, 0, 1), (-3.14158, 3.14158), 5.76, 0.0, 35.0, 43.0),
    "shoulder": ((0, 1, 0), (-1.85005, 1.25664), 20.0, 0.395, 144.0, 265.0),
    "elbow": ((0, 1, 0), (-1.76278, 1.6057), 18.49, 0.383, 59.0, 227.0),
    "forearm_roll": ((1, 0, 0), (-3.14158, 3.14158), 6.78, 0.14, 22.0, 78.0),
    "wrist_angle": ((0, 1, 0), (-1.8675, 2.23402), 6.28, 0.008, 35.0, 37.0),
    "wrist_rotate": ((1, 0, 0), (-3.14158, 3.14158), 1.2, 0.0, 35.0, 10.4),
}

# arm link chain: (name, pos, quat, joint_class, mass, ipos, iquat, diag)
_ARM_LINKS = (
    ("shoulder_link", (0, 0, 0.079), (1, 0, 0, 0), "waist", 0.798614,
     (0.000259233, -3.3552e-06, 0.0116129),
     (-0.476119, 0.476083, 0.52279, 0.522826),
     (0.00120156, 0.00113744, 0.0009388)),
    ("upper_arm_link", (0, 0, 0.04805), (1, 0, 0, 0), "shoulder", 0.792592,
     (0.0206949, 4e-10, 0.226459), (0, 0.0728458, 0, 0.997343),
     (0.00911338, 0.008925, 0.000759317)),
    ("upper_forearm_link", (0.05955, 0, 0.3), (1, 0, 0, 0), "elbow",
     0.322228, (0.105723, 0, 0),
     (-0.000621631, 0.704724, 0.0105292, 0.709403),
     (0.00144107, 0.00134228, 0.000152047)),
    ("lower_forearm_link", (0.2, 0, 0), (1, 0, 0, 0), "forearm_roll",
     0.414823, (0.0513477, 0.00680462, 0),
     (-0.702604, -0.0796724, -0.702604, 0.0796724),
     (0.0005911, 0.000546493, 0.000155707)),
    ("wrist_link", (0.1, 0, 0), (1, 0, 0, 0), "wrist_angle", 0.115395,
     (0.046743, -7.6652e-06, 0.010565),
     (-0.00100191, 0.544586, 0.0026583, 0.8387),
     (5.45707e-05, 4.63101e-05, 4.32692e-05)),
    ("gripper_link", (0.069744, 0, 0), (1, 0, 0, 0), "wrist_rotate",
     0.251652, (0.0395662, -2.56311e-07, 0.00400649),
     (0.62033, 0.619916, -0.339682, 0.339869),
     (0.000689546, 0.000650316, 0.000468142)),
)

# grasp-point spheres in the finger-link frame (mjx_aloha.xml g0/g1/g2);
# ysign=-1 for the left finger of each gripper, +1 for the right.
_GRASP_PTS = ((0.013, 0.0892, 0.0268), (0.0222, 0.0892, 0.0268),
              (0.0182, 0.0845, 0.0266))
# the two primitive-collision capsules per finger: (p0, p1, radius)
_FINGER_CAPS = (((-0.01, 0.0192, 0.015), (0.015, 0.0852, 0.0228), 0.005),
                ((0.035, 0.0192, 0.015), (0.02, 0.0852, 0.0228), 0.005))

_HOME_ARM = (0.0, -0.96, 1.16, 0.0, -0.3, 0.0, 0.01, 0.01)


def _build_arm(b: ModelBuilder, side: str, base_pos, base_quat,
               cube_sphere_pairs, cube_cap_pairs):
    base = b.add_body(f"{side}/base_link", -1, pos=base_pos, quat=base_quat,
                      mass=0.969034,
                      ipos=(-0.0534774, -0.000562575, 0.0205961),
                      iquat=(-0.00292324, 0.712517, 0.00480387, 0.701633),
                      inertia=(0.0071633, 0.00602451, 0.00169819))
    parent = base
    for name, pos, quat, jcls, mass, ipos, iquat, diag in _ARM_LINKS:
        axis, rng, damp, arm, frc, kp = _JOINT_CLASS[jcls]
        body = b.add_body(f"{side}/{name}", parent, pos=pos, quat=quat,
                          mass=mass, ipos=ipos, iquat=iquat, inertia=diag)
        j = b.add_joint(f"{side}/{jcls}", body, JointType.HINGE, axis=axis,
                        jrange=rng, limited=True, damping=damp,
                        armature=arm)
        b.add_actuator(j, ActuatorType.POSITION, kp=kp,
                       ctrlrange=rng, forcerange=(-frc, frc))
        parent = body

    gripper_link = parent
    b.add_site(f"{side}/gripper", gripper_link, pos=(0.15, 0, 0))

    gbase = b.add_body(f"{side}/gripper_base", gripper_link,
                       pos=(0.035, 0, 0), quat=_euler_xyz(0, 1.57, -1.57),
                       mass=0.42158,
                       ipos=(0.000182154, -0.0341589, -0.0106026),
                       iquat=(0.435286, 0.557074, -0.551539, 0.442718),
                       inertia=(0.00110438, 0.000790537, 0.000469727))
    palm = b.add_capsule(gbase, p0=(0.055, 0, 0.015), p1=(-0.055, 0, 0.015),
                         radius=0.03, friction=1.0)
    cube_cap_pairs.append(palm)

    for fname, ysign, fpos, fquat, ipos, iquat in (
            ("left_finger_link", -1.0, (0.0191, -0.0141637, 0.0211727),
             (0.5, -0.5, -0.5, 0.5), (0.0143478, -0.0284791, 0.0122897),
             (0.535486, 0.458766, -0.450407, 0.547651)),
            ("right_finger_link", 1.0, (-0.0191, -0.0141637, 0.0211727),
             (0.5, 0.5, 0.5, 0.5), (0.0143711, 0.0284792, 0.0121421),
             (0.461317, 0.537615, -0.545478, 0.447894))):
        fb = b.add_body(f"{side}/{fname}", gbase, pos=fpos, quat=fquat,
                        mass=0.0862937, ipos=ipos, iquat=iquat,
                        inertia=(5.86848e-05, 4.46887e-05, 1.8397e-05))
        j = b.add_joint(f"{side}/{fname[:-5]}", fb, JointType.SLIDE,
                        axis=(0, 0, -1), jrange=(0.0, 0.041), limited=True,
                        damping=10.1, armature=0.243)
        b.add_actuator(j, ActuatorType.POSITION, kp=365.0,
                       ctrlrange=(0.002, 0.037), forcerange=(-35.0, 35.0))
        for gx, gy, gz in _GRASP_PTS:
            cube_sphere_pairs.append(
                b.add_sphere(fb, pos=(gx, ysign * gy, gz), radius=0.006,
                             friction=1.0))
        for p0, p1, r in _FINGER_CAPS:
            cap = b.add_capsule(
                fb, p0=(p0[0], ysign * p0[1], p0[2]),
                p1=(p1[0], ysign * p1[1], p1[2]), radius=r, friction=1.0,
                floor=False)
            cube_cap_pairs.append(cap)


def _aloha_builder(dt, max_contacts):
    b = ModelBuilder(dt=dt)
    b.has_floor = True
    b.floor_z = 0.0
    b.sol_iter = 6
    b.max_contacts = max_contacts
    sphs: list = []
    caps: list = []
    _build_arm(b, "left", (-0.469, -0.019, 0.02), (1, 0, 0, 0), sphs, caps)
    _build_arm(b, "right", (0.469, -0.019, 0.02), (0, 0, 0, 1), sphs, caps)
    return b, sphs, caps


def aloha_model(dt: float = 0.01, max_contacts: int = 16,
                dtype=torch.float32, device=None) -> Model:
    """Both arms and the free cube on the table plane."""
    b, sphs, caps = _aloha_builder(dt, max_contacts)
    cube = b.add_body("box", -1, pos=_CUBE_START, mass=0.027,
                      inertia=(4.05e-06, 4.05e-06, 4.05e-06))
    b.add_joint("box_free", cube, JointType.FREE)
    cb = b.add_box(cube, size=(_CUBE_HALF,) * 3, friction=1.0, floor=True)
    for s in sphs:
        b.add_pair_sb(s, cb)
    for c in caps:
        b.add_pair_cb(c, cb)
    return b.finalize(dtype=dtype, device=device)


def _arms_qpos(nq, rest):
    q = np.zeros(nq)
    q[0:8] = _HOME_ARM
    q[8:16] = _HOME_ARM
    q[16:16 + len(rest)] = rest
    return q


def aloha_home_qpos(m: Model) -> torch.Tensor:
    return torch.tensor(_arms_qpos(m.nq, _CUBE_START + (1.0,)),
                        dtype=m.dtype, device=m.device)


def home_ctrl(m: Model) -> torch.Tensor:
    c = np.zeros(m.nu)
    c[0:6] = _HOME_ARM[:6]
    c[6:8] = 0.01
    c[8:14] = _HOME_ARM[:6]
    c[14:16] = 0.01
    return torch.tensor(c, dtype=m.dtype, device=m.device)


def _grasp_points(m: Model, info: StepInfo, side: str, fname: str, ysign):
    """World centers (B, 3, 3) of a finger's three grasp spheres."""
    fb = m.struct.body_id(f"{side}/{fname}")
    local = constant(m, f"aloha_grasp_{ysign}", [
        [gx, ysign * gy, gz] for gx, gy, gz in _GRASP_PTS], info.xpos)
    fq = info.xquat[:, fb, None].expand(-1, 3, -1)
    return info.xpos[:, fb, None] + quat_rotate(fq, local)


def _normal_sum(center, closest, active, inside=None, fallback=None):
    """Σ of the unit finger -> object directions over the active grasp
    spheres (B, 3), and whether any is active (B,)."""
    d = closest - center
    if inside is not None:
        d = torch.where(inside[..., None], fallback, d)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                        min=1e-9)
    total = torch.sum(torch.where(active[..., None], d, torch.zeros_like(d)),
                      dim=1)
    return total, active.any(dim=1)


def _box_grasp(m, info, side, fname, ysign, box_c, box_R, half):
    """The box contact scan of one finger as geometry, with the 0.02 m
    activation margin: (normal sum, any active)."""
    center = _grasp_points(m, info, side, fname, ysign)
    lb = torch.einsum("nji,nkj->nki", box_R, center - box_c[:, None])
    clamped = torch.maximum(torch.minimum(lb, half), -half)
    closest = box_c[:, None] + torch.einsum("nij,nkj->nki", box_R, clamped)
    dn = torch.linalg.vector_norm(closest - center, dim=-1)
    active = dn - 0.006 < _GRASP_MARGIN
    return _normal_sum(center, closest, active, dn < 1e-6,
                       box_c[:, None] - center)


def _hand_score(m, info, side, scan, combine):
    """Both fingers' scans of one hand -> the score where both touch,
    else 1."""
    (na, aa), (nb, ab) = (scan(side, f, y) for f, y in (
        ("left_finger_link", -1.0), ("right_finger_link", 1.0)))
    na = na / torch.clamp(torch.linalg.vector_norm(na, dim=-1,
                                                   keepdim=True), min=1e-9)
    nb = nb / torch.clamp(torch.linalg.vector_norm(nb, dim=-1,
                                                   keepdim=True), min=1e-9)
    score = combine(side, torch.sum(na * nb, dim=-1))
    return torch.where(aa & ab, score, torch.ones_like(score))


def _reaches(m, info, obj_c, scale):
    s = m.struct
    out = []
    for side in ("left", "right"):
        gl = s.body_id(f"{side}/gripper_link")
        gpos = info.site_xpos[:, s.site_id(f"{side}/gripper")]
        out.append(quat_rotate_inv(info.xquat[:, gl], obj_c - gpos) * scale)
    return out


def _handover_residual(m: Model, task: Task, state: State, info: StepInfo,
                       ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    box = s.body_id("box")
    box_c = info.xpos[:, box]
    box_R = quat_to_mat(info.xquat[:, box])
    reach_l, reach_r = _reaches(m, info, box_c, constant(
        m, "handover_scale", (1.0, 2.0, 2.0), box_c))
    half = constant(m, "handover_half", (_CUBE_HALF,) * 3, box_c)

    def scan(side, fname, ysign):
        return _box_grasp(m, info, side, fname, ysign, box_c, box_R, half)

    hands = [_hand_score(m, info, side, scan, lambda _, c: 0.5 * (c + 1.0))
             for side in ("left", "right")]
    grasp = torch.sqrt(torch.clamp(hands[0] * hands[1], min=0.0))
    return torch.cat([reach_l, reach_r, grasp[:, None],
                      box_c - task.mocap_pos[0]], dim=-1)


def _handover_transition(task: Task, m: Model, state: State,
                         info: StepInfo) -> Task:
    """Respawn the target across the table once the cube of the (single)
    simulated state's first env is within 1 cm: x flips side at
    U(0.3, 0.4), y = ±U(0.2, 0.3), z = U(0.25, 0.7)."""
    box = info.xpos[0, m.struct.body_id("box")]
    target = task.mocap_pos[0]
    solved = (state.time[0] > 0) & (torch.linalg.vector_norm(box - target)
                                    < 0.01)
    tick = int(torch.round(state.time[0] * 1e3))
    gen = torch.Generator().manual_seed((_HANDOVER_SEED << 32) + tick)
    u = torch.rand(4, generator=gen, dtype=torch.float64)
    flip = -1.0 if float(target[0]) > 0 else 1.0
    x = (flip * (0.3 + 0.1 * u[0])).to(target)
    side = 1.0 if u[2] > 0.5 else -1.0
    new = torch.stack([x, (side * (0.2 + 0.1 * u[1])).to(target),
                       (0.25 + 0.45 * u[3]).to(target)])
    pos = task.mocap_pos.clone()
    pos[0] = torch.where(solved, new, target)
    return dataclasses.replace(task, mocap_pos=pos)


_HANDOVER_SEED = 11                  # the JAX package's PRNGKey(11)
_TERMS = (
    TermSpec("Reach L", 3, NormType.L2, num_params=1),
    TermSpec("Reach R", 3, NormType.L2, num_params=1),
    TermSpec("Grasp", 1, NormType.NULL),
    TermSpec("Bring", 3, NormType.L2, num_params=1),
)
_WEIGHTS = (0.1, 0.1, 0.05, 0.4)
_NORM_PARAMS = ((0.01, 0.0), (0.01, 0.0), (0.0, 0.0), (0.003, 0.0))


def handover_task(dtype=torch.float32, device=None) -> Task:
    return make_task("Bimanual Handover", _TERMS, _handover_residual,
                     _WEIGHTS, norm_params=_NORM_PARAMS,
                     mocap={"box_goal": _TARGET_START},
                     transition_fn=_handover_transition, dtype=dtype,
                     device=device)


# ---------------------------------------------------------------------------
# Bimanual Reorient: the reorientation cross (three orthogonal capsules of
# radius 0.015, arms -0.02..0.06 per axis), brought to a target pose and
# orientation through an 18-D cross-point residual
# ---------------------------------------------------------------------------

_CROSS_ARMS = (((-0.02, 0.0, 0.0), (0.06, 0.0, 0.0)),
               ((0.0, -0.02, 0.0), (0.0, 0.06, 0.0)),
               ((0.0, 0.0, -0.02), (0.0, 0.0, 0.06)))
_CROSS_R = 0.015
_K_RADIUS = 0.05
_CROSS_START = (0.2, 0.0, 0.025)
_REORIENT_TARGET = (0.1, -0.2, 0.2)
_REORIENT_SEED = 5                   # the JAX package's PRNGKey(5)


def aloha_reorient_model(dt: float = 0.01, max_contacts: int = 16,
                         dtype=torch.float32, device=None) -> Model:
    """Both arms and the reorientation cross on the table plane."""
    b, sphs, caps = _aloha_builder(dt, max_contacts)
    cross = b.add_body("cross", -1, pos=_CROSS_START, mass=0.12,
                       inertia=(6.5e-05, 6.5e-05, 6.5e-05))
    b.add_joint("cross_free", cross, JointType.FREE)
    arm_caps = [b.add_capsule(cross, p0=p0, p1=p1, radius=_CROSS_R,
                              friction=1.0) for p0, p1 in _CROSS_ARMS]
    for s in sphs:
        for c in arm_caps:
            b.add_pair_sc(s, c)
    for c in caps:
        for ac in arm_caps:
            b.add_pair_cc(c, ac)
    return b.finalize(dtype=dtype, device=device)


def reorient_home_qpos(m: Model) -> torch.Tensor:
    return torch.tensor(_arms_qpos(m.nq, _CROSS_START + (1.0,)),
                        dtype=m.dtype, device=m.device)


def _cross_grasp(m, info, side, fname, ysign, cross_c, cross_R):
    """The cross contact scan of one finger: each grasp sphere against
    the nearest cross arm (the first on a tie)."""
    center = _grasp_points(m, info, side, fname, ysign)       # (B, 3, 3)
    ends = constant(m, "cross_arms", _CROSS_ARMS, center)       # (3, 2, 3)
    seg = cross_c[:, None, None] + torch.einsum("nij,akj->naki", cross_R,
                                                ends)         # (B,3,2,3)
    a, ab = seg[:, None, :, 0], (seg[:, :, 1] - seg[:, :, 0])[:, None]
    c = center[:, :, None]                                     # (B,3,1,3)
    t = torch.clamp(torch.sum((c - a) * ab, dim=-1)
                    / torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-12),
                    0.0, 1.0)
    pt = a + t[..., None] * ab                                 # (B,3,3,3)
    d = torch.linalg.vector_norm(pt - c, dim=-1)               # (B,3,3)
    k = torch.argmin(d, dim=-1, keepdim=True)
    best_d = torch.gather(d, -1, k)[..., 0]
    best_pt = torch.gather(pt, 2, k[..., None].expand(-1, -1, -1, 3))[:, :, 0]
    active = best_d - _CROSS_R - 0.006 < _GRASP_MARGIN
    return _normal_sum(center, best_pt, active)


def _reorient_residual(m: Model, task: Task, state: State, info: StepInfo,
                       ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    cid = s.body_id("cross")
    cross_c = info.xpos[:, cid]
    cross_R = quat_to_mat(info.xquat[:, cid])
    reach_l, reach_r = _reaches(m, info, cross_c, constant(
        m, "reorient_scale", (1.0, 3.0, 3.0), cross_c))

    def scan(side, fname, ysign):
        return _cross_grasp(m, info, side, fname, ysign, cross_c, cross_R)

    grasps = [_hand_score(m, info, side, scan, lambda _, c: 0.5 * (c + 1.0))
              for side in ("left", "right")]
    tR = quat_to_mat(task.mocap_quat[0])
    outs = []
    for dim in range(3):
        for sign in (-1.0, 1.0):
            outs.append(task.mocap_pos[0] + sign * _K_RADIUS * tR[:, dim]
                        - (cross_c + sign * _K_RADIUS * cross_R[:, :, dim]))
    return torch.cat([reach_l, reach_r, grasps[0][:, None],
                      grasps[1][:, None]] + outs, dim=-1)


def _reorient_transition(task: Task, m: Model, state: State,
                         info: StepInfo) -> Task:
    """A new random goal orientation once the cross of the (single)
    simulated state's first env matches it."""
    res = _reorient_residual(m, task, state, info,
                             state.qpos.new_zeros((state.batch, m.nu)))[0]
    solved = (state.time[0] > 0) & (torch.linalg.vector_norm(res[8:26])
                                    < 0.02)
    tick = int(torch.round(state.time[0] * 1e3))
    gen = torch.Generator().manual_seed((_REORIENT_SEED << 32) + tick)
    q = torch.randn(4, generator=gen, dtype=torch.float64)
    q = (q / torch.linalg.vector_norm(q)).to(task.mocap_quat)
    mq = task.mocap_quat.clone()
    mq[0] = torch.where(solved, q, mq[0])
    return dataclasses.replace(task, mocap_quat=mq)


_REORIENT_TERMS = (
    TermSpec("Reach L", 3, NormType.L22, num_params=2),
    TermSpec("Reach R", 3, NormType.L22, num_params=2),
    TermSpec("Grasp L", 1, NormType.NULL),
    TermSpec("Grasp R", 1, NormType.NULL),
    TermSpec("Bring", 18, NormType.L2, num_params=1),
)
_REORIENT_WEIGHTS = (0.1, 0.1, 0.05, 0.05, 1.0)
_REORIENT_NORM_PARAMS = ((0.05, 4.0), (0.05, 4.0), (0.0, 0.0),
                         (0.0, 0.0), (0.01, 0.0))


def reorient_task(dtype=torch.float32, device=None) -> Task:
    return make_task("Bimanual Reorient", _REORIENT_TERMS,
                     _reorient_residual, _REORIENT_WEIGHTS,
                     norm_params=_REORIENT_NORM_PARAMS,
                     mocap={"goal": _REORIENT_TARGET},
                     transition_fn=_reorient_transition, dtype=dtype,
                     device=device)


# ---------------------------------------------------------------------------
# Bimanual Insert: two connector halves (their grip boxes) grasped, lifted
# to the target height and mated, scored by 6-point crosses of the two
# mating sites
# ---------------------------------------------------------------------------

_GRIP_HALF = (0.025, 0.0195, 0.0065)
_F_GRIP_POS = (0.0, 0.0, -0.0065)
_M_GRIP_POS = (0.0, 0.0, 0.012838796)
_F_GRIP_QUAT = (0.7071068, 0.0, 0.7071068, 0.0)
_M_GRIP_QUAT = (0.7071068, 0.0, -0.7071068, 0.0)
_F_SITE_POS = (0.0, 0.0, 0.018)
_M_SITE_POS = (0.0, 0.0, -0.018)
_INSERT_RADIUS = 0.08
_INSERT_TARGET = (0.0, 0.0, 0.35)
_F_START = (-0.15, 0.0, 0.05)
_F_START_QUAT = (0.0, 1.0, 0.0, 0.0)
_M_START = (0.15, 0.0, 0.05)


def aloha_insert_model(dt: float = 0.01, max_contacts: int = 16,
                       dtype=torch.float32, device=None) -> Model:
    b, sphs, caps = _aloha_builder(dt, max_contacts)
    boxes = []
    for name, start, quat, mass, diag, grip_pos in (
            ("connector_f", _F_START, _F_START_QUAT, 0.0358,
             (1.5e-05, 1.49e-05, 9.41e-06), _F_GRIP_POS),
            ("connector_m", _M_START, (1, 0, 0, 0), 0.0701,
             (2.67e-05, 2.28e-05, 1.57e-05), _M_GRIP_POS)):
        body = b.add_body(name, -1, pos=start, quat=quat, mass=mass,
                          inertia=diag)
        b.add_joint(f"{name}_free", body, JointType.FREE)
        boxes.append(b.add_box(body, pos=grip_pos, size=_GRIP_HALF,
                               friction=0.5, floor=True))
        b.add_site(f"{name}_grip", body, pos=grip_pos)
        b.add_site(name, body, pos=_F_SITE_POS if name == "connector_f"
                   else _M_SITE_POS)
    for s in sphs:
        for bx in boxes:
            b.add_pair_sb(s, bx)
    for c in caps:
        for bx in boxes:
            b.add_pair_cb(c, bx)
    return b.finalize(dtype=dtype, device=device)


def insert_home_qpos(m: Model) -> torch.Tensor:
    return torch.tensor(_arms_qpos(m.nq, _F_START + _F_START_QUAT + _M_START
                                   + (1.0,)), dtype=m.dtype, device=m.device)


def _site_frame(info: StepInfo, m: Model, body: str, local_pos, local_quat):
    """World position (B, 3) and rotation (B, 3, 3) of an oriented site."""
    bid = m.struct.body_id(body)
    bq = info.xquat[:, bid]
    t = constant(m, f"site_pos_{local_pos}", local_pos, bq)
    lq = constant(m, f"site_quat_{local_quat}", local_quat, bq)
    return (info.xpos[:, bid] + quat_rotate(bq, t),
            quat_to_mat(quat_mul(bq, lq.expand_as(bq))))


def _insert_residual(m: Model, task: Task, state: State, info: StepInfo,
                     ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    fg_pos, fg_R = _site_frame(info, m, "connector_f", _F_GRIP_POS,
                               _F_GRIP_QUAT)
    mg_pos, mg_R = _site_frame(info, m, "connector_m", _M_GRIP_POS,
                               _M_GRIP_QUAT)
    reaches = []
    for side, gpos_w in (("left", fg_pos), ("right", mg_pos)):
        gl = s.body_id(f"{side}/gripper_link")
        gsite = info.site_xpos[:, s.site_id(f"{side}/gripper")]
        reaches.append(quat_rotate_inv(info.xquat[:, gl], gpos_w - gsite))
    half = constant(m, "grip_half", _GRIP_HALF, info.xpos)
    grips = {"left": (fg_pos, fg_R), "right": (mg_pos, mg_R)}
    ex = constant(m, "e_x", (1.0, 0.0, 0.0), info.xpos)

    def scan(side, fname, ysign):
        c, R = grips[side]
        return _box_grasp(m, info, side, fname, ysign, c, R, half)

    def combine(side, con):
        # (contact alignment + 2 frame alignment + 3) / 6
        gl = s.body_id(f"{side}/gripper_link")
        frame = torch.sum(quat_rotate(info.xquat[:, gl], ex)
                          * grips[side][1][:, :, 0], dim=-1)
        return (con + 2.0 * frame + 3.0) / 6.0

    grasps = [_hand_score(m, info, side, scan, combine)
              for side in ("left", "right")]
    f_site, f_R = _site_frame(info, m, "connector_f", _F_SITE_POS,
                              (1.0, 0, 0, 0))
    m_site, m_R = _site_frame(info, m, "connector_m", _M_SITE_POS,
                              (1.0, 0, 0, 0))
    target = task.mocap_pos[0]
    # the reference scales components 1 and 2 by 0.1, as written
    scale = constant(m, "insert_scale", (1.0, 0.1, 0.1), info.xpos)
    outs = []
    for dim in range(3):
        for sign in (-1.0, 1.0):
            outs.append(m_site + sign * _INSERT_RADIUS * m_R[:, :, dim]
                        - (f_site + sign * _INSERT_RADIUS * f_R[:, :, dim]))
    return torch.cat([reaches[0], reaches[1], grasps[0][:, None],
                      grasps[1][:, None], (m_site - target) * scale,
                      (f_site - target) * scale] + outs, dim=-1)


_INSERT_TERMS = (
    TermSpec("Reach L", 3, NormType.L2, num_params=1),
    TermSpec("Reach R", 3, NormType.L2, num_params=1),
    TermSpec("Grasp L", 1, NormType.NULL),
    TermSpec("Grasp R", 1, NormType.NULL),
    TermSpec("Lift", 6, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Insert", 18, NormType.L2, num_params=1),
)
_INSERT_WEIGHTS = (0.3, 0.3, 0.4, 0.4, 0.7, 0.4)
_INSERT_NORM_PARAMS = ((0.01, 0.0), (0.01, 0.0), (0.0, 0.0),
                       (0.0, 0.0), (0.05, 0.0), (0.01, 0.0))


def insert_task(dtype=torch.float32, device=None) -> Task:
    return make_task("Bimanual Insert", _INSERT_TERMS, _insert_residual,
                     _INSERT_WEIGHTS, norm_params=_INSERT_NORM_PARAMS,
                     mocap={"target": _INSERT_TARGET}, dtype=dtype,
                     device=device)
