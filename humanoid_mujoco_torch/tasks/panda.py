"""Panda "Pick" task, batched.

Counterpart of humanoid_mujoco_tpu/tasks/panda.py (the reference's
mjpc/tasks/panda): the Franka Emika Panda, a fixed-base 7-DOF arm and a
two-finger gripper with every link gravity-compensated (gravcomp 1),
actuated by six world-frame Cartesian wrench actuators at the
end-effector site (force gain 10, torque gain 1) and two finger position
servos; a free 0.04 x 0.06 x 0.04 box (8 corner spheres) and a mocap
target. The fingertips and palm are spheres paired with the box's
corners (35 slots, `max_contacts` 0). Its step takes the "contact"
route (nv 15, 14 limit rows).

Residual: Reach (3) eeff - box [L2(0.01), w 1]; Bring (6) the box's
two face sites minus the target's [L2(0.003), w 0.1].

Transition: once the mean face distance of the (single) simulated state
is under 0.015 the target respawns at a random pose. One difference from
the JAX package: the pose is drawn from a `torch.Generator` seeded from
the sim tick (round(time * 1e3)), where the JAX package folds the tick
into `PRNGKey(7)`; until the target is reached the two agree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.norms import NormType
from ..physics.math import quat_rotate
from ..physics.model import (ActuatorType, JointType, Model, ModelBuilder,
                             State)
from ..physics.step import StepInfo
from .base import Task, TermSpec, constant, make_task

_JNT_RANGE = (-2.8973, 2.8973)       # panda class default
_FACE = 0.026                        # box face-site offset
_BOX_START = (0.4, 0.5, 0.2)
_TARGET_START = (0.6, 0.4, 0.05)
_SEED = 7                            # the JAX package's PRNGKey(7)


def _diag(fullinertia):
    """MJCF fullinertia (Ixx Iyy Izz Ixy Ixz Iyz) -> (principal
    moments, iquat)."""
    xx, yy, zz, xy, xz, yz = fullinertia
    I = np.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]])
    w, V = np.linalg.eigh(I)
    if np.linalg.det(V) < 0:
        V[:, 0] = -V[:, 0]
    # rotation matrix -> quaternion (w,x,y,z)
    t = np.trace(V)
    if t > 0:
        r = np.sqrt(1.0 + t)
        q = np.array([0.5 * r, (V[2, 1] - V[1, 2]) / (2 * r),
                      (V[0, 2] - V[2, 0]) / (2 * r),
                      (V[1, 0] - V[0, 1]) / (2 * r)])
    else:
        i = int(np.argmax(np.diag(V)))
        j, k = (i + 1) % 3, (i + 2) % 3
        r = np.sqrt(1.0 + V[i, i] - V[j, j] - V[k, k])
        q = np.zeros(4)
        q[0] = (V[k, j] - V[j, k]) / (2 * r)
        q[1 + i] = 0.5 * r
        q[1 + j] = (V[j, i] + V[i, j]) / (2 * r)
        q[1 + k] = (V[k, i] + V[i, k]) / (2 * r)
    return tuple(w), tuple(q / np.linalg.norm(q))


# (name, pos, quat, mass, ipos, fullinertia, joint_range|None, damping)
# transcribed from panda_modified.xml worldbody
_LINKS = (
    ("link1", (0, 0, 0.333), (1, 0, 0, 0), 4.970684,
     (0.003875, 0.002081, -0.04762),
     (0.70337, 0.70661, 0.0091170, -1.39e-4, 6.772e-3, 1.9169e-2),
     None, 2.0),
    ("link2", (0, 0, 0), (1, -1, 0, 0), 0.646926,
     (-0.003141, -0.02872, 0.003495),
     (7.962e-3, 2.8110e-2, 2.5995e-2, -3.925e-3, 1.0254e-2, 7.04e-4),
     (-1.7628, 1.7628), 2.0),
    ("link3", (0, -0.316, 0), (1, 1, 0, 0), 3.228604,
     (2.7518e-2, 3.9252e-2, -6.6502e-2),
     (3.7242e-2, 3.6155e-2, 1.083e-2, -4.761e-3, -1.1396e-2, -1.2805e-2),
     _JNT_RANGE, 2.0),
    ("link4", (0.0825, 0, 0), (1, 1, 0, 0), 3.587895,
     (-5.317e-2, 1.04419e-1, 2.7454e-2),
     (2.5853e-2, 1.9552e-2, 2.8323e-2, 7.796e-3, -1.332e-3, 8.641e-3),
     (-3.0718, -0.698), 2.0),
    ("link5", (-0.0825, 0.384, 0), (1, -1, 0, 0), 1.225946,
     (-1.1953e-2, 4.1065e-2, -3.8437e-2),
     (3.5549e-2, 2.9474e-2, 8.627e-3, -2.117e-3, -4.037e-3, 2.29e-4),
     _JNT_RANGE, 2.0),
    ("link6", (0, 0, 0), (1, 1, 0, 0), 1.666555,
     (6.0149e-2, -1.4117e-2, -1.0517e-2),
     (1.964e-3, 4.354e-3, 5.433e-3, 1.09e-4, -1.158e-3, 3.41e-4),
     (-0.0175, 3.7525), 2.0),
    ("link7", (0.088, 0, 0), (1, 1, 0, 0), 0.735522,
     (1.0517e-2, -4.252e-3, 6.1597e-2),
     (1.2516e-2, 1.0027e-2, 4.815e-3, -4.28e-4, -1.196e-3, -7.41e-4),
     None, 1.0),
)

_HOME_ARM = (0.0, 0.3, 0.0, -1.57079, 0.0, 2.0, -0.7853)


# (name, pos, quat, mass, ipos, fullinertia, joint_range|None, damping)
_LINKS = (
    ("link1", (0, 0, 0.333), (1, 0, 0, 0), 4.970684,
     (0.003875, 0.002081, -0.04762),
     (0.70337, 0.70661, 0.0091170, -1.39e-4, 6.772e-3, 1.9169e-2),
     None, 2.0),
    ("link2", (0, 0, 0), (1, -1, 0, 0), 0.646926,
     (-0.003141, -0.02872, 0.003495),
     (7.962e-3, 2.8110e-2, 2.5995e-2, -3.925e-3, 1.0254e-2, 7.04e-4),
     (-1.7628, 1.7628), 2.0),
    ("link3", (0, -0.316, 0), (1, 1, 0, 0), 3.228604,
     (2.7518e-2, 3.9252e-2, -6.6502e-2),
     (3.7242e-2, 3.6155e-2, 1.083e-2, -4.761e-3, -1.1396e-2, -1.2805e-2),
     _JNT_RANGE, 2.0),
    ("link4", (0.0825, 0, 0), (1, 1, 0, 0), 3.587895,
     (-5.317e-2, 1.04419e-1, 2.7454e-2),
     (2.5853e-2, 1.9552e-2, 2.8323e-2, 7.796e-3, -1.332e-3, 8.641e-3),
     (-3.0718, -0.698), 2.0),
    ("link5", (-0.0825, 0.384, 0), (1, -1, 0, 0), 1.225946,
     (-1.1953e-2, 4.1065e-2, -3.8437e-2),
     (3.5549e-2, 2.9474e-2, 8.627e-3, -2.117e-3, -4.037e-3, 2.29e-4),
     _JNT_RANGE, 2.0),
    ("link6", (0, 0, 0), (1, 1, 0, 0), 1.666555,
     (6.0149e-2, -1.4117e-2, -1.0517e-2),
     (1.964e-3, 4.354e-3, 5.433e-3, 1.09e-4, -1.158e-3, 3.41e-4),
     (-0.0175, 3.7525), 2.0),
    ("link7", (0.088, 0, 0), (1, 1, 0, 0), 0.735522,
     (1.0517e-2, -4.252e-3, 6.1597e-2),
     (1.2516e-2, 1.0027e-2, 4.815e-3, -4.28e-4, -1.196e-3, -7.41e-4),
     None, 1.0),
)

_HOME_ARM = (0.0, 0.3, 0.0, -1.57079, 0.0, 2.0, -0.7853)


def build_panda_arm(b: ModelBuilder):
    """Panda arm + hand + fingers into `b`; returns (eeff site id,
    fingertip/palm sphere geom ids) — shared by the Panda bring task
    and manipulation PickAndPlace."""
    base = b.add_body("link0", -1, mass=0.629769,
                      ipos=(-0.041018, -0.00014, 0.049974),
                      inertia=_diag((3.15e-3, 3.88e-3, 4.285e-3,
                                     8.2904e-7, 1.5e-4, 8.2299e-6))[0])
    parent = base
    for name, pos, quat, mass, ipos, finert, rng, damp in _LINKS:
        diag, iquat = _diag(finert)
        body = b.add_body(name, parent, pos=pos, quat=quat, mass=mass,
                          ipos=ipos, iquat=iquat, inertia=diag,
                          gravcomp=1.0)
        b.add_joint(f"joint{name[-1]}", body, JointType.HINGE,
                    axis=(0, 0, 1),
                    jrange=rng if rng else (0.0, 0.0),
                    limited=rng is not None, damping=damp, armature=0.1)
        parent = body

    hand = b.add_body("hand", parent, pos=(0, 0, 0.107),
                      quat=(0.9238795, 0, 0, -0.3826834), mass=0.73,
                      ipos=(-0.01, 0, 0.03),
                      inertia=(0.001, 0.0025, 0.0017), gravcomp=1.0)
    eeff = b.add_site("eeff", hand, pos=(0, 0, 0.11))
    palm = b.add_sphere(hand, pos=(0, 0, 0.06), radius=0.02, friction=1.0)

    tips = [palm]
    for fname, fquat in (("left_finger", (1, 0, 0, 0)),
                         ("right_finger", (0, 0, 0, 1))):
        fb = b.add_body(fname, hand, pos=(0, 0, 0.0584), quat=fquat,
                        mass=0.015, inertia=(2.375e-6, 2.375e-6, 7.5e-7),
                        gravcomp=1.0)
        b.add_joint(f"{fname}_joint", fb, JointType.SLIDE, axis=(0, 1, 0),
                    jrange=(0.0, 0.04), limited=True, damping=2.0,
                    armature=0.1)
        b.add_site(f"tip_{fname}", fb, pos=(0, 0.01, 0.05))
        tips.append(b.add_sphere(fb, pos=(0, 0.008, 0.045), radius=0.009,
                                 friction=1.0))
    return eeff, tips


def add_panda_actuators(b: ModelBuilder, eeff: int):
    """The reference's 6 Cartesian eeff wrench actuators + finger
    position servos (panda_modified.xml actuator block)."""
    for i in range(3):
        g = [0.0] * 6
        g[i] = 10.0
        b.add_thrust(eeff, gear=tuple(g), ctrlrange=(-1, 1),
                     forcerange=(-1e9, 1e9), world_frame=True)
    for i in range(3):
        g = [0.0] * 6
        g[3 + i] = 1.0
        b.add_thrust(eeff, gear=tuple(g), ctrlrange=(-1, 1),
                     forcerange=(-1e9, 1e9), world_frame=True)
    for j, jd in enumerate(b._joints):
        if jd["name"].endswith("finger_joint"):
            b.add_actuator(j, ActuatorType.POSITION, gear=1.0, kp=100.0,
                           kv=5.0, ctrlrange=(0.0, 0.04),
                           forcerange=(-100.0, 100.0))


def panda_model(dt: float = 0.003, dtype=torch.float32, device=None
                ) -> Model:
    b = ModelBuilder(dt=dt)
    b.has_floor = True
    eeff, tips = build_panda_arm(b)
    box = b.add_body("box", -1, pos=_BOX_START, mass=0.096,
                     inertia=(4.16e-5, 2.56e-5, 4.16e-5))
    b.add_joint("box_free", box, JointType.FREE)
    b.add_site("box1", box, pos=(0, _FACE, 0))
    b.add_site("box2", box, pos=(0, -_FACE, 0))
    corners = [b.add_sphere(box, pos=(sx, sy, sz), radius=0.01,
                            friction=1.0)
               for sx in (-0.01, 0.01) for sy in (-0.02, 0.02)
               for sz in (-0.01, 0.01)]
    for t in tips:
        for c in corners:
            b.add_pair(t, c)
    add_panda_actuators(b, eeff)
    return b.finalize(dtype=dtype, device=device)


def panda_home_qpos(m: Model) -> torch.Tensor:
    q = np.zeros(m.nq)
    q[:7] = _HOME_ARM
    q[7:9] = 0.04                      # fingers open
    q[9:12] = (0.4, 0.5, 0.021)        # the box on the floor
    q[12] = 1.0
    return torch.tensor(q, dtype=m.dtype, device=m.device)


def home_ctrl(m: Model) -> torch.Tensor:
    c = np.zeros(m.nu)
    c[6:8] = 0.04
    return torch.tensor(c, dtype=m.dtype, device=m.device)


def _target_faces(m: Model, task: Task):
    tpos, tquat = task.mocap_pos[0], task.mocap_quat[0]
    r = quat_rotate(tquat, constant(m, "panda_face", (0.0, _FACE, 0.0),
                                    tpos))
    return tpos + r, tpos - r


def _panda_residual(m: Model, task: Task, state: State, info: StepInfo,
                    ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    sx = info.site_xpos
    t1, t2 = _target_faces(m, task)
    return torch.cat([sx[:, s.site_id("eeff")] - info.xpos[:, s.body_id("box")],
                      sx[:, s.site_id("box1")] - t1,
                      sx[:, s.site_id("box2")] - t2], dim=-1)


def _panda_transition(task: Task, m: Model, state: State,
                      info: StepInfo) -> Task:
    """Respawn the target once the box is brought to it (the state's
    first env decides; the tick is read on the host to seed the draw)."""
    s = m.struct
    t1, t2 = _target_faces(m, task)
    b1 = info.site_xpos[0, s.site_id("box1")]
    b2 = info.site_xpos[0, s.site_id("box2")]
    d = 0.5 * (torch.linalg.vector_norm(b1 - t1)
               + torch.linalg.vector_norm(b2 - t2))
    solved = (state.time[0] > 0) & (d < 0.015)
    tick = int(torch.round(state.time[0] * 1e3))
    gen = torch.Generator().manual_seed((_SEED << 32) + tick)
    xy = torch.rand(2, generator=gen, dtype=torch.float64) - 0.5
    z = 0.03 + 0.97 * torch.rand(1, generator=gen, dtype=torch.float64)
    quat = torch.randn(4, generator=gen, dtype=torch.float64)
    quat = quat / torch.linalg.vector_norm(quat)
    like = task.mocap_pos
    pos, mq = task.mocap_pos.clone(), task.mocap_quat.clone()
    pos[0] = torch.where(solved, torch.cat([xy, z]).to(like), pos[0])
    mq[0] = torch.where(solved, quat.to(like), mq[0])
    return dataclasses.replace(task, mocap_pos=pos, mocap_quat=mq)


_TERMS = (
    TermSpec("Reach", 3, NormType.L2, num_params=1),
    TermSpec("Bring", 6, NormType.L2, num_params=1),
)
_WEIGHTS = (1.0, 0.1)
_NORM_PARAMS = ((0.01, 0.0), (0.003, 0.0))


def panda_task(dtype=torch.float32, device=None) -> Task:
    return make_task("Panda", _TERMS, _panda_residual, _WEIGHTS,
                     norm_params=_NORM_PARAMS,
                     mocap={"target": _TARGET_START},
                     transition_fn=_panda_transition, dtype=dtype,
                     device=device)
