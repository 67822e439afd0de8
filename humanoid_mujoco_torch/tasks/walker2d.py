"""Planar Walker task, batched.

Counterpart of humanoid_mujoco_tpu/tasks/walker2d.py (the reference's
mjpc/tasks/walker, the dm_control planar walker): the torso on a planar
root of three joints on one body (rootz slide, rootx slide, rooty
hinge), hip / knee / ankle per leg, motors with gears 100 / 50 / 20.
Each foot capsule collides through two spheres at its ends (4 slots).
Its step runs kernels B1 and B2 (nv 9, 4 slots, 12 limit rows).

Residual (4 terms, quadratic norms):
    Control  (6): effort                       [weight 0.1]
    Height   (1): torso z - Height Goal (1.2)  [weight 10]
    Rotation (1): torso up-axis z - 1          [weight 3]
    Speed    (1): COM x velocity - Speed Goal  [weight 1]
"""

from __future__ import annotations

import math

import torch

from ..ops.norms import NormType
from ..physics.math import quat_rotate
from ..physics.model import (ActuatorType, JointType, Model, ModelBuilder,
                             State)
from ..physics.step import StepInfo
from .base import Task, TermSpec, make_task

_D2R = math.pi / 180.0


def walker_model(dt: float = 0.0025, dtype=torch.float32,
                 device=None) -> Model:
    """The dm_control walker's masses, joint ranges and gears."""
    b = ModelBuilder(dt=dt)
    b.has_floor = True
    torso = b.add_body("torso", -1, pos=(0.0, 0.0, 1.3), mass=10.7,
                       inertia=(0.334, 0.334, 0.026))
    for nm, ax, jt in (("rootz", (0, 0, 1), JointType.SLIDE),
                       ("rootx", (1, 0, 0), JointType.SLIDE),
                       ("rooty", (0, 1, 0), JointType.HINGE)):
        b.add_joint(nm, torso, jt, axis=ax)
    b.add_site("torso_site", torso)

    def leg(side: str, ysign: float):
        thigh = b.add_body(f"{side}_thigh", torso,
                           pos=(0.0, -0.05 * ysign, -0.3), mass=4.05,
                           ipos=(0.0, 0.0, -0.225),
                           inertia=(0.070, 0.070, 0.005))
        hip = b.add_joint(f"{side}_hip", thigh, JointType.HINGE,
                          axis=(0, 1, 0),
                          jrange=(-20 * _D2R, 100 * _D2R), limited=True,
                          damping=0.1, armature=0.01)
        shank = b.add_body(f"{side}_leg", thigh, pos=(0.0, 0.0, -0.7),
                           mass=2.78, inertia=(0.058, 0.058, 0.0022))
        knee = b.add_joint(f"{side}_knee", shank, JointType.HINGE,
                           axis=(0, 1, 0), pos=(0.0, 0.0, 0.25),
                           jrange=(-150 * _D2R, 0.0), limited=True,
                           damping=0.1, armature=0.01)
        foot = b.add_body(f"{side}_foot", shank, pos=(0.06, 0.0, -0.25),
                          mass=2.09, inertia=(0.0026, 0.008, 0.008))
        ankle = b.add_joint(f"{side}_ankle", foot, JointType.HINGE,
                            axis=(0, 1, 0), pos=(-0.06, 0.0, 0.0),
                            jrange=(-45 * _D2R, 45 * _D2R), limited=True,
                            damping=0.1, armature=0.01)
        # the foot capsule (along x, half-length 0.1, r 0.05) as its two
        # end spheres
        b.add_sphere(foot, pos=(-0.1, 0.0, 0.0), radius=0.05,
                     friction=0.7)
        b.add_sphere(foot, pos=(0.1, 0.0, 0.0), radius=0.05,
                     friction=0.7)
        b.add_site(f"{side}_foot_site", foot)
        for j, gear in ((hip, 100.0), (knee, 50.0), (ankle, 20.0)):
            b.add_actuator(j, ActuatorType.MOTOR, gear=gear,
                           ctrlrange=(-1.0, 1.0),
                           forcerange=(-gear, gear))

    leg("right", 1.0)
    leg("left", -1.0)
    return b.finalize(dtype=dtype, device=device)


def walker_stand_qpos(m: Model) -> torch.Tensor:
    """Upright rest: all zeros (the torso at z 1.3, feet on the floor)."""
    return torch.zeros(m.nq, dtype=m.dtype, device=m.device)


def walker_residual(m: Model, task: Task, state: State, info: StepInfo,
                    ctrl: torch.Tensor) -> torch.Tensor:
    torso = m.struct.body_id("torso")
    up = quat_rotate(info.xquat[:, torso], torch.tensor(
        [0.0, 0.0, 1.0], dtype=state.qpos.dtype, device=state.qpos.device))
    return torch.cat([ctrl, info.xpos[:, torso, 2:3] - task.params[0],
                      up[:, 2:3] - 1.0,
                      info.com_vel[:, 0:1] - task.params[1]], dim=-1)


_TERMS = (
    TermSpec("Control", 6, NormType.QUADRATIC),
    TermSpec("Height", 1, NormType.QUADRATIC),
    TermSpec("Rotation", 1, NormType.QUADRATIC),
    TermSpec("Speed", 1, NormType.QUADRATIC),
)
_WEIGHTS = (0.1, 10.0, 3.0, 1.0)


def walker_task(height_goal: float = 1.2, speed_goal: float = 0.0,
                dtype=torch.float32, device=None) -> Task:
    return make_task("Walker", _TERMS, walker_residual, _WEIGHTS,
                     params=(height_goal, speed_goal),
                     param_names=("Height Goal", "Speed Goal"),
                     dtype=dtype, device=device)
