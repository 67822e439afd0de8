"""Acrobot swing-up task, batched.

Counterpart of humanoid_mujoco_tpu/tasks/acrobot.py (the reference's
mjpc/tasks/acrobot): two 1 m, 1 kg links hanging from a fixed shoulder
at z = 2, only the elbow actuated (motor gear 2), constraints disabled.
Its step has no contact slots and no rows: the solver-free route, no
kernel.

Residual (3 terms, quadratic norms):
    Distance (2): goal - tip, (z, x) components   [weight 50]
    Velocity (2): joint velocities                [weight 1]
    Control  (1): elbow effort                    [weight 0.05]

The goal is the "goal" mocap body at (0, 0, 4), full upright
extension. The home keyframe hangs the arm down (shoulder at π).
"""

from __future__ import annotations

import math

import torch

from ..ops.norms import NormType
from ..physics.model import (ActuatorType, JointType, Model, ModelBuilder,
                             State)
from ..physics.step import StepInfo
from .base import Task, TermSpec, make_task


def acrobot_model(dt: float = 0.01, dtype=torch.float32,
                  device=None) -> Model:
    """Two slender links (1 kg, 1 m, joint damping 0.05) on y-axis
    hinges; motor gear 2 on the elbow only."""
    b = ModelBuilder(dt=dt)
    b.has_floor = False
    rod = (8.4e-2, 8.4e-2, 1.0e-4)     # I_com = m L²/12, m = 1, L = 1
    upper = b.add_body("upper_arm", -1, pos=(0.0, 0.0, 2.0), mass=1.0,
                       ipos=(0.0, 0.0, 0.5), inertia=rod)
    b.add_joint("shoulder", upper, JointType.HINGE, axis=(0, 1, 0),
                damping=0.05)
    lower = b.add_body("lower_arm", upper, pos=(0.0, 0.0, 1.0), mass=1.0,
                       ipos=(0.0, 0.0, 0.5), inertia=rod)
    elbow = b.add_joint("elbow", lower, JointType.HINGE, axis=(0, 1, 0),
                        damping=0.05)
    b.add_site("tip", lower, pos=(0.0, 0.0, 1.0))
    b.add_actuator(elbow, ActuatorType.MOTOR, gear=2.0,
                   ctrlrange=(-1.0, 1.0), forcerange=(-2.0, 2.0))
    return b.finalize(dtype=dtype, device=device)


def acrobot_home_qpos(m: Model) -> torch.Tensor:
    """Hanging rest (shoulder rotated π, tip at z = 0)."""
    q = torch.zeros(m.nq, dtype=m.dtype, device=m.device)
    q[0] = math.pi
    return q


def acrobot_residual(m: Model, task: Task, state: State, info: StepInfo,
                     ctrl: torch.Tensor) -> torch.Tensor:
    goal = task.mocap_pos[0]
    tip = info.site_xpos[:, m.struct.site_id("tip")]
    return torch.cat([torch.stack([goal[2] - tip[:, 2], goal[0] - tip[:, 0]],
                                  dim=-1), state.qvel, ctrl], dim=-1)


_TERMS = (
    TermSpec("Distance", 2, NormType.QUADRATIC),
    TermSpec("Velocity", 2, NormType.QUADRATIC),
    TermSpec("Control", 1, NormType.QUADRATIC),
)
_WEIGHTS = (50.0, 1.0, 0.05)


def acrobot_task(dtype=torch.float32, device=None) -> Task:
    return make_task("Acrobot", _TERMS, acrobot_residual, _WEIGHTS,
                     mocap={"goal": (0.0, 0.0, 4.0)}, dtype=dtype,
                     device=device)
