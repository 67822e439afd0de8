"""Particle tasks, batched.

Counterpart of humanoid_mujoco_tpu/tasks/particle.py (the reference's
mjpc/tasks/particle): a planar 0.1 kg point mass on two damped slide
joints with a motor each chases the "goal" mocap body. Its step has no
contact slots and no rows: the solver-free route, no kernel.

  * "Particle": the goal rides a Lissajous curve through the task
    transition, goal = (0.25 sin t, 0.25 cos(t / π), 0);
  * "ParticleFixed": a static goal (move it with `set_mocap`).

Residual (3 terms, quadratic norms):
    Position (2): position - goal   [weight 10]
    Velocity (2): velocity          [weight 0.1]
    Control  (2): ctrl              [weight 0.1]
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.norms import NormType
from ..physics.model import (ActuatorType, JointType, Model, ModelBuilder,
                             State)
from ..physics.step import StepInfo
from .base import Task, TermSpec, make_task


def particle_model(dt: float = 0.01, dtype=torch.float32,
                   device=None) -> Model:
    """Planar point mass: 2 slide joints (x, y), 2 motors."""
    b = ModelBuilder(dt=dt)
    b.has_floor = False
    body = b.add_body("particle", -1, mass=0.1,
                      inertia=(1e-4, 1e-4, 1e-4))
    jx = b.add_joint("slide_x", body, JointType.SLIDE, axis=(1, 0, 0),
                     damping=1.0)
    jy = b.add_joint("slide_y", body, JointType.SLIDE, axis=(0, 1, 0),
                     damping=1.0)
    for j in (jx, jy):
        b.add_actuator(j, ActuatorType.MOTOR, gear=1.0, ctrlrange=(-1, 1),
                       forcerange=(-1, 1))
    return b.finalize(dtype=dtype, device=device)


def particle_residual(m: Model, task: Task, state: State, info: StepInfo,
                      ctrl: torch.Tensor) -> torch.Tensor:
    goal = task.mocap_pos[0, :2]
    return torch.cat([state.qpos[:, :2] - goal, state.qvel[:, :2], ctrl],
                     dim=-1)


def lissajous_transition(task: Task, m: Model, state: State,
                         info: StepInfo) -> Task:
    """The goal mocap body moves to the Lissajous point at the time of
    the (single) simulated state."""
    t = state.time[0]
    goal = torch.stack([0.25 * torch.sin(t), 0.25 * torch.cos(t / math.pi),
                        torch.zeros_like(t)])
    pos = task.mocap_pos.clone()
    pos[0] = goal.to(pos.dtype)
    return dataclasses.replace(task, mocap_pos=pos)


_TERMS = (
    TermSpec("Position", 2, NormType.QUADRATIC),
    TermSpec("Velocity", 2, NormType.QUADRATIC),
    TermSpec("Control", 2, NormType.QUADRATIC),
)
_WEIGHTS = (10.0, 0.1, 0.1)


def particle_task(dtype=torch.float32, device=None) -> Task:
    """The moving-goal variant ("Particle")."""
    return make_task("Particle", _TERMS, particle_residual, _WEIGHTS,
                     mocap={"goal": (0.0, 0.0, 0.0)},
                     transition_fn=lissajous_transition, dtype=dtype,
                     device=device)


def particle_fixed_task(goal=(0.25, 0.0), dtype=torch.float32,
                        device=None) -> Task:
    """The static-goal variant ("ParticleFixed")."""
    return make_task("ParticleFixed", _TERMS, particle_residual, _WEIGHTS,
                     mocap={"goal": (*goal, 0.0)}, dtype=dtype,
                     device=device)
