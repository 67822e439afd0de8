"""Cartpole swing-up task, batched.

Counterpart of humanoid_mujoco_tpu/tasks/cartpole.py (the reference's
mjpc/tasks/cartpole): a 1 kg cart on a ±1.8 m slide rail carrying a
0.1 kg, 1 m pole on a passive hinge, one motor (gear 10) on the cart,
contact disabled. Its step has no contact slots and the rail's two
limit rows, so it runs kernel B3 (nv 2, 2 rows).

Residual (4 terms):
    Vertical (1): cos(pole angle) - 1      [SmoothAbs(0.01), weight 10]
    Centered (1): cart x - Goal            [SmoothAbs(0.1),  weight 10]
    Velocity (1): pole angular velocity    [quadratic,       weight 0.1]
    Control  (1): motor effort             [quadratic,       weight 0.1]

The home keyframe hangs the pole down (qpos = (0, 3.142)).
"""

from __future__ import annotations

import torch

from ..ops.norms import NormType
from ..physics.model import (ActuatorType, JointType, Model, ModelBuilder,
                             State)
from ..physics.step import StepInfo
from .base import Task, TermSpec, make_task


def cartpole_model(dt: float = 0.01, dtype=torch.float32,
                   device=None) -> Model:
    """Cart (1 kg box on a ±1.8 m slide) + pole (0.1 kg, 1 m, hinge
    about y), motor gear 10 on the slide."""
    b = ModelBuilder(dt=dt)
    b.has_floor = False
    cart = b.add_body("cart", -1, pos=(0.0, 0.0, 1.0), mass=1.0,
                      inertia=(0.0108, 0.0167, 0.0208))
    slider = b.add_joint("slider", cart, JointType.SLIDE, axis=(1, 0, 0),
                         jrange=(-1.8, 1.8), limited=True, damping=1e-4)
    pole = b.add_body("pole", cart, pos=(0.0, 0.0, 0.0), mass=0.1,
                      ipos=(0.0, 0.0, 0.5),
                      inertia=(8.4e-3, 8.4e-3, 1.0e-4))
    b.add_joint("hinge", pole, JointType.HINGE, axis=(0, 1, 0),
                damping=1e-4)
    b.add_site("tip", pole, pos=(0.0, 0.0, 1.0))
    b.add_actuator(slider, ActuatorType.MOTOR, gear=10.0,
                   ctrlrange=(-1.0, 1.0), forcerange=(-10.0, 10.0))
    return b.finalize(dtype=dtype, device=device)


def cartpole_home_qpos(m: Model) -> torch.Tensor:
    """The pole hanging down (keyframe qpos = (0, 3.142))."""
    q = torch.zeros(m.nq, dtype=m.dtype, device=m.device)
    q[1] = 3.142
    return q


def cartpole_residual(m: Model, task: Task, state: State, info: StepInfo,
                      ctrl: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.cos(state.qpos[:, 1:2]) - 1.0,
                      state.qpos[:, 0:1] - task.params[0],
                      state.qvel[:, 1:2], ctrl], dim=-1)


_TERMS = (
    TermSpec("Vertical", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Centered", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Velocity", 1, NormType.QUADRATIC),
    TermSpec("Control", 1, NormType.QUADRATIC),
)
_WEIGHTS = (10.0, 10.0, 0.1, 0.1)
_NORM_PARAMS = ((0.01, 0.0), (0.1, 0.0), (0.0, 0.0), (0.0, 0.0))


def cartpole_task(goal: float = 0.0, dtype=torch.float32,
                  device=None) -> Task:
    return make_task("Cartpole", _TERMS, cartpole_residual, _WEIGHTS,
                     norm_params=_NORM_PARAMS, params=(goal,),
                     param_names=("Goal",), dtype=dtype, device=device)
