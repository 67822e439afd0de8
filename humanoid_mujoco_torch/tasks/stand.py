"""Humanoid Cap Stand task, batched.

Counterpart of humanoid_mujoco_tpu/tasks/stand.py (the reference's
mjpc/tasks/humanoid_cap/stand): residual terms

  0 Height  (1)  SmoothAbs p=0.1, w=100 : torso z - mean(feet z) - goal
  1 Balance (1)  SmoothAbs p=0.1, w=50  : |capture point - feet centroid|_xy
  2 CoM Vel (2)  Quadratic,      w=10   : robot COM xy velocity
  3 JointVel(12) Quadratic,      w=0.01 : qvel[6:]
  4 Control (12) Cosh p=0.3,     w=0.025: ctrl

with capture point = torso COM + 0.2 s * robot COM velocity.
"""

from __future__ import annotations

import torch

from ..ops.norms import NormType
from ..physics.humanoid import JOINT_NAMES
from ..physics.math import safe_norm
from ..physics.model import Model, State
from ..physics.step import StepInfo
from .base import Task, TermSpec, make_task

K_FALL_TIME = 0.2
DEFAULT_HEIGHT_GOAL = 0.425


def stand_residual(m: Model, task: Task, state: State, info: StepInfo,
                   ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    torso = s.body_id("torso")
    f1 = info.site_xpos[:, s.site_id("right_bottom_foot")]
    f2 = info.site_xpos[:, s.site_id("left_bottom_foot")]
    height_err = (info.xpos[:, torso, 2] - 0.5 * (f1[:, 2] + f2[:, 2])
                  - task.params[0])
    capture = info.xipos[:, torso, :2] + K_FALL_TIME * info.com_vel[:, :2]
    balance = safe_norm(0.5 * (f1[:, :2] + f2[:, :2]) - capture)
    return torch.cat([height_err[:, None], balance[:, None],
                      info.com_vel[:, :2], state.qvel[:, 6:18], ctrl],
                     dim=-1)


def stand_task(height_goal: float = DEFAULT_HEIGHT_GOAL, risk: float = 0.0,
               dtype=torch.float32, device=None) -> Task:
    terms = (
        TermSpec("Height", 1, NormType.SMOOTH_ABS, 1),
        TermSpec("Balance", 1, NormType.SMOOTH_ABS, 1),
        TermSpec("CoM Vel.", 2, NormType.QUADRATIC),
        TermSpec("Joint Vel.", len(JOINT_NAMES), NormType.QUADRATIC),
        TermSpec("Control", len(JOINT_NAMES), NormType.COSH, 1),
    )
    weights = (100.0, 50.0, 10.0, 0.01, 0.025)
    norm_params = ((0.1, 0.0), (0.1, 0.0), (0.0, 0.0), (0.0, 0.0),
                   (0.3, 0.0))
    return make_task("Humanoid Cap Stand", terms, stand_residual, weights,
                     norm_params=norm_params, params=(height_goal,),
                     param_names=("Height Goal",), risk=risk, dtype=dtype,
                     device=device)
