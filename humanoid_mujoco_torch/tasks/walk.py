"""Humanoid Cap Walk task, batched.

Counterpart of humanoid_mujoco_tpu/tasks/walk.py: the upstream humanoid
Walk residual re-derived for the 12-DOF cap humanoid, on the stand
model (kernels B1 and B2), with two modes:

  mode 0 "Stand": the velocity target is zero, hold position;
  mode 1 "Walk":  track the commanded speed (parameter "Speed", 0.3
                  m/s) along the torso's heading.

Residual terms:
  Height    (1)  SmoothAbs p=0.1, w=100 : torso z - mean(feet z) - goal
  Balance   (1)  SmoothAbs p=0.1, w=50  : |capture point - feet centroid|_xy
  Upright   (2)  Quadratic,      w=10   : torso up-axis xy components
  Velocity  (2)  Quadratic,      w=10   : COM xy velocity - mode-gated target
  JointVel (12)  Quadratic,      w=0.01 : qvel[6:]
  Control  (12)  Cosh p=0.3,     w=0.025: ctrl
"""

from __future__ import annotations

import torch

from ..ops.norms import NormType
from ..physics.humanoid import JOINT_NAMES
from ..physics.math import quat_rotate, safe_norm
from ..physics.model import Model, State
from ..physics.step import StepInfo
from .base import Task, TermSpec, make_task
from .stand import DEFAULT_HEIGHT_GOAL, K_FALL_TIME


def walk_residual(m: Model, task: Task, state: State, info: StepInfo,
                  ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    torso = s.body_id("torso")
    f1 = info.site_xpos[:, s.site_id("right_bottom_foot")]
    f2 = info.site_xpos[:, s.site_id("left_bottom_foot")]
    height_err = (info.xpos[:, torso, 2] - 0.5 * (f1[:, 2] + f2[:, 2])
                  - task.params[0])
    com_vel = info.com_vel
    capture = info.xipos[:, torso, :2] + K_FALL_TIME * com_vel[:, :2]
    balance = safe_norm(0.5 * (f1[:, :2] + f2[:, :2]) - capture)
    q = info.xquat[:, torso]

    def axis(v):
        return quat_rotate(q, torch.tensor(v, dtype=q.dtype,
                                           device=q.device))
    upright = axis([0.0, 0.0, 1.0])[:, :2]
    fwd = axis([1.0, 0.0, 0.0])[:, :2]
    heading = fwd / safe_norm(fwd)[:, None]
    speed = torch.where(task.mode == 1, task.params[1],
                        torch.zeros_like(task.params[1]))
    return torch.cat([height_err[:, None], balance[:, None], upright,
                      com_vel[:, :2] - speed * heading,
                      state.qvel[:, 6:18], ctrl], dim=-1)


def walk_task(height_goal: float = DEFAULT_HEIGHT_GOAL, speed: float = 0.3,
              dtype=torch.float32, device=None) -> Task:
    terms = (
        TermSpec("Height", 1, NormType.SMOOTH_ABS, 1),
        TermSpec("Balance", 1, NormType.SMOOTH_ABS, 1),
        TermSpec("Upright", 2, NormType.QUADRATIC),
        TermSpec("Velocity", 2, NormType.QUADRATIC),
        TermSpec("Joint Vel.", len(JOINT_NAMES), NormType.QUADRATIC),
        TermSpec("Control", len(JOINT_NAMES), NormType.COSH, 1),
    )
    weights = (100.0, 50.0, 10.0, 10.0, 0.01, 0.025)
    norm_params = ((0.1, 0.0), (0.1, 0.0), (0.0, 0.0), (0.0, 0.0),
                   (0.0, 0.0), (0.3, 0.0))
    return make_task("Humanoid Cap Walk", terms, walk_residual, weights,
                     norm_params=norm_params, params=(height_goal, speed),
                     param_names=("Height Goal", "Speed"),
                     mode_names=("Stand", "Walk"), dtype=dtype,
                     device=device)
