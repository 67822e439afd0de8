"""Quadruped Hill task, batched.

Counterpart of humanoid_mujoco_tpu/tasks/quadruped_hill.py (the
reference's "Quadruped Hill"): the A1 of tasks/quadruped.py walks a
waypoint circuit over a procedural Gaussian hill (peak 0.35 m, width
1.2 m) sampled into a 64 x 64 bilinear heightfield over ±4 m. Its
heightfield is over kernel B1's 1024-cell gate, so its step takes the
plain smooth stage and kernel B2 (physics/step.py, route "contact"),
as the JAX step does.

Residual (4 terms, quadratic norms):
    Stand     (1): (trunk z - mean foot z) - Height Goal   [weight 1]
    Body Pos. (3): trunk position - waypoint position      [weight 5]
    Body Rot. (9): R(trunk) - R(waypoint), flattened       [weight 1]
    Control  (12): ctrl - home pose                        [weight 0.25]

Transition: once the trunk is within 0.15 m of the waypoint and the
quaternion distance 1 - |q · q_goal| is within 0.15, the next waypoint
of the ring (wrapping) becomes the goal: its index is `task.mode`, its
pose is written into the "goal" mocap body.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.norms import NormType
from ..physics.math import quat_to_mat
from ..physics.model import Model, State
from ..physics.step import StepInfo
from .base import Task, TermSpec, make_task
from .quadruped import FEET, HOME_LEG, quadruped_model

_TOL = 0.15
_HILL_H = 0.35           # peak height, m
_HILL_SIGMA = 1.2        # Gaussian width, m
_N_WAYPOINTS = 8
_RING_R = 1.6


def hill_height_np(x, y, hill_h: float = _HILL_H):
    return hill_h * np.exp(-(x * x + y * y) / (2.0 * _HILL_SIGMA ** 2))


def quadruped_hill_model(dt: float = 0.004, dtype=torch.float32,
                         device=None, hill_h: float = _HILL_H) -> Model:
    """The A1 on the Gaussian hill; `hill_h` scales the peak."""
    n, half = 64, 4.0
    m = quadruped_model(dt=dt, dtype=dtype, device=device,
                        hfield_shape=(n, n), hfield_halfsize=(half, half))
    xs = np.linspace(-half, half, n)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    return m.replace(hfield_data=torch.tensor(
        hill_height_np(X, Y, hill_h), dtype=dtype, device=m.device))


def waypoints(dtype=torch.float32, device=None, n: int = _N_WAYPOINTS,
              ring_r: float = _RING_R, hill_h: float = _HILL_H):
    """The ring of poses around the hill, headings facing travel
    (counter-clockwise): positions (n, 3), quaternions (n, 4)."""
    pos, quat = [], []
    for i in range(n):
        th = 2.0 * np.pi * i / n
        x, y = ring_r * np.cos(th), ring_r * np.sin(th)
        pos.append([x, y, hill_height_np(x, y, hill_h) + 0.26])
        yaw = th + np.pi / 2.0
        quat.append([np.cos(yaw / 2.0), 0.0, 0.0, np.sin(yaw / 2.0)])
    return (torch.tensor(pos, dtype=dtype, device=device),
            torch.tensor(quat, dtype=dtype, device=device))


def hill_residual(m: Model, task: Task, state: State, info: StepInfo,
                  ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    trunk = s.body_id("trunk")
    foot_z = info.site_xpos[:, [s.site_id(f) for f in FEET], 2]
    stand = (info.xpos[:, trunk, 2] - foot_z.mean(dim=1)
             - task.params[0])[:, None]
    body_pos = info.xpos[:, trunk] - task.mocap_pos[0]
    body_rot = (quat_to_mat(info.xquat[:, trunk])
                - quat_to_mat(task.mocap_quat[0])).flatten(1)
    home = torch.tensor(np.tile(HOME_LEG, 4), dtype=ctrl.dtype,
                        device=ctrl.device)
    return torch.cat([stand, body_pos, body_rot, ctrl - home], dim=-1)


def _make_transition(n: int, ring_r: float, hill_h: float):
    def hill_transition(task: Task, m: Model, state: State,
                        info: StepInfo) -> Task:
        """Advance the waypoint of the (single) simulated state when it
        is within tolerance."""
        wpos, wquat = waypoints(task.mocap_pos.dtype,
                                task.mocap_pos.device, n, ring_r, hill_h)
        trunk = m.struct.body_id("trunk")
        pos_err = torch.linalg.vector_norm(info.xpos[0, trunk]
                                           - task.mocap_pos[0])
        geo = 1.0 - torch.abs(torch.dot(info.xquat[0, trunk],
                                        task.mocap_quat[0]))
        advance = (pos_err <= _TOL) & (geo <= _TOL)
        idx = torch.where(advance, (task.mode + 1) % n, task.mode)
        mpos, mquat = task.mocap_pos.clone(), task.mocap_quat.clone()
        mpos[0], mquat[0] = wpos[idx.long()], wquat[idx.long()]
        return dataclasses.replace(task, mode=idx, mocap_pos=mpos,
                                   mocap_quat=mquat)
    return hill_transition


_TERMS = (
    TermSpec("Stand", 1, NormType.QUADRATIC),
    TermSpec("Body Pos.", 3, NormType.QUADRATIC),
    TermSpec("Body Rot.", 9, NormType.QUADRATIC),
    TermSpec("Control", 12, NormType.QUADRATIC),
)
_WEIGHTS = (1.0, 5.0, 1.0, 0.25)


def quadruped_hill_task(dtype=torch.float32, device=None,
                        n_waypoints: int = _N_WAYPOINTS,
                        ring_r: float = _RING_R,
                        hill_h: float = _HILL_H) -> Task:
    """`n_waypoints`, `ring_r` and `hill_h` shape the circuit; pass the
    same `hill_h` to quadruped_hill_model."""
    wpos, wquat = waypoints(dtype, "cpu", n_waypoints, ring_r, hill_h)
    return make_task("Quadruped Hill", _TERMS, hill_residual, _WEIGHTS,
                     params=(0.25,), param_names=("Height Goal",),
                     transition_fn=_make_transition(n_waypoints, ring_r,
                                                    hill_h),
                     mode_names=tuple(f"Waypoint {i}"
                                      for i in range(n_waypoints)),
                     mocap={"goal": (tuple(wpos[0].tolist()),
                                     tuple(wquat[0].tolist()))},
                     dtype=dtype, device=device)
