"""Quadrotor racing task, batched.

Counterpart of humanoid_mujoco_tpu/tasks/quadrotor.py
(mjpc/tasks/quadrotor): the Skydio X2, one free body with four rotors
as site actuators of gear (0, 0, 1, 0, 0, ±0.0201) (thrust along body z
at each rotor site and a yaw drag torque, ctrlrange [0, 13] N), and four
landing-gear spheres (4 floor slots, `max_contacts` 0). Its step takes
the "contact" route (nv 6, no limit rows).

Residual: Position (3) body - goal, Lin. Vel (3), Ang. Vel (3),
Control (4) ctrl - hover thrust; quadratic, weights 25 / 1.25 / 1.25 /
1e-3.

Transition: a 12-waypoint circuit; within 0.5 m of the goal (the
single simulated state's first env decides) the mode advances to the
next waypoint, mod 12.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.norms import NormType
from ..physics.model import JointType, Model, ModelBuilder, State
from ..physics.step import StepInfo
from .base import Task, TermSpec, make_task

_WAYPOINTS = (
    (1.2, 0.0, 0.75), (2.3, 0.6, 1.5), (2.7, 0.95, 1.5),
    (4.6, 0.4, 0.75), (5.0, -1.8, 0.75), (3.4, -2.5, 0.75),
    (2.5, -2.25, 1.45), (2.5, -2.25, 2.25), (1.5, -1.75, 1.85),
    (1.05, -1.75, 1.3), (0.1, -1.4, 0.75), (0.0, 0.0, 0.75),
)
_MASS = 1.325            # 4 x 0.25 rotors + 0.325 core
_GRAVITY = 9.81
_YAW_DRAG = 0.0201       # rotor torque / thrust
_ROTORS = ((-0.14, -0.18, 0.05, -1.0), (-0.14, 0.18, 0.05, 1.0),
           (0.14, 0.18, 0.08, 1.0), (0.14, -0.18, 0.08, -1.0))


def quadrotor_model(dt: float = 0.01, dtype=torch.float32, device=None
                    ) -> Model:
    b = ModelBuilder(dt=dt)
    b.has_floor = True
    body = b.add_body("x2", -1, pos=(0.0, 0.0, 0.1), mass=_MASS,
                      ipos=(0.0, 0.0, 0.054), inertia=(0.037, 0.025, 0.060))
    b.add_joint("root", body, JointType.FREE)
    for i, (x, y, z, s) in enumerate(_ROTORS):
        site = b.add_site(f"thrust{i + 1}", body, pos=(x, y, z))
        b.add_thrust(site, gear=(0.0, 0.0, 1.0, 0.0, 0.0, s * _YAW_DRAG),
                     ctrlrange=(0.0, 13.0), forcerange=(0.0, 13.0))
    for sx in (-0.1, 0.1):
        for sy in (-0.1, 0.1):
            b.add_sphere(body, pos=(sx, sy, 0.0), radius=0.02, friction=0.7)
    return b.finalize(dtype=dtype, device=device)


def quadrotor_home_qpos(m: Model) -> torch.Tensor:
    q = torch.zeros(m.nq, dtype=m.dtype, device=m.device)
    q[2], q[3] = 0.3, 1.0
    return q


def hover_ctrl(m: Model) -> float:
    """The thrust per rotor that holds the craft's weight."""
    return _MASS * _GRAVITY / m.nu


def _quadrotor_residual(m: Model, task: Task, state: State, info: StepInfo,
                        ctrl: torch.Tensor) -> torch.Tensor:
    pos = info.xpos[:, m.struct.body_id("x2")]
    return torch.cat([pos - task.mocap_pos[0], state.qvel[:, 0:3],
                      state.qvel[:, 3:6], ctrl - hover_ctrl(m)], dim=-1)


def _waypoint_transition(task: Task, m: Model, state: State,
                         info: StepInfo) -> Task:
    wps = torch.tensor(_WAYPOINTS, dtype=task.mocap_pos.dtype,
                       device=task.mocap_pos.device)
    err = info.xpos[0, m.struct.body_id("x2")] - task.mocap_pos[0]
    reached = torch.linalg.vector_norm(err) <= 0.5
    mode = torch.where(reached, (task.mode + 1) % len(_WAYPOINTS),
                       task.mode)
    pos = task.mocap_pos.clone()
    pos[0] = wps[mode.long()]
    return dataclasses.replace(task, mode=mode, mocap_pos=pos)


_TERMS = (
    TermSpec("Position", 3, NormType.QUADRATIC),
    TermSpec("Lin. Vel.", 3, NormType.QUADRATIC),
    TermSpec("Ang. Vel.", 3, NormType.QUADRATIC),
    TermSpec("Control", 4, NormType.QUADRATIC),
)
_WEIGHTS = (25.0, 1.25, 1.25, 1.0e-3)


def quadrotor_task(dtype=torch.float32, device=None) -> Task:
    return make_task(
        "Quadrotor", _TERMS, _quadrotor_residual, _WEIGHTS,
        mocap={"goal": _WAYPOINTS[0]}, transition_fn=_waypoint_transition,
        mode_names=tuple(["Loop"] + [f"Stage{i + 1}" for i in range(11)]),
        dtype=dtype, device=device)
