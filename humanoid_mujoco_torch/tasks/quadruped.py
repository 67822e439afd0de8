"""Quadruped Flat locomotion task, batched.

Counterpart of humanoid_mujoco_tpu/tasks/quadruped.py (the reference's
mjpc/tasks/quadruped, "Quadruped Flat"): the Unitree A1, its trunk on a
free joint and 4 legs x (abduction, hip, knee) on position servos (kp
50, forcerange ±33.5), r 0.02 foot spheres and four trunk crash spheres
(8 slots). Joint zero references follow a1.xml (ref 0) with the
standing pose in the home keyframe (legs 0 / 0.9 / -1.8, trunk z 0.27).
Its step runs kernels B1 and B2 (nv 18, 8 slots, 24 limit rows).

Residual (8 terms):
    Upright     (3): trunk up-axis z - 1, 0, 0     [SmoothAbs(0.05)]
    Height      (1): (trunk COM z - mean foot z) - 0.25  [SmoothAbs(0.04)]
    Position    (3): head site - goal (z term 0)   [L2(0.1)]
    Gait        (4): swing feet: foot z - (floor + r + step height)
                                                   [SmoothAbs(0.03)]
    Balance     (2): capture point - mean foot xy  [L2(0.1)]
    Effort     (12): 2e-2 x actuator torques       [quadratic]
    Posture    (12): (qpos - home) x joint gains (2, 1, 1)   [quadratic]
    Orientation (2): heading - (cos, sin)(Heading) [quadratic]

Modes are the gaits Stand | Walk | Trot | Canter | Gallop. The
transition writes the active gait's cadence, amplitude and duty ratio
into the parameters and its balance, upright and height weights into
the weights; the gait phase advances at 2π · cadence.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.norms import NormType
from ..physics.model import (ActuatorType, JointType, Model, ModelBuilder,
                             State)
from ..physics.step import StepInfo
from .base import Task, TermSpec, make_task

_HEIGHT_GOAL = 0.25
_FOOT_RADIUS = 0.02
_POSTURE_GAIN = (2.0, 1.0, 1.0)

# per gait: the feet's phase offsets, and [duty ratio, cadence Hz,
# amplitude m, balance weight, upright weight, height weight]
GAITS = ("Stand", "Walk", "Trot", "Canter", "Gallop")
_GAIT_PHASE = np.array([            # FL    HL    FR    HR
    [0.00, 0.00, 0.00, 0.00],
    [0.00, 0.75, 0.50, 0.25],
    [0.00, 0.50, 0.50, 0.00],
    [0.00, 0.33, 0.33, 0.66],
    [0.00, 0.40, 0.05, 0.35],
])
_GAIT_PARAM = np.array([
    [1.00, 1.0, 0.00, 0.00, 1.0, 1.0],
    [0.75, 1.0, 0.03, 0.00, 1.0, 1.0],
    [0.45, 2.0, 0.03, 0.20, 1.0, 1.0],
    [0.40, 4.0, 0.05, 0.03, 0.5, 0.2],
    [0.30, 3.5, 0.10, 0.03, 0.2, 0.1],
])

FEET = ("FL", "HL", "FR", "HR")
HOME_LEG = (0.0, 0.9, -1.8)         # abduction / hip / knee

# leg attachment: (name, hip x, hip y sign)
_LEGS = (("FL", 0.183, 1.0), ("HL", -0.183, 1.0),
         ("FR", 0.183, -1.0), ("HR", -0.183, -1.0))


def quadruped_model(dt: float = 0.004, dtype=torch.float32, device=None,
                    hfield_shape=None, hfield_halfsize=None) -> Model:
    """The Unitree A1 (a1_modified.xml numbers, ref 0 joints).
    `hfield_shape` / `hfield_halfsize` size the floor heightfield (the
    Hill variant's terrain); the shape is structure."""
    b = ModelBuilder(dt=dt)
    b.has_floor = True
    if hfield_shape is not None:
        b.hfield_shape = hfield_shape
    if hfield_halfsize is not None:
        b.hfield_halfsize = hfield_halfsize

    trunk = b.add_body("trunk", -1, pos=(0.0, 0.0, 0.27), mass=4.713,
                       ipos=(0.0, 0.0041, -0.0005),
                       inertia=(0.0158533, 0.0377999, 0.0456542))
    b.add_joint("root", trunk, JointType.FREE)
    b.add_site("head", trunk, pos=(0.3, 0.0, 0.0))
    # trunk crash spheres (collision box 0.125 x 0.04 x 0.057)
    for sx in (-0.12, 0.12):
        for sy in (-0.04, 0.04):
            b.add_sphere(trunk, pos=(sx, sy, 0.0), radius=0.055,
                         friction=0.6)

    for name, hx, ys in _LEGS:
        hip = b.add_body(f"{name}_hip", trunk, pos=(hx, ys * 0.047, 0.0),
                         mass=0.696,
                         ipos=(-0.003311 * np.sign(hx), ys * 0.000635, 0.0),
                         inertia=(0.000807752, 0.00055293, 0.000468983))
        abd = b.add_joint(f"{name}_hip_joint", hip, JointType.HINGE,
                          axis=(1, 0, 0), jrange=(-0.802851, 0.802851),
                          limited=True, damping=1.0, armature=0.01)
        thigh = b.add_body(f"{name}_thigh", hip,
                           pos=(0.0, ys * 0.08505, 0.0), mass=1.013,
                           ipos=(-0.003237, -ys * 0.022327, -0.027326),
                           inertia=(0.00555739, 0.00513936, 0.00133944))
        hipj = b.add_joint(f"{name}_thigh_joint", thigh, JointType.HINGE,
                           axis=(0, 1, 0), jrange=(-1.0472, 4.18879),
                           limited=True, damping=2.0, armature=0.01)
        calf = b.add_body(f"{name}_calf", thigh, pos=(0.0, 0.0, -0.2),
                          mass=0.226, ipos=(0.00472659, 0.0, -0.131975),
                          inertia=(0.00340344, 0.00339393, 3.54834e-05))
        knee = b.add_joint(f"{name}_calf_joint", calf, JointType.HINGE,
                           axis=(0, 1, 0), jrange=(-2.69653, -0.916298),
                           limited=True, damping=2.0, armature=0.01)
        b.add_sphere(calf, pos=(0.0, 0.0, -0.2), radius=_FOOT_RADIUS,
                     friction=0.6)
        b.add_site(name, calf, pos=(0.0, 0.0, -0.2))
        for j, rng in ((abd, (-0.802851, 0.802851)),
                       (hipj, (-1.0472, 4.18879)),
                       (knee, (-2.69653, -0.916298))):
            b.add_actuator(j, ActuatorType.POSITION, gear=1.0, kp=50.0,
                           kv=0.0, ctrlrange=rng,
                           forcerange=(-33.5, 33.5))
    return b.finalize(dtype=dtype, device=device)


def quadruped_home_qpos(m: Model) -> torch.Tensor:
    """The standing keyframe: trunk z 0.27, legs 0 / 0.9 / -1.8."""
    q = np.zeros(m.nq)
    q[2] = 0.27
    q[3] = 1.0
    q[7:] = np.tile(HOME_LEG, 4)
    return torch.tensor(q, dtype=m.dtype, device=m.device)


def home_ctrl(m: Model) -> torch.Tensor:
    """The servo targets of the standing keyframe (nu,)."""
    return torch.tensor(np.tile(HOME_LEG, 4), dtype=m.dtype,
                        device=m.device)


def _step_height(phase: torch.Tensor, footphase: torch.Tensor,
                 duty: torch.Tensor) -> torch.Tensor:
    """Swing-height profile: a cosine bump over the swing share of the
    cycle, 0 in stance."""
    angle = torch.remainder(phase + math.pi - footphase,
                            2 * math.pi) - math.pi
    angle = angle * 0.5 / torch.clamp(1.0 - duty, min=1e-6)
    value = torch.cos(torch.clamp(angle, -math.pi / 2, math.pi / 2))
    value = torch.where(duty < 1.0, value, torch.zeros_like(value))
    return torch.where(value.abs() < 1e-6, torch.zeros_like(value), value)


def quat_to_up_and_heading(q: torch.Tensor):
    """(R[2, 2] (...), normalized R[:2, 0] (..., 2)) of unit quaternions
    q (..., 4): the trunk's up-axis z and its heading."""
    w, x, y, z = q.unbind(-1)
    up_z = 1 - 2 * (x * x + y * y)
    fx = 1 - 2 * (y * y + z * z)
    fy = 2 * (x * y + w * z)
    n = torch.clamp(torch.sqrt(fx * fx + fy * fy), min=1e-9)
    return up_z, torch.stack([fx / n, fy / n], dim=-1)


def quadruped_residual(m: Model, task: Task, state: State, info: StepInfo,
                       ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    dtype, dev = state.qpos.dtype, state.qpos.device
    trunk = s.body_id("trunk")
    up_z, heading = quat_to_up_and_heading(info.xquat[:, trunk])
    zero = torch.zeros_like(up_z)
    foot_pos = info.site_xpos[:, [s.site_id(f) for f in FEET]]  # (B, 4, 3)
    avg_foot = foot_pos.mean(dim=1)
    goal = task.mocap_pos[0]
    upright = torch.stack([up_z - 1.0, zero, zero], dim=-1)
    height = (info.xipos[:, trunk, 2] - avg_foot[:, 2]
              - _HEIGHT_GOAL)[:, None]
    head = info.site_xpos[:, s.site_id("head")]
    position = torch.stack([head[:, 0] - goal[0], head[:, 1] - goal[1],
                            zero], dim=-1)
    # gait: cadence, amplitude and duty live in params (synced per gait)
    cadence, amplitude, duty = task.params[0], task.params[1], task.params[2]
    phase = 2 * math.pi * cadence * state.time
    footphase = 2 * math.pi * torch.tensor(
        _GAIT_PHASE, dtype=dtype, device=dev)[task.mode.long()]
    step = amplitude * _step_height(phase[:, None], footphase, duty)
    target_z = m.floor_z + _FOOT_RADIUS + step
    gait = torch.where(step != 0.0, foot_pos[..., 2] - target_z,
                       torch.zeros_like(step))
    fall_time = math.sqrt(2 * _HEIGHT_GOAL / 9.81)
    balance = (info.com[:, :2] + fall_time * info.com_vel[:, :2]
               - avg_foot[:, :2])
    effort = 2e-2 * info.actuator_force
    gains = torch.tensor(np.tile(_POSTURE_GAIN, 4), dtype=dtype, device=dev)
    home = torch.tensor(np.tile(HOME_LEG, 4), dtype=dtype, device=dev)
    posture = (state.qpos[:, 7:] - home) * gains
    hgoal = task.params[3]
    orientation = torch.stack([heading[:, 0] - torch.cos(hgoal),
                               heading[:, 1] - torch.sin(hgoal)], dim=-1)
    return torch.cat([upright, height, position, gait, balance, effort,
                      posture, orientation], dim=-1)


def gait_transition(task: Task, m: Model, state: State,
                    info: StepInfo) -> Task:
    """The active gait's cadence, amplitude and duty into the
    parameters, its balance, upright and height weights into the
    weights."""
    gp = torch.tensor(_GAIT_PARAM, dtype=task.params.dtype,
                      device=task.params.device)[task.mode.long()]
    params = task.params.clone()
    params[0], params[1], params[2] = gp[1], gp[2], gp[0]
    # term order: Upright (0), Height (1), Position (2), Gait (3),
    # Balance (4), ...
    weights = task.weights.clone()
    weights[4], weights[0], weights[1] = gp[3], gp[4], gp[5]
    return dataclasses.replace(task, params=params, weights=weights)


_TERMS = (
    TermSpec("Upright", 3, NormType.SMOOTH_ABS, 1),
    TermSpec("Height", 1, NormType.SMOOTH_ABS, 1),
    TermSpec("Position", 3, NormType.L2, 1),
    TermSpec("Gait", 4, NormType.SMOOTH_ABS, 1),
    TermSpec("Balance", 2, NormType.L2, 1),
    TermSpec("Effort", 12, NormType.QUADRATIC),
    TermSpec("Posture", 12, NormType.QUADRATIC),
    TermSpec("Orientation", 2, NormType.QUADRATIC),
)
_WEIGHTS = (1.0, 1.0, 0.2, 2.0, 0.2, 0.03, 0.02, 0.0)
_NORM_PARAMS = ((0.05, 0), (0.04, 0), (0.1, 0), (0.03, 0), (0.1, 0),
                (0, 0), (0, 0), (0, 0))


def quadruped_task(goal=(1.0, 0.0, 0.26), gait: str = "Stand",
                   dtype=torch.float32, device=None) -> Task:
    t = make_task(
        "Quadruped Flat", _TERMS, quadruped_residual, _WEIGHTS,
        norm_params=_NORM_PARAMS,
        params=(_GAIT_PARAM[0][1], _GAIT_PARAM[0][2], _GAIT_PARAM[0][0],
                0.0),
        param_names=("Cadence", "Amplitude", "Duty ratio", "Heading"),
        mocap={"goal": tuple(goal)}, transition_fn=gait_transition,
        mode_names=GAITS, dtype=dtype, device=device)
    return t.set_mode(gait) if gait != "Stand" else t
