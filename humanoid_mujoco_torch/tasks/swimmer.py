"""Swimmer task, batched.

Counterpart of humanoid_mujoco_tpu/tasks/swimmer.py (the reference's
mjpc/tasks/swimmer): the dm_control 6-link planar swimmer in a
density-1000 medium with contact disabled. A head body with slide-x /
slide-y / hinge-z root joints and five chained segments on limited
z-hinges (range ±90°, stiffness 1e-3, armature 1e-6); each link a
0.01 kg inertia box of full dims (0.002, 0.1, 0.02) m, propelled by the
inertia-box fluid drag (physics/engine.fluid_force). Its step has no
contact slots and ten joint-limit rows, so it runs kernel B3.

Residual (7 terms):
    Control  (5): ctrl                      [quadratic, weight 0.1]
    Distance (2): nose xy - target xy       [L2(0.04),  weight 10]

Transition: when the nose is within 0.04 m of the target, the target
mocap body jumps to a uniform random point in [-0.8, 0.8]². One
difference from the JAX package: the new point is drawn from a
`torch.Generator` seeded from the sim tick (round(time * 1e3)), where
the JAX package folds the tick into `PRNGKey(24)`; the two give other
numbers. Until the target is reached the transition is deterministic
and the same in both.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.norms import NormType
from ..physics.model import ActuatorType, JointType, Model, ModelBuilder
from ..physics.model import State
from ..physics.step import StepInfo
from .base import Task, TermSpec, make_task

_N_SEGMENTS = 5
_LINK_MASS = 0.01
_DIMS = (0.002, 0.1, 0.02)   # full dims of each link's inertia box, m
_GOAL_TOL = 0.04
_RESPAWN = 0.8               # respawn box half-width, m
_SEED = 24                   # the JAX package's PRNGKey(24)


def _box_inertia(mass, dims):
    dx, dy, dz = dims
    return (mass / 12.0 * (dy * dy + dz * dz),
            mass / 12.0 * (dx * dx + dz * dz),
            mass / 12.0 * (dx * dx + dy * dy))


def swimmer_model(dt: float = 0.01, dtype=torch.float32,
                  device=None) -> Model:
    """6-link planar swimmer in a density-1000 medium, contact disabled."""
    b = ModelBuilder(dt=dt)
    b.has_floor = False
    b.fluid_density = 1000.0
    b.limit_solref = (0.05, 0.3)
    b.limit_solimp = (0.0, 0.8, 0.1)

    inertia = _box_inertia(_LINK_MASS, _DIMS)
    head = b.add_body("head", -1, pos=(0.0, 0.0, 0.05), mass=_LINK_MASS,
                      inertia=inertia)
    b.add_joint("rootx", head, JointType.SLIDE, axis=(1, 0, 0))
    b.add_joint("rooty", head, JointType.SLIDE, axis=(0, 1, 0))
    b.add_joint("rootz", head, JointType.HINGE, axis=(0, 0, 1),
                pos=(0.0, -0.05, 0.0))
    b.add_site("nose", head, pos=(0.0, -0.06, 0.0))
    b.add_site("head", head, pos=(0.0, 0.0, 0.0))

    parent = head
    lim = math.pi / 2.0
    for i in range(_N_SEGMENTS):
        seg = b.add_body(f"segment_{i}", parent, pos=(0.0, 0.1, 0.0),
                         mass=_LINK_MASS, inertia=inertia)
        j = b.add_joint(f"joint_{i}", seg, JointType.HINGE,
                        axis=(0, 0, 1), pos=(0.0, -0.05, 0.0),
                        jrange=(-lim, lim), limited=True,
                        stiffness=1e-3, armature=1e-6)
        b.add_actuator(j, ActuatorType.MOTOR, gear=2e-3,
                       ctrlrange=(-1.0, 1.0), forcerange=(-1.0, 1.0))
        parent = seg
    return b.finalize(dtype=dtype, device=device)


def _nose_xy(m: Model, info: StepInfo) -> torch.Tensor:
    return info.site_xpos[:, m.struct.site_id("nose"), :2]


def swimmer_residual(m: Model, task: Task, state: State, info: StepInfo,
                     ctrl: torch.Tensor) -> torch.Tensor:
    return torch.cat([ctrl, _nose_xy(m, info) - task.mocap_pos[0, :2]],
                     dim=-1)


def swimmer_transition(task: Task, m: Model, state: State,
                       info: StepInfo) -> Task:
    """The target respawns uniformly in [-0.8, 0.8]² once the nose of
    the (single) simulated state is within 0.04 m of it. Reads the tick
    on the host to seed the draw."""
    cur = task.mocap_pos[0]
    reached = torch.linalg.vector_norm(cur[:2] - _nose_xy(m, info)[0]) \
        < _GOAL_TOL
    tick = int(torch.round(state.time[0] * 1e3))
    gen = torch.Generator().manual_seed((_SEED << 32) + tick)
    xy = (2.0 * torch.rand(2, generator=gen, dtype=torch.float64) - 1.0) \
        * _RESPAWN
    new = torch.cat([xy.to(cur.dtype).to(cur.device), cur[2:]])
    pos = task.mocap_pos.clone()
    pos[0] = torch.where(reached, new, cur)
    return dataclasses.replace(task, mocap_pos=pos)


_TERMS = (
    TermSpec("Control", _N_SEGMENTS, NormType.QUADRATIC),
    TermSpec("Distance", 2, NormType.L2, num_params=1),
)
_WEIGHTS = (0.1, 10.0)
_NORM_PARAMS = ((0.0, 0.0), (_GOAL_TOL, 0.0))


def swimmer_task(target=(1.0, 1.0), dtype=torch.float32,
                 device=None) -> Task:
    return make_task("Swimmer", _TERMS, swimmer_residual, _WEIGHTS,
                     norm_params=_NORM_PARAMS,
                     mocap={"target": (*target, 0.05)},
                     transition_fn=swimmer_transition, dtype=dtype,
                     device=device)
