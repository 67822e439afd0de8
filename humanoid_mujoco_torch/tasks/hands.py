"""Dexterous-hand cube reorientation: "Allegro" and "Shadow", batched.

Counterpart of humanoid_mujoco_tpu/tasks/hands.py (the reference's
mjpc/tasks/allegro and mjpc/tasks/shadow_reorient). The menagerie Wonik
Allegro (16 servo hinges; physics/allegro_data.py) and Shadow E3M5 (24;
physics/shadow_data.py, the four tendon-coupled distal pairs as
independently servoed joints) with a free reorientation cube. Sphere
proxies at every finger link's inertial centre and on the palm, paired
with the cube box (the Allegro's palm also as a box); the cube collides
with the floor. Allegro: nv 22, 74 slots, 32 limit rows; Shadow: nv 30,
58 slots, 48 limit rows; both keep their top-16 contact selection in
the step (nv·(nlim + 10 ncon) over 16384), so kernel B2 solves the 16
smallest gaps with their per-env chain mask.

Residual (6 terms):
    In Hand     (3): cube - grasp site              [L22(0.02, 2)]
    Orientation (3): goal quat (-) cube quat        [Quadratic]
    Cube Vel.   (3): cube linear velocity           [Quadratic, w 10]
    Actuator   (nu): actuator force                 [Quadratic]
    Grasp      (nj): hand qpos - grasp keyframe     [Quadratic]
    Joint Vel. (nj): hand qvel                      [Quadratic]
(the keyframe rounded to float32, as the JAX package stores it).

Transition: a fresh random goal orientation once the cube of the
(single) simulated state matches the current goal within 0.1 rad. One
difference from the JAX package: the quaternion is drawn from a
`torch.Generator` seeded from the sim tick (round(time * 1e3)), where
the JAX package folds the tick into `PRNGKey(17)`; until the goal is
matched the two agree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.norms import NormType
from ..physics.math import quat_sub
from ..physics.model import (ActuatorType, JointType, Model, ModelBuilder,
                             State)
from ..physics.step import StepInfo
from .base import Task, TermSpec, constant, make_task

# cube free-joint starting poses (task.xml keyframes)
_CUBE = {
    "allegro": dict(half=0.03, mass=0.122, pos=(0.2, 0.025, 0.075),
                    quat=(1.0, 0.0, 0.0, 0.0)),
    "shadow": dict(half=0.022, mass=0.126,
                   pos=(0.33326, -0.00362331, 0.0375343),
                   quat=(0.707635, 0.70405, 0.0500937, -0.0325089)),
}
# hand-joint keyframe poses (task.xml home/grasp keys, hand segment)
_KEY_HAND = {
    "allegro": (0, 0.58058, 0.701595, 0.538675, 0, 0.60767, 0.758085,
                0.741625, 0, 0.8876, 0.720425, 0.5848, 0.263, 0.32612,
                1.08493, 0.806715),
    "shadow": (0, -0.235248, -0.178041, 0.480484, 0.730515, 0.6284,
               -0.059347, 0.535468, 0.746225, 0.56556, -0.03491,
               0.544632, 0.53414, 0.793355, 0.384846, -0.254843,
               0.178072, 0.761935, 0.746225, -0.90042, 0.06721, 0.01047,
               0.6981, 0.4255),
}
_GOAL_START = (0.325, 0.17, 0.0475)     # goal display body pos
_SOLVED = 0.1                           # goal match, rad
_SEED = 17                              # the JAX package's PRNGKey(17)


def _load(hand: str):
    """The hand's data module (physics/allegro_data or shadow_data)."""
    if hand == "allegro":
        from ..physics import allegro_data as d
    else:
        from ..physics import shadow_data as d
    return d


def add_hand(b: ModelBuilder, hand: str):
    """The hand's bodies, servoed hinges and grasp site on builder b, and
    its sphere proxies (the palm's at the grasp site, radius 0.03; one
    of radius 0.011 at every other link's inertial centre; none touches
    the floor). Returns (body ids by name, sphere ids)."""
    d = _load(hand)
    ids = {}
    for name, parent, pos, quat, mass, ipos, iquat, diag in d.BODIES:
        pid = -1 if parent is None else ids[parent]
        ids[name] = b.add_body(name, pid, pos=pos, quat=quat, mass=mass,
                               ipos=ipos, iquat=iquat, inertia=diag)
    for (name, body, axis, pos, rng, damping, armature, kp, cr,
         fr) in d.JOINTS:
        j = b.add_joint(name, ids[body], JointType.HINGE, axis=axis,
                        pos=pos, jrange=rng,
                        limited=rng != (0.0, 0.0), damping=damping,
                        armature=armature)
        b.add_actuator(j, ActuatorType.POSITION, kp=kp, ctrlrange=cr,
                       forcerange=fr)
    palm = "palm" if hand == "allegro" else "rh_palm"
    grasp_pos = ((0.0, 0.0, 0.0) if hand == "allegro"
                 else (0.0, -0.035, 0.09))
    b.add_site("grasp_site", ids[palm], pos=grasp_pos)
    # hand proxies never touch the floor (the fixed base sits at the
    # plane; a floor slot there would inject huge static violations)
    sphs = [b.add_sphere(ids[palm], pos=grasp_pos, radius=0.03,
                         friction=1.0, floor=False)]
    for name, parent, pos, quat, mass, ipos, iquat, diag in d.BODIES:
        if name != palm:
            sphs.append(b.add_sphere(ids[name], pos=ipos, radius=0.011,
                                     friction=1.0, floor=False))
    return ids, sphs


def _hand_model(hand: str, dt: float, max_contacts: int, dtype,
                device) -> Model:
    b = ModelBuilder(dt=dt)
    b.has_floor = True
    b.max_contacts = max_contacts
    ids, sphs = add_hand(b, hand)
    # palm face as a box so the cube can rest on it (a single sphere
    # leaves fall-through gaps)
    palm_box = None
    if hand == "allegro":
        palm_box = b.add_box(ids["palm"], pos=(-0.009, 0.0, -0.04),
                             size=(0.0125, 0.05, 0.0555), friction=1.0,
                             floor=False)
    c = _CUBE[hand]
    cube = b.add_body("cube", -1, pos=c["pos"], mass=c["mass"],
                      inertia=(c["mass"] / 6 * (2 * c["half"] ** 2),) * 3)
    b.add_joint("cube_free", cube, JointType.FREE)
    box = b.add_box(cube, size=(c["half"],) * 3, friction=1.0,
                    floor=True)
    for s in sphs:
        b.add_pair_sb(s, box)
    if palm_box is not None:
        b.add_pair_bb(palm_box, box)
    return b.finalize(dtype=dtype, device=device)


def allegro_model(dt: float = 0.01, max_contacts: int = 16,
                  dtype=torch.float32, device=None) -> Model:
    return _hand_model("allegro", dt, max_contacts, dtype, device)


def shadow_model(dt: float = 0.01, max_contacts: int = 16,
                 dtype=torch.float32, device=None) -> Model:
    return _hand_model("shadow", dt, max_contacts, dtype, device)


def _home_qpos(hand: str, m: Model) -> torch.Tensor:
    key = np.asarray(_KEY_HAND[hand])
    c = _CUBE[hand]
    q = np.zeros(m.nq)
    q[:key.size] = key
    q[key.size:key.size + 3] = c["pos"]
    q[key.size + 3:key.size + 7] = c["quat"]
    return torch.tensor(q, dtype=m.dtype, device=m.device)


def allegro_home_qpos(m: Model) -> torch.Tensor:
    return _home_qpos("allegro", m)


def shadow_home_qpos(m: Model) -> torch.Tensor:
    return _home_qpos("shadow", m)


def _grasp_key(m: Model, hand: str, like: torch.Tensor) -> torch.Tensor:
    """The hand's grasp keyframe rounded to float32 (as the JAX residual
    holds it), in `like`'s dtype and device."""
    key = np.asarray(_KEY_HAND[hand], dtype=np.float32).astype(np.float64)
    return constant(m, f"{hand}_key", tuple(key), like)


def goal_error(m: Model, task: Task, info: StepInfo) -> torch.Tensor:
    """(B, 3) the goal orientation (normalized) minus the cube's, as a
    tangent vector."""
    cube = m.struct.body_id("cube")
    goal_q = task.mocap_quat[0]
    goal_q = goal_q / torch.linalg.vector_norm(goal_q)
    q = info.xquat[:, cube]
    return quat_sub(goal_q.expand_as(q), q)


def _make_residual(hand: str, nj: int):
    def residual(m: Model, task: Task, state: State, info: StepInfo,
                 ctrl: torch.Tensor) -> torch.Tensor:
        s = m.struct
        cube = s.body_id("cube")
        in_hand = info.xpos[:, cube] - info.site_xpos[
            :, s.site_id("grasp_site")]
        pose = state.qpos[:, :nj] - _grasp_key(m, hand, state.qpos)
        return torch.cat([in_hand, goal_error(m, task, info),
                          info.body_com_vel[:, cube], info.actuator_force,
                          pose, state.qvel[:, :nj]], dim=-1)
    return residual


def hands_transition(task: Task, m: Model, state: State,
                     info: StepInfo) -> Task:
    """A fresh random goal orientation once the cube of the (single)
    simulated state's first env matches the goal within 0.1 rad (the
    success side of the reference's cube-management transition). Reads
    the tick on the host to seed the draw."""
    err = torch.linalg.vector_norm(goal_error(m, task, info)[0])
    solved = (state.time[0] > 0) & (err < _SOLVED)
    tick = int(torch.round(state.time[0] * 1e3))
    gen = torch.Generator().manual_seed((_SEED << 32) + tick)
    q = torch.randn(4, generator=gen, dtype=torch.float64)
    q = (q / torch.linalg.vector_norm(q)).to(task.mocap_quat)
    mq = task.mocap_quat.clone()
    mq[0] = torch.where(solved, q, mq[0])
    return dataclasses.replace(task, mocap_quat=mq)


def _make_task(name: str, hand: str, nj: int, nu: int, pos_weight: float,
               orient_weight: float, act_weight: float,
               grasp_weight: float, jvel_weight: float, dtype, device):
    terms = (
        TermSpec("In Hand", 3, NormType.L22, num_params=2),
        TermSpec("Orientation", 3, NormType.QUADRATIC),
        TermSpec("Cube Vel.", 3, NormType.QUADRATIC),
        TermSpec("Actuator", nu, NormType.QUADRATIC),
        TermSpec("Grasp", nj, NormType.QUADRATIC),
        TermSpec("Joint Vel.", nj, NormType.QUADRATIC),
    )
    weights = (pos_weight, orient_weight, 10.0, act_weight,
               grasp_weight, jvel_weight)
    norm_params = ((0.02, 2.0),) + ((0.0, 0.0),) * 5
    return make_task(name, terms, _make_residual(hand, nj), weights,
                     norm_params=norm_params,
                     mocap={"goal": (_GOAL_START, (1.0, 0.0, 0.0, 0.0))},
                     transition_fn=hands_transition, dtype=dtype,
                     device=device)


def allegro_task(dtype=torch.float32, device=None) -> Task:
    # task.xml:51-56 weights
    return _make_task("Allegro", "allegro", 16, 16, 75.0, 7.5, 1.0,
                      0.1, 1.0e-3, dtype, device)


def shadow_task(dtype=torch.float32, device=None) -> Task:
    # task.xml:39-44 weights
    return _make_task("Shadow", "shadow", 24, 24, 20.0, 5.0, 0.1, 2.5,
                      1.0e-4, dtype, device)
