"""Humanoid Interact: the 21-DOF humanoid and an armchair, batched.

Counterpart of humanoid_mujoco_tpu/tasks/interact.py (the reference's
mjpc/tasks/humanoid/interact). The upstream humanoid
(physics/humanoid_upstream.py) with the armchair scene's seat, base and
back boxes on a fixed body, every capsule and sphere of the humanoid
paired with each of them: nv 27, 116 slots, 46 limit rows, dt 0.005;
its step keeps the top-24 contact selection (nv·(nlim + 10 ncon) over
16384), so kernel B2 solves the 24 smallest gaps with their per-env
chain mask.

The reference's "contact keyframes" (up to 5 body-point pairs the
humanoid should bring together, e.g. pelvis onto the seat) are task
state: `params` holds, per pair, an active flag, the two body indices
and the two local points (`set_contact_pair` authors one).

Residual (68): Torso / Pelvis / RFoot / LFoot Up (1 each) |up_z - 1|,
Head and Torso Height (1 each) |z - param|, Knee Feet XY and COM Feet
XY (1 each), Facing Dir (1) [SmoothAbs(0.1)]; CoM Vel. (2), Joint Vel.
(21) [Quadratic]; Control (21) [Cosh(0.05)]; Contact (15) per pair
|p1 - p2| [SmoothAbs(0.1)].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.norms import NormType
from ..physics.humanoid_upstream import build_humanoid21, stand_qpos
from ..physics.math import quat_rotate
from ..physics.model import Model, State
from ..physics.step import StepInfo
from .base import Task, TermSpec, constant, make_task

N_CONTACT_PAIRS = 5       # kNumberOfContactPairsInteract

# armchair scene (interact/scenes/armchair.xml): (pos, quat, size)
_CHAIR_POS = (-0.35, 0.0, 0.2)
_CHAIR_BOXES = (
    ((0.0, 0.0, 0.12), (1, 0, 0, 0), (0.25, 0.35, 0.05)),      # seat
    ((-0.12, 0.0, -0.05), (1, 0, 0, 0), (0.30, 0.35, 0.15)),   # base
    ((-0.35, 0.0, 0.35), (0.984, 0, -0.178, 0), (0.05, 0.35, 0.3)),
    ((-0.12, 0.37, 0.1), (1, 0, 0, 0), (0.3, 0.05, 0.3)),
    ((-0.12, -0.37, 0.1), (1, 0, 0, 0), (0.3, 0.05, 0.3)),
)


def interact_model(dt: float = 0.005, max_contacts: int = 24,
                   dtype=torch.float32, device=None) -> Model:
    """The 21-DOF humanoid and the armchair (fixed body); the humanoid's
    capsules and spheres gain pairs against the seat, base and back."""

    def extend(b, body_ids):
        chair = b.add_body("chair", -1, pos=_CHAIR_POS, mass=35.0,
                           inertia=(1.0, 1.0, 1.0))
        boxes = [b.add_box(chair, pos=p, quat=q, size=s, friction=1.0,
                           floor=False)
                 for p, q, s in _CHAIR_BOXES[:3]]   # seat/base/back
        for i in range(len(b._caps)):
            for bx in boxes:
                b.add_pair_cb(i, bx)
        for i in range(len(b._sphs)):
            for bx in boxes:
                b.add_pair_sb(i, bx)

    return build_humanoid21(dtype=dtype, dt=dt, max_contacts=max_contacts,
                            extend=extend, device=device)


def interact_home_qpos(m: Model) -> torch.Tensor:
    return stand_qpos(m)


# params layout: [head_h, torso_h, facing_x, facing_y, facing_on,
#                 then per pair i: (active, body1, body2,
#                                   p1x, p1y, p1z, p2x, p2y, p2z)]
_PAIR_STRIDE = 9
_PAIR_OFF = 5


def _param_names():
    names = ["Head Height", "Torso Height", "Facing X", "Facing Y",
             "Facing On"]
    for i in range(N_CONTACT_PAIRS):
        names += [f"P{i} Active", f"P{i} Body1", f"P{i} Body2",
                  f"P{i} X1", f"P{i} Y1", f"P{i} Z1",
                  f"P{i} X2", f"P{i} Y2", f"P{i} Z2"]
    return tuple(names)


def _interact_residual(m: Model, task: Task, state: State, info: StepInfo,
                       ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    p = task.params
    e_z = constant(m, "e_z", (0.0, 0.0, 1.0), state.qpos)
    e_x = constant(m, "e_x", (1.0, 0.0, 0.0), state.qpos)

    def up_z(body_name):
        return quat_rotate(info.xquat[:, s.body_id(body_name)], e_z)[:, 2]

    ups = torch.stack([torch.abs(up_z(b) - 1.0) for b in
                       ("torso", "pelvis", "foot_right", "foot_left")],
                      dim=-1)
    head = info.site_xpos[:, s.site_id("tracking[head]")]
    torso = info.xpos[:, s.body_id("torso")]
    head_h = torch.abs(head[:, 2] - p[0])
    torso_h = torch.abs(torso[:, 2] - p[1])

    def site_xy(name):
        return info.site_xpos[:, s.site_id(name), :2]

    feet = 0.5 * (site_xy("foot_right") + site_xy("foot_left"))
    knees = 0.5 * (site_xy("tracking[rknee]") + site_xy("tracking[lknee]"))
    knee_feet = torch.linalg.vector_norm(knees - feet, dim=-1)
    com_feet = torch.linalg.vector_norm(info.com[:, :2] - feet, dim=-1)

    fwd = quat_rotate(info.xquat[:, s.body_id("torso")], e_x)[:, :2]
    tgt = p[2:4] - torso[:, :2]
    tgt = tgt / torch.clamp(torch.linalg.vector_norm(tgt, dim=-1,
                                                     keepdim=True), min=1e-9)
    facing = torch.linalg.vector_norm(tgt - fwd, dim=-1) * p[4]

    # contact pairs: body indices are runtime leaves, gathered on device
    contacts = []
    for i in range(N_CONTACT_PAIRS):
        o = _PAIR_OFF + i * _PAIR_STRIDE
        ends = []
        for b_at, lp_at in ((o + 1, o + 3), (o + 2, o + 6)):
            b = p[b_at].to(torch.long).reshape(1)
            pos = info.xpos.index_select(1, b)[:, 0]
            quat = info.xquat.index_select(1, b)[:, 0]
            ends.append(pos + quat_rotate(quat, p[lp_at:lp_at + 3]))
        contacts.append(torch.abs(ends[0] - ends[1]) * p[o])
    return torch.cat([ups, head_h[:, None], torso_h[:, None],
                      knee_feet[:, None], com_feet[:, None],
                      facing[:, None], info.com_vel[:, :2],
                      state.qvel[:, 6:], ctrl] + contacts, dim=-1)


_TERMS = (
    TermSpec("Torso Up", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Pelvis Up", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("RFoot Up", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("LFoot Up", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Head Height", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Torso Height", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Knee Feet XY", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("COM Feet XY", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Facing Dir", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("CoM Vel.", 2, NormType.QUADRATIC),
    TermSpec("Joint Vel.", 21, NormType.QUADRATIC),
    TermSpec("Control", 21, NormType.COSH, num_params=1),
    TermSpec("Contact", 15, NormType.SMOOTH_ABS, num_params=1),
)
# task.xml:41-53
_WEIGHTS = (10.0, 10.0, 5.0, 5.0, 0.0, 20.0, 30.0, 0.0, 0.0, 10.0,
            0.01, 0.8, 100.0)
_NORM_PARAMS = tuple(
    [(0.1, 0.0)] * 9 + [(0.0, 0.0), (0.0, 0.0), (0.05, 0.0),
                        (0.1, 0.0)])


def interact_task(dtype=torch.float32, device=None) -> Task:
    params = np.zeros(_PAIR_OFF + N_CONTACT_PAIRS * _PAIR_STRIDE)
    params[0] = 1.4          # residual_Head Height default
    params[1] = 1.3          # residual_Torso Height default
    return make_task("Humanoid Interact", _TERMS, _interact_residual,
                     _WEIGHTS, norm_params=_NORM_PARAMS,
                     params=tuple(params), param_names=_param_names(),
                     dtype=dtype, device=device)


def set_contact_pair(task: Task, i: int, body1: int, body2: int,
                     local1, local2) -> Task:
    """Author contact-keyframe pair i (the reference GUI's selection
    flow, contact_keyframe.cc): e.g. the pelvis onto the chair seat."""
    o = _PAIR_OFF + i * _PAIR_STRIDE
    params = task.params.clone()
    params[o:o + _PAIR_STRIDE] = torch.tensor(
        [1.0, float(body1), float(body2), *np.asarray(local1, float),
         *np.asarray(local2, float)], dtype=params.dtype)
    return dataclasses.replace(task, params=params)
