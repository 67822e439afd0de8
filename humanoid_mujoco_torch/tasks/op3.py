"""ROBOTIS OP3 stand and handstand task, batched.

Counterpart of humanoid_mujoco_tpu/tasks/op3.py (mjpc/tasks/op3): the
menagerie robotis_op3 as the task patches it, 18 hinge dofs on kp-21.1
position servos (±5 N m) and a free root (physics/op3_data.py); the
XML's four foot boxes and seven sphere proxies for the hands, head,
torso and knees (39 slots, `max_contacts` 16 in `forward`). Its step
takes the "contact" route, selection-free over all 39 slots (nv 24).

Residual, two modes (Stand | Handstand): Height (1) [SmoothAbs(0.1),
w 100]; Balance (1) capture point vs the support centroid
[SmoothAbs(0.1), w 50]; CoM Vel (2) [w 10]; Ctrl Diff (18) ctrl - the
mode's keyframe [w 0.25]; Upright (13) [L2(0.01), w 5]; Joint Vel (18)
[w 1e-5]. The transition sets the Height Goal to the mode's height
(0.38 | 0.57).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.norms import NormType
from ..physics.math import quat_rotate
from ..physics.model import (ActuatorType, JointType, Model, ModelBuilder,
                             State)
from ..physics.op3_data import (BODIES, FOOT_BOXES, JOINTS, KEYFRAMES,
                                SERVO, SITES)
from ..physics.step import StepInfo
from .base import Task, TermSpec, constant, make_task

_FALL_TIME = 0.05
_MODE_HEIGHT = (0.38, 0.57)


def op3_model(dt: float = 0.005, max_contacts: int = 16,
              dtype=torch.float32, device=None) -> Model:
    b = ModelBuilder(dt=dt)
    b.has_floor = True
    ids = {}
    for name, parent, pos, quat, mass, ipos, iquat, diag in BODIES:
        pid = -1 if parent is None else ids[parent]
        ids[name] = b.add_body(name, pid, pos=pos, quat=quat, mass=mass,
                               ipos=ipos, iquat=iquat, inertia=diag)
    b.add_joint("root", ids["body_link"], JointType.FREE)
    cr, fr = SERVO["ctrlrange"], SERVO["forcerange"]
    for name, body, axis, pos, rng, damping, armature in JOINTS:
        j = b.add_joint(name, ids[body], JointType.HINGE, axis=axis,
                        pos=pos, jrange=rng, limited=rng != (0.0, 0.0),
                        damping=damping, armature=armature)
        b.add_actuator(j, ActuatorType.POSITION, kp=SERVO["kp"],
                       ctrlrange=(-cr, cr), forcerange=(-fr, fr))
    for body, pos, size in FOOT_BOXES:
        b.add_box(ids[body], pos=pos, size=size, friction=1.0, floor=True)
    for name, body, pos in SITES:
        b.add_site(name, ids[body], pos=pos)
    # sphere proxies of the hands, head, torso and knees
    for _, body, pos, r in (
            ("hand_l", "l_el_link", (-0.02, 0.14, 0.0), 0.02),
            ("hand_r", "r_el_link", (-0.02, -0.14, 0.0), 0.02),
            ("head_s", "head_tilt_link", (0.0, -0.02, 0.03), 0.045),
            ("torso_f", "body_link", (0.02, 0.0, 0.08), 0.05),
            ("torso_b", "body_link", (-0.03, 0.0, 0.08), 0.05),
            ("knee_l", "l_knee_link", (0.0, 0.0, -0.06), 0.025),
            ("knee_r", "r_knee_link", (0.0, 0.0, -0.06), 0.025)):
        b.add_sphere(ids[body], pos=pos, radius=r, friction=1.0)
    b.max_contacts = max_contacts
    return b.finalize(dtype=dtype, device=device)


def op3_home_qpos(m: Model, key: str = "home") -> torch.Tensor:
    return torch.tensor(KEYFRAMES[key], dtype=m.dtype, device=m.device)


def _site_axis(info: StepInfo, m: Model, site: str, k: int):
    """World axis k of the site's body frame (B, 3)."""
    q = info.xquat[:, m.struct.site_body[m.struct.site_id(site)]]
    return quat_rotate(q, constant(m, f"e_{k}", tuple(
        float(i == k) for i in range(3)), q))


def _op3_residual(m: Model, task: Task, state: State, info: StepInfo,
                  ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    dtype, dev = info.xpos.dtype, info.xpos.device
    sp = info.site_xpos
    head, lf, rf, lh, rh = (sp[:, s.site_id(n)] for n in (
        "head", "left_foot", "right_foot", "left_hand", "right_hand"))
    handstand = task.mode == 1
    h_stand = head[:, 2] - 0.5 * (lf[:, 2] + rf[:, 2])
    # the handstand branch's hand term is l_hand - r_hand, as the
    # reference writes it
    h_hand = 0.5 * (lf[:, 2] + rf[:, 2]) - 0.5 * (lh[:, 2] - rh[:, 2])
    height = torch.where(handstand, h_hand, h_stand) - task.params[0]
    cap = info.com[:, :2] + _FALL_TIME * info.com_vel[:, :2]
    support = torch.where(handstand, 0.5 * (lh[:, :2] + rh[:, :2]),
                          0.5 * (lf[:, :2] + rf[:, :2]))
    balance = torch.linalg.vector_norm(support - cap, dim=-1)
    keys = m.struct_static(("op3_keys", dtype, dev), lambda: torch.tensor(
        np.stack([np.asarray(KEYFRAMES["home"])[7:],
                  np.asarray(KEYFRAMES["handstand"])[7:]]), dtype=dtype,
        device=dev))
    ctrl_diff = ctrl - torch.where(handstand, keys[1], keys[0])
    z = constant(m, "e_z", (0.0, 0.0, 1.0), info.xpos)
    frz = _site_axis(info, m, "right_foot", 2)
    flz = _site_axis(info, m, "left_foot", 2)
    tz = _site_axis(info, m, "torso", 2)
    hry = _site_axis(info, m, "right_hand", 1)
    hly = _site_axis(info, m, "left_hand", 1)
    up_stand = torch.cat([0.1 * (frz - z), 0.1 * (flz - z),
                          tz[:, 2:3] - 1.0, tz.new_zeros((tz.shape[0], 6))],
                         dim=-1)
    up_hand = torch.cat([0.1 * (hry - z), 0.1 * (hly + z), 0.1 * (frz + z),
                         0.1 * (flz + z), tz[:, 2:3] + 1.0], dim=-1)
    upright = torch.where(handstand, up_hand, up_stand)
    return torch.cat([height[:, None], balance[:, None], info.com_vel[:, :2],
                      ctrl_diff, upright, state.qvel[:, 6:]], dim=-1)


def _op3_transition(task: Task, m: Model, state: State,
                    info: StepInfo) -> Task:
    """The mode's height into the Height Goal."""
    heights = torch.tensor(_MODE_HEIGHT, dtype=task.params.dtype,
                           device=task.params.device)
    params = task.params.clone()
    params[0] = heights[(task.mode == 1).long()]
    return dataclasses.replace(task, params=params)


_TERMS = (
    TermSpec("Height", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Balance", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("CoM Vel.", 2, NormType.QUADRATIC),
    TermSpec("Ctrl Diff", 18, NormType.QUADRATIC),
    TermSpec("Upright", 13, NormType.L2, num_params=1),
    TermSpec("Joint Vel", 18, NormType.QUADRATIC),
)
_WEIGHTS = (100.0, 50.0, 10.0, 0.25, 5.0, 1.0e-5)
_NORM_PARAMS = ((0.1, 0.0), (0.1, 0.0), (0.0, 0.0), (0.0, 0.0),
                (0.01, 0.0), (0.0, 0.0))


def op3_task(dtype=torch.float32, device=None) -> Task:
    return make_task("OP3", _TERMS, _op3_residual, _WEIGHTS,
                     norm_params=_NORM_PARAMS, params=(_MODE_HEIGHT[0],),
                     param_names=("Height Goal",),
                     transition_fn=_op3_transition,
                     mode_names=("Stand", "Handstand"), dtype=dtype,
                     device=device)
