"""FreeFingers (the reference's Fingers task), batched.

Counterpart of humanoid_mujoco_tpu/tasks/fingers.py
(mjpc/tasks/fingers): two free-floating sphere fingers, three slide
dofs each on position servos (kp 1000, the intvelocity actuators'
range as ctrlrange), gravity-compensated, push a thin free box (half
size 0.05 x 0.01 x 0.1, 0.2 kg) toward a goal pose; 12 slots (the box's
8 floor corners, the fingers' floor slots and finger-box pairs),
`max_contacts` 0. Its step takes the "contact" route (nv 12, 12 limit
rows).

Residual: Reach (6) finger - object per finger [L2(0.02), w 0.35];
Bring (3) |object site - target site| for three orientation sites
[SmoothAbs(0.05), w 1]; Control (6) ctrl - finger qpos
[SmoothAbs(0.01), w 0.05].
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.norms import NormType
from ..physics.math import quat_rotate
from ..physics.model import (ActuatorType, JointType, Model, ModelBuilder,
                             State)
from ..physics.step import StepInfo
from .base import Task, TermSpec, constant, make_task

_SITES = ((0.12, 0.0, 0.0), (0.0, 0.08, 0.0), (0.0, 0.0, 0.08))
_OBJ_SIZE = (0.05, 0.01, 0.1)
_TARGET_POS = (0.0, 0.0, 0.12)
_TARGET_QUAT = (0.7071068, 0.0, 0.7071068, 0.0)


def fingers_model(dt: float = 0.005, dtype=torch.float32, device=None
                  ) -> Model:
    b = ModelBuilder(dt=dt)
    b.has_floor = True
    obj = b.add_body("object", -1, pos=(0.0, 0.0, 0.3), mass=0.2,
                     inertia=(0.2 / 12 * 4 * (0.01 ** 2 + 0.1 ** 2),
                              0.2 / 12 * 4 * (0.05 ** 2 + 0.1 ** 2),
                              0.2 / 12 * 4 * (0.05 ** 2 + 0.01 ** 2)))
    b.add_joint("object_free", obj, JointType.FREE)
    box = b.add_box(obj, size=_OBJ_SIZE, friction=0.2, floor=True)
    for i, pos in enumerate(_SITES):
        b.add_site(str(i), obj, pos=pos)
    for name, y0 in (("finger_a", 0.1), ("finger_b", -0.1)):
        fb = b.add_body(name, -1, pos=(0.0, y0, 0.3), mass=0.034,
                        inertia=(5.4e-06, 5.4e-06, 5.4e-06), gravcomp=1.0)
        for ax, (axis, rng) in enumerate((((1, 0, 0), (-1.0, 1.0)),
                                          ((0, 1, 0), (-1.0, 1.0)),
                                          ((0, 0, 1), (0.0, 1.4)))):
            j = b.add_joint(f"{name}_{'xyz'[ax]}", fb, JointType.SLIDE,
                            axis=axis, jrange=rng, limited=True,
                            damping=2.0)
            b.add_actuator(j, ActuatorType.POSITION, kp=1000.0, kv=30.0,
                           ctrlrange=rng, forcerange=(-60.0, 60.0))
        b.add_site(name, fb)
        sph = b.add_sphere(fb, radius=0.02, friction=0.2)
        b.add_pair_sb(sph, box)
    return b.finalize(dtype=dtype, device=device)


def fingers_home_qpos(m: Model) -> torch.Tensor:
    """The object lying flat (rest height 0.05), the fingers at their
    spawn poses."""
    q = np.zeros(m.nq)
    q[0:3] = (0.0, 0.0, 0.05)
    q[3:7] = _TARGET_QUAT
    return torch.tensor(q, dtype=m.dtype, device=m.device)


def _fingers_residual(m: Model, task: Task, state: State, info: StepInfo,
                      ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    obj = info.xpos[:, s.body_id("object")]
    sx = info.site_xpos
    reach = torch.cat([sx[:, s.site_id("finger_a")] - obj,
                       sx[:, s.site_id("finger_b")] - obj], dim=-1)
    local = constant(m, "fingers_sites", _SITES, info.xpos)
    tp = task.mocap_pos[0] + quat_rotate(task.mocap_quat[0], local)
    op = sx[:, [s.site_id(str(i)) for i in range(len(_SITES))]]
    bring = torch.linalg.vector_norm(op - tp, dim=-1)
    return torch.cat([reach, bring, ctrl - state.qpos[:, 7:13]], dim=-1)


_TERMS = (
    TermSpec("Reach", 6, NormType.L2, num_params=1),
    TermSpec("Bring", 3, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Control", 6, NormType.SMOOTH_ABS, num_params=1),
)
_WEIGHTS = (0.35, 1.0, 0.05)
_NORM_PARAMS = ((0.02, 0.0), (0.05, 0.0), (0.01, 0.0))


def fingers_task(dtype=torch.float32, device=None) -> Task:
    return make_task("FreeFingers", _TERMS, _fingers_residual, _WEIGHTS,
                     norm_params=_NORM_PARAMS,
                     mocap={"target": (_TARGET_POS, _TARGET_QUAT)},
                     dtype=dtype, device=device)
