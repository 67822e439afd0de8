"""PickAndPlace (the reference's manipulation Bring task), batched.

Counterpart of humanoid_mujoco_tpu/tasks/pickplace.py
(mjpc/tasks/manipulation): the Panda arm and gripper of tasks/panda.py
and a small free box object (a box geom, its 8 corner sites at ±0.04)
to bring to a goal pose; the fingertips and palm are spheres paired
with the box (14 slots, `max_contacts` 0). Its step takes the "contact"
route (nv 15, 14 limit rows).

Residual: Reach (3) fingertip midpoint - object [L2(0.005), w 1];
Bring (8) |object corner - target corner| [SmoothAbs(0.01), w 0.2];
Careful (1) log10(1 + robot contact force not on the object)
[SmoothAbs(0.01), w 0.2]; Away (1) min(0, hand z - 0.6)
[SmoothAbs(0.01), w 0].

Transition, staged by the mode (bring | away): a solved bring turns
Reach off and Away on; a solved away turns them back and gives the
target a random orientation, drawn from a `torch.Generator` seeded from
the sim tick (the JAX package folds it into `PRNGKey(13)`; the draws
differ, the staging is the same).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import norms
from ..ops.norms import NormType
from ..physics.math import quat_rotate
from ..physics.model import JointType, Model, ModelBuilder, State
from ..physics.step import StepInfo
from .base import Task, TermSpec, constant, make_task
from .panda import _HOME_ARM, add_panda_actuators, build_panda_arm

_OBJ_SIZE = (0.011, 0.0151, 0.021)
_CORNERS = tuple((sx, sy, sz)
                 for sz in (0.04, -0.04) for sy in (0.04, -0.04)
                 for sx in (0.04, -0.04))
_OBJ_START = (0.45, 0.0, 0.0305)        # on the pedestal
_TARGET_START = (0.45, 0.0, 0.15)
_SEED = 13                              # the JAX package's PRNGKey(13)


def pickplace_model(dt: float = 0.005, dtype=torch.float32, device=None
                    ) -> Model:
    b = ModelBuilder(dt=dt)
    b.has_floor = True
    eeff, tips = build_panda_arm(b)
    obj = b.add_body("object", -1, pos=_OBJ_START, mass=0.034,
                     inertia=(4.9e-06, 3.9e-06, 2.4e-06))
    b.add_joint("object_free", obj, JointType.FREE)
    box = b.add_box(obj, size=_OBJ_SIZE, friction=1.0, floor=True)
    for i, pos in enumerate(_CORNERS):
        b.add_site(str(i), obj, pos=pos)
    for t in tips:
        b.add_pair_sb(t, box)
    add_panda_actuators(b, eeff)
    return b.finalize(dtype=dtype, device=device)


def pickplace_home_qpos(m: Model) -> torch.Tensor:
    q = np.zeros(m.nq)
    q[:7] = _HOME_ARM
    q[7:9] = 0.04
    q[9:12] = _OBJ_START
    q[12] = 1.0
    return torch.tensor(q, dtype=m.dtype, device=m.device)


def _careful_mask(m: Model) -> np.ndarray:
    """Per-slot 1 where the slot involves a robot body and not the
    object (CarefulCost's contact filter over the static slot tables)."""
    s = m.struct
    obj = s.body_id("object")
    a = np.asarray(s.slot_body_a)
    b = np.asarray(s.slot_body_b)
    robot = ((a >= 0) & (a != obj)) | ((b >= 0) & (b != obj))
    return (robot & ~((a == obj) | (b == obj))).astype(np.float32)


def _pickplace_residual(m: Model, task: Task, state: State,
                        info: StepInfo, ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    dtype, dev = info.xpos.dtype, info.xpos.device
    sx = info.site_xpos
    hand = 0.5 * (sx[:, s.site_id("tip_left_finger")]
                  + sx[:, s.site_id("tip_right_finger")])
    reach = hand - info.xpos[:, s.body_id("object")]
    corners = constant(m, "pickplace_corners", _CORNERS, info.xpos)
    tp = task.mocap_pos[0] + quat_rotate(task.mocap_quat[0], corners)
    op = sx[:, [s.site_id(str(i)) for i in range(len(_CORNERS))]]
    bring = torch.linalg.vector_norm(op - tp, dim=-1)
    mask = m.struct_static(("careful", dtype, dev), lambda: torch.tensor(
        _careful_mask(m), dtype=dtype, device=dev))
    careful = torch.log10(1.0 + torch.sum(mask * info.contact_force,
                                          dim=-1))
    away = torch.clamp(hand[:, 2] - 0.6, max=0.0)
    return torch.cat([reach, bring, careful[:, None], away[:, None]],
                     dim=-1)


def _pickplace_transition(task: Task, m: Model, state: State,
                          info: StepInfo) -> Task:
    """Stage the task on the (single) simulated state's first env."""
    res = _pickplace_residual(m, task, state, info,
                              state.qpos.new_zeros((state.batch, m.nu)))[0]
    bring_cost = norms.norm_value(res[3:11], NormType.SMOOTH_ABS,
                                  task.norm_params[1, 0],
                                  task.norm_params[1, 1])
    away_cost = norms.norm_value(res[12:13], NormType.SMOOTH_ABS,
                                 task.norm_params[3, 0],
                                 task.norm_params[3, 1])
    in_bring = task.mode == 0
    bring_done = in_bring & (state.time[0] > 0) & (bring_cost < 0.04)
    away_done = ~in_bring & (away_cost < 0.01)
    w = task.weights.clone()
    w0 = torch.where(bring_done, torch.zeros_like(w[0]),
                     torch.where(away_done, torch.ones_like(w[0]), w[0]))
    w3 = torch.where(bring_done, torch.ones_like(w[3]),
                     torch.where(away_done, torch.zeros_like(w[3]), w[3]))
    w[0], w[3] = w0, w3
    mode = torch.where(bring_done, torch.ones_like(task.mode),
                       torch.where(away_done, torch.zeros_like(task.mode),
                                   task.mode))
    tick = int(torch.round(state.time[0] * 1e3))
    gen = torch.Generator().manual_seed((_SEED << 32) + tick)
    q = torch.randn(4, generator=gen, dtype=torch.float64)
    q = (q / torch.linalg.vector_norm(q)).to(task.mocap_quat)
    mq = task.mocap_quat.clone()
    mq[0] = torch.where(away_done, q, mq[0])
    return dataclasses.replace(task, weights=w, mode=mode, mocap_quat=mq)


_TERMS = (
    TermSpec("Reach", 3, NormType.L2, num_params=1),
    TermSpec("Bring", 8, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Careful", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Away", 1, NormType.SMOOTH_ABS, num_params=1),
)
_WEIGHTS = (1.0, 0.2, 0.2, 0.0)
_NORM_PARAMS = ((0.005, 0.0), (0.01, 0.0), (0.01, 0.0), (0.01, 0.0))


def pickplace_task(dtype=torch.float32, device=None) -> Task:
    return make_task("PickAndPlace", _TERMS, _pickplace_residual,
                     _WEIGHTS, norm_params=_NORM_PARAMS,
                     mocap={"target": _TARGET_START},
                     transition_fn=_pickplace_transition,
                     mode_names=("bring", "away"), dtype=dtype,
                     device=device)
