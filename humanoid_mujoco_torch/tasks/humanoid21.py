"""Upstream humanoid Stand and Walk tasks (the 21-DOF MJPC humanoid),
batched.

Counterpart of humanoid_mujoco_tpu/tasks/humanoid21.py (the reference's
mjpc/tasks/humanoid/stand/stand.cc and walk/walk.cc residuals, with the
weights, norms and parameters of their task.xml). The model is
physics/humanoid_upstream.py; its step takes the "contact" route.

Stand (5 terms): head-over-feet height vs the Height Goal, capture
point vs the feet centroid, COM xy velocity, joint velocities, controls.
Walk (8 terms): torso height, pelvis-feet, capture point projected on
the feet segment, upright set, posture, walking speed along the heading,
feet velocity relative to the COM, controls (the JAX package's semantic
mapping of the Walk and Velocity slices).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.norms import NormType
from ..physics.humanoid_upstream import build_humanoid21
from ..physics.math import quat_rotate, safe_norm
from ..physics.model import Model, State
from ..physics.step import StepInfo
from .base import Task, TermSpec, constant, make_task

K_FALL_TIME_STAND = 0.2
K_FALL_TIME_WALK = 0.3


def _subtree_mask(struct, root_name: str) -> np.ndarray:
    """0/1 mask of the bodies in the subtree rooted at `root_name`."""
    root = struct.body_id(root_name)
    mask = np.zeros(struct.nbody)
    for b in range(struct.nbody):
        cur = b
        while cur >= 0:
            if cur == root:
                mask[b] = 1.0
                break
            cur = struct.body_parent[cur]
    return mask


def _standing(torso_z: torch.Tensor) -> torch.Tensor:
    """walk.cc's standing gate."""
    return torso_z / torch.sqrt(torso_z * torso_z + 0.45 * 0.45) - 0.4


def h21_stand_residual(m: Model, task: Task, state: State, info: StepInfo,
                       ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    head = s.body_id("head")
    sp = info.site_xpos[:, [s.site_id(n)
                            for n in ("sp0", "sp1", "sp2", "sp3")]]
    height = info.xpos[:, head, 2] - sp[..., 2].mean(dim=1) - task.params[0]
    capture = info.com[:, :2] + K_FALL_TIME_STAND * info.com_vel[:, :2]
    balance = safe_norm(sp[..., :2].mean(dim=1) - capture)
    return torch.cat([height[:, None], balance[:, None], info.com_vel[:, :2],
                      state.qvel[:, 6:], ctrl], dim=-1)


_STAND_TERMS = (
    TermSpec("Height", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("Balance", 1, NormType.SMOOTH_ABS, num_params=1),
    TermSpec("CoM Vel.", 2, NormType.QUADRATIC),
    TermSpec("Joint Vel.", 21, NormType.QUADRATIC),
    TermSpec("Control", 21, NormType.COSH, num_params=1),
)


def h21_stand_task(height_goal: float = 1.4, dtype=torch.float32,
                   device=None) -> Task:
    return make_task(
        "Humanoid Stand", _STAND_TERMS, h21_stand_residual,
        weights=(100.0, 50.0, 10.0, 0.01, 0.025),
        norm_params=((0.1, 0), (0.1, 0), (0, 0), (0, 0), (0.3, 0)),
        params=(height_goal,), param_names=("Height Goal",), dtype=dtype,
        device=device)


def h21_walk_residual(m: Model, task: Task, state: State, info: StepInfo,
                      ctrl: torch.Tensor) -> torch.Tensor:
    s = m.struct
    dtype, dev = state.qpos.dtype, state.qpos.device
    torso, pelvis = s.body_id("torso"), s.body_id("pelvis")
    fr, fl = s.body_id("foot_right"), s.body_id("foot_left")
    z_ref = constant(m, "e_z", (0.0, 0.0, 1.0), state.qpos)
    x_ref = constant(m, "e_x", (1.0, 0.0, 0.0), state.qpos)
    xpos, xquat = info.xpos, info.xquat

    torso_z = xpos[:, torso, 2]
    standing = _standing(torso_z)[:, None]
    height = torso_z - task.params[0]
    pelvis_feet = (0.5 * (xpos[:, fl, 2] + xpos[:, fr, 2])
                   - xpos[:, pelvis, 2] - 0.2)

    capture = info.com[:, :2] + K_FALL_TIME_WALK * info.com_vel[:, :2]
    axis = xpos[:, fr, :2] - xpos[:, fl, :2]
    axis_len = safe_norm(axis)[:, None]
    axis = axis / torch.clamp(axis_len, min=1e-9)
    length = 0.5 * axis_len - 0.05
    center = 0.5 * (xpos[:, fr, :2] + xpos[:, fl, :2])
    t = torch.sum((capture - center) * axis, dim=-1, keepdim=True)
    t = torch.minimum(torch.maximum(t, -length), length)
    balance = standing * (capture - (center + t * axis))

    torso_up = quat_rotate(xquat[:, torso], z_ref)
    pelvis_up = quat_rotate(xquat[:, pelvis], z_ref)
    fr_up = quat_rotate(xquat[:, fr], z_ref)
    fl_up = quat_rotate(xquat[:, fl], z_ref)
    upright = torch.cat([
        (torso_up[:, 2] - 1.0)[:, None],
        (0.3 * (pelvis_up[:, 2] - 1.0))[:, None],
        0.1 * standing * (fr_up - z_ref), 0.1 * standing * (fl_up - z_ref)],
        dim=-1)
    posture = state.qpos[:, 7:]

    fwd = sum(quat_rotate(xquat[:, b], x_ref)[:, :2]
              for b in (torso, pelvis, fr, fl))
    fwd = fwd / torch.clamp(safe_norm(fwd), min=1e-9)[:, None]
    msub = m.struct_static(
        ("h21_subtree", dtype, dev), lambda: torch.tensor(
            _subtree_mask(s, "waist_lower"), dtype=dtype,
            device=dev)) * m.body_mass
    bcv = info.body_com_vel
    sub_vel = torch.einsum("b,nbk->nk", msub, bcv) / torch.clamp(
        msub.sum(), min=1e-9)
    com_vel2 = 0.5 * (sub_vel[:, :2] + bcv[:, torso, :2])
    walk = standing * (torch.sum(com_vel2 * fwd, dim=-1, keepdim=True)
                       - task.params[1])
    move_feet = standing * (com_vel2 - 0.5 * bcv[:, fr, :2]
                            - 0.5 * bcv[:, fl, :2])
    return torch.cat([height[:, None], pelvis_feet[:, None], balance,
                      upright, posture, walk, move_feet, ctrl], dim=-1)


_WALK_TERMS = (
    TermSpec("Height", 1, NormType.SMOOTH_ABS2, num_params=2),
    TermSpec("Pelvis/Feet", 1, NormType.RECTIFY, num_params=1),
    TermSpec("Balance", 2, NormType.L22, num_params=2),
    TermSpec("Upright", 8, NormType.L2, num_params=1),
    TermSpec("Posture", 21, NormType.QUADRATIC),
    TermSpec("Walk", 1, NormType.SMOOTH_ABS2, num_params=2),
    TermSpec("Velocity", 2, NormType.SMOOTH_ABS2, num_params=2),
    TermSpec("Control", 21, NormType.COSH, num_params=1),
)


def h21_walk_task(height_goal: float = 1.35, speed: float = 0.5,
                  dtype=torch.float32, device=None) -> Task:
    return make_task(
        "Humanoid Walk", _WALK_TERMS, h21_walk_residual,
        weights=(5.0, 1.0, 5.0, 5.0, 0.025, 1.0, 0.625, 0.1),
        norm_params=((0.1, 4.0), (0.05, 0), (0.02, 4.0), (0.01, 0),
                     (0, 0), (0.5, 3.0), (0.2, 4.0), (0.3, 0)),
        params=(height_goal, speed), param_names=("Torso", "Speed"),
        dtype=dtype, device=device)


def humanoid21_model(**kwargs) -> Model:
    return build_humanoid21(**kwargs)
