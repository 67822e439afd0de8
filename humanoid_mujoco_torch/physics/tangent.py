"""Tangent-space (velocity-coordinate) state arithmetic, batched.

Counterpart of humanoid_mujoco_tpu/physics/tangent.py (the analog of
mj_integratePos / mj_differentiatePos and the reference's quaternion-
aware StateDiff, mjpc/utilities.h:174). Configurations live on a
manifold (free and ball joints carry quaternions); derivatives and the
iLQG algebra live in the 2·nv tangent space:

    state_add(m, qpos, dq) : qpos ⊞ dq   (dq (B, nv))
    qpos_diff(m, q1, q0)   : q1 ⊟ q0     -> (B, nv)

Both are inverses to first order and differentiable in forward mode,
which planners/derivatives.py uses for its A, B matrices.
"""

from __future__ import annotations

import torch

from . import math as pm
from .model import JointType, Model


def state_add(m: Model, qpos: torch.Tensor, dq: torch.Tensor
              ) -> torch.Tensor:
    """qpos ⊞ dq, (B, nq) and (B, nv) -> (B, nq), with the quaternion
    exponential map on free and ball joints."""
    s = m.struct
    cols = []
    for j in range(s.njnt):
        qadr, vadr = s.jnt_qadr[j], s.jnt_vadr[j]
        t = s.jnt_type[j]
        if t == JointType.FREE:
            cols.append(qpos[:, qadr:qadr + 3] + dq[:, vadr:vadr + 3])
            cols.append(pm.quat_mul(
                pm.quat_normalize(qpos[:, qadr + 3:qadr + 7]),
                pm.quat_exp(dq[:, vadr + 3:vadr + 6])))
        elif t == JointType.BALL:
            cols.append(pm.quat_mul(pm.quat_normalize(qpos[:, qadr:qadr + 4]),
                                    pm.quat_exp(dq[:, vadr:vadr + 3])))
        else:
            cols.append(qpos[:, qadr:qadr + 1] + dq[:, vadr:vadr + 1])
    return torch.cat(cols, dim=-1)


def qpos_diff(m: Model, q1: torch.Tensor, q0: torch.Tensor) -> torch.Tensor:
    """q1 ⊟ q0, (B, nq) twice -> (B, nv), quaternions by the local-frame
    logarithm."""
    s = m.struct
    parts = []
    for j in range(s.njnt):
        qadr = s.jnt_qadr[j]
        t = s.jnt_type[j]
        if t == JointType.FREE:
            parts.append(q1[:, qadr:qadr + 3] - q0[:, qadr:qadr + 3])
            parts.append(pm.quat_sub(
                pm.quat_normalize(q1[:, qadr + 3:qadr + 7]),
                pm.quat_normalize(q0[:, qadr + 3:qadr + 7])))
        elif t == JointType.BALL:
            parts.append(pm.quat_sub(pm.quat_normalize(q1[:, qadr:qadr + 4]),
                                     pm.quat_normalize(q0[:, qadr:qadr + 4])))
        else:
            parts.append(q1[:, qadr:qadr + 1] - q0[:, qadr:qadr + 1])
    if not parts:
        return q1.new_zeros((q1.shape[0], 0))
    return torch.cat(parts, dim=-1)


def state_diff(m: Model, qpos1: torch.Tensor, qvel1: torch.Tensor,
               qpos0: torch.Tensor, qvel0: torch.Tensor) -> torch.Tensor:
    """The full-state tangent difference (B, 2·nv): [qpos1 ⊟ qpos0;
    qvel1 - qvel0]."""
    return torch.cat([qpos_diff(m, qpos1, qpos0), qvel1 - qvel0], dim=-1)
