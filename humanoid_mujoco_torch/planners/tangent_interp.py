"""Tangent-space interpolation of nominal states (shared by policies).

Counterpart of humanoid_mujoco_tpu/planners/tangent_interp.py, batched.
"""

from __future__ import annotations

import torch

from ..physics.model import Model
from ..physics.tangent import qpos_diff, state_add


def interp_nominal_state(m: Model, qpos_lo: torch.Tensor,
                         qvel_lo: torch.Tensor, qpos_hi: torch.Tensor,
                         qvel_hi: torch.Tensor, frac):
    """x(frac) between two knot states, (B, ...) each, frac (B, 1) or a
    float: qpos along the quaternion-aware geodesic q_lo ⊞ frac·(q_hi ⊟
    q_lo), qvel linearly."""
    dq = qpos_diff(m, qpos_hi, qpos_lo)
    qpos_t = state_add(m, qpos_lo, frac * dq)
    qvel_t = qvel_lo * (1 - frac) + qvel_hi * frac
    return qpos_t, qvel_t
