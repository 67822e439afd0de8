"""RL reward functions, batch-first.

Counterpart of humanoid_mujoco_tpu/rl/rewards.py (the reference's
simulation/reward_functions.py standupReward and controlInputReward).
Every term is an exp-kernel bonus scaled_exp(x) = exp(-x / 0.5) with the
reference's weights; inputs are (B, ...) tensors, branch-free, and
terminal / truncated come back as (B,) bools.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..physics import math as pm
from ..physics.humanoid import ACTUATED_JOINT_ORDER, STAND_POS

_EXP_SCALE = 0.5
Z_INITIAL_POS = STAND_POS[2]          # -0.375
CONTROL_FREQUENCY = 500.0

# symmetry pairs of the reference, indexing ctrl in actuator order
_EQUAL = (("left_elbow", "right_elbow"),)
_OPPOSITE = (("left_hip_roll", "right_hip_roll"),
             ("left_hip_pitch", "right_hip_pitch"),
             ("left_knee", "right_knee"),
             ("left_shoulder_pitch", "right_shoulder_pitch"),
             ("left_shoulder_roll", "right_shoulder_roll"))
_JIDX = {n: i for i, n in enumerate(ACTUATED_JOINT_ORDER)}


@functools.lru_cache(maxsize=None)
def _down(dtype, device):
    return torch.tensor([0.0, 0.0, -1.0], dtype=dtype, device=device)


def _sexp(x):
    return torch.exp(-x / _EXP_SCALE)


@dataclasses.dataclass(frozen=True)
class RewardResult:
    reward: torch.Tensor      # (B,)
    terminal: torch.Tensor    # (B,) bool
    truncated: torch.Tensor   # (B,) bool


def _symmetry(ctrl):
    """ctrl (B, nu) -> (B,)."""
    r = 0.0
    for a, b in _EQUAL:
        r = r + _sexp((ctrl[:, _JIDX[a]] - ctrl[:, _JIDX[b]]) ** 2)
    for a, b in _OPPOSITE:
        r = r + _sexp((ctrl[:, _JIDX[a]] + ctrl[:, _JIDX[b]]) ** 2)
    return r / (len(_EQUAL) + len(_OPPOSITE))


def _interp(z, x0, x1, y1):
    """jnp.interp(z, [x0, x1], [0, y1]): linear between, clamped."""
    return torch.clamp((z - x0) / (x1 - x0), 0.0, 1.0) * y1


def _common_terms(w_hvel, w_upright, w_vvel, w_height, min_z, target_z,
                  velocity, target_velocity, torso_quat, z_pos,
                  joint_torques, previous_ctrl, latest_ctrl):
    """The term stack shared by both reward functions (weights differ)."""
    r = w_hvel * _sexp(torch.sum((velocity[:, :2] - target_velocity) ** 2,
                                 dim=-1))
    down = _down(torso_quat.dtype, torso_quat.device)
    local_gravity = pm.quat_rotate_inv(pm.quat_normalize(torso_quat), down)
    r = r + w_upright * _sexp(torch.sum((local_gravity - down) ** 2, dim=-1))
    r = r + w_vvel * _sexp(velocity[:, 2] ** 2)
    r = r + _interp(z_pos, min_z, target_z, w_height)
    # joint torque above 1 Nm, penalty-shaped bonus (per-joint mean)
    over = torch.clamp(torch.abs(joint_torques) - 1.0, min=0.0)
    r = r + 2.5 * torch.mean(_sexp(over ** 2), dim=-1)
    # control change, regularization, symmetry
    dctrl = (latest_ctrl - previous_ctrl) * CONTROL_FREQUENCY
    r = r + 2.0 * torch.mean(_sexp(dctrl ** 2), dim=-1)
    r = r + 0.5 * torch.mean(_sexp(latest_ctrl ** 2), dim=-1)
    r = r + 1.0 * _symmetry(latest_ctrl)
    return r, local_gravity


def _upright(local_gravity):
    return torch.amax(torch.abs(local_gravity[:, :2]), dim=-1) < 0.7


def standup_reward(velocity, target_velocity, torso_quat, target_yaw,
                   z_pos, joint_torques, previous_ctrl, latest_ctrl,
                   is_self_colliding, time, max_simulation_time
                   ) -> RewardResult:
    """standupReward: get up from lying. Terminal only on timeout;
    truncated (success) when the torso is back at stand height and
    upright."""
    r, local_gravity = _common_terms(
        5.0, 10.0, 0.0, 15.0, -0.6, Z_INITIAL_POS,
        velocity, target_velocity, torso_quat, z_pos, joint_torques,
        previous_ctrl, latest_ctrl)
    r = r - 20.0 * is_self_colliding.to(r.dtype)
    terminal = time >= max_simulation_time
    r = torch.where(terminal, torch.full_like(r, -100.0), r)
    truncated = (z_pos >= Z_INITIAL_POS) & _upright(local_gravity)
    return RewardResult(reward=r, terminal=terminal, truncated=truncated)


def control_input_reward(velocity, target_velocity, torso_quat, target_yaw,
                         z_pos, joint_torques, previous_ctrl, latest_ctrl,
                         is_self_colliding, time, max_simulation_time
                         ) -> RewardResult:
    """controlInputReward: walk / balance at a commanded velocity.
    Terminal on a fall (not upright, or below -0.5 m); truncated at the
    time limit when it is positive."""
    r, local_gravity = _common_terms(
        15.0, 10.0, 5.0, 5.0, Z_INITIAL_POS - 0.75, Z_INITIAL_POS,
        velocity, target_velocity, torso_quat, z_pos, joint_torques,
        previous_ctrl, latest_ctrl)
    r = r - 20.0 * is_self_colliding.to(r.dtype)
    terminal = ~_upright(local_gravity) | (z_pos < -0.5)
    r = torch.where(terminal, torch.full_like(r, -100.0), r)
    limit = max_simulation_time if max_simulation_time > 0 else float("inf")
    truncated = time >= limit
    return RewardResult(reward=r, terminal=terminal, truncated=truncated)
