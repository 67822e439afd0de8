"""Partial-state re-estimation for robot serving.

Counterpart of humanoid_mujoco_tpu/serving/state_estimation.py. The
robot reports only (joint_pos, joint_vel, ang_vel, quat), no root
height. The reference recovers the height by scanning 200 candidate
offsets for the one that needs the least vertical inverse-dynamics
force (find_ideal_distance_to_ground, controllers/mpc_utils.py:36-56).
Here, as in the JAX package, the score of a height is the root's
vertical acceleration after the contact solve at rest plus a penalty on
penetration; the 200 candidates are one batch through `forward` (plain
PyTorch, 6 solver iterations, the top-32 contact selection).
"""

from __future__ import annotations

import torch

from ..physics.model import Model, State, default_qpos
from ..physics.step import forward


def root_height_scores(m: Model, joint_pos, quat, n_candidates: int = 200,
                       z_range=(-0.7, -0.2)):
    """(zs (n,), scores (n,)) of the candidate root heights for the
    joint pose: |qacc_z| + 100 * total penetration after the contact
    solve at rest."""
    dtype, dev = m.dtype, m.device
    zs = torch.linspace(z_range[0], z_range[1], n_candidates,
                        dtype=torch.float64, device=dev).to(dtype)
    q = default_qpos(m).repeat(n_candidates, 1)
    q[:, 0:2] = 0.0
    q[:, 2] = zs
    q[:, 3:7] = torch.as_tensor(quat, dtype=dtype, device=dev)
    q[:, 7:] = torch.as_tensor(joint_pos, dtype=dtype, device=dev)
    s = State(qpos=q, qvel=q.new_zeros((n_candidates, m.nv)),
              time=q.new_zeros(n_candidates))
    qacc, _, _, info = forward(m, s, q.new_zeros((n_candidates, m.nu)),
                               solver_iters=6)
    pen = torch.sum(torch.clamp(-info.contact_dist, min=0.0), dim=-1)
    return zs, torch.abs(qacc[:, 2]) + 100.0 * pen


def find_ideal_root_height(m: Model, joint_pos, quat,
                           n_candidates: int = 200, z_range=(-0.7, -0.2)
                           ) -> torch.Tensor:
    """The candidate root z (a 0-d tensor) whose static contact forces
    best support the pose (the mpc_utils.py:36-56 scan, batched)."""
    zs, scores = root_height_scores(m, joint_pos, quat, n_candidates,
                                    z_range)
    return zs[torch.argmin(scores)]


def set_robot_state(m: Model, joint_pos, joint_vel, ang_vel, quat,
                    height=None) -> State:
    """A full state (batch 1) from the robot's partial observation
    (set_mujoco_state, controllers/mpc_utils.py:58-72); the root height
    from `find_ideal_root_height` unless given."""
    dtype, dev = m.dtype, m.device

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)
    joint_pos, quat = t(joint_pos), t(quat)
    if height is None:
        height = find_ideal_root_height(m, joint_pos, quat)
    q = default_qpos(m)
    q[0:2] = 0.0
    q[2] = t(height)
    q[3:7] = quat / torch.linalg.vector_norm(quat)
    q[7:] = joint_pos
    v = torch.zeros(m.nv, dtype=dtype, device=dev)
    v[3:6] = t(ang_vel)
    v[6:] = t(joint_vel)
    return State(qpos=q[None], qvel=v[None],
                 time=torch.zeros(1, dtype=dtype, device=dev))
