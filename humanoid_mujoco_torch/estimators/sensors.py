"""Measurement model shared by the estimators.

Counterpart of humanoid_mujoco_tpu/estimators/sensors.py. The reference
estimators consume MuJoCo sensor vectors (estimators/kalman.cc
measurement updates). Here the measurement mirrors what the real robot
reports to controllers/mpc_server.py:32-50: joint positions (12), joint
velocities (12), torso angular velocity (3, local) and the IMU gravity
direction (3, local). It is differentiable, so the EKF's H comes from
forward-mode derivatives in tangent coordinates
(`planners.derivatives._jacfwd`).

Every function takes batch-leading `(B, ...)` tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from ..physics import math as pm
from ..physics.humanoid import ACTUATED_JOINT_ORDER
from ..physics.model import Model
from ..physics.tangent import state_add
from ..planners.derivatives import _jacfwd


@dataclasses.dataclass(frozen=True)
class SensorModel:
    """Measurement spec: the noise scales (R's diagonal)."""

    noise: torch.Tensor       # (ny,) measurement noise std


def _is_robot_model(m: Model) -> bool:
    """True for the 12-DOF humanoid whose joints and IMU the robot
    reports (controllers/mpc_server.py:32-50); other models fall back to
    a generic full-state measurement so the estimators and the direct
    service work for any registry task."""
    names = set(m.struct.jnt_names)
    return all(n in names for n in ACTUATED_JOINT_ORDER)


def default_sensor_model(m: Model, dtype=torch.float32) -> SensorModel:
    """The noise scales of `measure`, on the model's device. The dtype is
    float32 unless given, whatever the model's, as in the JAX package."""
    if _is_robot_model(m):
        scales = ((12, 0.035),   # ~2 deg joint angle
                  (12, 0.087),   # ~5 deg/s joint velocity
                  (3, 0.035),    # gyro
                  (3, 0.05))     # gravity direction
    else:
        scales = ((m.nq, 0.01), (m.nv, 0.05))
    noise = torch.cat([torch.full((n, ), s, dtype=dtype, device=m.device)
                       for n, s in scales])
    return SensorModel(noise=noise)


def _robot_indices(m: Model):
    """(qpos addresses, qvel addresses) of the actuated joints in
    actuator order, as index tensors on the model's device."""
    def build():
        s = m.struct
        jids = [s.jnt_id(n) for n in ACTUATED_JOINT_ORDER]
        return tuple(torch.tensor([adr[j] for j in jids], dtype=torch.long,
                                  device=m.device)
                     for adr in (s.jnt_qadr, s.jnt_vadr))
    return m.struct_static(("robot_sensor_indices", m.device), build)


def measure(m: Model, qpos: torch.Tensor, qvel: torch.Tensor
            ) -> torch.Tensor:
    """h(x) (B, ny): the 30-D robot measurement (joints in actuator
    order), or the generic [qpos, qvel] for other models."""
    if not _is_robot_model(m):
        return torch.cat([qpos, qvel], dim=-1)
    qadr, vadr = _robot_indices(m)
    quat = pm.quat_normalize(qpos[:, 3:7])
    # filled on the device: a tensor from a list would copy (and sync)
    down = qpos.new_zeros((quat.shape[0], 3))
    down[:, 2] = -1.0
    gravity = pm.quat_rotate_inv(quat, down)
    return torch.cat([qpos[:, qadr], qvel[:, vadr], qvel[:, 3:6], gravity],
                     dim=-1)


def measurement_jacobian(m: Model, qpos: torch.Tensor, qvel: torch.Tensor
                         ) -> torch.Tensor:
    """H (B, ny, 2nv): the derivative of h in tangent coordinates, the
    2·nv unit tangents of each state in the batch of one dual pass."""
    nv = m.nv
    n = 2 * nv

    def f(z):
        qp = state_add(m, qpos.repeat_interleave(n, dim=0), z[:, :nv])
        return (measure(m, qp, qvel.repeat_interleave(n, dim=0)
                        + z[:, nv:]),)

    [(_, H)] = _jacfwd(f, qpos.shape[0], n, qpos.dtype, qpos.device)
    return H
