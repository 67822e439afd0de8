"""Cross-request state filtering for robot serving.

Counterpart of humanoid_mujoco_tpu/serving/filtering.py. The reference
runs an estimator in its own thread feeding the planner
(mjpc/app.cc:151-205) and exposes it as a standalone `filter_server`
binary (mjpc/grpc/CMakeLists.txt:281, grpc/filter_service.cc). Without
it, the serving path rebuilds the state on every request with a zero
root linear velocity and no memory between requests.

`ServingFilter` closes that gap: an EKF (estimators/kalman.py, batch 1)
that persists across requests. The first observation initializes the
state through the root-height search (`set_robot_state`); every later
one runs a predict with the last applied control and a measurement
update, so the root's linear velocity and height are tracked rather
than re-guessed.

`FilterService` mirrors the filter.proto verb surface (Init / Update /
State / Covariance / Noise / Reset) in process, as agent.py does
agent.proto. Its inputs and outputs are numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..estimators.kalman import EKFConfig, EKFState, ekf_init, ekf_update
from ..estimators.sensors import SensorModel, default_sensor_model
from ..physics import math as pm
from ..physics.model import Model, State
from .state_estimation import set_robot_state


def _as_tensor(x, dtype, device) -> torch.Tensor:
    """x (a tensor, an array or a list) as a tensor of dtype on device."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                           dtype=dtype, device=device)


def robot_measurement(joint_pos, joint_vel, ang_vel, quat,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """The robot report as the 30-D measurement of
    estimators/sensors.py::measure (joint positions, joint velocities,
    gyro, the IMU gravity direction from the reported quaternion), on
    `device` (`cuda` unless given). Inputs may carry leading batch
    axes; the output is (..., 30)."""
    device = resolve_device(device)

    def t(x):
        return _as_tensor(x, dtype, device)
    quat = t(quat)
    down = torch.zeros(quat.shape[:-1] + (3, ), dtype=dtype, device=device)
    down[..., 2] = -1.0
    gravity = pm.quat_rotate_inv(pm.quat_normalize(quat), down)
    return torch.cat([t(joint_pos), t(joint_vel), t(ang_vel), gravity],
                     dim=-1)


class ServingFilter:
    """An EKF that persists across serving requests (the app.cc:151-205
    estimator thread, in the request path), on the model's device."""

    def __init__(self, m: Model, cfg: Optional[EKFConfig] = None,
                 sensor: Optional[SensorModel] = None):
        self.m = m
        self.cfg = cfg or EKFConfig()
        self.sensor = sensor or default_sensor_model(m)
        self.ekf: Optional[EKFState] = None
        self.innovation = 0.0

    def reset(self):
        self.ekf = None
        self.innovation = 0.0

    def _tensor(self, x) -> torch.Tensor:
        return _as_tensor(x, self.m.dtype, self.m.device)

    def _update(self, ctrl, y) -> float:
        """One EKF update with ctrl (nu,) and y (ny,); the innovation's
        norm."""
        self.ekf, innov = ekf_update(self.m, self.cfg, self.sensor,
                                     self.ekf, self._tensor(ctrl)[None],
                                     self._tensor(y)[None])
        self.innovation = float(innov[0])
        return self.innovation

    def update(self, joint_pos, joint_vel, ang_vel, quat,
               last_ctrl=None) -> State:
        """Fold one robot observation in; returns the filtered State
        (batch 1).

        `last_ctrl` is the action applied since the previous request
        (Estimator::Update(ctrl, sensor), estimators/estimator.h:66).
        """
        if self.ekf is None:
            s0 = set_robot_state(self.m, joint_pos, joint_vel, ang_vel,
                                 quat)
            self.ekf = ekf_init(self.m, self.cfg, s0)
            return self.ekf.state
        if last_ctrl is None:
            last_ctrl = np.zeros(self.m.nu)
        self._update(last_ctrl, robot_measurement(
            joint_pos, joint_vel, ang_vel, quat, dtype=self.m.dtype,
            device=self.m.device))
        return self.ekf.state

    @property
    def state(self) -> Optional[State]:
        return None if self.ekf is None else self.ekf.state

    @property
    def covariance(self) -> Optional[torch.Tensor]:
        """The covariance (2nv, 2nv), or None before the first update."""
        return None if self.ekf is None else self.ekf.cov[0]


class FilterService:
    """The in-process `filter_server` surface (grpc/filter.proto: Init /
    Reset / Update / State / Covariance / Noise), on ServingFilter."""

    def __init__(self, m: Model, cfg: Optional[EKFConfig] = None):
        self._f = ServingFilter(m, cfg)

    def init(self, qpos, qvel=None):
        m = self._f.m
        qpos = self._f._tensor(qpos).reshape(1, m.nq)
        qvel = (torch.zeros_like(qpos[:, :m.nv]) if qvel is None
                else self._f._tensor(qvel).reshape(1, m.nv))
        s = State(qpos=qpos, qvel=qvel, time=qpos.new_zeros(1))
        self._f.ekf = ekf_init(m, self._f.cfg, s)

    def reset(self):
        self._f.reset()

    def update(self, ctrl, sensor_y) -> float:
        """The raw Estimator::Update: the control applied and the
        measurement vector; returns the innovation's norm."""
        if self._f.ekf is None:
            raise RuntimeError("filter not initialized (call init)")
        return self._f._update(ctrl, sensor_y)

    def state(self):
        s = self._f.state
        if s is None:
            return None
        return dict(qpos=s.qpos[0].cpu().numpy(),
                    qvel=s.qvel[0].cpu().numpy())

    def covariance(self):
        c = self._f.covariance
        return None if c is None else c.cpu().numpy()

    def noise(self):
        return self._f.sensor.noise.cpu().numpy()
