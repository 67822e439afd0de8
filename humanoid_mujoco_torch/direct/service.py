"""In-process Direct-optimizer service surface.

Counterpart of humanoid_mujoco_tpu/direct/service.py. The reference
exposes its direct trajectory optimizer as a stateful gRPC service
(mjpc/grpc/direct_service.{h,cc}: Init allocates the window, Data fills
the measurement buffers, Settings tunes the solver, Optimize runs it,
Cost / Status report). `DirectService` is that verb surface over
direct/optimizer.py, the relationship FilterService
(serving/filtering.py) has to filter.proto. Inputs and outputs are
numpy; the optimizer runs on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..estimators.sensors import SensorModel, default_sensor_model
from ..physics.model import Model
from .optimizer import DirectConfig, DirectResult, direct_optimize


class DirectService:
    def __init__(self, m: Model, configuration_length: int = 16,
                 dt: Optional[float] = None,
                 sensor: Optional[SensorModel] = None):
        if configuration_length < 3:
            raise ValueError("configuration_length must be >= 3")
        self.m = m
        self.T = int(configuration_length)
        self.dt = float(m.dt) if dt is None else float(dt)
        self.sensor = sensor or default_sensor_model(m)
        self.cfg = DirectConfig()
        self._qpos: Optional[np.ndarray] = None
        self._sensor: Optional[np.ndarray] = None
        self._ctrl: Optional[np.ndarray] = None
        self._result: Optional[DirectResult] = None

    # ---- verbs ----
    def set_data(self, qpos, sensor=None, ctrl=None):
        """Fill the window buffers (DataRequest): qpos (T, nq) is both
        the measured-configuration guess and the initialization."""
        qpos = np.asarray(qpos, dtype=float).reshape(self.T, self.m.nq)
        ny = int(self.sensor.noise.shape[0])
        if sensor is None:
            sensor = np.zeros((self.T, ny))
        sensor = np.asarray(sensor, dtype=float).reshape(self.T, ny)
        if ctrl is None:
            ctrl = np.zeros((self.T, self.m.nu))
        ctrl = np.asarray(ctrl, dtype=float).reshape(self.T, self.m.nu)
        self._qpos, self._sensor, self._ctrl = qpos, sensor, ctrl
        self._result = None

    def set_settings(self, gn_iters: int = 0, estimate_mass=None,
                     force_weight: float = 0.0,
                     regularization: float = 0.0,
                     estimate_params: Tuple[str, ...] = ()):
        """Zero and None fields leave the current setting unchanged
        (SettingsRequest semantics)."""
        kw = {}
        if gn_iters:
            kw["gn_iters"] = int(gn_iters)
        if estimate_mass is not None:
            kw["estimate_mass"] = bool(estimate_mass)
        if force_weight:
            kw["force_weight"] = float(force_weight)
        if regularization:
            kw["reg"] = float(regularization)
        if estimate_params:
            kw["estimate_params"] = tuple(estimate_params)
        self.cfg = dataclasses.replace(self.cfg, **kw)

    def settings(self) -> Dict:
        return dict(gn_iters=self.cfg.gn_iters,
                    estimate_mass=self.cfg.estimate_mass,
                    force_weight=float(self.cfg.force_weight),
                    regularization=float(self.cfg.reg),
                    estimate_params=tuple(self.cfg.estimate_params))

    def optimize(self) -> DirectResult:
        if self._qpos is None:
            raise RuntimeError("no data (call set_data first)")

        def t(x):
            return torch.as_tensor(x, dtype=self.m.dtype,
                                   device=self.m.device)
        self._result = direct_optimize(
            self.m, self.cfg, self.sensor, t(self._qpos), t(self._sensor),
            t(self._ctrl), self.dt)
        return self._result

    def cost(self) -> float:
        if self._result is None:
            raise RuntimeError("not optimized yet")
        return float(self._result.cost)

    def status(self) -> Dict:
        """The JAX service's status, and `improved`: whether the last
        optimize kept a step (its cost under the first iteration's); an
        optimize that kept none returned the window as it was given."""
        r = self._result
        return dict(gn_iters=self.cfg.gn_iters,
                    cost=float(r.cost) if r is not None else float("nan"),
                    optimized=r is not None,
                    improved=(r is not None
                              and float(r.cost) < float(r.cost_initial)))

    def reset(self):
        self._qpos = self._sensor = self._ctrl = None
        self._result = None
