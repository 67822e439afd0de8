"""Filter + Direct gRPC clients: the python/mujoco_mpc/{filter,
direct}.py binding analogs.

Counterpart of humanoid_mujoco_tpu/serving/grpc_estimation.py. Like
GrpcAgent (serving/grpc_client.py): find a free port, spawn `python -m
humanoid_mujoco_torch.serving.estimation_servers` on `device` as a
subprocess, open a localhost channel, mirror the proto verbs as methods;
the context manager kills the subprocess on exit. Needs grpcio and
protobuf.

    with GrpcFilter(task_id="Humanoid Cap Stand", device="cpu") as f:
        f.init(qpos)
        f.update(ctrl, sensor)
        s = f.state()

    with GrpcDirect(task_id="ParticleFixed",
                    configuration_length=8) as d:
        d.data(qpos_window)
        out = d.optimize()
"""

from __future__ import annotations

import atexit
import subprocess
import sys
from typing import Dict, Optional

import grpc
import numpy as np

from ..grpc import direct_pb2 as dpb
from ..grpc import filter_pb2 as fpb
from .estimation_servers import (DIRECT_RPCS, DIRECT_SERVICE, FILTER_RPCS,
                                 FILTER_SERVICE)


class _SpawnedClient:
    _SERVICE = ""
    _RPCS: Dict = {}

    def __init__(self, spawn_args, address: Optional[str],
                 connect_timeout: float, device: str):
        self._proc = None
        if address is None:
            import socket
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            self._proc = subprocess.Popen(
                [sys.executable, "-m",
                 "humanoid_mujoco_torch.serving.estimation_servers",
                 "--port", str(port), "--device", str(device)]
                + spawn_args)
            atexit.register(self.close)
            address = f"127.0.0.1:{port}"
        self._channel = grpc.insecure_channel(address)
        grpc.channel_ready_future(self._channel).result(
            timeout=connect_timeout)
        self._stubs = {
            name: self._channel.unary_unary(
                f"/{self._SERVICE}/{name}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_t.FromString)
            for name, (_req, resp_t) in self._RPCS.items()
        }

    def close(self):
        try:
            self._channel.close()
        except Exception:
            pass
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
            self._proc = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GrpcFilter(_SpawnedClient):
    _SERVICE = FILTER_SERVICE
    _RPCS = FILTER_RPCS

    def __init__(self, task_id: str = "Humanoid Cap Stand",
                 address: Optional[str] = None,
                 connect_timeout: float = 300.0, device: str = "cuda",
                 dtype: str = "float32"):
        super().__init__(["--service", "filter", "--dtype", dtype],
                         address, connect_timeout, device)
        self._task_id = task_id
        self._stubs["Init"](fpb.InitRequest(task_id=task_id))

    def init(self, qpos, qvel=None, task_id: str = ""):
        """(Re)initialize the filter state (filter.py Init analog);
        `task_id` switches the model, otherwise the current one stays."""
        if task_id:
            self._task_id = task_id
        self._stubs["Init"](fpb.InitRequest(
            task_id=self._task_id,
            qpos=np.asarray(qpos, float).tolist(),
            qvel=[] if qvel is None
            else np.asarray(qvel, float).tolist()))

    def reset(self):
        self._stubs["Reset"](fpb.Empty())

    def update(self, ctrl, sensor) -> float:
        r = self._stubs["Update"](fpb.UpdateRequest(
            ctrl=np.asarray(ctrl, float).tolist(),
            sensor=np.asarray(sensor, float).tolist()))
        return r.innovation

    def state(self) -> Dict[str, np.ndarray]:
        s = self._stubs["State"](fpb.Empty())
        return dict(qpos=np.asarray(s.qpos), qvel=np.asarray(s.qvel))

    def covariance(self) -> np.ndarray:
        c = self._stubs["Covariance"](fpb.Empty())
        return np.asarray(c.covariance).reshape(c.dimension, c.dimension)

    def noise(self) -> np.ndarray:
        return np.asarray(self._stubs["Noise"](fpb.Empty()).sensor)


class GrpcDirect(_SpawnedClient):
    _SERVICE = DIRECT_SERVICE
    _RPCS = DIRECT_RPCS

    def __init__(self, task_id: str = "ParticleFixed",
                 configuration_length: int = 16,
                 address: Optional[str] = None,
                 connect_timeout: float = 300.0, device: str = "cuda",
                 dtype: str = "float64"):
        super().__init__(["--service", "direct", "--dtype", dtype],
                         address, connect_timeout, device)
        self.T = configuration_length
        self._stubs["Init"](dpb.InitRequest(
            task_id=task_id,
            configuration_length=configuration_length))

    def data(self, qpos, sensor=None, ctrl=None):
        self._stubs["Data"](dpb.DataRequest(
            qpos=np.asarray(qpos, float).ravel().tolist(),
            sensor=[] if sensor is None
            else np.asarray(sensor, float).ravel().tolist(),
            ctrl=[] if ctrl is None
            else np.asarray(ctrl, float).ravel().tolist()))

    def settings(self, gn_iters: int = 0, estimate_mass: bool = False,
                 force_weight: float = 0.0, regularization: float = 0.0,
                 estimate_params=()) -> Dict:
        r = self._stubs["Settings"](dpb.SettingsRequest(
            gn_iters=gn_iters, estimate_mass=estimate_mass,
            force_weight=force_weight, regularization=regularization,
            estimate_params=list(estimate_params)))
        return dict(gn_iters=r.gn_iters, estimate_mass=r.estimate_mass,
                    force_weight=r.force_weight,
                    regularization=r.regularization,
                    estimate_params=tuple(r.estimate_params))

    def optimize(self) -> Dict:
        r = self._stubs["Optimize"](dpb.Empty())
        qpos = np.asarray(r.qpos)
        nq = qpos.size // self.T
        return dict(cost_initial=r.cost_initial, cost=r.cost_final,
                    mass_scale=r.mass_scale,
                    parameters=np.asarray(r.parameters),
                    qpos=qpos.reshape(self.T, nq),
                    qvel=np.asarray(r.qvel).reshape(self.T - 1, -1))

    def cost(self) -> float:
        return self._stubs["Cost"](dpb.Empty()).total

    def status(self) -> Dict:
        s = self._stubs["Status"](dpb.Empty())
        return dict(gn_iters=s.gn_iters, cost=s.cost,
                    optimized=s.optimized)

    def reset(self):
        self._stubs["Reset"](dpb.Empty())
