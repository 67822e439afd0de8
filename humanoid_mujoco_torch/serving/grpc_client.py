"""Agent gRPC client: the python/mujoco_mpc/agent.py binding analog.

Counterpart of humanoid_mujoco_tpu/serving/grpc_client.py. The
reference binding finds a free port, spawns the `agent_server` binary as
a subprocess, opens a localhost channel and mirrors the proto verbs as
methods (agent.py:81-123, 135-393). Same here, with `python -m
humanoid_mujoco_torch.serving.grpc_server --device DEVICE` as the server
process. Context manager: kills the subprocess on exit. Needs grpcio
and protobuf.

    with GrpcAgent(task_id="ParticleFixed", planner="sampling",
                   device="cpu") as ag:
        ag.set_state(qpos=[0, 0])
        ag.planner_step()
        u = ag.get_action()
"""

from __future__ import annotations

import atexit
import subprocess
import sys
from typing import Dict, Optional

import grpc
import numpy as np

from ..grpc import agent_pb2 as pb
from .grpc_server import RPCS, SERVICE


class GrpcAgent:
    def __init__(self, task_id: str = "Humanoid Cap Stand",
                 planner: str = "ilqg", horizon: int = 0,
                 nsample: int = 0, address: Optional[str] = None,
                 spawn: bool = True, connect_timeout: float = 300.0,
                 device: str = "cuda"):
        """`address` connects to a running server; otherwise spawns a
        server subprocess on a free port (agent.py:100-113), planning on
        `device`."""
        self._proc = None
        if address is None and spawn:
            import socket
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            self._proc = subprocess.Popen(
                [sys.executable, "-m",
                 "humanoid_mujoco_torch.serving.grpc_server",
                 "--task", task_id, "--planner", planner,
                 "--port", str(port), "--device", str(device)]
                + (["--horizon", str(horizon)] if horizon else [])
                + (["--nsample", str(nsample)] if nsample else []))
            atexit.register(self.close)
            address = f"127.0.0.1:{port}"
        self._channel = grpc.insecure_channel(address)
        grpc.channel_ready_future(self._channel).result(
            timeout=connect_timeout)
        self._stubs = {
            name: self._channel.unary_unary(
                f"/{SERVICE}/{name}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_t.FromString)
            for name, (_req_t, resp_t) in RPCS.items()
        }
        if address is not None and self._proc is None and task_id:
            # remote server may be un-initialized; Init is idempotent
            self._stubs["Init"](pb.InitRequest(
                task_id=task_id, planner=planner, horizon=horizon,
                nsample=nsample))

    # ---- verbs (python/mujoco_mpc/agent.py:135-393 surface) ----
    def set_state(self, qpos=None, qvel=None, time=None):
        self._stubs["SetState"](pb.State(
            qpos=[] if qpos is None else np.asarray(qpos, float).tolist(),
            qvel=[] if qvel is None else np.asarray(qvel, float).tolist(),
            time=float("nan") if time is None else float(time)))

    def get_state(self) -> Dict[str, np.ndarray]:
        s = self._stubs["GetState"](pb.Empty())
        return dict(qpos=np.asarray(s.qpos), qvel=np.asarray(s.qvel),
                    time=s.time)

    def planner_step(self, iterations: int = 1) -> float:
        r = self._stubs["PlannerStep"](
            pb.PlannerStepRequest(iterations=iterations))
        return r.best_return

    def get_action(self, time: Optional[float] = None,
                   averaging_duration: float = 0.0,
                   nominal_action: bool = False) -> np.ndarray:
        a = self._stubs["GetAction"](pb.GetActionRequest(
            time=-1.0 if time is None else time,
            averaging_duration=averaging_duration,
            nominal_action=nominal_action))
        return np.asarray(a.action)

    def step(self) -> np.ndarray:
        return np.asarray(self._stubs["Step"](pb.Empty()).action)

    def reset(self):
        self._stubs["Reset"](pb.Empty())

    def set_task_parameters(self, parameters: Dict[str, float]):
        self._stubs["SetTaskParameters"](
            pb.TaskParameters(parameters=parameters))

    def set_cost_weights(self, weights: Dict[str, float]):
        self._stubs["SetCostWeights"](pb.CostWeights(weights=weights))

    def get_cost_term_values(self) -> Dict[str, float]:
        return dict(self._stubs["GetCostValuesAndWeights"](
            pb.Empty()).values)

    def get_cost_weights(self) -> Dict[str, float]:
        return dict(self._stubs["GetCostValuesAndWeights"](
            pb.Empty()).weights)

    def get_residuals(self) -> np.ndarray:
        return np.asarray(
            self._stubs["GetResiduals"](pb.Empty()).residuals)

    def set_mode(self, mode: str):
        self._stubs["SetMode"](pb.Mode(mode=mode))

    def get_mode(self) -> str:
        return self._stubs["GetMode"](pb.Empty()).mode

    def set_mocap(self, name: str, pos=None, quat=None):
        self._stubs["SetMocap"](pb.Mocap(
            name=name,
            pos=[] if pos is None else list(map(float, pos)),
            quat=[] if quat is None else list(map(float, quat))))

    def best_trajectory(self) -> Dict[str, np.ndarray]:
        t = self._stubs["GetBestTrajectory"](pb.Empty())
        out = dict(times=np.asarray(t.times))
        if t.nq:
            out["qpos"] = np.asarray(t.qpos).reshape(t.horizon + 1, t.nq)
            out["qvel"] = np.asarray(t.qvel).reshape(t.horizon + 1, t.nv)
            out["actions"] = np.asarray(t.actions).reshape(t.horizon,
                                                           t.nu)
        else:
            out["knots"] = np.asarray(t.actions).reshape(t.horizon, t.nu)
        return out

    def set_anything(self, model: Optional[Dict] = None,
                     state: Optional[Dict] = None,
                     task: Optional[Dict] = None):
        def entries(d):
            return [pb.Anything.Entry(
                field=k, value=np.ravel(np.asarray(v, float)).tolist())
                for k, v in (d or {}).items()]
        self._stubs["SetAnything"](pb.Anything(
            model=entries(model), state=entries(state),
            task=entries(task)))

    # ---- lifecycle ----
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
