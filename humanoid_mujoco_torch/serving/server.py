"""Robot-facing TCP/JSON MPC server (the controllers/mpc_server.py
analog).

Counterpart of humanoid_mujoco_tpu/serving/server.py. Protocol
(mpc_server.py:32-65): the client sends one JSON object per request,

  {"joint_pos": [12], "joint_vel": [12], "ang_vel": [3], "quat": [4]},

and the server replies with a JSON list of 12 torques, or of position
targets joint_pos + 0.3 * torque in position mode
(TORQUE_TO_POSITION_MULTIPLIER, mpc_server.py:8-20). A request that
cannot be served gets {"error": "..."}.

Per request: re-estimate the full state (the root-height search), run
`planner_iterations` planner steps, reply with the policy's action
(compute_action, controllers/mpc_utils.py:89-106). With `filter="ekf"`
the state comes from an EKF that persists across requests
(serving/filtering.py::ServingFilter, the reference's estimator thread,
app.cc:151-205): the first request initializes it through the
root-height search, every later one folds the observation in with the
action the previous request returned as the predict's control, so the
root's linear velocity and height are tracked instead of re-guessed.

Run it with

  python -m humanoid_mujoco_torch.serving.server [--planner sampling]

(`--planner` defaults to "ilqg", as in the JAX package; `--device cpu`
runs the plain PyTorch path).

With `async_mode=True` (the reference's plan-while-acting architecture,
agent.cc:318-329) a native plan thread (native/async_agent.py) iterates
the planner continuously on the agent's device against the freshest
request state, and each request returns at once the action of the
latest published policy, evaluated on the CPU: its latency is one
policy query, not `planner_iterations` plans. The loop starts with the
first request and stops with `stop()`. It works with `filter="ekf"`
too: the filter's state is what the plan thread receives.
"""

from __future__ import annotations

import argparse
import json
import socket
import threading
import time
from typing import Optional

import numpy as np

from ..agent import Agent
from .filtering import ServingFilter
from .state_estimation import set_robot_state

TORQUE_TO_POSITION_MULTIPLIER = 0.3   # mpc_server.py:16
DEFAULT_PORT = 5555                   # mpc_server.py:22


class MPCServer:
    def __init__(self, agent: Agent, planner_iterations: int = 2,
                 position_mode: bool = False, port: int = DEFAULT_PORT,
                 host: str = "127.0.0.1", async_mode: bool = False,
                 filter: str = "none"):
        if filter not in ("none", "ekf"):
            raise ValueError(f"unknown filter {filter!r}")
        self.async_mode = async_mode
        self._async = None
        self._t0 = None
        self.filter_mode = filter
        self._filter = None
        self._last_action = None
        self.agent = agent
        self.planner_iterations = planner_iterations
        self.position_mode = position_mode
        self.port = port
        self.host = host
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self.listening = threading.Event()   # set once bound (see port)

    def start_async(self):
        """Start the background plan loop (idempotent)."""
        if self._async is None:
            from ..native.async_agent import AsyncAgent
            self._async = AsyncAgent(self.agent)
            self._t0 = time.monotonic()
            self._async.start()
        return self._async

    def stop_async(self):
        """Stop the plan loop; re-raise the exception that ended it."""
        if self._async is not None:
            a, self._async = self._async, None
            a.stop()

    @property
    def plan_iterations(self) -> int:
        return self._async.plan_iterations if self._async else 0

    def compute_action(self, joint_pos, joint_vel, ang_vel, quat
                       ) -> np.ndarray:
        """State re-estimation + plan + action (mpc_utils.py:89-106).
        An observation of the wrong length or type raises ValueError or
        TypeError."""
        m = self.agent.model
        obs = []
        for name, x, n in (("joint_pos", joint_pos, m.nq - 7),
                           ("joint_vel", joint_vel, m.nv - 6),
                           ("ang_vel", ang_vel, 3), ("quat", quat, 4)):
            x = np.asarray(x, dtype=np.float64)
            if x.shape != (n,):
                raise ValueError(f"{name} must hold {n} numbers, "
                                 f"not shape {x.shape}")
            obs.append(x)
        joint_pos, joint_vel, ang_vel, quat = obs
        if self.filter_mode == "ekf":
            if self._filter is None:
                self._filter = ServingFilter(m)
            state = self._filter.update(joint_pos, joint_vel, ang_vel, quat,
                                        last_ctrl=self._last_action)
        else:
            state = set_robot_state(m, joint_pos, joint_vel, ang_vel, quat)
        if self.async_mode:
            a = self.start_async()
            t = time.monotonic() - self._t0
            qpos, qvel = (x[0].double().cpu().numpy()
                          for x in (state.qpos, state.qvel))
            a.set_state(qpos, qvel, t)
            action = a.get_action(qpos, qvel, t)
        else:
            self.agent.state = state
            for _ in range(self.planner_iterations):
                self.agent.planner_step()
            action = self.agent.get_action()
        self._last_action = np.asarray(action)   # the EKF's predict ctrl
        if self.position_mode:
            # the torque command as joint position targets
            action = joint_pos + TORQUE_TO_POSITION_MULTIPLIER * action
        return np.asarray(action)

    def handle(self, conn: socket.socket):
        """Serve one connection until it closes. `raw_decode` takes one
        object per pass, so two requests that arrive in one recv are
        both served and a partial one waits for the rest."""
        decoder = json.JSONDecoder()
        buf = ""
        with conn:
            while not self._stop.is_set():
                data = conn.recv(65536)
                if not data:
                    break
                buf += data.decode()
                while True:
                    stripped = buf.lstrip()
                    if not stripped:
                        buf = ""
                        break
                    try:
                        msg, end = decoder.raw_decode(stripped)
                    except json.JSONDecodeError:
                        buf = stripped  # partial message: await more
                        break
                    buf = stripped[end:]
                    t0 = time.perf_counter()
                    try:
                        action = self.compute_action(
                            msg["joint_pos"], msg["joint_vel"],
                            msg["ang_vel"], msg["quat"])
                        reply = json.dumps(
                            [float(x) for x in action]).encode()
                    except (KeyError, ValueError, TypeError) as e:
                        reply = json.dumps({"error": str(e)}).encode()
                    conn.sendall(reply)
                    dt = time.perf_counter() - t0
                    # control-frequency probe (mpc_server.py:67-69)
                    print(f"control frequency: "
                          f"{1.0 / max(dt, 1e-9):.1f} Hz", flush=True)

    def serve_forever(self):
        """Accept one connection at a time and serve it until stop().
        With port 0 the system picks a free port; `port` holds the bound
        one once `listening` is set."""
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self._sock.listen(1)
        self.port = self._sock.getsockname()[1]
        self.listening.set()
        print(f"MPC server listening on {self.host}:{self.port}",
              flush=True)
        while not self._stop.is_set():
            try:
                self._sock.settimeout(1.0)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                if self._stop.is_set():
                    break
                raise
            self.handle(conn)

    def stop(self):
        """Stop serving and the plan loop (re-raising its failure)."""
        self._stop.set()
        if self._sock is not None:
            self._sock.close()
        self.stop_async()


def serve(planner: str = "ilqg", port: int = DEFAULT_PORT, device=None,
          **agent_kw):
    """Serve the stand task on the humanoid with `planner`."""
    from ..physics.humanoid import build_humanoid
    from ..tasks import stand_task
    agent = Agent(build_humanoid(device=device), stand_task(device=device),
                  planner=planner, **agent_kw)
    MPCServer(agent, port=port).serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--planner", default="ilqg",
                    help="ilqg, sampling, cem or mppi")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    serve(planner=args.planner, port=args.port, device=args.device)


if __name__ == "__main__":
    main()
