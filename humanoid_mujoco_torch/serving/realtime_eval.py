"""Real-time-paced closed-loop eval with the asynchronous agent.

Counterpart of humanoid_mujoco_tpu/serving/realtime_eval.py. The
reference's deployment shape (app.cc:90-93, the physics thread querying
ActionFromPolicy while the plan thread iterates continuously,
app.cc:493-496): a wall-clock-paced control loop steps the sim and
queries `AsyncAgent.get_action` at `control_hz` while the native plan
loop replans on `device` (the card by default) against the freshest
state. Reports achieved control Hz, plan iterations/s, get_action's
latency and the closed-loop cost trace.

The sim is the robot proxy (`RobotProxy`, which viz/live.py drives
too): on a deployment it is hardware, so it shares neither the card nor
the interpreter with the planner. It steps the plain PyTorch step on
the CPU, float32 as the agent's model, in a spawned process of its own,
as the JAX module pins its sim to the host: the JAX package compiles
that step for the host (XLA runs outside the GIL), while the port's
eager step is a Python call per operation, and as a thread of the
planner's process it would contend for the GIL with the plan thread's
launches (1.6 Hz of control at 100 Hz asked on the H100's host:
PERF.md §6). The control thread exchanges one message a control
period with it: the action and an optional wrench in; the state, the
task's cost and terms and the collision spheres' centres out, numpy
throughout.

A paced run (`realtime`) lasts `seconds` of wall time, at most seconds
x control_hz control steps: where the proxy cannot keep the pace, fewer
steps run and the achieved rate says so.

Usage:
  python -m humanoid_mujoco_torch.serving.realtime_eval --seconds 5
"""

from __future__ import annotations

import argparse
import multiprocessing
import time

import numpy as np


def _serve(conn, task_name: str, substeps: int):
    """The proxy process: reply to each (ctrl, xfrc) with the state after
    `substeps` steps; None ends it."""
    import torch
    torch.set_num_threads(1)
    from ..physics.collision import sphere_world_centers
    from ..physics.engine import fwd_position
    from ..physics.model import make_state
    from ..physics.step import step
    from ..planners.derivatives import _light_info
    from ..tasks import registry
    from ..tasks.base import cost_terms, cost_value

    m = registry.task_model(task_name, device="cpu")
    task = registry.get_task(task_name, device="cpu")
    s = make_state(m, qpos=registry.home_qpos(task_name, m))
    zero = torch.zeros((1, m.nu), dtype=m.dtype)

    def observe(s, u):
        res = task.residual(m, s, _light_info(m, s), u)
        kin = fwd_position(m, s.qpos)
        return dict(
            qpos=s.qpos[0].double().numpy(), qvel=s.qvel[0].double().numpy(),
            time=float(s.time[0]), cost=float(cost_value(task, res)[0]),
            terms=cost_terms(task, res)[0].double().numpy(),
            centers=sphere_world_centers(m, kin.xpos, kin.xmat)[0]
            .double().numpy())

    with torch.inference_mode():
        conn.send(observe(s, zero))
        while True:
            msg = conn.recv()
            if msg is None:
                break
            ctrl, xfrc = msg
            u = torch.as_tensor(ctrl, dtype=m.dtype).reshape(1, m.nu)
            f = (None if xfrc is None else torch.as_tensor(
                xfrc, dtype=m.dtype).reshape(1, m.struct.nbody, 6))
            try:
                for _ in range(substeps):
                    s, _ = step(m, s, u, xfrc=f)
                conn.send(observe(s, u))
            except Exception as e:   # noqa: BLE001, raised by the caller
                conn.send(dict(error=repr(e)))
    conn.close()


class RobotProxy:
    """Task `task_name`'s model at its home pose, `substeps` steps of its
    dt per `step` call, in a spawned process. `obs` holds the latest
    observation: qpos, qvel (float64), time, cost (the task's total),
    terms (per term) and centers (the collision spheres, (nsph, 3))."""

    def __init__(self, task_name: str, substeps: int):
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_serve,
                                 args=(child, task_name, substeps),
                                 daemon=True)
        self._proc.start()
        child.close()
        self.obs = self._conn.recv()

    def step(self, ctrl, xfrc=None) -> dict:
        """Apply ctrl (nu,) and the optional wrenches (nbody, 6) for the
        substeps; returns the new observation."""
        self._conn.send((np.asarray(ctrl, dtype=np.float64),
                         None if xfrc is None else np.asarray(xfrc)))
        obs = self._conn.recv()
        if "error" in obs:
            raise RuntimeError(f"the robot proxy failed: {obs['error']}")
        self.obs = obs
        return obs

    def close(self):
        if self._proc is not None:
            try:
                self._conn.send(None)
            except (BrokenPipeError, OSError):
                pass
            self._proc.join(timeout=30)
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join()
            self._proc = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run(seconds: float = 5.0, control_hz: float = 100.0,
        planner: str = "ilqg", horizon: int = 17, nsample: int = 32,
        realtime: bool = True, verbose: bool = True, device=None):
    from .. import resolve_device
    from ..agent import Agent
    from ..native.async_agent import AsyncAgent
    from ..physics import humanoid
    from ..tasks import stand_task

    dev = resolve_device(device)
    m = humanoid.build_humanoid(device=dev)
    agent = Agent(m, stand_task(device=dev), planner=planner,
                  horizon=horizon, nsample=nsample)
    agent.set_state(qpos=humanoid.stand_qpos(m))
    agent.planner_step()     # warm the plan path before the clock starts

    # sim substeps per control period at the model's own dt
    sub = max(1, int(round(1.0 / control_hz / float(m.dt))))
    aa = AsyncAgent(agent)
    n_ctrl = int(seconds * control_hz)
    period = 1.0 / control_hz
    costs = []
    act_lat = []    # per-call get_action latency (the robot-facing path)
    sim_lat = []    # per-call robot proxy step (the sim, another process)
    robot = RobotProxy("Humanoid Cap Stand", sub)
    t_start = time.monotonic()
    try:
        aa.start()
        for i in range(n_ctrl):
            if realtime and time.monotonic() - t_start >= seconds:
                break    # the proxy could not keep the pace: stop on time
            o = robot.obs
            t_q = time.perf_counter()
            u = aa.get_action(o["qpos"], o["qvel"], o["time"])
            act_lat.append(time.perf_counter() - t_q)
            t_q = time.perf_counter()
            o = robot.step(u)
            sim_lat.append(time.perf_counter() - t_q)
            aa.set_state(o["qpos"], o["qvel"], o["time"])
            costs.append(o["cost"])
            if realtime:
                sleep = (i + 1) * period - (time.monotonic() - t_start)
                if sleep > 0:
                    time.sleep(sleep)
    finally:
        wall = time.monotonic() - t_start
        robot.close()
        aa.stop()     # joins the plan thread; re-raises its failure
    iters = aa.plan_iterations

    out = dict(achieved_control_hz=len(costs) / wall,
               plan_iterations_per_s=iters / wall,
               plan_iterations=iters,
               action_latency_ms_mean=float(np.mean(act_lat) * 1e3),
               action_latency_ms_p50=float(np.percentile(act_lat, 50) * 1e3),
               action_latency_ms_p99=float(
                   np.percentile(act_lat, 99) * 1e3),
               sim_step_ms_mean=float(np.mean(sim_lat) * 1e3),
               mean_cost=float(np.mean(costs)),
               final_cost=float(np.mean(costs[-int(control_hz):])),
               wall_s=wall, control_steps=len(costs), sim_substeps=sub)
    if verbose:
        print(f"control: {out['achieved_control_hz']:.1f} Hz (target "
              f"{control_hz}), planning: {out['plan_iterations_per_s']:.1f}"
              f" it/s ({iters} total), mean cost/step "
              f"{out['mean_cost']:.4f}, last-second cost "
              f"{out['final_cost']:.4f}", flush=True)
    return out


def measure_async_rates(duration_s: float = 3.0, control_hz: float = 100.0,
                        device=None) -> dict:
    """Compact async-deployment numbers: plans/s, achieved control Hz,
    and get_action's latency while the plan loop replans continuously
    (the sampling planner, 128 candidates)."""
    out = run(seconds=duration_s, control_hz=control_hz,
              planner="sampling", nsample=128, realtime=True,
              verbose=False, device=device)
    return {
        "async_control_hz": round(out["achieved_control_hz"], 1),
        "async_plans_per_s": round(out["plan_iterations_per_s"], 2),
        "async_action_latency_ms": round(
            out["action_latency_ms_mean"], 3),
        "async_action_latency_p99_ms": round(
            out["action_latency_ms_p99"], 3),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--hz", type=float, default=100.0)
    ap.add_argument("--planner", default="ilqg")
    ap.add_argument("--horizon", type=int, default=17)
    ap.add_argument("--as-fast-as-possible", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    run(seconds=args.seconds, control_hz=args.hz, planner=args.planner,
        horizon=args.horizon, realtime=not args.as_fast_as_possible,
        device=args.device)


if __name__ == "__main__":
    main()
