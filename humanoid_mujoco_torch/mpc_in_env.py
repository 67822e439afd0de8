"""MPC driving the randomized RL environment: the robustness check
(the controllers/mpc_in_env.py:20-48 analog).

Counterpart of humanoid_mujoco_tpu/mpc_in_env.py. The MPC agent plans on
its own clean torque-actuated humanoid while the env runs the randomized
position-servo model (rl/env.py, a batch of one: kernel B1 with per-env
parameter packs, then B2) with observation noise, delays, pushes and
torque noise:

  loop: noisy env obs (joint pos/vel, ang vel) + the torso quaternion
        -> partial-state re-estimation (the root-height search)
        -> planner iterations -> action + N(0, 0.15 * 1.5) torque noise
        -> env step (the MPC's torques go straight into the env's
           position actuators, as in the reference)

The env's draws and the torque noise come from two `torch.Generator`s
seeded from `seed`; the agent draws from its own.

Usage:
  python -m humanoid_mujoco_torch.mpc_in_env --seconds 5 --rand 0.1 \\
      [--planner ilqg|sampling|cem|mppi] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import resolve_device

TORQUE_NOISE_STD = 0.15 * 1.5   # mpc_in_env.py:37


def run(seconds: float = 5.0, randomization_factor: float = 0.0,
        planner: str = "ilqg", planner_iterations: int = 2,
        horizon: int = 17, torque_noise: float = TORQUE_NOISE_STD,
        seed: int = 0, verbose: bool = True, device=None):
    """Run the loop for `seconds` of sim time or until the robot falls.
    Returns dict(survival_s, fell, mean_reward, control_hz, steps)."""
    from .agent import Agent
    from .physics.humanoid import build_humanoid
    from .rl.env import EnvConfig, _torso_quat, batch_reset, batch_step
    from .rl.env import rl_humanoid_model
    from .serving.state_estimation import set_robot_state
    from .tasks import stand_task

    dev = resolve_device(device)
    # env: randomized position-servo model, stand mode (falling ends it)
    env_cfg = EnvConfig(standup=False, max_sim_time=seconds)
    base = rl_humanoid_model(device=dev)
    env_gen = torch.Generator(device=dev)
    env_gen.manual_seed(seed)
    noise_gen = torch.Generator(device=dev)
    noise_gen.manual_seed(seed)
    es, obs = batch_reset(env_cfg, base, randomization_factor, 1, env_gen)

    # MPC: clean torque model + stand task
    agent = Agent(build_humanoid(device=dev), stand_task(device=dev),
                  planner=planner, horizon=horizon)

    rewards, n_steps = [], 0
    t0 = time.time()
    done = False
    max_steps = int(seconds / 0.002)
    while not done and n_steps < max_steps:
        o = obs[0]
        # the ground-truth torso quaternion (env.torso_quat,
        # mpc_in_env.py:26-31)
        quat = _torso_quat(es.patch.apply(base), es)[0]
        agent.state = set_robot_state(agent.model, o[:12], o[12:24],
                                      o[24:27], quat)
        for _ in range(planner_iterations):
            agent.planner_step()
        u = torch.as_tensor(agent.get_action(), dtype=base.dtype,
                            device=dev)
        u = u + torque_noise * torch.randn(u.shape, generator=noise_gen,
                                           device=dev, dtype=base.dtype)
        es, obs, r, term, _ = batch_step(env_cfg, base, es, u[None],
                                         env_gen)
        rewards.append(float(r[0]))
        done = bool(term[0])
        n_steps += 1

    wall = time.time() - t0
    out = dict(survival_s=n_steps * 0.002,
               fell=bool(done),
               mean_reward=float(np.mean(rewards)) if rewards else 0.0,
               control_hz=n_steps / max(wall, 1e-9),
               steps=n_steps)
    if verbose:
        print(f"survived {out['survival_s']:.2f}s / {seconds}s "
              f"(fell={out['fell']}), mean reward "
              f"{out['mean_reward']:.2f}, {out['control_hz']:.1f} Hz",
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rand", type=float, default=0.0)
    ap.add_argument("--planner", default="ilqg",
                    help="ilqg, sampling, cem or mppi")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--horizon", type=int, default=17)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    run(seconds=args.seconds, randomization_factor=args.rand,
        planner=args.planner, planner_iterations=args.iters,
        horizon=args.horizon, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
