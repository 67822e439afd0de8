"""Policy video export: the generate_policy_videos.py analog.

Counterpart of humanoid_mujoco_tpu/rl/videos.py. The reference rolls
the trained SB3 policy in the randomized env and writes 9 green-screen
MP4s of ~5 s each through cv2.VideoWriter (its
rl/generate_policy_videos.py:36-51). Same shape here: roll the policy in
the env (batch 1, on the model's device), record qpos at control rate,
render with the sphere-cloud software renderer (viz/render.py) and
write MP4s.

`record_episode` draws its reset and step draws from a generator
seeded `seed`, or takes them as tensors (`reset_draws`, `step_draws`),
which is how the tests feed it the JAX package's draws.

Usage:
  python -m humanoid_mujoco_torch.rl.videos --ckpt runs/ckpt_0000100.pt \\
      --out runs/videos --n 9 --seconds 5 --rand 0.0 [--greenscreen] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import torch

from .. import resolve_device
from .env import (EnvConfig, ResetDraws, StepDraws, draw_reset, draw_step,
                  env_reset, env_step, rl_humanoid_model)
from .evaluate import load_policy

CONTROL_HZ = 500.0


def record_episode(ckpt: Optional[str] = None, seconds: float = 5.0,
                   randomization_factor: float = 0.0, seed: int = 0,
                   standup: bool = True, device=None,
                   dtype=torch.float32,
                   reset_draws: Optional[ResetDraws] = None,
                   step_draws: Optional[Sequence[StepDraws]] = None):
    """Roll one episode of the checkpoint's deterministic policy (the
    zero policy without one) until it ends or `seconds` of control at
    500 Hz. Returns (the model the episode ran on, its randomization
    applied; the qpos trajectory (T, nq) as numpy)."""
    dev = resolve_device(device)
    base = rl_humanoid_model(dtype=dtype, device=dev)
    act = load_policy(ckpt, dev) if ckpt else (
        lambda o: torch.zeros((o.shape[0], base.nu), dtype=o.dtype,
                              device=o.device))
    cfg = EnvConfig(standup=standup, max_sim_time=seconds)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    es, obs = env_reset(cfg, base, randomization_factor,
                        reset_draws if reset_draws is not None
                        else draw_reset(base, 1, gen))
    traj = [es.phys.qpos[0]]
    for t in range(int(seconds * CONTROL_HZ)):
        d = step_draws[t] if step_draws is not None else draw_step(base, 1,
                                                                   gen)
        with torch.no_grad():
            es, obs, _, term, trunc = env_step(cfg, base, es, act(obs), d)
        traj.append(es.phys.qpos[0])
        if bool(term[0]) or bool(trunc[0]):
            break
    patch = type(es.patch)(**{f.name: getattr(es.patch, f.name)[0]
                              for f in dataclasses.fields(es.patch)})
    return patch.apply(base), torch.stack(traj).cpu().numpy()


def generate_policy_videos(ckpt: Optional[str], out: str, n_videos: int = 9,
                           seconds: float = 5.0,
                           randomization_factor: float = 0.0,
                           greenscreen: bool = True, fps: float = 50.0,
                           width: int = 480, height: int = 360,
                           device=None):
    """Write `n_videos` MP4s (9 × 5 s green-screen, the reference's
    default grid), episode i from seed i. Returns the written paths."""
    from ..viz.render import render_trajectory

    os.makedirs(out, exist_ok=True)
    paths = []
    for i in range(n_videos):
        em, qtraj = record_episode(ckpt, seconds, randomization_factor,
                                   seed=i, device=device)
        # control rate 500 Hz -> video fps: stride the trajectory
        stride = max(1, int(round(CONTROL_HZ / fps)))
        p = render_trajectory(em, qtraj[::stride],
                              os.path.join(out, f"policy_{i}.mp4"),
                              fps=fps, width=width, height=height,
                              greenscreen=greenscreen)
        paths.append(p)
        print(f"wrote {p} ({qtraj.shape[0]} steps)", flush=True)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None,
                    help="policy checkpoint (.pt); zero policy if unset")
    ap.add_argument("--out", default="runs/videos")
    ap.add_argument("--n", type=int, default=9)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rand", type=float, default=0.0)
    ap.add_argument("--greenscreen", action="store_true")
    ap.add_argument("--fps", type=float, default=50.0)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    generate_policy_videos(a.ckpt, a.out, a.n, a.seconds, a.rand,
                           a.greenscreen, a.fps, device=a.device)


if __name__ == "__main__":
    main()
