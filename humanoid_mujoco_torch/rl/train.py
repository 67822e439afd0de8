"""Training driver: SAC or PPO with the randomization curriculum.

Counterpart of humanoid_mujoco_tpu/rl/train.py (the reference's
rl/train.py CLI): the collect-and-update loop runs on one device, writes
`train.log.jsonl` and the `train.progress` percent file into `--out`,
and saves a complete checkpoint (parameters, optimizer moments, replay
buffer, env batch, generator state, curriculum, iteration) with
`torch.save`, so that `--ckpt` resumes exactly.

Under a process group (`parallel.distributed.init_distributed`: the
HMT_COORDINATOR variables, or torchrun's, as tools/pod_run_torch.sh
starts it) PPO runs data-parallel: each rank steps its shard of the
env batch (`dp_sharded_ppo_step`, on its own card), the checkpoint
holds the whole batch gathered from the ranks, and rank 0 writes the
files.

Usage:
  python -m humanoid_mujoco_torch.rl.train --algo sac --envs 256 \\
      --steps 1000000 --standup --out runs/sac
  torchrun --nproc-per-node 4 -m humanoid_mujoco_torch.rl.train \\
      --algo ppo --envs 1024 --out runs/ppo
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..parallel.distributed import (dp_sharded_ppo_step, gather_env_batch,
                                    init_distributed, shard_env_batch)
from .curriculum import CurriculumState, curriculum_init, curriculum_update
from .env import EnvConfig, env_state_to_dict, rl_humanoid_model
from .ppo import PPOConfig, ppo_init, ppo_train_step
from .sac import SACConfig, sac_init, sac_train_step


def push_randomization_factor(state, rf: float):
    """Write the curriculum's live randomization factor into every env,
    so that later auto-resets randomize at the new level."""
    es = state.env_state
    state.env_state = dataclasses.replace(es, rf=torch.full_like(es.rf, rf))
    return state


def _save_ckpt(out, it, state, cur, recent_success, mesh=None):
    """Write the checkpoint; under a mesh the env batch is gathered from
    every rank (a collective) and rank 0 writes."""
    path = os.path.join(out, f"ckpt_{it:07d}.pt")
    d = state.state_dict()
    if mesh is not None:
        d["env_state"] = env_state_to_dict(
            gather_env_batch(mesh, state.env_state))
        d["obs"] = gather_env_batch(mesh, state.obs)
        if mesh.rank != 0:
            return path
    torch.save(dict(state=d, cur=dataclasses.asdict(cur), iter=it,
                    recent_success=list(recent_success)), path)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", choices=("sac", "ppo"), default="sac")
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--standup", action="store_true", default=True)
    ap.add_argument("--walk", dest="standup", action="store_false")
    ap.add_argument("--rand", type=float, default=0.0,
                    help="initial randomization factor")
    ap.add_argument("--no-curriculum", action="store_true")
    ap.add_argument("--out", default="runs/train")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint (.pt) of this driver to resume from")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh = init_distributed(device=args.device)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0
    if mesh is not None and args.algo != "ppo":
        raise ValueError("data-parallel training runs PPO (--algo ppo)")
    # no TF32 in the networks' products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    os.makedirs(args.out, exist_ok=True)
    base = rl_humanoid_model(device=dev)
    env_cfg = EnvConfig(standup=args.standup,
                        max_sim_time=10.0 if args.standup else -1.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    cur = curriculum_init(args.rand)
    if args.algo == "sac":
        cfg = SACConfig(n_envs=args.envs, batch_size=4 * args.envs)
        state = sac_init(cfg, env_cfg, base, cur.randomization_factor, gen)
        train_step = sac_train_step
        steps_per_iter = cfg.steps_per_update * cfg.n_envs
    else:
        cfg = PPOConfig(n_envs=args.envs)
        state = ppo_init(cfg, env_cfg, base, cur.randomization_factor, gen)
        train_step = ppo_train_step
        if mesh is not None:
            def train_step(cfg, env_cfg, base, state):
                return dp_sharded_ppo_step(mesh, cfg, env_cfg, base, state)
        steps_per_iter = cfg.rollout_len * cfg.n_envs

    start_iter = 0
    recent_success = []
    if args.ckpt:
        loaded = torch.load(args.ckpt, map_location=dev, weights_only=True)
        state.load_state_dict(loaded["state"])
        cur = CurriculumState(**loaded["cur"])
        start_iter = int(loaded["iter"])
        recent_success = list(loaded["recent_success"])
        if lead:
            print(f"resumed from {args.ckpt} at iteration {start_iter}")
    if mesh is not None:
        state.env_state = shard_env_batch(mesh, state.env_state)
        state.obs = shard_env_batch(mesh, state.obs)

    n_iters = max(1, args.steps // steps_per_iter)
    log_path = os.path.join(args.out, "train.log.jsonl")
    progress_path = os.path.join(args.out, "train.progress")
    t0 = time.time()
    for it in range(start_iter, n_iters):
        state, metrics = train_step(cfg, env_cfg, base, state)
        if it % args.eval_every == 0 or it == n_iters - 1:
            metrics = {k: float(v) for k, v in metrics.items()}
            recent_success.append(metrics.get("success_rate", 0.0))
            if not args.no_curriculum and len(recent_success) >= 3:
                cur = curriculum_update(cur,
                                        float(np.mean(recent_success[-3:])))
                recent_success = recent_success[-3:]
                state = push_randomization_factor(state,
                                                  cur.randomization_factor)
            rec = dict(iter=it, env_steps=it * steps_per_iter,
                       rand_factor=cur.randomization_factor,
                       wall_s=round(time.time() - t0, 1), **metrics)
            if lead:
                with open(log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                with open(progress_path, "w") as f:
                    f.write(f"{100.0 * (it + 1) / n_iters:.2f}")
                print(rec, flush=True)
            if cur.done:
                print("curriculum complete: stopping")
                break
        if it % args.ckpt_every == 0 and it > 0:
            _save_ckpt(args.out, it, state, cur, recent_success, mesh)
    path = _save_ckpt(args.out, n_iters, state, cur, recent_success, mesh)
    if lead:
        print(f"done in {time.time() - t0:.0f}s")
    return state, path


if __name__ == "__main__":
    main()
