"""Policy evaluation: deterministic episodes on the env batch.

Counterpart of humanoid_mujoco_tpu/rl/evaluate.py (the reference's
rl/visualize_policy.py rollout and the EvalCallback's survival metric),
headless: per randomization factor, n episodes of the deterministic
policy tanh(mean) from a reset drawn with a generator seeded 0; writes
`eval.csv`, `traj_rf*.npy` (env 0's qpos every 10 steps) and, when
matplotlib imports, `eval_curves.png`.

`load_policy` reads this package's own checkpoints (rl/train.py's
`torch.save` dicts). A checkpoint of the JAX package is a pickle of JAX
arrays and cannot be read without JAX; its parameters carry across with
`networks.params_from_flax`.

Usage:
  python -m humanoid_mujoco_torch.rl.evaluate runs/sac/ckpt_0000100.pt \\
      --episodes 16 --out runs/eval
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from .env import (EnvConfig, batch_reset, draw_step, env_step,
                  rl_humanoid_model)
from .networks import GaussianPolicy


def policy_actor(pi_state: dict, device=None, dtype=torch.float32
                 ) -> Callable:
    """The deterministic actor tanh(mean) of a GaussianPolicy state dict
    (obs -> action), its widths and std head read from the dict."""
    dev = resolve_device(device)
    n_layers = sum(1 for k in pi_state if k.startswith("mlp.layers.")
                   and k.endswith(".weight"))
    w = [pi_state[f"mlp.layers.{i}.weight"] for i in range(n_layers)]
    hidden = tuple(x.shape[0] for x in w)
    state_dependent = "log_std" not in pi_state
    pi = GaussianPolicy(w[0].shape[1], pi_state["heads.0.weight"].shape[0],
                        hidden, "tanh", state_dependent, device=dev,
                        dtype=dtype)
    pi.load_state_dict(pi_state)
    pi.requires_grad_(False)

    def act(obs):
        return torch.tanh(pi(obs)[0])
    return act


def load_policy(ckpt_path: str, device=None) -> Callable:
    """The deterministic actor (float32) of a checkpoint: a train
    checkpoint ({"state": {"pi": ...}, ...}) or a dict holding "pi"."""
    dev = resolve_device(device)
    ck = torch.load(ckpt_path, map_location=dev, weights_only=True)
    if "state" in ck:
        ck = ck["state"]
    return policy_actor(ck["pi"], dev)


def run_episodes(cfg: EnvConfig, base, act: Callable, es, obs,
                 max_steps: int, draws: Callable):
    """Step the batch under `act` until every episode has ended or
    `max_steps`; `draws(es)` gives each step's `StepDraws`. Returns
    (stats, traj): mean reward, mean episode length and success rate
    (truncated at the time limit while alive), and env 0's qpos every
    10 steps (T, nq)."""
    n = es.batch
    total_r = np.zeros(n)
    alive = np.ones(n, bool)
    lengths = np.zeros(n)
    success = np.zeros(n, bool)
    traj = []
    for t in range(max_steps):
        es, obs, r, term, trunc = env_step(cfg, base, es, act(obs),
                                           draws(es))
        r, term, trunc = torch.stack(
            [r.double(), term.double(), trunc.double()]).cpu().numpy()
        term, trunc = term > 0, trunc > 0
        total_r += r * alive
        lengths += alive
        success |= trunc & alive
        alive &= ~(term | trunc)
        if t % 10 == 0:
            traj.append(es.phys.qpos[0].cpu().numpy())
        if not alive.any():
            break
    return dict(mean_reward=float(total_r.mean()),
                mean_episode_len=float(lengths.mean()),
                success_rate=float(success.mean())), np.stack(traj)


def evaluate(ckpt: str, rand_factors=(0.0, 0.25, 0.5, 0.75, 1.0),
             n_episodes: int = 16, max_steps: int = 2000,
             standup: bool = True, out: str = "runs/eval", device=None):
    """Reward, episode length and success rate per randomization
    factor; one row each, also written to `out`."""
    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    base = rl_humanoid_model(device=dev)
    act = load_policy(ckpt, dev)
    cfg = EnvConfig(standup=standup,
                    max_sim_time=10.0 if standup else -1.0)
    rows = []
    for rf in rand_factors:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        es, obs = batch_reset(cfg, base, rf, n_episodes, gen)
        with torch.no_grad():
            stats, traj = run_episodes(
                cfg, base, act, es, obs, max_steps,
                lambda e: draw_step(base, e.batch, gen))
        rows.append(dict(rand_factor=rf, **stats))
        np.save(os.path.join(out, f"traj_rf{rf:.2f}.npy"), traj)
        print(json.dumps(rows[-1]), flush=True)

    with open(os.path.join(out, "eval.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    _plot(rows, out)
    return rows


def _plot(rows, out):
    """Reward, episode length and success rate against the
    randomization factor (plot_training_curves.py analog), when
    matplotlib is installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    rf = [r["rand_factor"] for r in rows]
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5))
    for ax, key, label in zip(
            axes, ("mean_reward", "mean_episode_len", "success_rate"),
            ("mean reward", "episode length", "success rate")):
        ax.plot(rf, [r[key] for r in rows], "o-")
        ax.set_xlabel("randomization factor")
        ax.set_ylabel(label)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(out, "eval_curves.png"), dpi=120)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--episodes", type=int, default=16)
    ap.add_argument("--walk", dest="standup", action="store_false")
    ap.add_argument("--out", default="runs/eval")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    evaluate(a.ckpt, n_episodes=a.episodes, standup=a.standup, out=a.out,
             device=a.device)


if __name__ == "__main__":
    main()
