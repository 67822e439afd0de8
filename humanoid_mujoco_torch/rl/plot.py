"""Training-curve plotting: the rl/plot_training_curves.py analog.

Counterpart of humanoid_mujoco_tpu/rl/plot.py. Reads the
train.log.jsonl the port's training loop writes (rl/train.py) and
renders reward / success-rate / randomization-factor curves vs env
steps to a PNG. The reference plots reward and episode length vs the
randomization factor from SB3's evaluations.npz + the curriculum CSV
(rl/plot_training_curves.py, randomization_adaptation_callback.py:26-31).

Usage:
  python -m humanoid_mujoco_torch.rl.plot --log runs/train.log.jsonl \
      --out curves.png
"""

from __future__ import annotations

import argparse
import json


def load_log(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def plot_curves(log_path: str, out_png: str, title: str = ""):
    """Reward, success rate and randomization factor against env steps,
    written to `out_png` (matplotlib is imported here, so the module
    imports without it)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = load_log(log_path)
    steps = [r["env_steps"] for r in rows]
    fig, axes = plt.subplots(3, 1, figsize=(7, 9), sharex=True)

    axes[0].plot(steps, [r.get("mean_reward", float("nan"))
                         for r in rows], color="#1f77b4")
    axes[0].set_ylabel("mean reward")
    axes[0].grid(alpha=0.3)

    axes[1].plot(steps, [r.get("success_rate", float("nan"))
                         for r in rows], color="#2ca02c")
    axes[1].set_ylabel("success rate")
    axes[1].set_ylim(-0.05, 1.05)
    axes[1].grid(alpha=0.3)

    axes[2].plot(steps, [r.get("rand_factor", float("nan"))
                         for r in rows], color="#d62728")
    axes[2].set_ylabel("randomization factor")
    axes[2].set_xlabel("env steps")
    axes[2].set_ylim(-0.05, 1.05)
    axes[2].grid(alpha=0.3)

    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", required=True)
    ap.add_argument("--out", default="train_curves.png")
    ap.add_argument("--title", default="")
    args = ap.parse_args()
    print(plot_curves(args.log, args.out, args.title))


if __name__ == "__main__":
    main()
