"""Hyperparameter search: the rl/tune_hyperparameters.py analog.

Counterpart of humanoid_mujoco_tpu/rl/tune.py. The reference drives
rl_zoo3/Optuna with `--sampler tpe --pruner median` over a PPO space
(tune_hyperparameters.py:26-33, simulation/hyperparam_config.py:5-29).
Optuna is not a dependency, so this module implements the same two
algorithms with numpy and `random`, a copy of the JAX package's (given
the same seeds, both propose the same parameters):

* ``TPESampler``: Tree-structured Parzen Estimator (Bergstra et al.
  2011, the algorithm behind Optuna's default sampler). Completed
  trials are split into the best ``gamma`` fraction (l) and the rest
  (g); each is modeled with a Parzen window (Gaussian KDE in the
  parameter's transformed space, weighted categorical for choices);
  candidates are drawn from l and ranked by the ratio l(x)/g(x).
* ``MedianPruner``: a trial reporting intermediate values is pruned
  when its value falls below the median of completed trials' values at
  the same step (after ``n_warmup_steps``), as optuna's MedianPruner.

A ``Study``/``Trial`` surface mirrors the optuna API shape
(suggest_float / suggest_categorical / report / should_prune). The
objective is short PPO runs of the port's trainer (rl/ppo.py) on the
standup env, on the card unless told otherwise.

Usage:
  python -m humanoid_mujoco_torch.rl.tune --trials 16 --iters 12 \
      [--envs 32] [--device cpu] [--out runs/tune.jsonl]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Parameter distributions


@dataclass(frozen=True)
class FloatDist:
    low: float
    high: float
    log: bool = False

    def to_internal(self, x: float) -> float:
        return math.log(x) if self.log else x

    def from_internal(self, z: float) -> float:
        x = math.exp(z) if self.log else z
        return min(max(x, self.low), self.high)

    def bounds_internal(self) -> Tuple[float, float]:
        if self.log:
            return math.log(self.low), math.log(self.high)
        return self.low, self.high

    def sample(self, rng: random.Random) -> float:
        lo, hi = self.bounds_internal()
        return self.from_internal(rng.uniform(lo, hi))


@dataclass(frozen=True)
class CategoricalDist:
    choices: Tuple

    def sample(self, rng: random.Random):
        return rng.choice(self.choices)


# ---------------------------------------------------------------------------
# TPE sampler


class TPESampler:
    """Tree-structured Parzen Estimator (maximization).

    Mirrors optuna's independent TPE: per-parameter univariate Parzen
    estimators, gamma(n) = min(ceil(0.1 n), 25) best trials in l(x),
    bandwidths from neighbor spacing with a prior-width floor, and a
    uniform prior component mixed into both densities.
    """

    def __init__(self, n_startup_trials: int = 10,
                 n_ei_candidates: int = 24, seed: int = 0):
        self.n_startup = n_startup_trials
        self.n_ei = n_ei_candidates
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)

    @staticmethod
    def _gamma(n: int) -> int:
        return min(int(math.ceil(0.1 * n)), 25)

    def _split(self, history: List[Tuple[Dict, float]]):
        done = sorted(history, key=lambda t: -t[1])
        n_best = max(self._gamma(len(done)), 1)
        return done[:n_best], done[n_best:]

    def _parzen_logpdf(self, obs: np.ndarray, lo: float, hi: float,
                       x: np.ndarray) -> np.ndarray:
        """log density of a Parzen mixture over `obs` (+ uniform prior
        component), evaluated at x. Everything in internal coords."""
        width = hi - lo
        if obs.size == 0:
            return np.full_like(x, -math.log(width))
        # bandwidth: per-observation mean neighbor spacing, floored
        srt = np.sort(obs)
        if srt.size == 1:
            bw = np.array([width / 2.0])
        else:
            left = np.concatenate([[width], np.diff(srt)])
            right = np.concatenate([np.diff(srt), [width]])
            bw = np.maximum((left + right) / 2.0, 1e-3 * width)
        # mixture: uniform prior + one Gaussian per observation
        k = srt.size + 1
        comp = np.full((x.size, k), -np.inf)
        comp[:, 0] = -math.log(width)
        z = (x[:, None] - srt[None, :]) / bw[None, :]
        comp[:, 1:] = (-0.5 * z * z
                       - np.log(bw[None, :] * math.sqrt(2 * math.pi)))
        m = comp.max(axis=1, keepdims=True)
        return (m[:, 0] + np.log(np.exp(comp - m).sum(axis=1))
                - math.log(k))

    def _sample_float(self, dist: FloatDist,
                      best: List[float], rest: List[float]) -> float:
        lo, hi = dist.bounds_internal()
        obs_l = np.array([dist.to_internal(v) for v in best])
        obs_g = np.array([dist.to_internal(v) for v in rest])
        # draw candidates from l(x): pick a mixture component, sample it
        cands = []
        width = hi - lo
        for _ in range(self.n_ei):
            if obs_l.size == 0 or self.rng.random() < 1.0 / (obs_l.size + 1):
                cands.append(self.rng.uniform(lo, hi))
            else:
                mu = self.rng.choice(list(obs_l))
                cands.append(min(max(self.np_rng.normal(
                    mu, 0.2 * width), lo), hi))
        x = np.array(cands)
        score = (self._parzen_logpdf(obs_l, lo, hi, x)
                 - self._parzen_logpdf(obs_g, lo, hi, x))
        return dist.from_internal(float(x[int(np.argmax(score))]))

    def _sample_categorical(self, dist: CategoricalDist,
                            best: List, rest: List):
        def weights(obs):
            # add-one smoothed counts (optuna's weighted categorical)
            c = np.ones(len(dist.choices))
            for v in obs:
                c[dist.choices.index(v)] += 1.0
            return c / c.sum()
        wl, wg = weights(best), weights(rest)
        score = np.log(wl) - np.log(wg)
        return dist.choices[int(np.argmax(score))]

    def suggest(self, name: str, dist,
                history: List[Tuple[Dict, float]]):
        usable = [(p, v) for p, v in history if name in p]
        if len(usable) < self.n_startup:
            return dist.sample(self.rng)
        best, rest = self._split(usable)
        bv = [p[name] for p, _ in best]
        rv = [p[name] for p, _ in rest]
        if isinstance(dist, FloatDist):
            return self._sample_float(dist, bv, rv)
        return self._sample_categorical(dist, bv, rv)


class RandomSampler:
    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def suggest(self, name, dist, history):
        return dist.sample(self.rng)


# ---------------------------------------------------------------------------
# Median pruner


class MedianPruner:
    """Prune a trial whose intermediate value at step s is below the
    median of completed trials' values at step s (maximization)."""

    def __init__(self, n_startup_trials: int = 4, n_warmup_steps: int = 1):
        self.n_startup = n_startup_trials
        self.n_warmup = n_warmup_steps

    def should_prune(self, step: int, value: float,
                     completed_curves: List[Dict[int, float]]) -> bool:
        if step < self.n_warmup or len(completed_curves) < self.n_startup:
            return False
        at_step = [c[step] for c in completed_curves if step in c]
        if not at_step:
            return False
        return value < float(np.median(at_step))


class NopPruner:
    def should_prune(self, *a, **k):
        return False


# ---------------------------------------------------------------------------
# Study / Trial (optuna-shaped surface)


class TrialPruned(Exception):
    pass


@dataclass
class Trial:
    number: int
    study: "Study"
    params: Dict = field(default_factory=dict)
    curve: Dict[int, float] = field(default_factory=dict)

    def suggest_float(self, name: str, low: float, high: float,
                      log: bool = False) -> float:
        v = self.study.sampler.suggest(name, FloatDist(low, high, log),
                                       self.study.history)
        self.params[name] = v
        return v

    def suggest_categorical(self, name: str, choices: Sequence):
        v = self.study.sampler.suggest(
            name, CategoricalDist(tuple(choices)), self.study.history)
        self.params[name] = v
        return v

    def report(self, value: float, step: int):
        self.curve[step] = value

    def should_prune(self) -> bool:
        if not self.curve:
            return False
        step = max(self.curve)
        return self.study.pruner.should_prune(
            step, self.curve[step], self.study.completed_curves)


class Study:
    def __init__(self, sampler=None, pruner=None, log_path: str = ""):
        self.sampler = sampler or TPESampler()
        self.pruner = pruner or MedianPruner()
        self.history: List[Tuple[Dict, float]] = []    # completed only
        self.completed_curves: List[Dict[int, float]] = []
        self.trials: List[Dict] = []
        self.log_path = log_path

    @property
    def best_trial(self) -> Dict:
        done = [t for t in self.trials if t["state"] == "COMPLETE"]
        return max(done, key=lambda t: t["value"])

    def optimize(self, objective, n_trials: int, verbose: bool = True):
        for i in range(n_trials):
            trial = Trial(number=i, study=self)
            state, value = "COMPLETE", None
            try:
                value = float(objective(trial))
            except TrialPruned:
                state = "PRUNED"
                value = trial.curve[max(trial.curve)] if trial.curve else None
            if state == "COMPLETE":
                self.history.append((dict(trial.params), value))
                self.completed_curves.append(dict(trial.curve))
            rec = dict(trial=i, state=state, value=value,
                       params=trial.params)
            self.trials.append(rec)
            if self.log_path:
                with open(self.log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if verbose:
                print(rec, flush=True)
        return self.best_trial


# ---------------------------------------------------------------------------
# PPO objective (search space = hyperparam_config.py:5-29 /
# rl_zoo3 ppo.py sample_ppo_params ranges)


def make_objective(iters: int = 12, n_envs: int = 32, n_evals: int = 4,
                   seed: int = 0, device=None):
    """Short PPO runs on the standup env (rollouts of 32 steps); reports
    the intermediate mean reward n_evals times (the reference's
    --n-evaluations 5). Trial i draws from a generator seeded seed + i."""
    import torch

    from .. import resolve_device
    from .env import EnvConfig, rl_humanoid_model
    from .ppo import PPOConfig, ppo_init, ppo_train_step

    dev = resolve_device(device)
    base = rl_humanoid_model(device=dev)
    env_cfg = EnvConfig(standup=True)

    def objective(trial: Trial) -> float:
        cfg = PPOConfig(
            n_envs=n_envs, rollout_len=32,
            n_epochs=int(trial.suggest_categorical("n_epochs", (4, 8, 10))),
            lr=float(trial.suggest_float("lr", 1e-5, 1e-3, log=True)),
            gamma=1.0 - trial.suggest_float("one_minus_gamma", 1e-3, 1e-1,
                                            log=True),
            lam=float(trial.suggest_categorical("lam", (0.9, 0.95, 0.99))),
            clip=float(trial.suggest_categorical("clip", (0.1, 0.2, 0.3))),
            ent_coef=trial.suggest_float("ent_coef", 1e-8, 1e-1, log=True))
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + trial.number)
        state = ppo_init(cfg, env_cfg, base, 0.0, gen)
        rewards, eval_every = [], max(1, iters // n_evals)
        for it in range(iters):
            state, metrics = ppo_train_step(cfg, env_cfg, base, state)
            rewards.append(float(metrics["mean_reward"]))
            if (it + 1) % eval_every == 0:
                trial.report(float(np.mean(rewards[-eval_every:])),
                             step=(it + 1) // eval_every)
                if trial.should_prune():
                    raise TrialPruned()
        return float(np.mean(rewards[-max(1, iters // 4):]))

    return objective


def tune(n_trials: int = 16, iters: int = 12, sampler: str = "tpe",
         pruner: str = "median", seed: int = 0,
         out: str = "runs/tune.jsonl", n_envs: int = 32, device=None):
    """The study over `n_trials` PPO runs; each trial's record is
    appended to `out` as a JSON line. Returns the best trial."""
    smp = (TPESampler(seed=seed) if sampler == "tpe"
           else RandomSampler(seed=seed))
    prn = MedianPruner() if pruner == "median" else NopPruner()
    if out and os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    study = Study(sampler=smp, pruner=prn, log_path=out)
    best = study.optimize(make_objective(iters=iters, n_envs=n_envs,
                                         seed=seed, device=device),
                          n_trials)
    print("best:", best)
    return best


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=16)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--envs", type=int, default=32)
    ap.add_argument("--sampler", choices=("tpe", "random"), default="tpe")
    ap.add_argument("--pruner", choices=("median", "none"), default="median")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/tune.jsonl")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    return tune(a.trials, a.iters, a.sampler, a.pruner, a.seed, a.out,
                a.envs, a.device)


if __name__ == "__main__":
    main()
