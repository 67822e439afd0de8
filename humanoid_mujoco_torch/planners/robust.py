"""Robust planner: a meta-planner over a sampling delegate.

Counterpart of humanoid_mujoco_tpu/planners/robust.py (the reference's
RobustPlanner, mjpc/planners/robust/robust_planner.cc:46-130): take the
delegate's top-K candidate plans, re-roll each under R
Ornstein-Uhlenbeck random-wrench sequences (NoisyRollout,
mjpc/trajectory.cc:100-210) and keep the candidate with the best
AVERAGE perturbed return.

The K candidates x R wrench sequences run as one batch of K·R
rollouts, each env carrying its own wrench slice, so on the card each
of their steps is one launch of kernels B1 and B2. The top K follow a
stable ascending sort of the returns (`cem.elite_indices`), the order
of the JAX package's `lax.top_k(-returns)`: diverged candidates tie at
MAX_RETURN and go to the lower index.

Defaults match the reference: repetitions 5, wrench scale 0.1, rate 0.1
(robust_planner.cc:46-57).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..physics.model import Model, State
from ..rollout import ou_wrench_sequence, rollout_spline
from ..tasks.base import Task
from .cem import elite_indices
from .policy import SplinePolicy
from .sampling import (PlanInfo, SamplingConfig, candidate_returns,
                       plan_nominal, sample_candidates)


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    sampling: SamplingConfig = dataclasses.field(
        default_factory=SamplingConfig)
    n_best: int = 4
    repetitions: int = 5
    xfrc_std: float = 0.1
    xfrc_rate: float = 0.1


def robust_plan(m: Model, task: Task, cfg: RobustConfig,
                policy: SplinePolicy, state: State,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                ou_noise: Optional[torch.Tensor] = None
                ) -> Tuple[SplinePolicy, PlanInfo]:
    """One iteration from a single state (batch 1). `noise` (N, knots,
    nu) and `ou_noise` (R, T, nbody, 6), standard normals, replace the
    candidates' and the wrench sequences' draws from `generator`."""
    sc = cfg.sampling
    nominal = plan_nominal(m, sc, policy, state, "robust_plan")
    cands = sample_candidates(m, sc, nominal.values, generator, noise)
    returns = candidate_returns(m, task, sc, state, nominal.times, cands)
    top_idx = elite_indices(returns, cfg.n_best)
    top = cands[top_idx]                                  # (K, knots, nu)

    # the same R sequences for every candidate (a fair comparison)
    K, R = cfg.n_best, cfg.repetitions
    seqs = ou_wrench_sequence(
        sc.horizon, m.struct.nbody, cfg.xfrc_std, cfg.xfrc_rate,
        m.dt, generator, ou_noise, R, state.qpos.dtype,
        state.qpos.device)                                # (R, T, nbody, 6)
    n = K * R                                             # env k·R + r
    sN = State(qpos=state.qpos.expand(n, -1), qvel=state.qvel.expand(n, -1),
               time=state.time.expand(n))
    noisy = rollout_spline(
        m, task, sN, nominal.times, top.repeat_interleave(R, dim=0),
        sc.order, sc.horizon, xfrc_seq=seqs.repeat(K, 1, 1, 1),
        solver_iters=sc.solver_iters).total_return.reshape(K, R)
    avg = noisy.mean(dim=1)
    best_k = torch.argmin(avg)
    winner = top_idx[best_k]
    info = PlanInfo(returns=returns, winner=winner, best_return=avg[best_k],
                    nominal_return=returns[0],
                    improvement=returns[0] - returns[winner])
    return SplinePolicy(times=nominal.times, values=top[best_k]), info
