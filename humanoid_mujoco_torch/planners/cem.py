"""Cross-entropy method planner.

Counterpart of humanoid_mujoco_tpu/planners/cem.py (the reference's
CrossEntropyPlanner, mjpc/planners/cross_entropy/planner.cc): sample
around the mean plan, keep the n_elite lowest-cost candidates, refit a
per-knot Gaussian mean and standard deviation over them; the sampling
std is max(std, std_min * ctrl half-range).

The elites are the first n_elite of a stable ascending sort of the
returns, which orders ties as the JAX package's `lax.top_k(-returns)`
does (lower index first). Ties are real: every diverged candidate
returns MAX_RETURN.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops.spline import SplineOrder
from ..physics.model import Model, State
from ..tasks.base import Task
from .policy import SplinePolicy
from .sampling import PlanInfo, candidate_returns, plan_nominal


@dataclasses.dataclass(frozen=True)
class CEMConfig:
    nsample: int = 64
    nknots: int = 3
    horizon: int = 17
    order: int = SplineOrder.ZERO
    solver_iters: int = 8
    n_elite: int = 6
    std_initial: float = 0.1
    std_min: float = 0.01     # share of the ctrl half-range


@dataclasses.dataclass(frozen=True)
class CEMState:
    """Per-knot sampling std carried across plan iterations."""

    std: torch.Tensor   # (K, nu)


def cem_init(m: Model, cfg: CEMConfig) -> CEMState:
    return CEMState(std=torch.full((cfg.nknots, m.nu), cfg.std_initial,
                                   dtype=m.dtype, device=m.device))


def elite_indices(returns: torch.Tensor, n_elite: int) -> torch.Tensor:
    """The n_elite lowest returns' indices, best first, ties to the
    lower index (`lax.top_k(-returns, n_elite)`'s order)."""
    return torch.sort(returns, stable=True).indices[:n_elite]


def cem_plan(m: Model, task: Task, cfg: CEMConfig, policy: SplinePolicy,
             cem_state: CEMState, state: State,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None
             ) -> Tuple[SplinePolicy, CEMState, PlanInfo]:
    """One CEM iteration from a single state (batch 1). `noise` (N, K,
    nu) standard normal replaces the Gaussian draw from `generator`."""
    nominal = plan_nominal(m, cfg, policy, state, "cem_plan")
    lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
    std = torch.maximum(cem_state.std, cfg.std_min * 0.5 * (hi - lo))
    vals = nominal.values
    shape = (cfg.nsample, cfg.nknots, m.nu)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=vals.device,
                            dtype=vals.dtype)
    noise = torch.as_tensor(noise, dtype=vals.dtype, device=vals.device)
    cands = vals[None] + noise * std[None]
    cands = torch.cat([vals[None], cands[1:]])
    cands = torch.clamp(cands, lo, hi)
    returns = candidate_returns(m, task, cfg, state, nominal.times, cands)
    elite_idx = elite_indices(returns, cfg.n_elite)
    elites = cands[elite_idx]                       # (E, K, nu)
    mean = torch.mean(elites, dim=0)
    var = torch.mean((elites - mean) ** 2, dim=0)
    winner = elite_idx[0]
    info = PlanInfo(returns=returns, winner=winner,
                    best_return=returns[winner], nominal_return=returns[0],
                    improvement=returns[0] - returns[winner])
    return (SplinePolicy(times=nominal.times, values=mean),
            CEMState(std=torch.sqrt(var)), info)
