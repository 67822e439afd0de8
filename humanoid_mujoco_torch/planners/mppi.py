"""MPPI (model-predictive path integral) planner.

Counterpart of humanoid_mujoco_tpu/planners/mppi.py: the sampling
planner's candidates, but the update is the exponentially weighted
average of all of them,

    w_i = softmax(-(J_i - min J) / temperature),  u = Σ_i w_i u_i,

instead of the argmin. Returns reach MAX_RETURN (1e6) for a diverged
candidate; subtracting the best first keeps the softmax finite, and
such candidates get a weight of about zero.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..physics.model import Model, State
from ..tasks.base import Task
from .policy import SplinePolicy
from .sampling import (PlanInfo, SamplingConfig, candidate_returns,
                       plan_nominal, sample_candidates)


@dataclasses.dataclass(frozen=True)
class MPPIConfig(SamplingConfig):
    temperature: float = 1.0


def mppi_plan(m: Model, task: Task, cfg: MPPIConfig, policy: SplinePolicy,
              state: State, generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None
              ) -> Tuple[SplinePolicy, PlanInfo]:
    """One MPPI iteration from a single state (batch 1). `noise` (N, K,
    nu) standard normal replaces the Gaussian draw from `generator`."""
    nominal = plan_nominal(m, cfg, policy, state, "mppi_plan")
    cands = sample_candidates(m, cfg, nominal.values, generator, noise)
    returns = candidate_returns(m, task, cfg, state, nominal.times, cands)
    best = torch.min(returns)
    w = torch.softmax(-(returns - best) / cfg.temperature, dim=0)
    values = torch.einsum("n,nku->ku", w, cands)
    values = torch.clamp(values, m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1])
    winner = torch.argmin(returns)
    info = PlanInfo(returns=returns, winner=winner, best_return=best,
                    nominal_return=returns[0], improvement=returns[0] - best)
    return SplinePolicy(times=nominal.times, values=values), info
