"""Sample-gradient planner.

Counterpart of humanoid_mujoco_tpu/planners/sample_gradient.py (the
reference's mjpc/planners/sample_gradient/planner.h:146-162): the
random sampling candidates plus candidates stepped along a gradient
estimate recovered from the previous iteration's samples (a zero-order,
evolution-strategies estimate) at log-spaced step sizes, with a
low-pass filter on the gradient across iterations. All N + n_gradient
candidates roll out in one batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..physics.model import Model, State
from ..tasks.base import Task
from .policy import SplinePolicy
from .sampling import (PlanInfo, SamplingConfig, candidate_returns,
                       plan_nominal, sample_candidates)


@dataclasses.dataclass(frozen=True)
class SampleGradientConfig:
    sampling: SamplingConfig = dataclasses.field(
        default_factory=SamplingConfig)
    n_gradient: int = 8
    filter_coef: float = 0.5
    step_max: float = 0.5


@dataclasses.dataclass(frozen=True)
class SampleGradientState:
    grad: torch.Tensor    # (nknots, nu) filtered gradient estimate


def sample_gradient_init(m: Model, cfg: SampleGradientConfig
                         ) -> SampleGradientState:
    return SampleGradientState(grad=torch.zeros(
        (cfg.sampling.nknots, m.nu), dtype=m.dtype, device=m.device))


def sample_gradient_state_from_numpy(grad, dtype=torch.float32,
                                     device=None) -> SampleGradientState:
    """A SampleGradientState from the JAX state's `grad` as a numpy
    array, so that both packages can start from one estimate."""
    return SampleGradientState(grad=torch.tensor(np.asarray(grad),
                                                 dtype=dtype, device=device))


def sample_gradient_plan(m: Model, task: Task, cfg: SampleGradientConfig,
                         policy: SplinePolicy, gs: SampleGradientState,
                         state: State,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None
                         ) -> Tuple[SplinePolicy, SampleGradientState,
                                    PlanInfo]:
    """One iteration from a single state (batch 1). `noise` (N, knots,
    nu) standard normal replaces the candidates' draw from
    `generator`."""
    sc = cfg.sampling
    dtype, dev = state.qpos.dtype, state.qpos.device
    lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
    nominal = plan_nominal(m, sc, policy, state, "sample_gradient_plan")
    cands = sample_candidates(m, sc, nominal.values, generator, noise)

    # gradient-direction candidates at log-spaced steps
    gnorm = torch.sqrt(torch.sum(gs.grad ** 2) + 1e-12)
    gdir = gs.grad / gnorm
    steps = cfg.step_max * torch.logspace(-3, 0, cfg.n_gradient, dtype=dtype,
                                          device=dev)
    gcands = torch.clamp(nominal.values[None] - steps[:, None, None] * gdir,
                         lo, hi)
    all_cands = torch.cat([cands, gcands])
    returns = candidate_returns(m, task, sc, state, nominal.times, all_cands)
    winner = torch.argmin(returns)

    # the ES estimate from the random samples:
    # g ~ mean_i (J_i - J_nom) (cand_i - nominal) / sigma^2
    half_range = 0.5 * (hi - lo)
    sigma2 = torch.clamp((sc.exploration * half_range) ** 2, min=1e-8)
    dr = returns[1:sc.nsample] - returns[0]                  # (N-1,)
    dc = cands[1:] - nominal.values[None]                    # (N-1, K, nu)
    g_new = torch.einsum("n,nku->ku", dr, dc) / (
        (sc.nsample - 1) * sigma2[None, :])
    # diverged rollouts (MAX_RETURN) would poison the estimate
    g_new = torch.where(dr.abs().max() > 1e5, torch.zeros_like(g_new),
                        g_new)
    grad = cfg.filter_coef * gs.grad + (1 - cfg.filter_coef) * g_new
    info = PlanInfo(returns=returns, winner=winner,
                    best_return=returns[winner], nominal_return=returns[0],
                    improvement=returns[0] - returns[winner])
    return (SplinePolicy(times=nominal.times, values=all_cands[winner]),
            SampleGradientState(grad=grad), info)
