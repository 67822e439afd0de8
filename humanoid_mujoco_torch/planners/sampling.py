"""Predictive-sampling planner (zero-order random search).

Counterpart of humanoid_mujoco_tpu/planners/sampling.py (the
reference's SamplingPlanner, mjpc/planners/sampling/planner.cc):
resample the nominal to now -> N-1 Gaussian knot perturbations plus the
nominal -> one batched rollout of all N -> argmin winner.

Randomness comes from an explicit `torch.Generator`, or from pre-drawn
standard-normal `noise` so that tests can feed the JAX package and the
port the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops.spline import SplineOrder
from ..physics.model import Model, State
from ..rollout import rollout_spline
from ..tasks.base import Task
from .policy import SplinePolicy, resample_policy

_STD2_PROPORTION = 0.2  # share of candidates on the 2nd std (planner.cc:325)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    nsample: int = 64          # candidates including the nominal
    nknots: int = 3
    horizon: int = 17          # steps of the model's dt
    order: int = SplineOrder.ZERO
    solver_iters: int = 8
    exploration: float = 0.05  # std as a share of the ctrl half-range
    exploration2: float = 0.0  # 2nd std (0 = off)


@dataclasses.dataclass(frozen=True)
class PlanInfo:
    returns: torch.Tensor        # (N,)
    winner: torch.Tensor         # () index
    best_return: torch.Tensor    # ()
    nominal_return: torch.Tensor  # () return of the unperturbed candidate
    improvement: torch.Tensor    # () nominal - best


def sample_candidates(m: Model, cfg: SamplingConfig, nominal: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, K, nu) candidates: index 0 = nominal, the rest Gaussian knots
    scaled by exploration * ctrl half-range, with an optional 20% share
    on the second std. `noise` (N, K, nu) standard normal replaces the
    Gaussian draw from `generator`."""
    N, K, nu = cfg.nsample, cfg.nknots, nominal.shape[-1]
    dev, dtype = nominal.device, nominal.dtype
    lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
    if noise is None:
        noise = torch.randn((N, K, nu), generator=generator, device=dev,
                            dtype=dtype)
    noise = torch.as_tensor(noise, dtype=dtype, device=dev)
    std = torch.full((N,), cfg.exploration, dtype=dtype, device=dev)
    if cfg.exploration2 > 0:
        uniform = torch.rand((N,), generator=generator, device=dev,
                             dtype=dtype)
        std = torch.where(uniform < _STD2_PROPORTION,
                          torch.full_like(std, cfg.exploration2), std)
    noise = noise * std[:, None, None] * (0.5 * (hi - lo))
    noise = torch.cat([torch.zeros_like(noise[:1]), noise[1:]])
    return torch.clamp(nominal[None] + noise, lo, hi)


def plan_nominal(m: Model, cfg, policy: SplinePolicy, state: State,
                 name: str) -> SplinePolicy:
    """The policy resampled to the state's time on a fresh knot grid; a
    sampling planner plans from one state (batch 1)."""
    if state.batch != 1:
        raise ValueError(f"{name} plans from one state (batch 1)")
    return resample_policy(policy, state.time[0], cfg.horizon * m.dt,
                           cfg.nknots, cfg.order)


def candidate_returns(m: Model, task: Task, cfg, state: State,
                      times: torch.Tensor, cands: torch.Tensor
                      ) -> torch.Tensor:
    """Total returns (N,) of candidate knot values (N, K, nu), all
    rolled out from the one state in a single batch."""
    N = cands.shape[0]
    sN = State(qpos=state.qpos.expand(N, -1), qvel=state.qvel.expand(N, -1),
               time=state.time.expand(N))
    return rollout_spline(m, task, sN, times, cands, cfg.order, cfg.horizon,
                          solver_iters=cfg.solver_iters).total_return


def sampling_plan(m: Model, task: Task, cfg: SamplingConfig,
                  policy: SplinePolicy, state: State,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None
                  ) -> Tuple[SplinePolicy, PlanInfo]:
    """One OptimizePolicy iteration from a single state (batch 1)."""
    nominal = plan_nominal(m, cfg, policy, state, "sampling_plan")
    cands = sample_candidates(m, cfg, nominal.values, generator, noise)
    returns = candidate_returns(m, task, cfg, state, nominal.times, cands)
    winner = torch.argmin(returns)
    info = PlanInfo(returns=returns, winner=winner,
                    best_return=returns[winner], nominal_return=returns[0],
                    improvement=returns[0] - returns[winner])
    return SplinePolicy(times=nominal.times, values=cands[winner]), info
