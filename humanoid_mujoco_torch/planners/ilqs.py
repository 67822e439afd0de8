"""iLQS planner: alternating sampling and iLQG.

Counterpart of humanoid_mujoco_tpu/planners/ilqs.py (the reference's
mjpc/planners/ilqs/planner.cc:86-248): one predictive-sampling
iteration, its winning spline as iLQG's open-loop nominal (zero gains),
one iLQG iteration, the refined actions fitted back to a spline by
least squares (the normal equations Wᵀ W knots = Wᵀ u with the
interpolation weights, ilqs/planner.cc:115-170), and whichever policy
returned less kept (`active_ilqg`).

The sampling iteration's rollouts (batch N) and iLQG's (batch 4 and 8)
go through kernels B1 and B2 on the card; iLQG's linearization is the
plain derivative path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import linalg
from ..ops.spline import spline_sample
from ..physics.model import Model, State
from ..tasks.base import Task
from .gradient import interp_weights
from .ilqg import (ILQGConfig, ILQGState, ilqg_init, ilqg_plan,
                   ilqg_state_from_numpy)
from .policy import SplinePolicy
from .sampling import PlanInfo, SamplingConfig, sampling_plan


@dataclasses.dataclass(frozen=True)
class ILQSConfig:
    sampling: SamplingConfig = dataclasses.field(
        default_factory=SamplingConfig)
    ilqg: ILQGConfig = dataclasses.field(default_factory=ILQGConfig)


@dataclasses.dataclass(frozen=True)
class ILQSState:
    spline: SplinePolicy
    ilqg: ILQGState
    active_ilqg: torch.Tensor    # () bool: which policy won last iteration

    @classmethod
    def from_numpy(cls, leaves, dtype=torch.float32, device=None
                   ) -> "ILQSState":
        """An ILQSState from the JAX state's leaves as nested dicts of
        numpy arrays ({"spline": {"times", "values"}, "ilqg": {"policy":
        {...}, "reg"}, "active_ilqg"}), so that both packages can start
        from one state."""
        pol = leaves["ilqg"]["policy"]
        return cls(
            spline=SplinePolicy(*(torch.tensor(
                np.asarray(leaves["spline"][k]), dtype=dtype, device=device)
                for k in ("times", "values"))),
            ilqg=ilqg_state_from_numpy(
                pol["times"], pol["qpos_nom"], pol["qvel_nom"], pol["u_nom"],
                pol["K"], pol["k_scale"], leaves["ilqg"]["reg"],
                dtype=dtype, device=device),
            active_ilqg=torch.tensor(bool(leaves["active_ilqg"]),
                                     device=device))


def ilqs_init(m: Model, cfg: ILQSConfig, state: State,
              spline: SplinePolicy) -> ILQSState:
    return ILQSState(spline=spline, ilqg=ilqg_init(m, cfg.ilqg, state),
                     active_ilqg=torch.tensor(False, device=m.device))


def spline_fit(u: torch.Tensor, times: torch.Tensor,
               knot_times: torch.Tensor, order: int) -> torch.Tensor:
    """Least-squares knots (K, nu) = argmin |W knots - u|^2 for actions
    u (T, nu) at `times` (ilqs/planner.cc:115-170: the normal equations
    and a Cholesky solve)."""
    W = interp_weights(times, knot_times, order)             # (T, K)
    K = knot_times.shape[0]
    A = W.T @ W + 1e-6 * torch.eye(K, dtype=u.dtype, device=u.device)
    return linalg.solve_psd(A, W.T @ u)


def ilqs_plan(m: Model, task: Task, cfg: ILQSConfig, ps: ILQSState,
              state: State, generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None
              ) -> Tuple[ILQSState, PlanInfo]:
    """One iteration from a single state (batch 1). `noise` (N, knots,
    nu) standard normal replaces the sampling candidates' draw from
    `generator`."""
    lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
    # 1. a sampling iteration on the spline policy
    spline, s_info = sampling_plan(m, task, cfg.sampling, ps.spline, state,
                                   generator, noise)

    # 2. its winner seeds iLQG's nominal (open loop)
    T = cfg.ilqg.horizon
    times = state.time[0] + m.dt * torch.arange(
        T + 1, dtype=state.qpos.dtype, device=state.qpos.device)
    u_seed = torch.clamp(spline_sample(spline.times, spline.values,
                                       times[:-1], cfg.sampling.order),
                         lo, hi)
    warm = ps.ilqg.policy.replace(times=times, u_nom=u_seed,
                                  K=torch.zeros_like(ps.ilqg.policy.K))

    # 3. an iLQG iteration
    ilqg_state, g_info = ilqg_plan(
        m, task, cfg.ilqg, dataclasses.replace(ps.ilqg, policy=warm), state)

    # 4. the refined actions back to a spline; the better policy kept
    fitted = torch.clamp(spline_fit(ilqg_state.policy.u_nom, times[:-1],
                                    spline.times, cfg.sampling.order),
                         lo, hi)
    ilqg_better = g_info.best_return < s_info.best_return
    best = torch.minimum(g_info.best_return, s_info.best_return)
    info = PlanInfo(returns=s_info.returns, winner=s_info.winner,
                    best_return=best, nominal_return=s_info.nominal_return,
                    improvement=s_info.nominal_return - best)
    new_spline = SplinePolicy(
        times=spline.times,
        values=torch.where(ilqg_better, fitted, spline.values))
    return ILQSState(spline=new_spline, ilqg=ilqg_state,
                     active_ilqg=ilqg_better), info
