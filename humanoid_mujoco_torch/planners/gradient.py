"""Gradient (first-order shooting) planner.

Counterpart of humanoid_mujoco_tpu/planners/gradient.py (the
reference's mjpc/planners/gradient/): linearize along the nominal
(`trajectory_derivatives`, plain PyTorch by design), run the backward
cost-gradient recursion (Gradient::GradientStep, gradient/gradient.h:
44), map the action-space gradient into knot space through the
interpolation weights (du_knots = Wᵀ du_actions, exact for interpolants
linear in the knots: the SplineMapping analog,
gradient/spline_mapping.cc), then line-search over log-spaced steps,
all `n_linesearch` rollouts in one batch.

The nominal rollout runs at batch 1 through the ordinary `step`, so on
the card its steps and the line search's go through kernels B1 and B2.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.spline import SplineOrder, spline_sample
from ..physics.model import Model, State
from ..physics.step import step
from ..tasks.base import Task
from .derivatives import trajectory_derivatives
from .policy import SplinePolicy
from .sampling import PlanInfo, candidate_returns, plan_nominal


@dataclasses.dataclass(frozen=True)
class GradientConfig:
    nknots: int = 5
    horizon: int = 17
    order: int = SplineOrder.LINEAR
    n_linesearch: int = 12
    solver_iters: int = 8
    deriv_solver_iters: int = 3
    step_max: float = 1.0


def interp_weights(times: torch.Tensor, knot_times: torch.Tensor,
                   order: int) -> torch.Tensor:
    """W (T, K) with u(t_i) = sum_k W[i, k] knot_k: zero-order hold, or
    linear interpolation for every other order (the spline mapping of
    interpolants linear in the knots)."""
    K = knot_times.shape[0]
    idx = torch.clamp(torch.searchsorted(knot_times, times, right=True) - 1,
                      0, K - 1)
    if order == SplineOrder.ZERO:
        return F.one_hot(idx, K).to(times.dtype)
    lo = torch.clamp(idx, 0, K - 2)
    hi = lo + 1
    h = torch.clamp(knot_times[hi] - knot_times[lo], min=1e-9)
    s = torch.clamp((times - knot_times[lo]) / h, 0.0, 1.0)
    return (F.one_hot(lo, K).to(times.dtype) * (1 - s)[:, None]
            + F.one_hot(hi, K).to(times.dtype) * s[:, None])


def nominal_rollout(m: Model, cfg: GradientConfig, nominal: SplinePolicy,
                    state: State):
    """The spline nominal rolled from one state (batch 1): qpos (T+1,
    nq), qvel (T+1, nv), ctrl (T, nu) and the step times (T+1,)."""
    lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
    s = state
    qp, qv, us, tt = [], [], [], []
    for _ in range(cfg.horizon):
        u = torch.clamp(spline_sample(nominal.times, nominal.values, s.time,
                                      cfg.order), lo, hi)
        s2, _ = step(m, s, u, solver_iters=cfg.solver_iters)
        qp.append(s.qpos[0])
        qv.append(s.qvel[0])
        us.append(u[0])
        tt.append(s.time[0])
        s = s2
    return (torch.stack(qp + [s.qpos[0]]), torch.stack(qv + [s.qvel[0]]),
            torch.stack(us), torch.stack(tt + [s.time[0]]))


def gradient_plan(m: Model, task: Task, cfg: GradientConfig,
                  policy: SplinePolicy, state: State
                  ) -> Tuple[SplinePolicy, PlanInfo]:
    """One iteration from a single state (batch 1). Deterministic: the
    JAX signature's key is unused there too."""
    dtype, dev = state.qpos.dtype, state.qpos.device
    nominal = plan_nominal(m, cfg, policy, state, "gradient_plan")
    qp, qv, u_nom, times = nominal_rollout(m, cfg, nominal, state)
    derivs = trajectory_derivatives(m, task, qp, qv, u_nom, times,
                                    solver_iters=cfg.deriv_solver_iters)

    # the backward gradient recursion: Qu_t = cu_t + B_tᵀ Vx_{t+1},
    # Vx_t = cx_t + A_tᵀ Vx_{t+1} (gradient/gradient.h:44)
    Vx = torch.zeros(derivs.cx.shape[1], dtype=dtype, device=dev)
    Qu = [None] * cfg.horizon
    for t in reversed(range(cfg.horizon)):
        Qu[t] = derivs.cu[t] + derivs.B[t].T @ Vx
        Vx = derivs.cx[t] + derivs.A[t].T @ Vx
    Qu = torch.stack(Qu)                                     # (T, nu)

    # into knot space through the interpolation weights
    W = interp_weights(times[:-1], nominal.times, cfg.order)  # (T, K)
    g_knots = W.T @ Qu                                        # (K, nu)
    g_dir = g_knots / torch.sqrt(torch.sum(g_knots ** 2) + 1e-12)

    # the line search over log-spaced steps, the nominal at step 0
    steps = cfg.step_max * torch.cat([
        torch.zeros(1, dtype=dtype, device=dev),
        torch.logspace(-4, 0, cfg.n_linesearch - 1, dtype=dtype,
                       device=dev)])
    values = torch.clamp(nominal.values[None] - steps[:, None, None] * g_dir,
                         m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1])
    returns = candidate_returns(m, task, cfg, state, nominal.times, values)
    winner = torch.argmin(returns)
    info = PlanInfo(returns=returns, winner=winner,
                    best_return=returns[winner], nominal_return=returns[0],
                    improvement=returns[0] - returns[winner])
    return SplinePolicy(times=nominal.times, values=values[winner]), info
