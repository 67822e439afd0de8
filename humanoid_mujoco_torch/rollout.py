"""Batched rollouts: a Python loop over the physics step.

Counterpart of humanoid_mujoco_tpu/rollout.py. The JAX package scans
one rollout and vmaps it over the batch; here the batch is the leading
axis of the state and the horizon is a loop. Divergence guard: a
rollout whose physics diverged returns MAX_RETURN (the reference's
kMaxReturnValue).
"""

from __future__ import annotations

import dataclasses

import torch

from .ops.spline import spline_sample
from .physics.model import Model, State
from .physics.step import step
from .tasks.base import Task, cost_value

MAX_RETURN = 1e6


@dataclasses.dataclass(frozen=True)
class RolloutResult:
    total_return: torch.Tensor   # (B,) mean per-step cost, 1e6 if diverged
    costs: torch.Tensor          # (B, T)
    residuals: torch.Tensor      # (B, T, nres)
    final_state: State
    diverged: torch.Tensor       # (B,) any step diverged


def _finish(task: Task, residuals, diverged, s_end) -> RolloutResult:
    residuals = torch.stack(residuals, dim=1)
    diverged = torch.stack(diverged, dim=1).any(dim=1)
    costs = cost_value(task, residuals)
    # normalized by the horizon (UpdateReturn, mjpc/trajectory.cc:325)
    total = costs.sum(dim=1) / max(costs.shape[1], 1)
    bad = diverged | ~torch.isfinite(total)
    total = torch.where(bad, torch.full_like(total, MAX_RETURN), total)
    return RolloutResult(total_return=total, costs=costs,
                         residuals=residuals, final_state=s_end,
                         diverged=diverged)


def rollout_spline(m: Model, task: Task, s0: State, times: torch.Tensor,
                   values: torch.Tensor, order: int, horizon: int,
                   solver_iters: int = 8) -> RolloutResult:
    """Roll a spline policy for `horizon` steps of m.dt.

    s0 (B, ...), times (K,), values (B, K, nu) or shared (K, nu).
    (The per-step wrench sequence of the JAX signature comes with the
    robust planner's slice.)
    """
    lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
    s = s0
    residuals, diverged = [], []
    for t in range(horizon):
        ctrl = torch.clamp(spline_sample(times, values, s.time, order),
                           lo, hi)
        if ctrl.ndim == 1:
            ctrl = ctrl.expand(s.batch, -1)
        s_new, info = step(m, s, ctrl, solver_iters=solver_iters)
        residuals.append(task.residual(m, s, info, ctrl))
        diverged.append(info.diverged)
        s = s_new
    return _finish(task, residuals, diverged, s)


def rollout_actions(m: Model, task: Task, s0: State, actions: torch.Tensor,
                    solver_iters: int = 8) -> RolloutResult:
    """Roll an explicit action sequence, actions (B, T, nu)."""
    lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
    s = s0
    residuals, diverged = [], []
    for t in range(actions.shape[1]):
        ctrl = torch.clamp(actions[:, t], lo, hi)
        s_new, info = step(m, s, ctrl, solver_iters=solver_iters)
        residuals.append(task.residual(m, s, info, ctrl))
        diverged.append(info.diverged)
        s = s_new
    return _finish(task, residuals, diverged, s)
