"""Batched rollouts: a Python loop over the physics step.

Counterpart of humanoid_mujoco_tpu/rollout.py. The JAX package scans
one rollout and vmaps it over the batch; here the batch is the leading
axis of the state and the horizon is a loop. Divergence guard: a
rollout whose physics diverged returns MAX_RETURN (the reference's
kMaxReturnValue).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
                   xfrc_seq: Optional[torch.Tensor] = None,
                   solver_iters: int = 8) -> RolloutResult:
    """Roll a spline policy for `horizon` steps of m.dt.

    s0 (B, ...), times (K,), values (B, K, nu) or shared (K, nu).
    xfrc_seq: optional per-step external wrenches (B, T, nbody, 6), or
    (T, nbody, 6) shared by the batch (the robust planner's OU
    perturbations, mjpc/trajectory.cc:147-155); step t takes
    xfrc_seq[:, t] as it lies, a strided view (batch stride 0 when
    shared), which kernel B1 reads in place.
    """
    lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
    if xfrc_seq is not None:
        if xfrc_seq.ndim == 3:
            xfrc_seq = xfrc_seq.expand(s0.batch, *xfrc_seq.shape)
        horizon = xfrc_seq.shape[1]
    s = s0
    residuals, diverged = [], []
    for t in range(horizon):
        ctrl = torch.clamp(spline_sample(times, values, s.time, order),
                           lo, hi)
        if ctrl.ndim == 1:
            ctrl = ctrl.expand(s.batch, -1)
        xfrc = None if xfrc_seq is None else xfrc_seq[:, t]
        s_new, info = step(m, s, ctrl, xfrc=xfrc, solver_iters=solver_iters)
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


def ou_wrench_sequence(horizon: int, nbody: int, scale, rate: float, dt,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None,
                       repetitions: Optional[int] = None, dtype=None,
                       device=None) -> torch.Tensor:
    """Ornstein-Uhlenbeck random wrench sequences (R, T, nbody, 6), the
    NoisyRollout perturbation model (mjpc/trajectory.cc:147-155):
    x_{t+1} = x_t - theta x_t dt + scale sqrt(2 theta dt) w_t from x = 0,
    theta = 1 / rate. dt: a number or the model's 0-d `dt` (no host
    read). `noise` (R, T, nbody, 6) standard normal replaces the draw of
    `repetitions` sequences from `generator`."""
    if noise is None:
        noise = torch.randn((repetitions, horizon, nbody, 6),
                            generator=generator, dtype=dtype, device=device)
    theta = 1.0 / max(float(rate), 1e-6)
    gain = scale * torch.sqrt(torch.as_tensor(
        2 * theta * dt, dtype=noise.dtype, device=noise.device))
    x = torch.zeros_like(noise[:, 0])
    seq = []
    for t in range(noise.shape[1]):
        x = x + theta * (0.0 - x) * dt + gain * noise[:, t]
        seq.append(x)
    return torch.stack(seq, dim=1)
