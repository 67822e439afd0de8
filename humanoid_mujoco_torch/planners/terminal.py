"""Infinite-horizon LQR terminal value for short-horizon MPC.

Counterpart of humanoid_mujoco_tpu/planners/terminal.py. The reference
runs iLQG with a 0.35 s horizon and no terminal cost (task.xml:11). The
JAX package adds an option: solve the discrete algebraic Riccati
equation at the task's equilibrium once (a fixed-point iteration of the
backward pass's Riccati step) and use 0.5 (x_T ⊖ x_eq)ᵀ P (x_T ⊖ x_eq)
as the terminal cost, in the rollout returns and as the backward
pass's initial value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops import linalg
from ..physics.model import Model, State
from ..physics.step import step
from ..physics.tangent import state_diff
from ..tasks.base import Task
from .derivatives import (gauss_newton_cost, residual_tangent,
                          step_tangent_jacobians)


@dataclasses.dataclass(frozen=True)
class TerminalCost:
    P: torch.Tensor        # (2nv, 2nv) value Hessian at the equilibrium
    qpos_eq: torch.Tensor  # (nq,)
    qvel_eq: torch.Tensor  # (nv,)
    weight: torch.Tensor   # () scaling (1 = the exact DARE value)


def lqr_terminal(m: Model, task: Task, qpos_eq: torch.Tensor,
                 u_eq: Optional[torch.Tensor] = None, iters: int = 200,
                 reg: float = 1e-6, weight: float = 1.0,
                 solver_iters: int = 6) -> TerminalCost:
    """The stationary P of the DARE around (qpos_eq (nq,), 0) under the
    task's Gauss-Newton cost expansion."""
    dtype, dev = qpos_eq.dtype, qpos_eq.device
    qvel_eq = torch.zeros(m.nv, dtype=dtype, device=dev)
    u = torch.zeros(m.nu, dtype=dtype, device=dev) if u_eq is None else u_eq
    q, v, u, t0 = (qpos_eq[None], qvel_eq[None], u[None],
                   torch.zeros(1, dtype=dtype, device=dev))
    s_next, _ = step(m, State(q, v, t0), u, solver_iters=solver_iters)
    A, B = step_tangent_jacobians(m, q, v, u, t0, s_next.qpos, s_next.qvel,
                                  solver_iters=solver_iters)
    A, B = A[0], B[0]
    r, C, D = residual_tangent(m, task, q, v, u, t0)
    _, _, cxx, cxu, cuu = (x[0] for x in gauss_newton_cost(task, r, C, D))
    eye_u = torch.eye(m.nu, dtype=dtype, device=dev)
    P = cxx
    for _ in range(iters):
        PA, PB = P @ A, P @ B
        Quu = cuu + B.T @ PB + reg * eye_u
        Qux = cxu.T + B.T @ PA
        K = linalg.chol_solve(linalg.chol_factor(Quu), Qux)
        P = linalg.symmetrize(cxx + A.T @ PA - Qux.T @ K)
    return TerminalCost(P=P, qpos_eq=qpos_eq, qvel_eq=qvel_eq,
                        weight=torch.as_tensor(weight, dtype=dtype,
                                               device=dev))


def terminal_value(m: Model, term: TerminalCost, qpos: torch.Tensor,
                   qvel: torch.Tensor) -> torch.Tensor:
    """0.5 w dxᵀ P dx of a batch of final states (B, ...) -> (B,)."""
    dx = _dx(m, term, qpos, qvel)
    return 0.5 * term.weight * torch.sum(dx * (dx @ term.P.T), dim=-1)


def terminal_gradient(m: Model, term: TerminalCost, qpos: torch.Tensor,
                      qvel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Vx (B, 2nv), Vxx (2nv, 2nv)) at a batch of final states."""
    dx = _dx(m, term, qpos, qvel)
    return term.weight * (dx @ term.P.T), term.weight * term.P


def _dx(m, term, qpos, qvel):
    B = qpos.shape[0]
    return state_diff(m, qpos, qvel, term.qpos_eq.expand(B, -1),
                      term.qvel_eq.expand(B, -1))
