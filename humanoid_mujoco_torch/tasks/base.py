"""Residual-based cost model (the reference's Task / ResidualFn).

Counterpart of humanoid_mujoco_tpu/tasks/base.py:
    residual r(state) -> cost_k = weight_k * norm_k(r_slice_k; p)
    -> total = Σ_k cost_k -> optional risk transform
       (exp(risk * total) - 1) / risk.
Term structure is static; weights, norm parameters, task parameters and
risk are tensors. Residual functions work on a batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from .. import resolve_device
from ..ops import norms
from ..physics.model import Model, State
from ..physics.step import StepInfo

# residual signature: (model, task, state, info, ctrl) -> (B, nres)
ResidualFn = Callable[[Model, "Task", State, StepInfo, torch.Tensor],
                      torch.Tensor]

_RISK_TOL = 1e-6


@dataclasses.dataclass(frozen=True)
class TermSpec:
    """Static description of one cost term (name, residual dim, norm)."""

    name: str
    dim: int
    norm: int          # norms.NormType value
    num_params: int = 0


@dataclasses.dataclass(frozen=True)
class Task:
    name: str
    terms: Tuple[TermSpec, ...]
    residual_fn: ResidualFn
    param_names: Tuple[str, ...]
    weights: torch.Tensor       # (nterm,)
    norm_params: torch.Tensor   # (nterm, 2) (p, q) per term
    params: torch.Tensor        # (nparam,)
    risk: torch.Tensor          # ()

    @property
    def nres(self) -> int:
        return sum(t.dim for t in self.terms)

    @property
    def nterm(self) -> int:
        return len(self.terms)

    def residual(self, m: Model, state: State, info: StepInfo,
                 ctrl: torch.Tensor) -> torch.Tensor:
        return self.residual_fn(m, self, state, info, ctrl)


def make_task(name: str, terms, residual_fn, weights, norm_params=None,
              params=(), param_names=(), risk=0.0, dtype=torch.float32,
              device=None) -> Task:
    dev = resolve_device(device)
    nterm = len(terms)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    npz = (torch.zeros((nterm, 2), dtype=dtype, device=dev)
           if norm_params is None else t(norm_params).reshape(nterm, 2))
    return Task(name=name, terms=tuple(terms), residual_fn=residual_fn,
                param_names=tuple(param_names), weights=t(weights),
                norm_params=npz, params=t(list(params)).reshape(-1),
                risk=t(risk))


def cost_terms(task: Task, residual: torch.Tensor) -> torch.Tensor:
    """Weighted per-term costs (..., nterm) from residual (..., nres)."""
    outs = []
    off = 0
    for k, t in enumerate(task.terms):
        r = residual[..., off:off + t.dim]
        off += t.dim
        c = norms.norm_value(r, t.norm, task.norm_params[k, 0],
                             task.norm_params[k, 1])
        outs.append(task.weights[k] * c)
    return torch.stack(outs, dim=-1)


def cost_value(task: Task, residual: torch.Tensor) -> torch.Tensor:
    """Total (risk-transformed) cost (...) from residual (..., nres)."""
    total = torch.sum(cost_terms(task, residual), dim=-1)
    risk = task.risk
    small = torch.abs(risk) < _RISK_TOL
    transformed = (torch.exp(risk * total) - 1.0) / torch.where(
        small, torch.ones_like(risk), risk)
    return torch.where(small, total, transformed)


def trajectory_cost(task: Task, residuals: torch.Tensor,
                    diverged: torch.Tensor | None = None,
                    max_return: float = 1e6) -> torch.Tensor:
    """Σ over the horizon of per-step costs, (..., T, nres) -> (...); a
    rollout that diverged anywhere, or is not finite, gets max_return."""
    total = torch.sum(cost_value(task, residuals), dim=-1)
    total = torch.nan_to_num(total, nan=max_return, posinf=max_return)
    if diverged is not None:
        total = torch.where(diverged.any(dim=-1),
                            torch.full_like(total, max_return), total)
    return total
