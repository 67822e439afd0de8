"""Residual-based cost model (the reference's Task / ResidualFn).

Counterpart of humanoid_mujoco_tpu/tasks/base.py:
    residual r(state) -> cost_k = weight_k * norm_k(r_slice_k; p)
    -> total = Σ_k cost_k -> optional risk transform
       (exp(risk * total) - 1) / risk.
Term structure is static; weights, norm parameters, task parameters and
risk are tensors. Residual functions work on a batch. A task may carry
mocap goal bodies (named positions and orientations its residual reads),
modes, and a transition that moves them between control steps
(Task::Transition).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

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
    # transition_fn(task, m, state, info) -> Task, run after a sim step;
    # mode_names name the values of `mode` (SetMode / GetMode)
    transition_fn: Optional[Callable] = None
    mode_names: Tuple[str, ...] = ("default",)
    mode: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(0, dtype=torch.int32))
    # mocap goal bodies: names, positions (nmocap, 3), quats (nmocap, 4)
    mocap_names: Tuple[str, ...] = ()
    mocap_pos: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((0, 3)))
    mocap_quat: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((0, 4)))

    @property
    def nres(self) -> int:
        return sum(t.dim for t in self.terms)

    @property
    def nterm(self) -> int:
        return len(self.terms)

    def residual(self, m: Model, state: State, info: StepInfo,
                 ctrl: torch.Tensor) -> torch.Tensor:
        return self.residual_fn(m, self, state, info, ctrl)

    def set_weight(self, name: str, value) -> "Task":
        """SetCostWeights verb: a copy with term `name` weighted `value`."""
        i = [t.name for t in self.terms].index(name)
        w = self.weights.clone()
        w[i] = value
        return dataclasses.replace(self, weights=w)

    def set_param(self, name: str, value) -> "Task":
        """SetTaskParameters verb: a copy with parameter `name` set."""
        i = self.param_names.index(name)
        p = self.params.clone()
        p[i] = value
        return dataclasses.replace(self, params=p)

    def set_mocap(self, name: str, pos=None, quat=None) -> "Task":
        """SetMocap verb: a copy with mocap body `name` moved."""
        i = self.mocap_names.index(name)
        t = self
        if pos is not None:
            mp = t.mocap_pos.clone()
            mp[i] = torch.as_tensor(pos, dtype=mp.dtype, device=mp.device)
            t = dataclasses.replace(t, mocap_pos=mp)
        if quat is not None:
            mq = t.mocap_quat.clone()
            mq[i] = torch.as_tensor(quat, dtype=mq.dtype, device=mq.device)
            t = dataclasses.replace(t, mocap_quat=mq)
        return t

    def set_mode(self, mode) -> "Task":
        """SetMode verb: mode by index or name."""
        if isinstance(mode, str):
            mode = self.mode_names.index(mode)
        return dataclasses.replace(self, mode=torch.as_tensor(
            mode, dtype=torch.int32, device=self.mode.device))

    def transition(self, m: Model, state: State, info: StepInfo) -> "Task":
        """Per-step task transition (Task::Transition): the task with its
        goals or mode moved, or itself when it has no transition."""
        if self.transition_fn is None:
            return self
        return self.transition_fn(self, m, state, info)


def constant(m: Model, key: str, values, like: torch.Tensor) -> torch.Tensor:
    """`values` as a tensor of `like`'s dtype and device, built once per
    model structure: a residual's constants, which a host-to-device copy
    a step would otherwise hold the host up for."""
    return m.struct_static((key, like.dtype, like.device), lambda: torch.tensor(
        values, dtype=like.dtype, device=like.device))


def make_task(name: str, terms, residual_fn, weights, norm_params=None,
              params=(), param_names=(), risk=0.0, transition_fn=None,
              mode_names=("default",), mocap=None, dtype=torch.float32,
              device=None) -> Task:
    """A Task on `device`. `mocap` maps a goal body's name to its
    position (3,) or to (position, quaternion)."""
    dev = resolve_device(device)
    nterm = len(terms)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    npz = (torch.zeros((nterm, 2), dtype=dtype, device=dev)
           if norm_params is None else t(norm_params).reshape(nterm, 2))
    mocap = mocap or {}
    mpos = torch.zeros((len(mocap), 3), dtype=dtype, device=dev)
    mquat = t([1.0, 0.0, 0.0, 0.0]).repeat(len(mocap), 1)
    for i, v in enumerate(mocap.values()):
        posquat = isinstance(v, tuple) and len(v) == 2
        mpos[i] = t(v[0] if posquat else v)
        if posquat:
            mquat[i] = t(v[1])
    return Task(name=name, terms=tuple(terms), residual_fn=residual_fn,
                param_names=tuple(param_names), weights=t(weights),
                norm_params=npz, params=t(list(params)).reshape(-1),
                risk=t(risk), transition_fn=transition_fn,
                mode_names=tuple(mode_names),
                mode=torch.tensor(0, dtype=torch.int32, device=dev),
                mocap_names=tuple(mocap), mocap_pos=mpos,
                mocap_quat=mquat)


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
