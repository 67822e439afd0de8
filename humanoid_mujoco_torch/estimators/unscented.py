"""Unscented Kalman filter with quaternion-aware sigma points.

Counterpart of humanoid_mujoco_tpu/estimators/unscented.py, a rebuild of
the reference UKF (mjpc/estimators/unscented.h:51-60,178-202): 2·n + 1
sigma points in the TANGENT space (n = 2·nv), mapped onto the
configuration manifold with ⊞, propagated through the full nonlinear
step and recombined with tangent-space means and covariances.

B filters run in lockstep. Their B·(2n + 1) sigma points are ONE batch
of `step` (kernels B1 + B2 at batch 73 for one humanoid filter on the
card), where the JAX package vmaps the step over the points.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..ops import linalg
from ..physics.model import Model, State
from ..physics.step import step
from ..physics.tangent import qpos_diff, state_add
from .kalman import _eye, process_noise
from .sensors import SensorModel, measure


@dataclasses.dataclass(frozen=True)
class UKFConfig:
    alpha: float = 1e-1
    beta: float = 2.0
    process_noise_pos: float = 1e-5
    process_noise_vel: float = 1e-3
    init_cov: float = 1e-4
    solver_iters: int = 4


@dataclasses.dataclass(frozen=True)
class UKFState:
    state: State
    cov: torch.Tensor      # (B, 2nv, 2nv)


def ukf_init(m: Model, cfg: UKFConfig, state: State) -> UKFState:
    n = 2 * m.nv
    B = state.qpos.shape[0]
    cov = (cfg.init_cov * _eye(n, state.qpos)).expand(B, n, n).clone()
    return UKFState(state=state, cov=cov)


def _weighted_cov(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """sum_i w_i a_i b_iᵀ over the sigma points: w (P,), a (B, P, j),
    b (B, P, k) -> (B, j, k)."""
    return torch.einsum("i,bij,bik->bjk", w, a, b)


def ukf_update(m: Model, cfg: UKFConfig, sensor: SensorModel,
               ukf: UKFState, ctrl: torch.Tensor, y: torch.Tensor
               ) -> Tuple[UKFState, torch.Tensor]:
    """One sigma-point predict + update of each filter: ctrl (B, nu),
    y (B, ny). Returns (state', innovation norm (B,))."""
    nv = m.nv
    n = 2 * nv
    npt = 2 * n + 1
    B = y.shape[0]
    st = ukf.state
    lam = cfg.alpha ** 2 * n - n
    c = n + lam
    w_mean0 = lam / c
    w_cov0 = lam / c + (1 - cfg.alpha ** 2 + cfg.beta)
    w_i = 1.0 / (2 * c)

    # sigma points in tangent space: 0, ±sqrt(c P) (the rows of √c Lᵀ)
    L = linalg.chol_factor(ukf.cov + 1e-12 * _eye(n, y))
    sLt = math.sqrt(c) * L.transpose(-1, -2)
    deltas = torch.cat([y.new_zeros((B, 1, n)), sLt, -sLt], dim=1)

    # every filter's 2n + 1 points as one batch of the step
    d = deltas.reshape(B * npt, n)
    qp = state_add(m, st.qpos.repeat_interleave(npt, dim=0), d[:, :nv])
    qv = st.qvel.repeat_interleave(npt, dim=0) + d[:, nv:]
    s2, _ = step(m, State(qp, qv, st.time.repeat_interleave(npt, dim=0)),
                 ctrl.repeat_interleave(npt, dim=0),
                 solver_iters=cfg.solver_iters)

    # tangent mean: anchor at the central point, average the differences
    qps = s2.qpos.reshape(B, npt, -1)
    qvs = s2.qvel.reshape(B, npt, nv)
    anchor_q, anchor_v = qps[:, 0], qvs[:, 0]
    dqs = qpos_diff(m, s2.qpos, anchor_q.repeat_interleave(npt, dim=0))
    dtan = torch.cat([dqs.reshape(B, npt, nv), qvs - anchor_v[:, None]],
                     dim=-1)                                # (B, 2n+1, n)
    w = torch.cat([y.new_tensor([w_mean0]), y.new_full((2 * n, ), w_i)])
    wc = torch.cat([y.new_tensor([w_cov0]), y.new_full((2 * n, ), w_i)])
    mean_t = torch.einsum("i,bij->bj", w, dtan)
    qpos_pred = state_add(m, anchor_q, mean_t[:, :nv])
    qvel_pred = anchor_v + mean_t[:, nv:]
    dd = dtan - mean_t[:, None]
    Q = torch.diag(process_noise(nv, cfg.process_noise_pos,
                                 cfg.process_noise_vel, y))
    P = _weighted_cov(wc, dd, dd) + Q

    # measurement sigma points
    ys = measure(m, s2.qpos, s2.qvel).reshape(B, npt, -1)
    y_mean = torch.einsum("i,bij->bj", w, ys)
    dy = ys - y_mean[:, None]
    R = torch.diag((sensor.noise ** 2).to(y.dtype))
    S = _weighted_cov(wc, dy, dy) + R
    Pxy = _weighted_cov(wc, dd, dy)

    Ls = linalg.chol_factor(S)
    K = linalg.chol_solve(Ls, Pxy.transpose(-1, -2)).transpose(-1, -2)
    innov = y - y_mean
    dx = (K @ innov[..., None])[..., 0]
    qpos = state_add(m, qpos_pred, dx[:, :nv])
    qvel = qvel_pred + dx[:, nv:]
    P_new = P - K @ S @ K.transpose(-1, -2)
    P_new = linalg.symmetrize(P_new) + 1e-12 * _eye(n, y)

    new = UKFState(state=State(qpos=qpos, qvel=qvel, time=st.time + m.dt),
                   cov=P_new)
    return new, torch.linalg.vector_norm(innov, dim=-1)
