"""Extended Kalman filter on the tangent-space state.

Counterpart of humanoid_mujoco_tpu/estimators/kalman.py, a rebuild of
the reference EKF (mjpc/estimators/kalman.cc:188-292): predict with the
full nonlinear step and propagate the covariance through the tangent
Jacobian A (`step_tangent_jacobians`, the mjd_transitionFD
replacement), then a standard innovation update. The covariance lives
in the 2·nv tangent space; configuration updates go through the
quaternion ⊞.

B filters run in lockstep: the state and covariance are batch-leading,
(B, ...) and (B, 2nv, 2nv). The predict is one `step` of the batch
(kernels B1 + B2 for the humanoid on the card, B3 for a "rows" model);
A comes from one dual `step(ift=True)`, plain PyTorch by design. The
update's linear algebra raises nothing and syncs nothing with the host
(`torch.linalg.solve_ex`): a singular S gives NaN, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops.linalg import symmetrize
from ..physics.model import Model, State
from ..physics.step import step
from ..physics.tangent import state_add
from ..planners.derivatives import step_tangent_jacobians
from .sensors import SensorModel, measure, measurement_jacobian


@dataclasses.dataclass(frozen=True)
class EKFConfig:
    process_noise_pos: float = 1e-5
    process_noise_vel: float = 1e-3
    init_cov: float = 1e-4
    # the sim path's contact iterations (physics/step.py default 8), so
    # the predict model agrees with the simulated plant
    solver_iters: int = 8


@dataclasses.dataclass(frozen=True)
class EKFState:
    state: State
    cov: torch.Tensor      # (B, 2nv, 2nv)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def process_noise(nv: int, pos: float, vel: float, like: torch.Tensor
                  ) -> torch.Tensor:
    """Q's diagonal (2nv,): `pos` on the configuration, `vel` on the
    velocity tangent."""
    return torch.cat([torch.full((nv, ), pos, dtype=like.dtype,
                                 device=like.device),
                      torch.full((nv, ), vel, dtype=like.dtype,
                                 device=like.device)])


def ekf_init(m: Model, cfg: EKFConfig, state: State) -> EKFState:
    n = 2 * m.nv
    B = state.qpos.shape[0]
    cov = (cfg.init_cov * _eye(n, state.qpos)).expand(B, n, n).clone()
    return EKFState(state=state, cov=cov)


def ekf_update(m: Model, cfg: EKFConfig, sensor: SensorModel,
               ekf: EKFState, ctrl: torch.Tensor, y: torch.Tensor
               ) -> Tuple[EKFState, torch.Tensor]:
    """One predict + measurement update of each filter (the
    Estimator::Update analog, estimators/estimator.h:33-97): ctrl
    (B, nu), y (B, ny). Returns (state', innovation norm (B,))."""
    nv = m.nv
    n2 = 2 * nv
    st = ekf.state

    # ---- predict ----
    s_pred, _ = step(m, st, ctrl, solver_iters=cfg.solver_iters)
    A, _ = step_tangent_jacobians(
        m, st.qpos, st.qvel, ctrl, st.time, s_pred.qpos, s_pred.qvel,
        solver_iters=cfg.solver_iters)
    Q = torch.diag(process_noise(nv, cfg.process_noise_pos,
                                 cfg.process_noise_vel, y))
    P = A @ ekf.cov @ A.transpose(-1, -2) + Q
    # the contact Jacobian is stiff (||A|| ~ 1e3 at a grazing contact
    # with solref 0.015 at 2 ms), so A P Aᵀ carries float32 rounding of
    # the order of 1e-2: symmetrize here and jitter S below, or the
    # factorization sees an indefinite matrix and the filter NaNs (the
    # reference runs float64, where this never surfaces)
    P = symmetrize(P)

    # ---- update ----
    H = measurement_jacobian(m, s_pred.qpos, s_pred.qvel)
    innov = y - measure(m, s_pred.qpos, s_pred.qvel)
    # the noise squared in its own dtype (float32 by default), as in JAX
    R = torch.diag((sensor.noise ** 2).to(y.dtype))
    ny = y.shape[-1]
    Ht = H.transpose(-1, -2)
    S = H @ P @ Ht + R
    # In float32 the S assembly at ||P|| ~ 1e2-1e3 carries rounding
    # ~1e-2, enough to leave S slightly indefinite: a Cholesky (the
    # kalman.cc:212,232 mju_cholFactor/Solve route, valid in the
    # reference's float64) emits NaN. An LU solve with a relative jitter
    # is robust at the same cost for ny = 30.
    trace = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
    S = symmetrize(S) + (1e-5 * trace / ny + 1e-9)[:, None, None] \
        * _eye(ny, y)
    K = torch.linalg.solve_ex(S, H @ P)[0].transpose(-1, -2)   # (B, 2nv, ny)
    dx = (K @ innov[..., None])[..., 0]
    qpos = state_add(m, s_pred.qpos, dx[:, :nv])
    qvel = s_pred.qvel + dx[:, nv:]
    # the Joseph form keeps P_new PSD under float32 rounding
    IKH = _eye(n2, y) - K @ H
    P_new = IKH @ P @ IKH.transpose(-1, -2) + K @ R @ K.transpose(-1, -2)
    P_new = symmetrize(P_new)

    new = EKFState(state=State(qpos=qpos, qvel=qvel, time=s_pred.time),
                   cov=P_new)
    return new, torch.linalg.vector_norm(innov, dim=-1)
