"""Batch (moving-horizon) estimator.

Counterpart of humanoid_mujoco_tpu/estimators/batch.py, a rebuild of the
reference's recursive sliding-window MLE (mjpc/estimators/batch.h:39-78,
built on the direct optimizer): keep a fixed window of the last W
(state, ctrl, measurement) triples and estimate tangent corrections to
the whole window by Gauss-Newton on

    sum_t |y_t - h(x_t)|^2_Rinv  +  sum_t |x_{t+1} ⊖ f(x_t)|^2_Qinv
    + |x_0 ⊖ prior|^2_Pinv

The reference factorizes a banded Hessian with a band Cholesky
(batch/direct.cc:504-506); here, as in the JAX package, the (W·2nv)²
system is solved densely (`ops.linalg.solve_psd`).

B windows run in lockstep, batch-leading. Each Gauss-Newton iteration
takes the W measurement Jacobians in one dual pass, the W − 1 dynamics
residuals in one `step` of B·(W − 1) knots (kernels B1 + B2 for the
humanoid on the card) and their A in one dual `step(ift=True)`, and
assembles the block-tridiagonal system with tensor ops. The iterations
are a Python loop with no host sync in it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops import linalg
from ..physics.model import Model, State
from ..physics.step import step
from ..physics.tangent import state_add, state_diff
from ..planners.derivatives import step_tangent_jacobians
from .kalman import _eye, process_noise
from .sensors import SensorModel, measure, measurement_jacobian


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    window: int = 8
    gn_iters: int = 2
    solver_iters: int = 4
    process_noise_pos: float = 1e-4
    process_noise_vel: float = 1e-2
    prior_cov: float = 1e-2


@dataclasses.dataclass(frozen=True)
class BatchState:
    qpos_win: torch.Tensor    # (B, W, nq) window of state estimates
    qvel_win: torch.Tensor    # (B, W, nv)
    ctrl_win: torch.Tensor    # (B, W, nu) controls applied at each step
    y_win: torch.Tensor       # (B, W, ny) measurements
    time: torch.Tensor        # (B,)
    filled: torch.Tensor      # (B,) int32 number of valid entries


def batch_init(m: Model, cfg: BatchConfig, state: State, ny: int = 30
               ) -> BatchState:
    """A window filled with copies of `state` and its measurement (`ny`
    is kept for the JAX signature; the measurement sets the width)."""
    W = cfg.window
    qpos, qvel = state.qpos, state.qvel
    B = qpos.shape[0]
    return BatchState(
        qpos_win=qpos[:, None].repeat(1, W, 1),
        qvel_win=qvel[:, None].repeat(1, W, 1),
        ctrl_win=qpos.new_zeros((B, W, m.nu)),
        y_win=measure(m, qpos, qvel)[:, None].repeat(1, W, 1),
        time=state.time,
        filled=torch.ones(B, dtype=torch.int32, device=qpos.device))


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, W, ...) -> (B·W, ...)."""
    return x.reshape((-1, ) + x.shape[2:])


def _system(H, r_y, A, r_d, Rinv, Qinv, Pinv, dx0):
    """The Gauss-Newton system (Hgn (B, W·n, W·n), g (B, W·n)) of the
    window from the measurement terms H (B, W, ny, n), r_y (B, W, ny),
    the dynamics terms A (B, W-1, n, n), r_d (B, W-1, n) (d r_d[t]/d x_t
    = -A_t, d r_d[t]/d x_{t+1} = I) and the prior's dx0 (B, n).

    The blocks are assembled as a (B, W, W, n, n) tensor: its diagonal
    holds Hᵀ Rinv H, Aᵀ Qinv A on the first W − 1 steps, Qinv on the last
    W − 1 and Pinv on the first; the off-diagonal blocks -A_tᵀ Qinv and
    their transposes."""
    B, W, _, n = H.shape
    Ht = H.transpose(-1, -2)
    At = A.transpose(-1, -2)
    AtQ = At * Qinv                                  # (B, W-1, n, n)
    Qd, Pd = torch.diag(Qinv), torch.diag(Pinv)
    diag = Ht @ (Rinv[:, None] * H)                  # (B, W, n, n)
    diag = diag + torch.cat([AtQ @ A, diag.new_zeros((B, 1, n, n))], dim=1)
    diag = diag + torch.cat([diag.new_zeros((B, 1, n, n)),
                             Qd.expand(B, W - 1, n, n)], dim=1)
    diag[:, 0] = diag[:, 0] + Pd
    idx = torch.arange(W, device=H.device)
    blocks = H.new_zeros((B, W, W, n, n))
    blocks[:, idx, idx] = diag
    blocks[:, idx[:-1], idx[1:]] = -AtQ
    blocks[:, idx[1:], idx[:-1]] = -AtQ.transpose(-1, -2)
    Hgn = blocks.transpose(2, 3).reshape(B, W * n, W * n)

    g = -(Ht @ (Rinv * r_y)[..., None])[..., 0]      # (B, W, n)
    qr = Qinv * r_d                                   # (B, W-1, n)
    g = g + torch.cat([-(At @ qr[..., None])[..., 0],
                       g.new_zeros((B, 1, n))], dim=1)
    g = g + torch.cat([g.new_zeros((B, 1, n)), qr], dim=1)
    g[:, 0] = g[:, 0] + Pinv * dx0
    return Hgn, g.reshape(B, W * n)


def batch_update(m: Model, cfg: BatchConfig, sensor: SensorModel,
                 bs: BatchState, ctrl: torch.Tensor, y: torch.Tensor
                 ) -> Tuple[BatchState, State]:
    """Shift each window, append (ctrl (B, nu), y (B, ny)), re-optimize
    all window states. Returns (new batch state, the current MAP state
    estimate)."""
    W = cfg.window
    nv = m.nv
    n = 2 * nv
    B = y.shape[0]
    dtype = y.dtype

    # shift in: predict the newest state from the last estimate
    last = State(bs.qpos_win[:, -1], bs.qvel_win[:, -1], bs.time)
    pred, _ = step(m, last, ctrl, solver_iters=cfg.solver_iters)
    qp = torch.cat([bs.qpos_win[:, 1:], pred.qpos[:, None]], dim=1)
    qv = torch.cat([bs.qvel_win[:, 1:], pred.qvel[:, None]], dim=1)
    ctrl_win = torch.cat([bs.ctrl_win[:, 1:], ctrl[:, None]], dim=1)
    y_win = torch.cat([bs.y_win[:, 1:], y[:, None]], dim=1)

    # the noise's inverse squares in its own dtype, as in JAX
    Rinv = (1.0 / (sensor.noise ** 2)).to(dtype)
    Qinv = process_noise(nv, 1.0 / cfg.process_noise_pos,
                         1.0 / cfg.process_noise_vel, y)
    Pinv = torch.full((n, ), 1.0 / cfg.prior_cov, dtype=dtype,
                      device=y.device)
    prior_q, prior_v = qp[:, 0], qv[:, 0]
    u = _flat(ctrl_win[:, 1:])
    t0 = y.new_zeros(B * (W - 1))
    eye = _eye(W * n, y)

    for _ in range(cfg.gn_iters):
        # measurement residuals and Jacobians at the W window steps
        r_y = y_win - measure(m, _flat(qp), _flat(qv)).reshape(B, W, -1)
        H = measurement_jacobian(m, _flat(qp), _flat(qv)).reshape(
            B, W, -1, n)
        # dynamics residuals r_d[t] = x_{t+1} ⊖ f(x_t) and A_t, the W − 1
        # knots of every window as one batch
        q0, v0 = _flat(qp[:, :-1]), _flat(qv[:, :-1])
        s2, _ = step(m, State(q0, v0, t0), u, solver_iters=cfg.solver_iters)
        r_d = state_diff(m, _flat(qp[:, 1:]), _flat(qv[:, 1:]), s2.qpos,
                         s2.qvel).reshape(B, W - 1, n)
        A, _ = step_tangent_jacobians(m, q0, v0, u, t0, s2.qpos, s2.qvel,
                                      solver_iters=cfg.solver_iters)
        dx0 = state_diff(m, qp[:, 0], qv[:, 0], prior_q, prior_v)
        Hgn, g = _system(H, r_y, A.reshape(B, W - 1, n, n), r_d, Rinv,
                         Qinv, Pinv, dx0)
        dx = -linalg.solve_psd(Hgn + 1e-8 * eye, g).reshape(B * W, n)
        qp = state_add(m, _flat(qp), dx[:, :nv]).reshape(B, W, -1)
        qv = qv + dx[:, nv:].reshape(B, W, nv)

    new = BatchState(qpos_win=qp, qvel_win=qv, ctrl_win=ctrl_win,
                     y_win=y_win, time=bs.time + m.dt,
                     filled=torch.clamp(bs.filled + 1, max=W))
    est = State(qpos=qp[:, -1], qvel=qv[:, -1], time=new.time)
    return new, est
