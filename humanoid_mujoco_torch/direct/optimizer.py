"""Direct (batch) trajectory optimizer: the mjpc/direct/ rebuild.

Counterpart of humanoid_mujoco_tpu/direct/optimizer.py. The reference's
"Direct" optimizer (direct/direct.cc, docs/DIRECT.md) estimates a
configuration trajectory q_{0:T} from noisy sensor data by minimizing

    sum_t |y_t - h(q_t, v_t)|^2_Rinv  +  w_f * |f(q, v, a)_t|^2

with velocities and accelerations by finite differences on the
configuration manifold, by Gauss-Newton on a banded Hessian (nband =
3·nv, direct.cc:136). With `contact_forces=True` (the default) the force
residual is the full model's, constraint forces included
(direct.cc:136,504-506): the contact Newton solve runs at each knot with
implicit-function derivatives (`forward(..., ift=True)`), so windows that
touch the ground fit against the right force model:

    f_t = (M(q_t) + h D) (v_{t+1} - v_t) / h - qfrc_total(q_t, v_t, u_t)

J comes, as in the JAX package's one `jacfwd` over the stacked tangent
of the whole window and the parameters, from one dual pass: each
interior knot under every unit tangent of the window and the
parameters, (T − 2)·(T·nv + nparam) rows. The residuals and their
derivatives are plain PyTorch on every device, as the JAX force
residual never enters a Pallas kernel (`forward` has none).

Model-parameter estimation (the direct/model_parameters.cc analog)
takes a named set of global parameters jointly with the trajectory:
mass_scale, damping_scale, friction_scale. A parameter's tangent rides
in the model's leaf (`Model.replace`), through the plain path's reads;
in the Jacobian's pass the leaf is per row (batch-first, as the RL
env's domain-randomized leaves), each row carrying its own tangent.

One window is optimized per call: the knots and tangents are its batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..estimators.sensors import SensorModel, measure
from ..ops import linalg
from ..physics.engine import (actuation, crb_mass_matrix, fwd_position,
                              fwd_velocity, passive_force, rnea_bias)
from ..physics.model import Model, State
from ..physics.step import forward
from ..physics.tangent import qpos_diff, state_add
from ..planners.derivatives import _jacfwd

# named global parameters: theta is a small vector of fractional
# corrections; PARAM_TRANSFORMS[name](m, theta_i) applies one of them,
# theta_i () shared or (B,) per row
PARAM_TRANSFORMS = {
    "mass_scale": lambda m, v: m.replace(
        body_mass=m.body_mass * (1.0 + v)[..., None]),
    "damping_scale": lambda m, v: m.replace(
        dof_damping=m.dof_damping * (1.0 + v)[..., None]),
    "friction_scale": lambda m, v: m.replace(
        floor_friction=m.floor_friction * (1.0 + v)),
}


@dataclasses.dataclass(frozen=True)
class DirectConfig:
    gn_iters: int = 6
    # shorthand for ("mass_scale",)
    estimate_mass: bool = False
    # further named parameters estimated jointly with the trajectory
    # (direct/model_parameters.cc)
    estimate_params: Tuple[str, ...] = ()
    # include the constraint forces of the contact Newton solve in the
    # force residual (the reference's full-model force residual)
    contact_forces: bool = True
    solver_iters: int = 6
    # force residual weight: finite-difference accelerations at small dt
    # amplify configuration noise by 1/dt², so the force term needs
    # down-weighting against the sensor term (the reference exposes the
    # same trade-off as per-term weights in direct/direct.cc)
    force_weight: float = 1e-4
    reg: float = 1e-4


def _param_names(cfg: DirectConfig) -> Tuple[str, ...]:
    names = tuple(cfg.estimate_params)
    if cfg.estimate_mass and "mass_scale" not in names:
        names = ("mass_scale", ) + names
    return names


@dataclasses.dataclass(frozen=True)
class DirectResult:
    qpos: torch.Tensor          # (T, nq) optimized configurations
    qvel: torch.Tensor          # (T-1, nv) finite-difference velocities
    cost: torch.Tensor          # () final cost
    cost_initial: torch.Tensor  # () the first iteration's starting cost
    mass_scale: torch.Tensor    # () estimated mass multiplier (1 if off)
    params: torch.Tensor        # (nparam,) estimated fractional corrections


def _fd_velocities(m: Model, qpos_seq: torch.Tensor, dt) -> torch.Tensor:
    """v_t = (q_{t+1} ⊖ q_t) / dt on the configuration manifold,
    (T, nq) -> (T-1, nv)."""
    return qpos_diff(m, qpos_seq[1:], qpos_seq[:-1]) / dt


def _apply_params(m: Model, cfg: DirectConfig, theta: torch.Tensor
                  ) -> Model:
    """m with the parameters theta (nparam,) applied, or per row with
    theta (B, nparam)."""
    for i, name in enumerate(_param_names(cfg)):
        m = PARAM_TRANSFORMS[name](m, theta[..., i])
    return m


def _knot_residuals(mm: Model, cfg: DirectConfig, sensor: SensorModel,
                    q_prev, q, q_next, y, u, dt):
    """The weighted sensor and force residuals (R, ny), (R, nv) of a
    batch of knots, each from its configurations q_{t-1}, q_t, q_{t+1}
    (R, nq), measurement (R, ny) and control (R, nu).

    The force residual is DISCRETE-CONSISTENT with the simulator's
    semi-implicit Euler with implicit damping (physics/step.py):
        (M(q_t) + h D) (v_{t+1} - v_t) / h - qfrc_total(q_t, v_t, u_t)
    with v_{t+1} = (q_{t+1} ⊖ q_t) / h: exactly zero on noise-free sim
    data, unlike a continuous midpoint inverse dynamics, whose O(dt)
    mismatch is amplified by 1/dt² and buries the parameter signal. The
    sensor residual reads the sim's velocity at knot t, v_t (the one
    that carried q_{t-1} to q_t).
    """
    v_old = qpos_diff(mm, q, q_prev) / dt
    v_new = qpos_diff(mm, q_next, q) / dt
    r_y = (y - measure(mm, q, v_old)) / sensor.noise
    if cfg.contact_forces:
        # the implicit-function derivative keeps the contact solve
        # differentiable for the outer Gauss-Newton Jacobian
        _, qfrc_total, M, _ = forward(
            mm, State(q, v_old, q.new_zeros(q.shape[0])), u,
            solver_iters=cfg.solver_iters, ift=True)
    else:
        kin = fwd_position(mm, q)
        vel = fwd_velocity(mm, kin, v_old)
        M = crb_mass_matrix(mm, kin)
        qfrc_total = (actuation(mm, q, v_old, u)
                      + passive_force(mm, q, v_old)
                      - rnea_bias(mm, kin, vel, v_old))
    MhD = M + dt * torch.diag_embed(mm.dof_damping)
    r_f = math.sqrt(cfg.force_weight) * (
        linalg.mv(MhD, v_new - v_old) / dt - qfrc_total)
    return r_y, r_f


def _window(qpos_seq, y_seq, ctrl_seq):
    """The interior knots' arguments of `_knot_residuals`."""
    return (qpos_seq[:-2], qpos_seq[1:-1], qpos_seq[2:], y_seq[1:-1],
            ctrl_seq[1:-1])


def direct_residuals(m: Model, cfg: DirectConfig, sensor: SensorModel,
                     qpos_seq: torch.Tensor, y_seq: torch.Tensor,
                     ctrl_seq: torch.Tensor, dt, theta: torch.Tensor
                     ) -> torch.Tensor:
    """The stacked weighted residual vector of the window, qpos_seq
    (T, nq), y_seq (T, ny), ctrl_seq (T, nu): the sensor residuals of
    the interior knots ((T-2)·ny), then their force residuals
    ((T-2)·nv)."""
    mm = _apply_params(m, cfg, theta)
    r_y, r_f = _knot_residuals(mm, cfg, sensor,
                               *_window(qpos_seq, y_seq, ctrl_seq), dt)
    return torch.cat([r_y.reshape(-1), r_f.reshape(-1)])


def residual_jacobian(m: Model, cfg: DirectConfig, sensor: SensorModel,
                      qpos_seq: torch.Tensor, y_seq: torch.Tensor,
                      ctrl_seq: torch.Tensor, dt, theta: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r, J): `direct_residuals` and its Jacobian (nres, T·nv + nparam)
    in the tangent of the configurations and the parameters, by one dual
    pass (see the module docstring)."""
    T, nv = qpos_seq.shape[0], m.nv
    K = T - 2
    nvar = T * nv + len(_param_names(cfg))
    args = _window(qpos_seq, y_seq, ctrl_seq)
    idx = torch.arange(K, device=qpos_seq.device)

    def rows(z):
        # row k·nvar + i: knot k under the window's unit tangent e_i
        zq = z[:, :T * nv].reshape(K, nvar, T, nv)
        q = [state_add(m, x.repeat_interleave(nvar, dim=0),
                       zq[idx, :, idx + j].reshape(K * nvar, nv))
             for j, x in enumerate(args[:3])]
        return _knot_residuals(_apply_params(m, cfg, theta + z[:, T * nv:]),
                               cfg, sensor, *q,
                               *(x.repeat_interleave(nvar, dim=0)
                                 for x in args[3:]), dt)

    (r_y, Jy), (r_f, Jf) = _jacfwd(rows, K, nvar, qpos_seq.dtype,
                                   qpos_seq.device)
    return (torch.cat([r_y.reshape(-1), r_f.reshape(-1)]),
            torch.cat([Jy.reshape(-1, nvar), Jf.reshape(-1, nvar)]))


def direct_optimize(m: Model, cfg: DirectConfig, sensor: SensorModel,
                    qpos_init: torch.Tensor, y_seq: torch.Tensor,
                    ctrl_seq: torch.Tensor, dt: float) -> DirectResult:
    """Gauss-Newton over tangent corrections to the whole window
    (Direct::Optimize). qpos_init (T, nq): the initial guess (e.g. the
    measured configurations); y_seq (T, ny); ctrl_seq (T, nu).

    A step is kept only if it lowers the cost to a finite value, decided
    on the device (`torch.where`); nothing syncs with the host between
    iterations."""
    T, nv = qpos_init.shape[0], m.nv
    dtype, dev = qpos_init.dtype, qpos_init.device
    pnames = _param_names(cfg)
    npar = len(pnames)
    nvar = T * nv + npar
    eye = torch.eye(nvar, dtype=dtype, device=dev)

    qpos_seq = qpos_init
    theta = torch.zeros((npar, ), dtype=dtype, device=dev)
    cost = cost_initial = qpos_init.new_zeros(())
    for it in range(cfg.gn_iters):
        r0, J = residual_jacobian(m, cfg, sensor, qpos_seq, y_seq, ctrl_seq,
                                  dt, theta)
        H = J.T @ J + cfg.reg * eye
        dx = -linalg.solve_psd(H, J.T @ r0)
        dx = torch.nan_to_num(dx, nan=0.0, posinf=0.0, neginf=0.0)
        qp_new = state_add(m, qpos_seq, dx[:T * nv].reshape(T, nv))
        th_new = theta + dx[T * nv:]
        r1 = direct_residuals(m, cfg, sensor, qp_new, y_seq, ctrl_seq, dt,
                              th_new)
        c0 = torch.sum(r0 ** 2)
        c1 = torch.sum(r1 ** 2)
        # accept only if improved AND finite (a simple trust guard)
        better = torch.isfinite(c1) & (c1 < c0)
        qpos_seq = torch.where(better, qp_new, qpos_seq)
        theta = torch.where(better, th_new, theta)
        cost = torch.where(better, c1, c0)
        if it == 0:
            cost_initial = c0
    if "mass_scale" in pnames:
        ms = 1.0 + theta[pnames.index("mass_scale")]
    else:
        ms = qpos_init.new_ones(())
    return DirectResult(qpos=qpos_seq, qvel=_fd_velocities(m, qpos_seq, dt),
                        cost=cost, cost_initial=cost_initial,
                        mass_scale=ms, params=theta)
