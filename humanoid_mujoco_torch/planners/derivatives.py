"""Model and cost linearization along a nominal trajectory.

Counterpart of humanoid_mujoco_tpu/planners/derivatives.py. The
reference finite-differences mj_step per knot on a thread pool
(mjpc/planners/model_derivatives.cc:45-164) and chains the residual
Jacobians with analytic norm gradients and Hessians into Gauss-Newton
cost expansions (mjpc/planners/cost_derivatives.cc:77-230). Here:

- A, B are forward-mode derivatives of the tangent-wrapped step, with
  the implicit-function derivative of the contact solve (`ift=True`).
  The JAX package takes them with one `jacfwd` per knot, vmapped over
  the knots. Here the 2·nv + nu unit tangents ride in the batch: every
  knot is repeated once per tangent direction, and one dual-number
  `step(ift=True)` at batch T·(2·nv + nu) (816 for the humanoid's 17
  knots) gives every column of every knot's Jacobian. Rows never mix,
  so each row's tangent is its own direction's derivative.
- C, D are the residual's Jacobians in tangent coordinates, taken the
  same way through the kinematics-only StepInfo: in the same dual step
  along a nominal (its StepInfo holds the perturbed start state's
  kinematics), in a dual `_light_info` pass of their own otherwise.

This path is plain PyTorch on every device by design, not a fallback:
the JAX derivative path never enters a Pallas kernel either
(step.py:230-232; the kernels serve rollouts only, ROADMAP ground
rules). The planners' rollouts do go through the kernels.

Derivative skip (evaluate A, B every (skip+1)-th knot and interpolate
linearly between, model_derivatives.cc:53-72) is a static option.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..ops import norms
from ..physics.engine import body_com_velocities, fwd_position, fwd_velocity
from ..physics.model import Model, State
from ..physics.step import StepInfo, step
from ..physics.tangent import state_add, state_diff
from ..tasks.base import Task


@dataclasses.dataclass(frozen=True)
class Derivatives:
    A: torch.Tensor    # (T, 2nv, 2nv)
    B: torch.Tensor    # (T, 2nv, nu)
    cx: torch.Tensor   # (T, 2nv)
    cu: torch.Tensor   # (T, nu)
    cxx: torch.Tensor  # (T, 2nv, 2nv)
    cxu: torch.Tensor  # (T, 2nv, nu)
    cuu: torch.Tensor  # (T, nu, nu)


def _light_info(m: Model, state: State) -> StepInfo:
    """Kinematics-only StepInfo of a batch (no contact solve): valid for
    residuals and transitions that read positions and velocities. The
    contact, acceleration and force leaves are zeros."""
    kin = fwd_position(m, state.qpos)
    vel = fwd_velocity(m, kin, state.qvel)
    return StepInfo(
        xpos=kin.xpos, xquat=kin.xquat, xipos=kin.xipos,
        site_xpos=kin.site_xpos, com=kin.anchor, com_vel=vel.com_vel,
        body_com_vel=body_com_velocities(kin, vel),
        **_zero_leaves(m, state.qpos))


def _zero_leaves(m: Model, like: torch.Tensor) -> dict:
    """The leaves a kinematics-only StepInfo holds at zero, for the
    batch, dtype and device of `like` (B, ...)."""
    B = like.shape[0]

    def z(n):
        return like.new_zeros((B, n))
    return dict(contact_dist=z(m.ncon), contact_force=z(m.ncon),
                qacc=z(m.nv), actuator_force=z(m.nu), qfrc_total=z(m.nv),
                diverged=torch.zeros(B, dtype=torch.bool, device=like.device))


def light_from_step(m: Model, info: StepInfo) -> StepInfo:
    """`_light_info` of a step's start state, from that step's StepInfo:
    the step already computed the start state's kinematic leaves (kernel
    B1 on the card), so only the others are zeroed."""
    return dataclasses.replace(info, **_zero_leaves(m, info.qacc))


def _jacfwd(f: Callable, nk: int, n: int, dtype, device):
    """Forward-mode Jacobians of f at 0 for nk knots at once.

    f maps z (nk·n, n), whose row k·n + i belongs to knot k and carries
    the unit tangent e_i, to outputs (nk·n, ...) computed row by row.
    Returns, for each output, (primal at knot k (nk, ...), Jacobian
    (nk, ..., n))."""
    eye = torch.eye(n, dtype=dtype, device=device)
    with fwAD.dual_level():
        z = fwAD.make_dual(torch.zeros((nk * n, n), dtype=dtype,
                                       device=device), eye.repeat(nk, 1))
        outs = []
        for y in f(z):
            primal, tangent = fwAD.unpack_dual(y)
            if tangent is None:
                tangent = torch.zeros_like(primal)
            tangent = tangent.reshape((nk, n) + primal.shape[1:])
            outs.append((primal[::n].clone(),
                         torch.movedim(tangent, 1, -1).clone()))
    return outs


def _repeat(n: int, *xs):
    return [x.repeat_interleave(n, dim=0) for x in xs]


def residual_tangent(m: Model, task: Task, qpos: torch.Tensor,
                     qvel: torch.Tensor, ctrl: torch.Tensor, t: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(r (B, nres), C (B, nres, 2nv), D (B, nres, nu)): the residual at
    each state and its Jacobians with respect to (dx, du)."""
    nv, nu = m.nv, m.nu
    n = 2 * nv + nu

    def f(z):
        qp, qv, u, tt = _repeat(n, qpos, qvel, ctrl, t)
        st = State(qpos=state_add(m, qp, z[:, :nv]),
                   qvel=qv + z[:, nv:2 * nv], time=tt)
        return (task.residual(m, st, _light_info(m, st), u + z[:, 2 * nv:]),)

    [(r, J)] = _jacfwd(f, qpos.shape[0], n, qpos.dtype, qpos.device)
    return r, J[..., :2 * nv], J[..., 2 * nv:]


def step_tangent_jacobians(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                           ctrl: torch.Tensor, t: torch.Tensor,
                           next_qpos: torch.Tensor, next_qvel: torch.Tensor,
                           solver_iters: int = 8, ift: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A = d x'/dx (B, 2nv, 2nv) and B = d x'/du (B, 2nv, nu) in tangent
    coordinates at each of a batch of knots, x' measured from
    (next_qpos, next_qvel): the mjd_transitionFD replacement.

    `ift=True` (the default) takes the contact solve's implicit-function
    sensitivity at its converged active set (solver.newton_solve)."""
    return _linearize(m, None, qpos, qvel, ctrl, t, next_qpos, next_qvel,
                      solver_iters, ift)[:2]


def _linearize(m, task, qpos, qvel, ctrl, t, next_qpos, next_qvel,
               solver_iters, ift):
    """(A, B) of `step_tangent_jacobians`, and with a `task` also
    (r, C, D) of `residual_tangent`, from one dual-number step: the
    step's own StepInfo holds the perturbed start state's kinematics,
    which are all `_light_info` reads."""
    nv = m.nv
    n = 2 * nv + m.nu

    def f(z):
        qp, qv, u, tt, qp2, qv2 = _repeat(n, qpos, qvel, ctrl, t, next_qpos,
                                          next_qvel)
        st = State(qpos=state_add(m, qp, z[:, :nv]),
                   qvel=qv + z[:, nv:2 * nv], time=tt)
        u = u + z[:, 2 * nv:]
        s2, info = step(m, st, u, solver_iters=solver_iters, ift=ift)
        dx = state_diff(m, s2.qpos, s2.qvel, qp2, qv2)
        if task is None:
            return (dx,)
        return dx, task.residual(m, st, light_from_step(m, info), u)

    outs = _jacfwd(f, qpos.shape[0], n, qpos.dtype, qpos.device)
    J = outs[0][1]
    AB = [J[..., :2 * nv], J[..., 2 * nv:]]
    if task is None:
        return AB
    r, Jr = outs[1]
    return AB + [r, Jr[..., :2 * nv], Jr[..., 2 * nv:]]


def gauss_newton_cost(task: Task, r: torch.Tensor, C: torch.Tensor,
                      D: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(cx, cu, cxx, cxu, cuu), batch-leading, from the residual r
    (B, nres) and its Jacobians C (B, nres, nx), D (B, nres, nu) through
    each term's norm gradient and Hessian (cost_derivatives.cc:77-110)."""
    B, nx, nu = C.shape[0], C.shape[2], D.shape[2]
    cx, cu = r.new_zeros((B, nx)), r.new_zeros((B, nu))
    cxx, cxu = r.new_zeros((B, nx, nx)), r.new_zeros((B, nx, nu))
    cuu = r.new_zeros((B, nu, nu))
    off = 0
    for k, term in enumerate(task.terms):
        d = term.dim
        rs, Cs, Ds = r[:, off:off + d], C[:, off:off + d], D[:, off:off + d]
        off += d
        _, g, H = norms.norm_hess(rs, term.norm, task.norm_params[k, 0],
                                  task.norm_params[k, 1])
        w = task.weights[k]
        CsT, DsT = Cs.transpose(-1, -2), Ds.transpose(-1, -2)
        cx = cx + w * (CsT @ g[..., None])[..., 0]
        cu = cu + w * (DsT @ g[..., None])[..., 0]
        HC, HD = H @ Cs, H @ Ds
        cxx = cxx + w * (CsT @ HC)
        cxu = cxu + w * (CsT @ HD)
        cuu = cuu + w * (DsT @ HD)
    return cx, cu, cxx, cxu, cuu


def trajectory_derivatives(m: Model, task: Task, qpos_nom: torch.Tensor,
                           qvel_nom: torch.Tensor, ctrl_nom: torch.Tensor,
                           times: torch.Tensor, solver_iters: int = 8,
                           skip: int = 0, ift: bool = True) -> Derivatives:
    """The linearization along a nominal, the knots as the batch.

    qpos_nom (T+1, nq), qvel_nom (T+1, nv), ctrl_nom (T, nu), times
    (T+1,). With skip > 0, A and B are evaluated every (skip+1)-th knot
    and linearly interpolated between (model_derivatives.cc:53-72)."""
    T = ctrl_nom.shape[0]
    if skip <= 0:
        # one dual step gives the dynamics and the residual Jacobians
        A, B, r, C, D = _linearize(
            m, task, qpos_nom[:-1], qvel_nom[:-1], ctrl_nom, times[:-1],
            qpos_nom[1:], qvel_nom[1:], solver_iters, ift)
    else:
        stride = skip + 1
        idx = np.arange(0, T, stride)
        Ae, Be = step_tangent_jacobians(
            m, qpos_nom[idx], qvel_nom[idx], ctrl_nom[idx], times[idx],
            qpos_nom[idx + 1], qvel_nom[idx + 1], solver_iters=solver_iters,
            ift=ift)
        tt = np.arange(T) / stride
        lo = np.clip(np.floor(tt).astype(np.int64), 0, len(idx) - 1)
        hi = np.clip(lo + 1, 0, len(idx) - 1)
        frac = torch.as_tensor(tt - lo, dtype=Ae.dtype,
                               device=Ae.device)[:, None, None]
        A = Ae[lo] * (1 - frac) + Ae[hi] * frac
        B = Be[lo] * (1 - frac) + Be[hi] * frac
        r, C, D = residual_tangent(m, task, qpos_nom[:-1], qvel_nom[:-1],
                                   ctrl_nom, times[:-1])
    cx, cu, cxx, cxu, cuu = gauss_newton_cost(task, r, C, D)
    return Derivatives(A=A, B=B, cx=cx, cu=cu, cxx=cxx, cxu=cxu, cuu=cuu)
