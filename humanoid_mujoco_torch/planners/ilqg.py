"""iLQG: the planner the reference's stand task selects (agent_planner=2,
tasks/humanoid_cap/stand/task.xml:9).

Counterpart of humanoid_mujoco_tpu/planners/ilqg.py (a rebuild of
mjpc/planners/ilqg/{planner,backward_pass,policy}.cc). One iteration:

1. the nominal: the current policy rolled from the fresh state at four
   feedback scales (0, 0.1, 0.37, 1), the best return winning
   (NominalTrajectory + FeedbackRollouts, ilqg/planner.cc:167-219);
2. the linearization along it (planners/derivatives.py: forward-mode
   Jacobians through `step(ift=True)`, plain PyTorch by design);
3. the Riccati backward pass with the control-limit boxQP (a loop over
   the knots, backward_pass.cc:65-250);
4. the line search: eight log-spaced step sizes rolled out at once
   (planner.cc:618-680);
5. acceptance and the regularization ladder driven by the actual over
   the expected improvement (planner.cc:551-604).

The rollouts of steps 1 and 4 are batched calls of the ordinary `step`
(batch 4 and batch 8, T steps each), so on the card they run through
kernels B1 and B2. The product is a feedback policy u(t, x) = u_nom(t)
+ K(t)(x ⊖ x_nom(t)) (ilqg/policy.cc:82-161, with the quaternion-aware
state difference): it holds the humanoid's balance where zero-order
sampling cannot. Every choice (best index, acceptance, the new
regularization) stays on the device; nothing here reads a tensor on
the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import boxqp, linalg
from ..ops.linalg import mv
from ..physics.model import Model, State
from ..physics.step import step
from ..physics.tangent import state_diff
from ..rollout import MAX_RETURN
from ..tasks.base import Task, cost_value
from .derivatives import light_from_step, trajectory_derivatives
from .tangent_interp import interp_nominal_state
from .terminal import TerminalCost, terminal_gradient, terminal_value


@dataclasses.dataclass(frozen=True)
class ILQGConfig:
    horizon: int = 17
    n_linesearch: int = 8
    # contact Newton iterations of the plan rollouts: the same as the
    # sim's (step's default 8), or plan and sim solve different contact
    # problems (the reference's round-1 closed-loop wobble)
    solver_iters: int = 8
    deriv_solver_iters: int = 8
    # implicit-function derivatives through the contact solve
    ift: bool = True
    skip: int = 0
    # the control-limit boxQP in the backward pass (on, as the
    # reference's action_limits) and the regularization scheme
    limits: bool = True
    reg_type: int = 0
    boxqp_iters: int = 8
    reg_initial: float = 1e-2
    reg_min: float = 1e-6
    reg_max: float = 1e4


@dataclasses.dataclass(frozen=True)
class ILQGPolicy:
    """A feedback policy along a nominal trajectory."""

    times: torch.Tensor      # (T+1,)
    qpos_nom: torch.Tensor   # (T+1, nq)
    qvel_nom: torch.Tensor   # (T+1, nv)
    u_nom: torch.Tensor      # (T, nu)
    K: torch.Tensor          # (T, nu, 2nv) feedback gains
    k_scale: torch.Tensor    # () the nominal search's feedback scaling

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ILQGState:
    """The planner state carried across iterations."""

    policy: ILQGPolicy
    reg: torch.Tensor        # () current regularization


@dataclasses.dataclass(frozen=True)
class ILQGInfo:
    best_return: torch.Tensor
    nominal_return: torch.Tensor
    improvement: torch.Tensor
    expected: torch.Tensor
    reg: torch.Tensor
    alpha: torch.Tensor


def ilqg_init(m: Model, cfg: ILQGConfig, state: State) -> ILQGState:
    """The zero policy with zero gains, anchored at one state (batch 1)."""
    dtype, dev = state.qpos.dtype, state.qpos.device
    T = cfg.horizon
    times = state.time[0] + m.dt * torch.arange(T + 1, dtype=dtype,
                                                device=dev)
    return ILQGState(
        policy=ILQGPolicy(
            times=times, qpos_nom=state.qpos[0].expand(T + 1, -1).clone(),
            qvel_nom=state.qvel[0].expand(T + 1, -1).clone(),
            u_nom=torch.zeros((T, m.nu), dtype=dtype, device=dev),
            K=torch.zeros((T, m.nu, 2 * m.nv), dtype=dtype, device=dev),
            k_scale=torch.tensor(1.0, dtype=dtype, device=dev)),
        reg=torch.tensor(cfg.reg_initial, dtype=dtype, device=dev))


def ilqg_state_from_numpy(times, qpos_nom, qvel_nom, u_nom, K, k_scale, reg,
                          dtype=torch.float32, device=None) -> ILQGState:
    """An ILQGState from the JAX policy's leaves as numpy arrays, so that
    both packages can start from one policy."""
    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)
    return ILQGState(policy=ILQGPolicy(
        times=t(times), qpos_nom=t(qpos_nom), qvel_nom=t(qvel_nom),
        u_nom=t(u_nom), K=t(K), k_scale=t(k_scale)), reg=t(reg))



def _clamp_ctrl(m: Model, u: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.maximum(u, m.act_ctrlrange[:, 0]),
                         m.act_ctrlrange[:, 1])


def ilqg_action(m: Model, policy: ILQGPolicy, qpos: torch.Tensor,
                qvel: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """u = interp(u_nom)(t) + k_scale K(t) (x ⊖ interp(x_nom)(t)), clamped,
    for a batch of states (B, ...) at times t (B,) -> (B, nu).

    u_nom, x_nom and K are interpolated linearly in time, as the
    reference's iLQGPolicy::Action (ilqg/policy.cc:82-161): a zero-order
    hold would make the feedback fight the nominal's own motion between
    knots. x_nom moves along the tangent-space geodesic."""
    T = policy.u_nom.shape[0]
    idx = torch.clamp(torch.searchsorted(policy.times, t, right=True) - 1,
                      0, T - 1)
    nxt = torch.clamp(idx + 1, max=T)
    t_lo, t_hi = policy.times[idx], policy.times[nxt]
    frac = torch.clamp((t - t_lo) / torch.clamp(t_hi - t_lo, min=1e-9),
                       0.0, 1.0)[:, None]
    hi = torch.clamp(idx + 1, max=T - 1)
    u_t = policy.u_nom[idx] * (1 - frac) + policy.u_nom[hi] * frac
    K_t = (policy.K[idx] * (1 - frac[..., None])
           + policy.K[hi] * frac[..., None])
    qpos_t, qvel_t = interp_nominal_state(
        m, policy.qpos_nom[idx], policy.qvel_nom[idx], policy.qpos_nom[nxt],
        policy.qvel_nom[nxt], frac)
    dx = state_diff(m, qpos, qvel, qpos_t, qvel_t)
    return _clamp_ctrl(m, u_t + policy.k_scale * mv(K_t, dx))


def _feedback_rollout(m: Model, task: Task, s0: State, policy: ILQGPolicy,
                      du: torch.Tensor, alpha: torch.Tensor,
                      solver_iters: int, k_scale=1.0,
                      terminal: Optional[TerminalCost] = None):
    """Roll u_t = clamp(u_nom_t + alpha du_t + k_scale K_t (x ⊖ x_nom_t))
    from one state (batch 1) for each of a batch of alphas (N,) (and
    feedback scales, (N,) or one float), all N in one batch through
    `step` (ActionRollouts, ilqg/planner.cc:618-680).

    Returns (total_return (N,), qpos (N, T+1, nq), qvel (N, T+1, nv),
    u (N, T, nu)). The policy is looked up by time, not by position:
    after a plan-act cycle the state's clock has moved on, and the
    half-step offset keeps the accumulated rollout clock from landing an
    ulp below a knot. du is indexed by step on the new timeline."""
    T = policy.u_nom.shape[0]
    N = alpha.shape[0]
    if not torch.is_tensor(k_scale):
        k_scale = torch.full_like(alpha, k_scale)
    s = State(qpos=s0.qpos.expand(N, -1), qvel=s0.qvel.expand(N, -1),
              time=s0.time.expand(N))
    qps, qvs, us, costs, divs = [], [], [], [], []
    for i in range(T):
        j = torch.clamp(torch.searchsorted(
            policy.times, s.time + 0.5 * m.dt, right=True) - 1, 0, T - 1)
        dx = state_diff(m, s.qpos, s.qvel, policy.qpos_nom[j],
                        policy.qvel_nom[j])
        u = _clamp_ctrl(m, policy.u_nom[j] + alpha[:, None] * du[i]
                        + k_scale[:, None] * mv(policy.K[j], dx))
        s2, info = step(m, s, u, solver_iters=solver_iters)
        res = task.residual(m, s, light_from_step(m, info), u)
        qps.append(s.qpos)
        qvs.append(s.qvel)
        us.append(u)
        costs.append(cost_value(task, res))
        divs.append(info.diverged)
        s = s2
    total = torch.stack(costs, dim=1).sum(dim=1)
    if terminal is not None:
        total = total + terminal_value(m, terminal, s.qpos, s.qvel)
    total = total / max(T, 1)
    bad = torch.stack(divs, dim=1).any(dim=1) | ~torch.isfinite(total)
    total = torch.where(bad, torch.full_like(total, MAX_RETURN), total)
    return (total, torch.stack(qps + [s.qpos], dim=1),
            torch.stack(qvs + [s.qvel], dim=1), torch.stack(us, dim=1))


# regularization schemes (ilqg/backward_pass.h:28-32, settings.h:27)
REG_CONTROL = 0        # Quu += reg I
REG_STATE_CONTROL = 1  # Quu += reg BᵀB, Qux += reg BᵀA ("feedback")
REG_VALUE = 2          # Vxx += reg I inside the Q expansion
REG_NONE = 3


def backward_pass(derivs, reg: torch.Tensor,
                  u_nom: Optional[torch.Tensor] = None,
                  ctrlrange: Optional[torch.Tensor] = None,
                  reg_type: int = REG_CONTROL, boxqp_iters: int = 8,
                  terminal_init=None):
    """The Riccati recursion, a loop from the last knot to the first
    (backward_pass.cc:65-250). Returns (du (T, nu), K (T, nu, 2nv),
    dV (2,)).

    With `u_nom` and `ctrlrange`, each knot solves the control-limit
    boxQP (mju_boxQP via backward_pass.cc:158-196): du keeps to the box
    [lo - u_nom_t, hi - u_nom_t], the feedback rows of saturated
    actuators are zero, and the next knot's du warm-starts the active
    set."""
    T, nx = derivs.cx.shape
    nu = derivs.cu.shape[1]
    dtype, dev = derivs.cx.dtype, derivs.cx.device
    limits = u_nom is not None and ctrlrange is not None
    if limits:
        lo_t = ctrlrange[None, :, 0] - u_nom
        hi_t = ctrlrange[None, :, 1] - u_nom
    eye_x = torch.eye(nx, dtype=dtype, device=dev)
    eye_u = torch.eye(nu, dtype=dtype, device=dev)
    if terminal_init is not None:
        Vx, Vxx = (x.to(dtype) for x in terminal_init)
    else:
        Vx = torch.zeros(nx, dtype=dtype, device=dev)
        Vxx = torch.zeros((nx, nx), dtype=dtype, device=dev)
    dV = torch.zeros(2, dtype=dtype, device=dev)
    du_prev = torch.zeros(nu, dtype=dtype, device=dev)
    dus, Ks = [None] * T, [None] * T
    for t in reversed(range(T)):
        A, B = derivs.A[t], derivs.B[t]
        cxu_T = derivs.cxu[t].T
        Qx = derivs.cx[t] + A.T @ Vx
        Qu = derivs.cu[t] + B.T @ Vx
        VxxA = Vxx @ A
        Qxx = derivs.cxx[t] + A.T @ VxxA
        Qux = cxu_T + B.T @ VxxA
        Quu = derivs.cuu[t] + B.T @ (Vxx @ B)
        if reg_type == REG_VALUE:
            Vxx_reg = Vxx + reg * eye_x
            Qux_reg = cxu_T + B.T @ (Vxx_reg @ A)
            Quu_reg = derivs.cuu[t] + B.T @ (Vxx_reg @ B)
        elif reg_type == REG_STATE_CONTROL:
            Qux_reg = Qux + reg * (B.T @ A)
            Quu_reg = Quu + reg * (B.T @ B)
        elif reg_type == REG_NONE:
            Qux_reg, Quu_reg = Qux, Quu
        else:  # REG_CONTROL
            Qux_reg, Quu_reg = Qux, Quu + reg * eye_u
        if limits:
            lo, hi = lo_t[t], hi_t[t]
            res = boxqp.box_qp(Quu_reg, Qu, lo, hi,
                               x0=torch.minimum(torch.maximum(du_prev, lo),
                                                hi),
                               iters=boxqp_iters)
            du = res.x
            K = -boxqp.free_solve(res, Qux_reg)
        else:
            L = linalg.chol_factor(Quu_reg)
            du = -linalg.chol_solve(L, Qu)
            K = -linalg.chol_solve(L, Qux_reg)
        # the value update takes the unregularized Quu and Qux with the
        # clamped du and the limit-aware K (backward_pass.cc:219-249)
        Vx = Qx + K.T @ (Quu @ du + Qu) + Qux.T @ du
        Vxx = linalg.symmetrize(Qxx + K.T @ (Quu @ K + Qux) + Qux.T @ K)
        dV = dV + torch.stack([Qu @ du, 0.5 * du @ (Quu @ du)])
        du_prev = du
        dus[t], Ks[t] = du, K
    return torch.stack(dus), torch.stack(Ks), dV


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without reading it on the host."""
    return x.index_select(0, i.reshape(1))[0]


def ilqg_plan(m: Model, task: Task, cfg: ILQGConfig, pstate: ILQGState,
              state: State, terminal: Optional[TerminalCost] = None
              ) -> Tuple[ILQGState, ILQGInfo]:
    """One OptimizePolicy iteration from one state (batch 1)
    (ilqg/planner.cc:156-164, 377-615). `terminal` (optional) adds the
    LQR cost-to-go at the horizon's end, in the rollout returns and as
    the backward pass's initial value."""
    if state.batch != 1:
        raise ValueError("ilqg_plan plans from one state (batch 1)")
    dtype, dev = state.qpos.dtype, state.qpos.device
    T = cfg.horizon
    old = pstate.policy

    # 1. the nominal: the current policy at four feedback scales, from
    #    open loop to full gains, so that stiff gains computed before the
    #    state moved cannot poison it
    zero_du = torch.zeros((T, m.nu), dtype=dtype, device=dev)
    k_scales = torch.tensor([0.0, 0.1, 0.37, 1.0], dtype=dtype, device=dev)
    nrets, nqp, nqv, nus = _feedback_rollout(
        m, task, state, old, zero_du, torch.zeros_like(k_scales),
        cfg.solver_iters, k_scale=k_scales, terminal=terminal)
    nbest = torch.argmin(nrets)
    nom_return, qp, qv, u = (_pick(x, nbest) for x in (nrets, nqp, nqv, nus))
    times = state.time[0] + m.dt * torch.arange(T + 1, dtype=dtype,
                                                device=dev)
    nominal = ILQGPolicy(times=times, qpos_nom=qp, qvel_nom=qv, u_nom=u,
                         K=old.K, k_scale=_pick(k_scales, nbest))

    # 2. the linearization along the nominal
    derivs = trajectory_derivatives(
        m, task, qp, qv, u, times, solver_iters=cfg.deriv_solver_iters,
        skip=cfg.skip, ift=cfg.ift)

    # 3. the backward pass (its terminal value from the DARE if given)
    tinit = None
    if terminal is not None:
        Vx, Vxx = terminal_gradient(m, terminal, qp[-1:], qv[-1:])
        tinit = (Vx[0], Vxx)
    du, K, dV = backward_pass(
        derivs, pstate.reg, u_nom=u if cfg.limits else None,
        ctrlrange=m.act_ctrlrange if cfg.limits else None,
        reg_type=cfg.reg_type, boxqp_iters=cfg.boxqp_iters,
        terminal_init=tinit)
    nominal = nominal.replace(K=K)

    # 4. the line search over log-spaced step sizes, one batch
    alphas = torch.as_tensor(np.logspace(0.0, -3.0, cfg.n_linesearch),
                             dtype=dtype, device=dev)
    returns, qps, qvs, us = _feedback_rollout(
        m, task, state, nominal, du, alphas, cfg.solver_iters,
        terminal=terminal)
    best = torch.argmin(returns)
    best_return, alpha = _pick(returns, best), _pick(alphas, best)

    # 5. acceptance and regularization, as the reference
    # (ilqg/planner.cc:551-604, backward_pass.cc UpdateRegularization):
    # the best line-search rollout always becomes the new nominal; only
    # non-finite gains or all rollouts diverged keep the old policy
    finite = torch.isfinite(du).all() & torch.isfinite(K).all()
    accept = finite & (best_return < MAX_RETURN)
    K_new = torch.where(finite, K, old.K)
    # the returns are normalized by the horizon, dV is summed over it
    expected = (-(alpha * dV[0] + alpha ** 2 * dV[1])) / T + 1e-16
    improvement = nom_return - best_return
    # the surprise z: reg halves on good agreement or a large step,
    # doubles on poor agreement or a tiny one, quadruples on failure;
    # a converged model (negligible expected improvement) decays reg so
    # that the gains approach the unregularized LQR gains
    z = torch.clamp(improvement / expected, 0.0, 2.0)
    good = (z > 0.5) | (alpha > 0.3)
    bad_step = (z < 0.1) | (alpha < 0.06)
    converged = expected < 1e-4 * (1.0 + torch.abs(nom_return))
    one = torch.ones_like(pstate.reg)
    factor = torch.where(~accept, 4.0 * one, torch.where(
        converged | good, 0.5 * one, torch.where(bad_step, 2.0 * one, one)))
    reg = torch.clamp(pstate.reg * factor, cfg.reg_min, cfg.reg_max)
    new_policy = ILQGPolicy(
        times=times,
        qpos_nom=torch.where(accept, _pick(qps, best), qp),
        qvel_nom=torch.where(accept, _pick(qvs, best), qv),
        u_nom=torch.where(accept, _pick(us, best), u),
        K=K_new,
        # the accepted policy carries full feedback (planner.cc:604)
        k_scale=torch.where(accept, one, nominal.k_scale))
    info = ILQGInfo(best_return=torch.where(accept, best_return, nom_return),
                    nominal_return=nom_return, improvement=improvement,
                    expected=expected, reg=reg, alpha=alpha)
    return ILQGState(policy=new_policy, reg=reg), info
