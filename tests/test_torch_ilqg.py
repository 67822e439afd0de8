"""Port parity: the iLQG slice against the JAX package.

Float64 on the CPU (the JAX side runs with x64), the same numpy-seeded
inputs through both packages; tolerances are max-abs error over max-abs
value:

- `physics.tangent`: `state_add`, `qpos_diff` and `state_diff` on the
  humanoid at 1e-12, and the add/diff round trips of
  tests/test_ilqg.py:59-77 at 1e-12;
- `norm_grad` and `norm_hess` for every NormType at 1e-10;
- `box_qp` and `free_solve` on random SPD problems at 1e-9, and
  `box_qp` against the KKT active-set enumeration of
  tests/test_ilqg.py:277 (25 problems, 1e-7);
- `backward_pass` for the four regularization schemes, with and
  without the control limits, at 1e-9 on the same Derivatives, and
  against the numpy Riccati recursion of tests/test_ilqg.py:153 (1e-9);
- `newton_solve`, `forward` and `step` with `ift=True`: the primal
  equals `ift=False` at 1e-9 (the step at the stand pose and a noisy
  one, where every loaded slot is among the 32 smallest gaps, since
  `step(ift=False)` is selection-free and `forward` keeps 32 slots);
- `step_tangent_jacobians` (`ift=True`) at the stand pose, both feet in
  contact, plan dt 0.02: against JAX's `jacfwd` at 1e-7 of the largest
  entry, and against central differences of the converged step (30
  solver iterations) at tests/test_ilqg.py:104-150's 5e-4: its sampled
  columns at its eps 1e-6, and every column at 1e-7;
- `residual_tangent` and `gauss_newton_cost` at 1e-9 and
  `trajectory_derivatives` with skip 0 and skip 2 (A, B at 1e-7; the
  cost leaves at 1e-9) along a 4-knot nominal of states near the stand
  pose;
- two `ilqg_plan` iterations from `ilqg_init` on the stand task at
  horizon 4 with 4 line-search alphas: u_nom, K, reg, the nominal and
  the returns at 1e-6. The JAX rollouts take the 32 smallest gaps, the
  port's are selection-free, so every step of the port's rollouts is
  checked first: each loaded slot is among the 32 smallest gaps;
- the JAX package's own pendulum oracles (tests/test_ilqg.py:199-262)
  on the port's one-hinge pendulum without contacts or rows (the step's
  solver-free route), with their thresholds: after 12 iterations the
  cost is below 0.25 of the zero-policy nominal, the best return is
  near-monotone and the final angle within 0.5 of π; after 8, the
  gains are zero on the saturated knots, the swing-up starts
  saturated, and a perturbed state gets a corrective action at the
  strongest free knot;
- `ilqg_action` on perturbed states and times, and the Agent's
  `get_action` (at the state's time, at a given time, with
  `nominal_action=True`, averaged over 3 sim steps), `step` and
  `best_trajectory` with the JAX plan's policy in both agents, at 1e-9.

The JAX references of the last three groups (jit compiles of the
derivative path and of the plan) are built in processes of their own
by tests/test_torch_port.py; `run_checks` builds them in this process.
"""

import dataclasses
import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu.agent import Agent as JAgent
from humanoid_mujoco_tpu.mpc import make_plan_model as j_plan_model
from humanoid_mujoco_tpu.ops import boxqp as jboxqp
from humanoid_mujoco_tpu.ops import norms as jnorms
from humanoid_mujoco_tpu.physics import humanoid as jh
from humanoid_mujoco_tpu.physics import tangent as jtan
from humanoid_mujoco_tpu.physics.model import State as JState
from humanoid_mujoco_tpu.planners import derivatives as jder
from humanoid_mujoco_tpu.planners import ilqg as jilqg
from humanoid_mujoco_tpu.tasks import stand_task as j_stand_task

from humanoid_mujoco_torch import mpc
from humanoid_mujoco_torch.agent import Agent
from humanoid_mujoco_torch.mpc import make_plan_model
from humanoid_mujoco_torch.ops import boxqp, norms
from humanoid_mujoco_torch.physics import humanoid as th
from humanoid_mujoco_torch.physics import tangent
from humanoid_mujoco_torch.ops.norms import NormType
from humanoid_mujoco_torch.physics.model import (ActuatorType, JointType,
                                                 ModelBuilder, State,
                                                 make_state)
from humanoid_mujoco_torch.physics.solver import finish_efc, newton_solve
from humanoid_mujoco_torch.physics.step import forward, step
from humanoid_mujoco_torch.planners import derivatives as tder
from humanoid_mujoco_torch.planners import ilqg as tilqg
from humanoid_mujoco_torch.tasks import stand_task
from humanoid_mujoco_torch.tasks.base import TermSpec, make_task

import test_torch_refs as refs
import test_torch_rl as trl

torch.set_num_threads(1)
# tests/conftest.py sets this too; the references run in processes of
# their own, which do not import conftest
jax.config.update("jax_enable_x64", True)

F64 = torch.float64
PLAN_DT, H, NLS, ITERS = 0.02, 4, 4, 2
rel, t64, tree_np = trl.rel, trl.t64, trl.tree_np


@functools.lru_cache(maxsize=None)
def jm64():
    return jh.build_humanoid(dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def tm64():
    return th.build_humanoid(dtype=F64, device="cpu")


def inputs():
    """The numpy-seeded inputs every reference and check shares."""
    rng = np.random.default_rng(8)
    q0 = np.asarray(jh.stand_qpos(jm64()))
    q = np.tile(q0, (3, 1))
    q[1:, 7:] += 0.02 * rng.standard_normal((2, 12))
    q[2, 3:7] += 0.05 * rng.standard_normal(4)     # not a unit quaternion
    dq = rng.uniform(-0.1, 0.1, (3, 18))
    v = 0.1 * rng.standard_normal((3, 18))
    plan_q = q0.copy()
    plan_q[7:] += 0.01 * rng.standard_normal(12)
    plan_v = 0.05 * rng.standard_normal(18)
    nom_q = np.tile(plan_q, (H + 1, 1))
    nom_q[:, 7:] += 0.01 * rng.standard_normal((H + 1, 12))
    nom_v = plan_v + 0.05 * rng.standard_normal((H + 1, 18))
    nom_u = 0.1 * rng.standard_normal((H, 12))
    probe_q = np.tile(plan_q, (3, 1))
    probe_q[:, 7:] += 0.01 * rng.standard_normal((3, 12))
    probe_v = plan_v + 0.05 * rng.standard_normal((3, 18))
    probe_t = np.array([0.0, 0.013, 0.05])
    return dict(q0=q0, q=q, dq=dq, v=v, plan_q=plan_q, plan_v=plan_v,
                nom_q=nom_q, nom_v=nom_v, nom_u=nom_u,
                nom_t=PLAN_DT * np.arange(H + 1), probe_q=probe_q,
                probe_v=probe_v, probe_t=probe_t)


def ops_inputs():
    """Norm arguments, box QPs and linear-quadratic problems."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((5, 4))
    qps = []
    for n in (3, 5, 12):
        M = rng.standard_normal((n, n))
        Hq = M @ M.T + 0.5 * np.eye(n)
        qps.append(dict(H=Hq, g=2.0 * rng.standard_normal(n),
                        lo=-np.abs(rng.standard_normal(n)) * 0.5,
                        hi=np.abs(rng.standard_normal(n)) * 0.5,
                        x0=0.3 * rng.standard_normal(n),
                        rhs=rng.standard_normal((n, 7))))
    T, nx, nu = 6, 4, 3
    d = dict(A=np.stack([np.eye(nx) + 0.05 * rng.standard_normal((nx, nx))
                         for _ in range(T)]),
             B=0.3 * rng.standard_normal((T, nx, nu)),
             cx=0.5 * rng.standard_normal((T, nx)),
             cu=2.0 * rng.standard_normal((T, nu)),
             cxu=0.05 * rng.standard_normal((T, nx, nu)))
    Q = rng.standard_normal((T, nx, nx))
    d["cxx"] = Q @ Q.transpose(0, 2, 1) * 0.1 + 0.5 * np.eye(nx)
    d["cuu"] = np.tile(0.2 * np.eye(nu), (T, 1, 1))
    u_nom = 0.5 * rng.standard_normal((T, nu))
    ctrlrange = np.stack([-np.ones(nu), np.ones(nu)], axis=1)
    return dict(x=x, qps=qps, derivs=d, u_nom=u_nom, ctrlrange=ctrlrange,
                reg=0.05)


NORM_PARAMS = {jnorms.NormType.NULL: (0.0, 0.0),
               jnorms.NormType.QUADRATIC: (0.0, 0.0),
               jnorms.NormType.L22: (0.3, 4.0),
               jnorms.NormType.L2: (0.2, 0.0),
               jnorms.NormType.COSH: (0.3, 0.0),
               jnorms.NormType.POWER_LOSS: (1.5, 0.0),
               jnorms.NormType.SMOOTH_ABS: (0.1, 0.0),
               jnorms.NormType.SMOOTH_ABS2: (0.2, 3.0),
               jnorms.NormType.RECTIFY: (0.5, 0.0)}
BACKWARD_CASES = [(reg_type, limits) for reg_type in range(4)
                  for limits in (False, True)]


# ---------------------------------------------------------------------------
# JAX references
# ---------------------------------------------------------------------------

def _jax_ops():
    """Tangent maps, norms, box QPs and backward passes (eager, small)."""
    jm, x, o = jm64(), inputs(), ops_inputs()
    q1 = [jtan.state_add(jm, jnp.asarray(q), jnp.asarray(d))
          for q, d in zip(x["q"], x["dq"])]
    out = dict(
        state_add=np.stack([np.asarray(a) for a in q1]),
        qpos_diff=np.stack([np.asarray(jtan.qpos_diff(jm, a, jnp.asarray(q)))
                            for a, q in zip(q1, x["q"])]),
        state_diff=np.stack([np.asarray(jtan.state_diff(
            jm, a, jnp.asarray(v), jnp.asarray(q), jnp.asarray(0.5 * v)))
            for a, q, v in zip(q1, x["q"], x["v"])]))
    out["norms"] = {}
    for t, (p, q) in NORM_PARAMS.items():
        y, g, Hn = jnorms.norm_hess(jnp.asarray(o["x"]), t, p, q)
        y2, g2 = jnorms.norm_grad(jnp.asarray(o["x"]), t, p, q)
        out["norms"][int(t)] = [np.asarray(a) for a in (y, g, Hn, y2, g2)]
    out["qps"] = []
    for qp in o["qps"]:
        res = jboxqp.box_qp(*(jnp.asarray(qp[k]) for k in
                              ("H", "g", "lo", "hi")),
                            x0=jnp.asarray(qp["x0"]), iters=8)
        out["qps"].append(dict(
            res=[np.asarray(a) for a in res],
            free_solve=np.asarray(jboxqp.free_solve(res,
                                                    jnp.asarray(qp["rhs"])))))
    derivs = jder.Derivatives(**{k: jnp.asarray(v)
                                 for k, v in o["derivs"].items()})
    out["backward"] = []
    for reg_type, limits in BACKWARD_CASES:
        kw = (dict(u_nom=jnp.asarray(o["u_nom"]),
                   ctrlrange=jnp.asarray(o["ctrlrange"])) if limits else {})
        out["backward"].append([np.asarray(a) for a in jilqg.backward_pass(
            derivs, jnp.asarray(o["reg"]), reg_type=reg_type, **kw)])
    return out


def stand_next_state():
    """The port's converged step (30 solver iterations) from the stand
    pose at rest under zero control, on the plan model: the state the
    Jacobians at the stand pose measure from."""
    pm = make_plan_model(tm64(), PLAN_DT)
    s0 = make_state(pm, qpos=th.stand_qpos(pm))
    s1, _ = step(pm, s0, torch.zeros((1, pm.nu), dtype=F64), solver_iters=30)
    return s1.qpos[0].numpy(), s1.qvel[0].numpy()


def _jax_derivs():
    """The Jacobians at the stand pose, the residual and Gauss-Newton
    expansions at one knot, and the linearization along a 4-knot
    nominal (states near the stand pose) with skip 0 and 2."""
    jm = j_plan_model(jm64(), PLAN_DT)
    task = j_stand_task(dtype=jnp.float64)
    x = inputs()
    q1, v1 = stand_next_state()
    A, B = jax.jit(lambda: jder.step_tangent_jacobians(
        jm, jnp.asarray(x["q0"]), jnp.zeros(jm.nv), jnp.zeros(jm.nu),
        jnp.asarray(0.0), jnp.asarray(q1), jnp.asarray(v1),
        solver_iters=12, ift=True))()

    def cost():
        r, C, D = jder.residual_tangent(
            jm, task, *(jnp.asarray(x[k][1]) for k in
                        ("nom_q", "nom_v", "nom_u", "nom_t")))
        return (r, C, D), jder.gauss_newton_cost(task, r, C, D)
    res, gn = jax.jit(cost)()
    out = dict(A=np.asarray(A), B=np.asarray(B),
               residual=[np.asarray(a) for a in res],
               gauss_newton=[np.asarray(a) for a in gn])
    for skip in (0, 2):
        d = jax.jit(lambda: jder.trajectory_derivatives(
            jm, task, *(jnp.asarray(x[k]) for k in
                        ("nom_q", "nom_v", "nom_u", "nom_t")),
            skip=skip))()
        out[f"skip{skip}"] = tree_np(d)
    return out


def _jax_plan():
    """Two ilqg_plan iterations from ilqg_init, then ilqg_action on the
    probes, and a JAX Agent holding the plan's policy."""
    jm = jm64()
    pm = j_plan_model(jm, PLAN_DT)
    task = j_stand_task(dtype=jnp.float64)
    x = inputs()
    cfg = jilqg.ILQGConfig(horizon=H, n_linesearch=NLS)
    s0 = JState(jnp.asarray(x["plan_q"]), jnp.asarray(x["plan_v"]),
                jnp.asarray(0.0))
    ps = jilqg.ilqg_init(pm, cfg, s0)
    plan = jax.jit(lambda ps, s: jilqg.ilqg_plan(pm, task, cfg, ps, s))
    iters = []
    for _ in range(ITERS):
        ps, info = plan(ps, s0)
        iters.append(dict(state=tree_np(ps), info=tree_np(info)))
    act = jax.jit(lambda pol, q, v, t: jilqg.ilqg_action(jm, pol, q, v, t))
    out = dict(iters=iters, actions=[
        np.asarray(act(ps.policy, q, v, t))
        for q, v, t in zip(x["probe_q"], x["probe_v"], x["probe_t"])])
    a = JAgent(jm, task, planner="ilqg", horizon=H)
    a.pstate = ps
    a.set_state(qpos=x["probe_q"][0], qvel=x["probe_v"][0], time=0.01)
    out["agent"] = dict(
        action=a.get_action(), action_t=a.get_action(time=0.03),
        nominal=a.get_action(nominal_action=True),
        action_avg=a.get_action(averaging_duration=0.006),
        u_step=a.step(), state=a.get_state(),
        traj=a.best_trajectory())
    return out


_BUILD = {"derivs": _jax_derivs, "plan": _jax_plan}
_RESULTS = {}
NAMES = tuple(_BUILD)


def reference(name: str):
    """The JAX reference `name`, built once per process."""
    if name not in _RESULTS:
        _RESULTS[name] = _BUILD[name]() if name in _BUILD else _jax_ops()
    return _RESULTS[name]


def mass_matrices(name):
    """The humanoid's mass matrix at its stand pose, for the loop-form
    Cholesky check (tests/test_torch_refs.py)."""
    return [refs.at_rest("humanoid", tm64(), th.stand_qpos(tm64()).numpy())]


# ---------------------------------------------------------------------------
# checks against the references
# ---------------------------------------------------------------------------

def check_tangent():
    c, x, m = reference("ops"), inputs(), tm64()
    q, dq, v = t64(x["q"]), t64(x["dq"]), t64(x["v"])
    q1 = tangent.state_add(m, q, dq)
    assert rel(c["state_add"], q1) < 1e-12
    assert rel(c["qpos_diff"], tangent.qpos_diff(m, q1, q)) < 1e-12
    assert rel(c["state_diff"], tangent.state_diff(m, q1, v, q, 0.5 * v)) \
        < 1e-12
    # the round trips of tests/test_ilqg.py:59-77 at the stand pose
    rng = np.random.default_rng(3)
    q0 = t64(x["q0"])[None]
    d = t64(rng.uniform(-0.1, 0.1, (1, 18)))
    assert rel(d, tangent.qpos_diff(m, tangent.state_add(m, q0, d), q0)) \
        < 1e-12
    rng = np.random.default_rng(4)
    qa = tangent.state_add(m, q0, t64(rng.uniform(-0.2, 0.2, (1, 18))))
    assert rel(qa, tangent.state_add(m, q0, tangent.qpos_diff(m, qa, q0))) \
        < 1e-12


def check_norms():
    c, o = reference("ops"), ops_inputs()
    x = t64(o["x"])
    for t, (p, q) in NORM_PARAMS.items():
        ref = c["norms"][int(t)]
        out = norms.norm_hess(x, int(t), p, q) + norms.norm_grad(x, int(t),
                                                                  p, q)
        for name, r, g in zip(("y", "g", "H", "y2", "g2"), ref, out):
            assert rel(r, g) < 1e-10, (t, name, rel(r, g))


def check_boxqp():
    c, o = reference("ops"), ops_inputs()
    for ref, qp in zip(c["qps"], o["qps"]):
        res = boxqp.box_qp(*(t64(qp[k]) for k in ("H", "g", "lo", "hi")),
                           x0=t64(qp["x0"]), iters=8)
        for name, r, g in zip(boxqp.BoxQPResult._fields, ref["res"], res):
            assert rel(r, g) < 1e-9, (name, rel(r, g))
        assert rel(ref["free_solve"], boxqp.free_solve(res, t64(qp["rhs"]))) \
            < 1e-9
        # batched: the same problems as one batch of two
        two = boxqp.box_qp(*(t64(np.stack([qp[k]] * 2)) for k in
                             ("H", "g", "lo", "hi")), iters=8)
        alone = boxqp.box_qp(*(t64(qp[k]) for k in ("H", "g", "lo", "hi")),
                             iters=8)
        assert rel(alone.x, two.x[1]) < 1e-12


def check_backward_pass():
    c, o = reference("ops"), ops_inputs()
    derivs = tder.Derivatives(**{k: t64(v) for k, v in o["derivs"].items()})
    for (reg_type, limits), ref in zip(BACKWARD_CASES, c["backward"]):
        kw = (dict(u_nom=t64(o["u_nom"]), ctrlrange=t64(o["ctrlrange"]))
              if limits else {})
        out = tilqg.backward_pass(derivs, t64(o["reg"]), reg_type=reg_type,
                                  **kw)
        for name, r, g in zip(("du", "K", "dV"), ref, out):
            assert rel(r, g) < 1e-9, (reg_type, limits, name, rel(r, g))
        if limits:
            # saturated axes get no feedback
            du = out[0].numpy() + o["u_nom"]
            sat = (np.abs(du) >= 1.0 - 1e-9)
            assert sat.any()
            assert np.all(out[1].numpy()[sat] == 0.0)


def check_jacobians():
    c, x = reference("derivs"), inputs()
    pm = make_plan_model(tm64(), PLAN_DT)
    q, v = t64(x["q0"])[None], torch.zeros((1, 18), dtype=F64)
    u, t0 = torch.zeros((1, 12), dtype=F64), torch.zeros(1, dtype=F64)
    q1, v1 = stand_next_state()
    A, B = tder.step_tangent_jacobians(pm, q, v, u, t0, t64(q1)[None],
                                       t64(v1)[None], solver_iters=12,
                                       ift=True)
    assert rel(c["A"], A[0]) < 1e-7, rel(c["A"], A[0])
    assert rel(c["B"], B[0]) < 1e-7, rel(c["B"], B[0])
    # columns against central differences of the converged step: the
    # JAX test's sampled columns at its eps 1e-6, and every column at
    # 1e-7 (the differences' error is linear in eps on columns 14 and 17,
    # 3.0e-3 and 7.5e-4 at 1e-6: a curvature switch at the stand pose,
    # where the two one-sided slopes agree but their change does not)
    rng = np.random.default_rng(0)
    n = 2 * pm.nv + pm.nu
    sampled = np.concatenate([rng.choice(2 * pm.nv, size=6, replace=False),
                              2 * pm.nv + rng.choice(pm.nu, size=3,
                                                     replace=False)])
    J = torch.cat([A[0], B[0]], dim=1)
    for eps, cols in ((1e-6, sampled), (1e-7, np.arange(n))):
        Z = eps * torch.eye(n, dtype=F64)[cols]
        Z = torch.cat([Z, -Z])
        k = len(cols)
        s = State(qpos=tangent.state_add(pm, q.expand(2 * k, -1),
                                         Z[:, :18]),
                  qvel=v + Z[:, 18:36], time=t0.expand(2 * k))
        s2, info = step(pm, s, u + Z[:, 36:], solver_iters=30)
        assert_top32_premise(info)
        d = tangent.state_diff(pm, s2.qpos[:k], s2.qvel[:k], s2.qpos[k:],
                               s2.qvel[k:]) / (2 * eps)
        err = float((J[:, cols].T - d).abs().max())
        assert err < 5e-4, (eps, err)
    # both feet in contact at the stand pose
    assert int((info.contact_force[0] > 0).sum()) >= 2


def check_derivatives():
    c, x = reference("derivs"), inputs()
    pm = make_plan_model(tm64(), PLAN_DT)
    task = stand_task(dtype=F64, device="cpu")
    qp, qv, u, times = (t64(x[k]) for k in ("nom_q", "nom_v", "nom_u",
                                             "nom_t"))
    r, C, D = tder.residual_tangent(pm, task, qp[1:2], qv[1:2], u[1:2],
                                    times[1:2])
    for ref, out in zip(c["residual"], (r, C, D)):
        assert rel(ref, out[0]) < 1e-9, rel(ref, out[0])
    gn = tder.gauss_newton_cost(task, r, C, D)
    for ref, out in zip(c["gauss_newton"], gn):
        assert rel(ref, out[0]) < 1e-9, rel(ref, out[0])
    for skip in (0, 2):
        d = tder.trajectory_derivatives(pm, task, qp, qv, u, times,
                                        skip=skip)
        ref = c[f"skip{skip}"]
        for f in dataclasses.fields(d):
            tol = 1e-7 if f.name in ("A", "B") else 1e-9
            err = rel(ref[f.name], getattr(d, f.name))
            assert err < tol, (skip, f.name, err)


def assert_top32_premise(info):
    """Every slot that carries force is among the 32 smallest gaps, in
    every env of a step: where the JAX CPU step's top-32 selection and
    the port's selection-free step solve the same problem."""
    gaps = info.contact_dist.numpy()
    loaded = info.contact_force.numpy() > 0
    cut = np.sort(gaps, axis=1)[:, 31:32]
    assert np.all(~loaded | (gaps <= cut)), np.argwhere(loaded & (gaps > cut))


class premise_on_rollouts:
    """Within the block, every `step` the iLQG rollouts take is checked
    against the top-32 premise."""

    def __enter__(self):
        self.saved = tilqg.step
        self.n = 0

        def spy(*a, **kw):
            out = self.saved(*a, **kw)
            assert_top32_premise(out[1])
            self.n += 1
            return out
        tilqg.step = spy
        return self

    def __exit__(self, *exc):
        tilqg.step = self.saved


def check_plan():
    c, x = reference("plan"), inputs()
    m = tm64()
    pm = make_plan_model(m, PLAN_DT)
    task = stand_task(dtype=F64, device="cpu")
    cfg = tilqg.ILQGConfig(horizon=H, n_linesearch=NLS)
    s0 = make_state(m, qpos=t64(x["plan_q"]), qvel=t64(x["plan_v"]))
    ps = tilqg.ilqg_init(pm, cfg, s0)
    with premise_on_rollouts() as spy:
        for it in c["iters"]:
            ps, info = tilqg.ilqg_plan(pm, task, cfg, ps, s0)
            ref, pol = it["state"], ps.policy
            for k in ("times", "qpos_nom", "qvel_nom", "u_nom", "K",
                      "k_scale"):
                err = rel(ref["policy"][k], getattr(pol, k))
                assert err < 1e-6, (k, err)
            assert rel(ref["reg"], ps.reg) < 1e-6
            for f in dataclasses.fields(info):
                err = rel(it["info"][f.name], getattr(info, f.name))
                assert err < 1e-6, (f.name, err)
    assert spy.n == ITERS * 2 * H
    assert float(np.abs(c["iters"][-1]["state"]["policy"]["K"]).max()) > 0
    # ilqg_action on the JAX plan's own policy
    ps = jax_policy_state(c)
    for q, v, t, ref in zip(x["probe_q"], x["probe_v"], x["probe_t"],
                            c["actions"]):
        out = tilqg.ilqg_action(m, ps.policy, t64(q)[None], t64(v)[None],
                                t64([t]))
        assert rel(ref, out[0]) < 1e-9
    # the three probes as one batch
    out = tilqg.ilqg_action(m, ps.policy, t64(x["probe_q"]),
                            t64(x["probe_v"]), t64(x["probe_t"]))
    assert rel(np.stack(c["actions"]), out) < 1e-9
    s = make_state(m, qpos=t64(x["probe_q"]), qvel=t64(x["probe_v"]),
                   time=t64(x["probe_t"]))
    assert torch.equal(mpc.ilqg_action_fn(m, ps.policy, s), out)


def jax_policy_state(c):
    """The port's ILQGState holding the JAX plan's last policy."""
    ref = c["iters"][-1]["state"]
    pol = ref["policy"]
    return tilqg.ilqg_state_from_numpy(
        pol["times"], pol["qpos_nom"], pol["qvel_nom"], pol["u_nom"],
        pol["K"], pol["k_scale"], ref["reg"], dtype=F64, device="cpu")


def check_agent():
    c, x = reference("plan"), inputs()
    m = tm64()
    a = Agent(m, stand_task(dtype=F64, device="cpu"), horizon=H)
    assert a.planner == "ilqg" and a.cfg.horizon == H
    a.pstate = jax_policy_state(c)
    a.set_state(qpos=x["probe_q"][0], qvel=x["probe_v"][0], time=0.01)
    r = c["agent"]
    assert rel(r["action"], a.get_action()) < 1e-9
    assert rel(r["action_t"], a.get_action(time=0.03)) < 1e-9
    nominal = a.get_action(nominal_action=True)
    assert rel(r["nominal"], nominal) < 1e-9
    assert rel(r["nominal"], r["action"]) > 1e-6     # the feedback acts
    assert rel(r["action_avg"], a.get_action(averaging_duration=0.006)) \
        < 1e-9
    assert rel(r["u_step"], a.step()) < 1e-9
    st = a.get_state()
    for k in ("qpos", "qvel"):
        assert rel(r["state"][k], st[k]) < 1e-9, k
    traj = a.best_trajectory()
    assert traj.keys() == r["traj"].keys()
    for k in traj:
        assert rel(r["traj"][k], traj[k]) < 1e-12, k


# ---------------------------------------------------------------------------
# checks of the port alone
# ---------------------------------------------------------------------------

def check_boxqp_kkt():
    """box_qp against the KKT point found by enumerating every clamp
    pattern (tests/test_ilqg.py:277), 25 problems of size 3."""
    rng = np.random.default_rng(2)
    n = 3
    for trial in range(25):
        M = rng.standard_normal((n, n))
        Hq = M @ M.T + np.eye(n) * 0.5
        g = rng.standard_normal(n) * 2.0
        lo = -np.abs(rng.standard_normal(n)) * 0.5
        hi = np.abs(rng.standard_normal(n)) * 0.5
        best = None
        for pat in itertools.product((0, 1, 2), repeat=n):
            xk = np.where(np.array(pat) == 1, lo,
                          np.where(np.array(pat) == 2, hi, 0.0))
            fr = [i for i in range(n) if pat[i] == 0]
            if fr:
                rhs = g[fr] + Hq[np.ix_(fr, range(n))] @ xk
                rhs -= Hq[np.ix_(fr, fr)] @ xk[fr]
                xk[fr] = -np.linalg.solve(Hq[np.ix_(fr, fr)], rhs)
            if np.any(xk < lo - 1e-9) or np.any(xk > hi + 1e-9):
                continue
            grad = g + Hq @ xk
            ok = all(not ((pat[i] == 1 and grad[i] < -1e-9)
                          or (pat[i] == 2 and grad[i] > 1e-9)
                          or (pat[i] == 0 and abs(grad[i]) > 1e-7))
                     for i in range(n))
            if ok:
                best = xk
                break
        assert best is not None, trial
        res = boxqp.box_qp(t64(Hq), t64(g), t64(lo), t64(hi), iters=12)
        assert float(np.abs(res.x.numpy() - best).max()) < 1e-7, trial


def check_backward_pass_riccati():
    """backward_pass without limits or regularization is the textbook
    finite-horizon LQR (tests/test_ilqg.py:153)."""
    rng = np.random.default_rng(0)
    T, nx, nu = 12, 4, 2
    A = np.stack([np.eye(nx) + 0.05 * rng.standard_normal((nx, nx))
                  for _ in range(T)])
    B = np.stack([0.1 * rng.standard_normal((nx, nu)) for _ in range(T)])
    Q, R = np.eye(nx) * 0.5, np.eye(nu) * 0.2
    q = rng.standard_normal((T, nx)) * 0.1
    r = rng.standard_normal((T, nu)) * 0.1
    derivs = tder.Derivatives(
        A=t64(A), B=t64(B), cx=t64(q), cu=t64(r),
        cxx=t64(np.tile(Q, (T, 1, 1))), cxu=torch.zeros((T, nx, nu),
                                                         dtype=F64),
        cuu=t64(np.tile(R, (T, 1, 1))))
    du, K, _ = tilqg.backward_pass(derivs, torch.tensor(0.0, dtype=F64))
    Vx, Vxx = np.zeros(nx), np.zeros((nx, nx))
    K_ref, du_ref = np.zeros((T, nu, nx)), np.zeros((T, nu))
    for t in reversed(range(T)):
        Qx, Qu = q[t] + A[t].T @ Vx, r[t] + B[t].T @ Vx
        Qxx = Q + A[t].T @ Vxx @ A[t]
        Qux = B[t].T @ Vxx @ A[t]
        Quu = R + B[t].T @ Vxx @ B[t]
        K_ref[t] = -np.linalg.solve(Quu, Qux)
        du_ref[t] = -np.linalg.solve(Quu, Qu)
        Vx = Qx + K_ref[t].T @ (Quu @ du_ref[t] + Qu) + Qux.T @ du_ref[t]
        Vxx = Qxx + K_ref[t].T @ (Quu @ K_ref[t] + Qux) + Qux.T @ K_ref[t]
        Vxx = 0.5 * (Vxx + Vxx.T)
    assert float(np.abs(K.numpy() - K_ref).max()) < 1e-9
    assert float(np.abs(du.numpy() - du_ref).max()) < 1e-9


def check_ift_primal():
    """ift=True moves no value: the Newton solve, forward and the step,
    at the stand pose and a noisy one (the third state's tilted, non-unit
    quaternion loads slots outside the 32 smallest gaps within the
    selection-free solve's iterations)."""
    m, x = tm64(), inputs()
    s = make_state(m, qpos=t64(x["q"][:2]), qvel=t64(x["v"][:2]))
    ctrl = torch.zeros((2, 12), dtype=F64)
    plain, ift = forward(m, s, ctrl), forward(m, s, ctrl, ift=True)
    for r, o in zip(plain[:3], ift[:3]):
        assert rel(r, o) < 1e-9, rel(r, o)
    for f in dataclasses.fields(plain[3]):
        r, o = getattr(plain[3], f.name), getattr(ift[3], f.name)
        assert torch.equal(r, o) if r.dtype == torch.bool else \
            rel(r, o) < 1e-9, f.name
    s1, info = step(m, s, ctrl)
    assert_top32_premise(info)
    s1i, info_i = step(m, s, ctrl, ift=True)
    for r, o in ((s1.qpos, s1i.qpos), (s1.qvel, s1i.qvel),
                 (info.qacc, info_i.qacc),
                 (info.contact_force, info_i.contact_force)):
        assert rel(r, o) < 1e-9, rel(r, o)
    # the Newton solve alone, on the rows forward builds
    from humanoid_mujoco_torch.ops import linalg
    from humanoid_mujoco_torch.physics import engine
    from humanoid_mujoco_torch.physics.collision import collide
    from humanoid_mujoco_torch.physics.solver import make_contact_rows
    kin, _, M, qfs = engine.prepare_smooth(m, s.qpos, s.qvel, ctrl)
    rows = make_contact_rows(m, kin, s.qpos, collide(m, kin.xpos, kin.xmat))
    Mchol = linalg.chol_factor(M)
    efc = finish_efc(rows, s.qvel, Mchol)
    for r, o in zip(newton_solve(M, Mchol, qfs, efc),
                    newton_solve(M, Mchol, qfs, efc, ift=True)):
        assert rel(r, o) < 1e-9, rel(r, o)


def check_defaults_plan():
    """The Agent's default planner plans: two planner steps on a float32
    agent at horizon 3 give finite returns and gains, the policy's
    nominal anchored at the state, and reset restores the zero policy."""
    m = th.build_humanoid(device="cpu")
    a = Agent(m, "Humanoid Cap Stand", horizon=3)
    a.set_state(qpos=th.stand_qpos(m))
    for _ in range(2):
        assert np.isfinite(a.planner_step())
    p = a.pstate.policy
    assert torch.isfinite(p.K).all() and float(p.K.abs().max()) > 0
    assert torch.equal(p.qpos_nom[0], a.state.qpos[0])
    u = a.get_action()
    assert u.shape == (12,) and np.all(np.isfinite(u))
    a.reset()
    assert float(a.pstate.policy.K.abs().max()) == 0.0
    with pytest.raises(ValueError, match="batch 1"):
        tilqg.ilqg_plan(a.plan_model, a.task, a.cfg, a.pstate,
                        make_state(m, batch=2))


def pendulum_model(dt=0.05):
    """tests/test_ilqg.py's pendulum: one damped hinge, a ±10 motor."""
    b = ModelBuilder(dt=dt)
    b.has_floor = False
    body = b.add_body("pend", -1, mass=1.0, ipos=(0, 0, -0.5),
                      inertia=(0.05, 0.05, 0.001))
    jnt = b.add_joint("hinge", body, JointType.HINGE, axis=(0, 1, 0),
                      damping=0.1)
    b.add_actuator(jnt, ActuatorType.MOTOR, gear=1.0, ctrlrange=(-10, 10),
                   forcerange=(-10, 10))
    return b.finalize(dtype=F64, device="cpu")


def pendulum_task():
    """Drive the hinge to π (upright) with small control."""
    def residual(m, task, state, info, ctrl):
        return torch.cat([state.qpos[:, :1] - task.params[0],
                          state.qvel[:, :1], ctrl], dim=-1)
    terms = (TermSpec("angle", 1, NormType.QUADRATIC),
             TermSpec("vel", 1, NormType.QUADRATIC),
             TermSpec("ctrl", 1, NormType.QUADRATIC))
    return make_task("pend-swing", terms, residual, (10.0, 0.1, 0.01),
                     params=(np.pi,), param_names=("target",), dtype=F64,
                     device="cpu")


def check_pendulum_oracles():
    """tests/test_ilqg.py:199-262 on the port: 12 iterations from the
    hanging pendulum (horizon 30, 6 alphas, 2 solver iterations), the
    gains read after the 8th as there."""
    m, task = pendulum_model(), pendulum_task()
    s0 = make_state(m)
    cfg = tilqg.ILQGConfig(horizon=30, n_linesearch=6, solver_iters=2,
                           deriv_solver_iters=2)
    ps = tilqg.ilqg_init(m, cfg, s0)
    returns, nominal0, pol8 = [], None, None
    for i in range(12):
        ps, info = tilqg.ilqg_plan(m, task, cfg, ps, s0)
        if nominal0 is None:
            nominal0 = float(info.nominal_return)
        returns.append(float(info.best_return))
        if i == 7:
            pol8 = ps.policy
    assert returns[-1] < nominal0 * 0.25, (nominal0, returns)
    assert returns[-1] <= min(returns) * 1.01, returns
    assert abs(float(ps.policy.qpos_nom[-1, 0]) - np.pi) < 0.5
    # boxQP: zero gains where the control is clamped at its limit ...
    u = pol8.u_nom.numpy().ravel()
    K = pol8.K.numpy().reshape(len(u), -1)
    saturated = np.abs(u) >= 10.0 - 1e-6
    assert saturated[:3].all(), u
    np.testing.assert_allclose(K[saturated], 0.0, atol=1e-9)
    # ... and a corrective action at the strongest free knot
    free = np.nonzero(~saturated)[0]
    assert free.size > 0
    assert np.abs(K[free]).sum() > 1.0
    i = int(free[np.argmax(np.abs(K[free]).sum(axis=1))])
    q, v, t = pol8.qpos_nom[i:i + 1], pol8.qvel_nom[i:i + 1], \
        pol8.times[i:i + 1]
    u_nom = tilqg.ilqg_action(m, pol8, q, v, t)
    u_pert = tilqg.ilqg_action(m, pol8, q + 0.2, v + 0.5, t)
    assert not np.allclose(u_nom.numpy(), u_pert.numpy(), atol=1e-6)


def run_local_checks():
    """The checks that need no JAX reference process."""
    check_boxqp_kkt()
    check_backward_pass_riccati()
    check_ift_primal()
    check_defaults_plan()
    check_pendulum_oracles()


def run_reference_checks(references=None):
    """The checks against the JAX references; `references` holds results
    of `reference` built elsewhere (in other processes)."""
    _RESULTS.update(references or {})
    check_tangent()
    check_norms()
    check_boxqp()
    check_backward_pass()
    check_jacobians()
    check_derivatives()
    check_plan()
    check_agent()


def run_checks(references=None):
    run_local_checks()
    run_reference_checks(references)
