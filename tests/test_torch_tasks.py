"""Port parity: the task library's sphere-and-joint tier against JAX.

Humanoid Cap Walk, Walker, Quadruped Flat and Hill, Cartpole, Acrobot,
Particle and ParticleFixed, float64 on the CPU (the JAX side with x64),
the same numpy-seeded inputs through both packages; tolerances are
max-abs error over max-abs value:

- models and tasks: every model leaf and Structure field, and every
  task leaf (weights, params, norm params, mocap, modes, terms), are
  equal; the port's registry names are the JAX registry's;
- residuals and costs of every task on 8 random states (Quadruped at
  each of its five gaits, Walk in both modes), both packages fed the
  same state and StepInfo, at 1e-10; the transitions are exact: the
  gait sync of params and weights, the Hill waypoint advance writing
  mocap and mode, the Lissajous goal;
- 20 `step`s from the home keyframe plus joint noise against the JAX
  `step` at 1e-9: Walker and Quadruped Flat (B1 + B2 twins; JAX's CPU
  step makes no selection, `max_contacts` 0), Quadruped Hill (plain
  smooth stage + B2 twin), Cartpole (B3 twin, driven into its rail
  limit so the limit rows carry force), Acrobot and Particle (the
  solver-free route); some slot carries force in the contact models;
- one `sampling_plan` with JAX's noise on Walker, Quadruped Flat and
  Cartpole, and one `ilqg_plan` iteration on Cartpole (its derivatives
  through `step(ift=True)` and the 2 limit rows), at 1e-6;
- routing: the kernel entry points each model's step reaches (B1, B2,
  B3 or none), counted by patched entry points;
- `Agent(task_model(name), name)` at its default planner (iLQG) plans
  and acts for each task on the CPU.

The JAX references (jit compiles of the steps and plans) are built in
processes of their own by tests/test_torch_port.py; `run_checks`
builds them in this process.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu.mpc import make_plan_model as j_plan_model
from humanoid_mujoco_tpu.physics.model import State as JState
from humanoid_mujoco_tpu.physics.step import StepInfo as JStepInfo
from humanoid_mujoco_tpu.physics.step import step as j_step
from humanoid_mujoco_tpu.planners import ilqg as jilqg
from humanoid_mujoco_tpu.planners import policy as jpolicy
from humanoid_mujoco_tpu.planners import sampling as jsampling
from humanoid_mujoco_tpu.tasks import base as jbase
from humanoid_mujoco_tpu.tasks import registry as jregistry
from humanoid_mujoco_tpu.tasks import quadruped as jquad
from humanoid_mujoco_tpu.tasks import quadruped_hill as jhill

from humanoid_mujoco_torch.agent import Agent
from humanoid_mujoco_torch.mpc import make_plan_model
from humanoid_mujoco_torch.ops.spline import SplineOrder
from humanoid_mujoco_torch.physics import engine, fused_smooth, fused_solver
from humanoid_mujoco_torch.physics.model import (_LEAVES, Structure, State,
                                                 make_state)
from humanoid_mujoco_torch.physics.solver import make_rows
from humanoid_mujoco_torch.physics.step import forward, route, step
from humanoid_mujoco_torch.planners import (SamplingConfig, init_policy,
                                            sampling_plan)
from humanoid_mujoco_torch.planners import ilqg as tilqg
from humanoid_mujoco_torch.tasks import base, registry
from humanoid_mujoco_torch.tasks import quadruped as tquad
from humanoid_mujoco_torch.tasks import quadruped_hill as thill

import test_torch_refs as refs
import test_torch_rl as trl

torch.set_num_threads(1)
# tests/conftest.py sets this too; the references run in processes of
# their own, which do not import conftest
jax.config.update("jax_enable_x64", True)

F64 = torch.float64
rel, t64, tree_np = trl.rel, trl.t64, trl.tree_np
NEW = ("Acrobot", "Cartpole", "Humanoid Cap Walk", "Particle",
       "ParticleFixed", "Quadruped Flat", "Quadruped Hill", "Walker")
MODELS = ("Acrobot", "Cartpole", "Particle", "Quadruped Flat",
          "Quadruped Hill", "Walker")
STEP_MODELS = ("Walker", "Quadruped Flat", "Quadruped Hill", "Cartpole",
               "Acrobot", "Particle")
CONTACT_MODELS = ("Walker", "Quadruped Flat", "Quadruped Hill")
PLAN_MODELS = ("Walker", "Quadruped Flat", "Cartpole")
ROUTES = {"Humanoid Cap Walk": "smooth", "Walker": "smooth",
          "Quadruped Flat": "smooth", "Quadruped Hill": "contact",
          "Cartpole": "rows", "Acrobot": "free", "Particle": "free",
          "ParticleFixed": "free"}
STEPS, NSTATE = 20, 8
PLAN_N, PLAN_K, PLAN_H = 8, 3, 8
ILQG_H, ILQG_NLS, ILQG_DT = 10, 4, 0.02


@functools.lru_cache(maxsize=None)
def jax_model(name):
    return jregistry.task_model(name, dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def port_model(name):
    return registry.task_model(name, dtype=F64, device="cpu")


def jax_task(name, **kw):
    return jregistry.get_task(name, dtype=jnp.float64, **kw)


def port_task(name, **kw):
    return registry.get_task(name, dtype=F64, device="cpu", **kw)


def start(name, B, seed):
    """B numpy-seeded states near the task's home keyframe and controls:
    (qpos, qvel, ctrl). Quadruped Hill stands on the slope at the first
    ring waypoint's x; Cartpole runs into its right rail limit."""
    rng = np.random.default_rng(seed)
    jm = jax_model(name)
    q0 = np.asarray(jregistry.home_qpos(name, jm), np.float64)
    nq, nv, nu = jm.nq, jm.nv, jm.nu
    lo, hi = (np.asarray(jm.act_ctrlrange, np.float64).T if nu
              else (np.zeros(0), np.zeros(0)))
    qpos = np.tile(q0, (B, 1))
    qvel = 0.1 * rng.standard_normal((B, nv))
    ctrl = rng.uniform(lo + 0.3 * (hi - lo), hi - 0.3 * (hi - lo), (B, nu))
    if name.startswith("Quadruped"):
        qpos[:, 7:] += 0.03 * rng.standard_normal((B, 12))
        ctrl = np.tile(np.asarray(jquad.home_ctrl(jm)), (B, 1)) \
            + 0.05 * rng.standard_normal((B, 12))
        if name == "Quadruped Hill":
            qpos[:, 0] = 1.6
            qpos[:, 2] = jhill._hill_height_np(1.6, 0.0) + 0.27
    elif name == "Humanoid Cap Stand":
        qpos[:, 7:] += 0.05 * rng.standard_normal((B, 12))
        ctrl = 0.3 * rng.standard_normal((B, nu))
    elif name == "Walker":
        qpos[:, 1:] += 0.05 * rng.standard_normal((B, nq - 1))
    elif name == "Cartpole":
        qpos[:, 0] = 1.75
        qpos[:, 1] += 0.2 * rng.standard_normal(B)
        qvel[:, 0] = 1.5
        ctrl[:] = 1.0
    else:
        qpos += 0.3 * rng.standard_normal((B, nq))
    return qpos, qvel, ctrl


def run_o0(fn, *args):
    """fn(*args) jit-compiled at XLA optimization level 0: the same
    numbers, less compile time."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


def _jax_step(name):
    """20 JAX steps of 2 states of model `name`: qpos, qvel, qacc,
    contact force and site positions per step."""
    jm = jax_model(name)
    qpos, qvel, ctrl = start(name, 2, seed=1)

    def run(q, v, u):
        def body(s, _):
            s2, info = j_step(jm, s, u)
            return s2, (s2.qpos, s2.qvel, info.qacc, info.contact_force,
                        info.site_xpos)
        s0 = JState(q, v, jnp.asarray(0.0, jnp.float64))
        return jax.lax.scan(body, s0, None, length=STEPS)[1]
    return [np.asarray(t) for t in run_o0(jax.vmap(run), qpos, qvel, ctrl)]


def plan_noise(key, nu):
    return np.asarray(jax.random.normal(jax.random.split(key)[0],
                                        (PLAN_N, PLAN_K, nu), jnp.float64))


def _jax_plan(name):
    """One `sampling_plan` of model `name` from the first `start` state,
    with the noise its key draws."""
    jm, jt = jax_model(name), jax_task(name)
    qpos, qvel, _ = start(name, 1, seed=2)
    cfg = jsampling.SamplingConfig(nsample=PLAN_N, nknots=PLAN_K,
                                   horizon=PLAN_H, order=SplineOrder.LINEAR,
                                   exploration=0.2)
    key = jax.random.PRNGKey(5)
    s0 = JState(jnp.asarray(qpos[0]), jnp.asarray(qvel[0]),
                jnp.asarray(0.0, jnp.float64))
    pol, info = run_o0(
        lambda p, s, k: jsampling.sampling_plan(jm, jt, cfg, p, s, k),
        jpolicy.init_policy(jm, PLAN_K), s0, key)
    return dict(noise=plan_noise(key, jm.nu), values=tree_np(pol),
                info=tree_np(info))


def _jax_ilqg(name):
    """One `ilqg_plan` iteration from `ilqg_init` on Cartpole, the pole
    0.25 rad off hanging, plan dt 0.02."""
    jm = jax_model(name)
    pm = j_plan_model(jm, ILQG_DT)
    cfg = jilqg.ILQGConfig(horizon=ILQG_H, n_linesearch=ILQG_NLS)
    q0 = np.asarray(jregistry.home_qpos(name, jm)).copy()
    q0[1] = np.pi - 0.25
    s0 = JState(jnp.asarray(q0), jnp.zeros(2, jnp.float64),
                jnp.asarray(0.0, jnp.float64))
    ps, info = run_o0(lambda ps, s: jilqg.ilqg_plan(
        pm, jax_task(name), cfg, ps, s), jilqg.ilqg_init(pm, cfg, s0), s0)
    return dict(q0=q0, state=tree_np(ps), info=tree_np(info))


_KINDS = {"step": _jax_step, "plan": _jax_plan, "ilqg": _jax_ilqg}
# the references in groups of about equal compile time, one process each
_GROUPS = {
    "light": (("step", "Walker"), ("step", "Cartpole"), ("step", "Acrobot"),
              ("step", "Particle"), ("plan", "Walker"),
              ("plan", "Cartpole"), ("ilqg", "Cartpole")),
    "quadruped_step": (("step", "Quadruped Flat"),),
    "hill_step": (("step", "Quadruped Hill"),),
    "quadruped_plan": (("plan", "Quadruped Flat"),),
}
_RESULTS = {}
NAMES = tuple(_GROUPS)


def reference(name: str):
    """The JAX references of group `name` as {(kind, model): result},
    built once per process."""
    if name not in _RESULTS:
        _RESULTS[name] = {job: _KINDS[job[0]](job[1])
                          for job in _GROUPS[name]}
    return _RESULTS[name]


def mass_matrices(name):
    """Mass matrices of group `name`'s models at home, for the loop-form
    Cholesky check (tests/test_torch_refs.py)."""
    models = sorted({model for _, model in _GROUPS[name]})
    return [refs.at_rest(n, port_model(n), registry.home_qpos(
        n, port_model(n)).numpy()) for n in models]


def all_references():
    """Every group's references in one dict."""
    return {k: v for n in NAMES for k, v in reference(n).items()}


# ---------------------------------------------------------------------------
# models, tasks, registry
# ---------------------------------------------------------------------------

def check_models():
    for name in MODELS:
        jm, m = jax_model(name), port_model(name)
        for leaf in _LEAVES + ("sol_iter",):
            np.testing.assert_array_equal(getattr(m, leaf).numpy(),
                                          np.asarray(getattr(jm, leaf)),
                                          err_msg=f"{name}: {leaf}")
        for f in dataclasses.fields(Structure):
            assert getattr(m.struct, f.name) == getattr(jm.struct, f.name), \
                (name, f.name)
        assert m.struct.max_contacts == 0, name
        assert route(m) == ROUTES[name], (name, route(m))
    assert not fused_smooth.supported(port_model("Quadruped Hill"))


def task_leaves_equal(jt, t):
    assert t.name == jt.name
    assert [dataclasses.astuple(x) for x in t.terms] == \
        [(x.name, x.dim, int(x.norm), x.num_params) for x in jt.terms]
    assert t.param_names == tuple(jt.param_names)
    assert t.mode_names == tuple(jt.mode_names)
    assert t.mocap_names == tuple(jt.mocap_names)
    assert (t.transition_fn is None) == (jt.transition_fn is None)
    for leaf in ("weights", "norm_params", "params", "risk", "mode",
                 "mocap_pos", "mocap_quat"):
        np.testing.assert_array_equal(getattr(t, leaf).numpy(),
                                      np.asarray(getattr(jt, leaf)),
                                      err_msg=f"{t.name}: {leaf}")


def check_tasks():
    for name in NEW:
        task_leaves_equal(jax_task(name), port_task(name))
    for gait in tquad.GAITS:
        task_leaves_equal(jax_task("Quadruped Flat", gait=gait),
                          port_task("Quadruped Flat", gait=gait))
    assert set(registry.list_tasks()) <= set(jregistry.list_tasks())
    # the contact-rich tier (slice 9) is tests/test_torch_contact.py's
    contact = {"Bimanual Handover", "FreeFingers", "Humanoid Stand",
               "Humanoid Track", "Humanoid Walk", "OP3", "Panda",
               "PickAndPlace", "Quadrotor"}
    # and the top-k tier (slice 10) tests/test_torch_topk.py's
    topk = {"Allegro", "Bimanual Insert", "Bimanual Reorient",
            "Humanoid Interact", "Rubik", "Shadow"}
    assert set(NEW) | {"Humanoid Cap Stand", "Swimmer"} | contact | topk \
        == set(registry.list_tasks())
    for name in MODELS:
        np.testing.assert_array_equal(
            registry.home_qpos(name, port_model(name)).numpy(),
            np.asarray(jregistry.home_qpos(name, jax_model(name))))


# ---------------------------------------------------------------------------
# residuals, costs, transitions
# ---------------------------------------------------------------------------

def jax_info(info, i=None):
    """The JAX StepInfo of a port StepInfo (env i, or the batch)."""
    def a(x):
        x = x.numpy()
        return jnp.asarray(x if i is None else x[i])
    return JStepInfo(**{f.name: a(getattr(info, f.name))
                        for f in dataclasses.fields(info)})


def residual_case(name, t, jt, seed):
    """The residual and costs of task t / jt on NSTATE states of `start`
    at times in [0, 1), both packages on the port's forward StepInfo.
    Returns the largest residual entry."""
    model = {"ParticleFixed": "Particle",
             "Humanoid Cap Walk": "Humanoid Cap Stand"}.get(name, name)
    m, jm = port_model(model), jax_model(model)
    qpos, qvel, ctrl = start(model, NSTATE, seed)
    times = np.random.default_rng(seed + 1).uniform(0.0, 1.0, NSTATE)
    s = State(qpos=t64(qpos), qvel=t64(qvel), time=t64(times))
    info = forward(m, s, t64(ctrl))[3]
    r = t.residual(m, s, info, t64(ctrl))
    jr = jax.vmap(lambda q, v, tt, inf, u: jt.residual(
        jm, JState(q, v, tt), inf, u))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(times),
        jax_info(info), jnp.asarray(ctrl))
    assert rel(jr, r) < 1e-10, (name, rel(jr, r))
    assert rel(jbase.cost_terms(jt, jr), base.cost_terms(t, r)) < 1e-10
    assert rel(jbase.cost_value(jt, jr), base.cost_value(t, r)) < 1e-10
    return float(np.abs(np.asarray(jr)).max())


def check_residuals():
    for i, name in enumerate(("Acrobot", "Cartpole", "Particle",
                              "ParticleFixed", "Walker", "Quadruped Hill")):
        assert residual_case(name, port_task(name), jax_task(name), 10 + i) \
            > 0
    m, jm = port_model("Quadruped Flat"), jax_model("Quadruped Flat")
    for g, gait in enumerate(tquad.GAITS):
        t = port_task("Quadruped Flat", gait=gait)
        t = t.transition(m, None, None)
        jt = jax_task("Quadruped Flat", gait=gait)
        jt = jt.transition(jm, None, None)
        residual_case("Quadruped Flat", t, jt, 20 + g)
    for mode in ("Stand", "Walk"):
        residual_case("Humanoid Cap Walk",
                      port_task("Humanoid Cap Walk").set_mode(mode),
                      jax_task("Humanoid Cap Walk").set_mode(mode), 30)


def check_transitions():
    # the gait sync: params and weights, exact
    m, jm = port_model("Quadruped Flat"), jax_model("Quadruped Flat")
    for gait in tquad.GAITS:
        t = port_task("Quadruped Flat", gait=gait).transition(m, None, None)
        jt = jax_task("Quadruped Flat", gait=gait).transition(jm, None,
                                                              None)
        np.testing.assert_array_equal(t.params.numpy(),
                                      np.asarray(jt.params))
        np.testing.assert_array_equal(t.weights.numpy(),
                                      np.asarray(jt.weights))
    # the Hill waypoints: advance within tolerance, wrap, hold when far
    m, jm = port_model("Quadruped Hill"), jax_model("Quadruped Hill")
    trunk = m.struct.body_id("trunk")
    qpos, qvel, ctrl = start("Quadruped Hill", 1, seed=3)
    s = make_state(m, qpos=t64(qpos), qvel=t64(qvel))
    info = forward(m, s, t64(ctrl))[3]
    wpos, wquat = thill.waypoints(F64, "cpu")
    t, jt = port_task("Quadruped Hill"), jax_task("Quadruped Hill")
    js = JState(jnp.asarray(qpos[0]), jnp.asarray(qvel[0]),
                jnp.asarray(0.0, jnp.float64))
    modes = []
    for k in (0, 1, 2, None):
        inf = info
        if k is not None:       # the trunk 0.1 m off waypoint k
            xpos, xquat = info.xpos.clone(), info.xquat.clone()
            xpos[0, trunk] = wpos[k] + torch.tensor([0.1, 0.0, 0.0],
                                                    dtype=F64)
            xquat[0, trunk] = wquat[k]
            inf = dataclasses.replace(info, xpos=xpos, xquat=xquat)
        t = t.transition(m, s, inf)
        jt = jt.transition(jm, js, jax_info(inf, 0))
        for leaf in ("mode", "mocap_pos", "mocap_quat"):
            np.testing.assert_array_equal(getattr(t, leaf).numpy(),
                                          np.asarray(getattr(jt, leaf)))
        modes.append(int(t.mode))
    assert modes == [1, 2, 3, 3], modes
    t, jt = t.set_mode(7), jt.set_mode(7)      # at the goal: wrap to 0
    xpos, xquat = info.xpos.clone(), info.xquat.clone()
    xpos[0, trunk], xquat[0, trunk] = t.mocap_pos[0], t.mocap_quat[0]
    inf = dataclasses.replace(info, xpos=xpos, xquat=xquat)
    t = t.transition(m, s, inf)
    jt = jt.transition(jm, js, jax_info(inf, 0))
    assert int(t.mode) == 0 and int(jt.mode) == 0
    np.testing.assert_array_equal(t.mocap_pos.numpy(),
                                  np.asarray(jt.mocap_pos))
    # the Lissajous goal
    m, jm = port_model("Particle"), jax_model("Particle")
    t, jt = port_task("Particle"), jax_task("Particle")
    for tt in (0.0, 0.37, 5.2):
        s = make_state(m, time=tt)
        t2 = t.transition(m, s, None)
        jt2 = jt.transition(jm, JState(jnp.zeros(2), jnp.zeros(2),
                                       jnp.asarray(tt, jnp.float64)), None)
        np.testing.assert_array_equal(t2.mocap_pos.numpy(),
                                      np.asarray(jt2.mocap_pos))
    assert port_task("ParticleFixed").transition_fn is None


# ---------------------------------------------------------------------------
# steps, plans
# ---------------------------------------------------------------------------

def check_steps():
    refs = all_references()
    for name in STEP_MODELS:
        ref = {name: refs["step", name]}
        m = port_model(name)
        qpos, qvel, ctrl = start(name, 2, seed=1)
        s, u = make_state(m, qpos=t64(qpos), qvel=t64(qvel)), t64(ctrl)
        outs, limit_force = [], 0.0
        for _ in range(STEPS):
            if name == "Cartpole":      # the rail limit rows' force
                _, _, M, qf = engine.prepare_smooth(m, s.qpos, s.qvel, u)
                rows = make_rows(m, s.qpos)
                f = fused_solver.solve_constraints_euler_reference(
                    M, qf, s.qvel, rows.J, rows.pos, rows.k, rows.b,
                    rows.d, m.dt * m.dof_damping, m.dt)[2]
                limit_force = max(limit_force, float(f.max()))
            s, info = step(m, s, u)
            assert not bool(info.diverged.any()), name
            outs.append((s.qpos, s.qvel, info.qacc, info.contact_force,
                         info.site_xpos))
        for k, (r, o) in enumerate(zip(ref[name], zip(*outs))):
            o = torch.stack(o, dim=1)
            assert r.shape == o.shape, (name, k, r.shape, o.shape)
            assert r.size == 0 or rel(r, o) < 1e-9, (name, k, rel(r, o))
        if name in CONTACT_MODELS:
            assert jax_model(name).struct.max_contacts == 0
            assert float(np.max(ref[name][3])) > 0, name
        if name == "Cartpole":
            assert limit_force > 0


def check_plans():
    refs = all_references()
    for name in PLAN_MODELS:
        m, t, c = port_model(name), port_task(name), refs["plan", name]
        qpos, qvel, _ = start(name, 1, seed=2)
        cfg = SamplingConfig(nsample=PLAN_N, nknots=PLAN_K,
                             horizon=PLAN_H, order=SplineOrder.LINEAR,
                             exploration=0.2)
        pol, info = sampling_plan(m, t, cfg, init_policy(m, PLAN_K),
                                  make_state(m, qpos=t64(qpos),
                                             qvel=t64(qvel)),
                                  noise=t64(c["noise"]))
        assert rel(c["info"]["returns"], info.returns) < 1e-6, name
        assert int(info.winner) == int(c["info"]["winner"]), name
        assert rel(c["values"]["values"], pol.values) < 1e-6, name
        assert np.ptp(c["info"]["returns"]) > 0, name
    # one iLQG iteration on Cartpole
    c = refs["ilqg", "Cartpole"]
    m = port_model("Cartpole")
    pm = make_plan_model(m, ILQG_DT)
    cfg = tilqg.ILQGConfig(horizon=ILQG_H, n_linesearch=ILQG_NLS)
    s0 = make_state(m, qpos=t64(c["q0"]))
    ps, info = tilqg.ilqg_plan(pm, port_task("Cartpole"), cfg,
                               tilqg.ilqg_init(pm, cfg, s0), s0)
    for k in ("times", "qpos_nom", "qvel_nom", "u_nom", "K", "k_scale"):
        err = rel(c["state"]["policy"][k], getattr(ps.policy, k))
        assert err < 1e-6, (k, err)
    assert rel(c["state"]["reg"], ps.reg) < 1e-6
    for f in dataclasses.fields(info):
        err = rel(c["info"][f.name], getattr(info, f.name))
        assert err < 1e-6, (f.name, err)
    assert float(np.abs(c["state"]["policy"]["K"]).max()) > 0


# ---------------------------------------------------------------------------
# routing, agents
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counted_entries():
    """Count the calls of the three kernel entry points (on the CPU they
    run the twins), by patching them in their modules."""
    calls = {"smooth": 0, "solver": 0, "euler": 0}
    saved = (fused_smooth.smooth_raw, fused_solver.solve_step_raw,
             fused_solver.solve_constraints_euler)

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper
    fused_smooth.smooth_raw = counted("smooth", saved[0])
    fused_solver.solve_step_raw = counted("solver", saved[1])
    fused_solver.solve_constraints_euler = counted("euler", saved[2])
    try:
        yield calls
    finally:
        (fused_smooth.smooth_raw, fused_solver.solve_step_raw,
         fused_solver.solve_constraints_euler) = saved


EXPECTED_CALLS = {"smooth": {"smooth": 1, "solver": 1, "euler": 0},
                  "contact": {"smooth": 0, "solver": 1, "euler": 0},
                  "rows": {"smooth": 0, "solver": 0, "euler": 1},
                  "free": {"smooth": 0, "solver": 0, "euler": 0}}


def check_routing():
    for name in NEW:
        m = registry.task_model(name, dtype=F64, device="cpu")
        s = make_state(m, qpos=registry.home_qpos(name, m), batch=2)
        with counted_entries() as calls:
            step(m, s, torch.zeros((2, m.nu), dtype=F64))
        assert calls == EXPECTED_CALLS[ROUTES[name]], (name, calls)
        assert route(m) == ROUTES[name]


def agent_start(name, m):
    """A state an agent of task `name` starts from: the home keyframe,
    Quadruped Hill's on the slope at the first waypoint."""
    q = registry.home_qpos(name, m).clone()
    if name == "Quadruped Hill":
        q[0] = 1.6
        q[2] = float(thill.hill_height_np(1.6, 0.0)) + 0.27
    return q


def check_agents():
    """Each task at its default planner (iLQG) on the CPU, float32, at
    horizon 3: a planner step with a finite return, a finite action."""
    for name in NEW:
        m = registry.task_model(name, device="cpu")
        a = Agent(m, name, horizon=3)
        assert a.planner == "ilqg"
        if name == "Humanoid Cap Walk":
            a.set_mode("Walk")
            assert a.get_mode() == "Walk"
        a.set_state(qpos=agent_start(name, m))
        assert np.isfinite(a.planner_step()), name
        u = a.get_action()
        assert u.shape == (m.nu,) and np.all(np.isfinite(u)), name


def run_local_checks():
    """The checks that need no JAX reference process."""
    check_models()
    check_tasks()
    check_residuals()
    check_transitions()
    check_routing()
    check_agents()


def run_reference_checks(references=None):
    """The checks against the JAX references; `references` holds results
    of `reference` built elsewhere (in other processes)."""
    _RESULTS.update(references or {})
    check_steps()
    check_plans()


def run_checks(references=None):
    run_local_checks()
    run_reference_checks(references)
