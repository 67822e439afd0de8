"""Port parity: the Swimmer's path against JAX.

The Swimmer (tasks/swimmer.py: nv 8, no contact slots, ten joint-limit
rows, fluid drag) is the model whose step runs kernel B3. Against the
JAX package, on the same numpy-seeded inputs, float64:

- every model leaf and the Structure fields are equal;
- 20 `step`s from a moving state with hinges near their limits, 1e-9;
- a 4 x 10 `rollout_spline` (linear spline, plan model dt 0.02) total
  return, 1e-7 relative;
- the transition's deterministic branch (target not reached) is exact;
  its respawn lands in [-0.8, 0.8]² and away from the nose;
- a 2-cycle `mpc_rollout` with `run_transition`, the port's planner fed
  the Gaussian noise the JAX planner draws from its keys: the same qpos
  trace and costs (1e-9) and the same winners.

Also the registry (every name a JAX registry name), and a model with
no contacts and no constraint rows stepping through the solver-free
route as the JAX step does (20 steps, 1e-9). Tolerances are max-abs
error over max-abs value. The JAX references are built in a background
thread by tests/test_torch_port.py, which runs these checks as the
port's one collected test (ROADMAP.md,
"Keep the count of collected test items small").
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu import mpc as jmpc
from humanoid_mujoco_tpu.ops.spline import SplineOrder as JOrder
from humanoid_mujoco_tpu.physics.model import ModelBuilder as JModelBuilder
from humanoid_mujoco_tpu.physics.model import make_state as j_make_state
from humanoid_mujoco_tpu.physics.step import step as j_step
from humanoid_mujoco_tpu.planners import policy as jpolicy
from humanoid_mujoco_tpu.planners import sampling as jsampling
from humanoid_mujoco_tpu.rollout import rollout_spline as j_rollout_spline
from humanoid_mujoco_tpu.tasks import registry as jregistry
from humanoid_mujoco_tpu.tasks import swimmer as jswimmer

from humanoid_mujoco_torch import mpc
from humanoid_mujoco_torch.ops.spline import SplineOrder
from humanoid_mujoco_torch.physics.model import (_LEAVES, JointType,
                                                 ModelBuilder, Structure,
                                                 default_qpos, make_state)
from humanoid_mujoco_torch.physics.step import route, step
from humanoid_mujoco_torch.planners import (SamplingConfig, init_policy,
                                            sampling_plan)
from humanoid_mujoco_torch.rollout import rollout_spline
from humanoid_mujoco_torch.tasks import registry
from humanoid_mujoco_torch.tasks import swimmer as tswimmer

torch.set_num_threads(1)

STEPS = 20
N, KNOTS, HORIZON, PLAN_DT = 4, 6, 10, 0.02
NCYCLE, SIM_STEPS = 2, 5
START_CTRL = 0.8     # the first nominal: costly control, so it loses
TARGET = (0.0, -0.5)


def rel_err(ref, out):
    r = np.asarray(ref, np.float64)
    o = out.detach().numpy().astype(np.float64)
    assert r.shape == o.shape, (r.shape, o.shape)
    return float(np.max(np.abs(r - o)) / (np.max(np.abs(r)) + 1e-12))


def start():
    """A moving Swimmer state with hinges near their ±90° limits, and a
    fixed control."""
    rng = np.random.default_rng(7)
    qpos = np.zeros(8)
    qpos[:3] = 0.2 * rng.standard_normal(3)
    qpos[3:] = np.array([1.5, -1.2, 0.4, -1.55, 0.9])
    qvel = 0.8 * rng.standard_normal(8)
    ctrl = rng.uniform(-1.0, 1.0, 5)
    return qpos, qvel, ctrl


def port():
    m = tswimmer.swimmer_model(dtype=torch.float64, device="cpu")
    return m, tswimmer.swimmer_task(target=TARGET, dtype=torch.float64,
                                    device="cpu")


@functools.lru_cache(maxsize=None)
def jax_swimmer():
    """The JAX references: the step trace, the rollout returns and the
    MPC run, whose planner reports its winners through a callback."""
    jm = jswimmer.swimmer_model(dtype=jnp.float64)
    task = jswimmer.swimmer_task(target=TARGET, dtype=jnp.float64)
    qpos, qvel, ctrl = start()
    out = {}

    def run(s):
        def body(s, _):
            s2, info = j_step(jm, s, jnp.asarray(ctrl))
            return s2, (s2.qpos, s2.qvel, info.qacc, info.site_xpos)
        return jax.lax.scan(body, s, None, length=STEPS)[1]
    trace = jax.jit(run)(j_make_state(jm, qpos=qpos, qvel=qvel))
    out["trace"] = [np.asarray(t) for t in trace]

    pm = jmpc.make_plan_model(jm, PLAN_DT)
    rng = np.random.default_rng(8)
    values = rng.uniform(-1.0, 1.0, (N, KNOTS, 5))
    times = np.linspace(0.0, HORIZON * PLAN_DT, KNOTS)
    s0 = j_make_state(jm, qpos=qpos, qvel=qvel)
    ret = jax.jit(jax.vmap(lambda v: j_rollout_spline(
        pm, task, s0, jnp.asarray(times), v, JOrder.LINEAR,
        HORIZON).total_return))(jnp.asarray(values))
    out.update(values=values, times=times, returns=np.asarray(ret))

    cfg = jsampling.SamplingConfig(nsample=N, nknots=KNOTS, horizon=HORIZON,
                                   order=JOrder.LINEAR, exploration=0.3)
    key = jax.random.PRNGKey(3)
    noise = [np.asarray(jax.random.normal(jax.random.split(k)[0],
                                          (N, KNOTS, 5), jnp.float64))
             for k in jax.random.split(key, NCYCLE)]
    winners = []

    def plan_fn(mm, tt, pp, ss, kk):
        pol, info = jsampling.sampling_plan(mm, tt, cfg, pp, ss, kk)
        jax.debug.callback(lambda w: winners.append(int(w)), info.winner,
                           ordered=True)
        return pol, info
    pol0 = jpolicy.init_policy(jm, KNOTS)
    pol0 = pol0.replace(values=jnp.full_like(pol0.values, START_CTRL))
    # O0: same numbers, less compile time
    run = jax.jit(lambda s, p, k: jmpc.mpc_rollout(
        jm, pm, task, plan_fn, p, s, k, ncycle=NCYCLE,
        steps_per_plan=SIM_STEPS,
        action_fn=jmpc.spline_action_fn(JOrder.LINEAR),
        run_transition=True)).lower(j_make_state(jm), pol0, key).compile(
            {"xla_backend_optimization_level": 0})
    res = run(j_make_state(jm), pol0, key)
    out.update(noise=noise, winners=winners,
               mpc_states=np.asarray(res.states),
               mpc_costs=np.asarray(res.costs),
               mpc_best=np.asarray(res.plan_returns),
               mpc_target=np.asarray(res.final_task.mocap_pos))
    return out


def check_model_leaves():
    jm = jswimmer.swimmer_model(dtype=jnp.float64)
    m, _ = port()
    for name in _LEAVES + ("sol_iter",):
        np.testing.assert_array_equal(getattr(m, name).numpy(),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    for f in dataclasses.fields(Structure):
        assert getattr(m.struct, f.name) == getattr(jm.struct, f.name), \
            f.name
    assert m.ncon == 0 and m.struct.fluid_density == 1000.0


def check_steps():
    ref = jax_swimmer()
    m, _ = port()
    qpos, qvel, ctrl = start()
    s = make_state(m, qpos=qpos, qvel=qvel)
    c = torch.tensor(ctrl)[None]
    outs = []
    for _ in range(STEPS):
        s, info = step(m, s, c)
        outs.append((s.qpos[0], s.qvel[0], info.qacc[0],
                     info.site_xpos[0]))
        assert info.contact_force.shape == (1, 0)
        assert info.contact_dist.shape == (1, 0)
        assert not bool(info.diverged.any())
    for name, r, o in zip(("qpos", "qvel", "qacc", "site_xpos"),
                          ref["trace"], zip(*outs)):
        assert rel_err(r, torch.stack(o)) < 1e-9, (name, rel_err(
            r, torch.stack(o)))


def check_rollout():
    ref = jax_swimmer()
    m, task = port()
    pm = mpc.make_plan_model(m, PLAN_DT)
    qpos, qvel, _ = start()
    res = rollout_spline(pm, task, make_state(pm, qpos=qpos, qvel=qvel,
                                              batch=N),
                         torch.tensor(ref["times"]),
                         torch.tensor(ref["values"]), SplineOrder.LINEAR,
                         HORIZON)
    assert rel_err(ref["returns"], res.total_return) < 1e-7
    assert not bool(res.diverged.any())


def check_transition():
    m, task = port()
    assert task.mocap_names == ("target",)
    s = make_state(m)
    _, info = step(m, s, torch.zeros(1, m.nu))
    # far from the target: deterministic, unchanged
    t1 = task.transition(m, s, info)
    assert torch.equal(t1.mocap_pos, task.mocap_pos)
    nose = info.site_xpos[0, m.struct.site_id("nose")]
    for tick in (0, 1, 37):
        near = task.set_mocap("target", pos=(nose[0] + 0.01, nose[1], 0.05))
        st = s.replace(time=torch.full((1,), tick * 1e-3,
                                       dtype=torch.float64))
        t2 = near.transition(m, st, info)
        xy = t2.mocap_pos[0, :2]
        assert bool((xy.abs() <= 0.8).all())
        assert float(torch.linalg.vector_norm(xy - nose[:2])) > 0.04
        assert float(t2.mocap_pos[0, 2]) == 0.05
        # the same tick draws the same point
        assert torch.equal(near.transition(m, st, info).mocap_pos,
                           t2.mocap_pos)
    assert task.set_mode("default").mode.item() == 0


def check_mpc():
    ref = jax_swimmer()
    m, task = port()
    pm = mpc.make_plan_model(m, PLAN_DT)
    cfg = SamplingConfig(nsample=N, nknots=KNOTS, horizon=HORIZON,
                         order=SplineOrder.LINEAR, exploration=0.3)
    noise = [torch.tensor(x) for x in ref["noise"]]
    winners = []

    def plan_fn(mm, tt, pp, ss, gen):
        pol, info = sampling_plan(mm, tt, cfg, pp, ss, noise=noise.pop(0))
        winners.append(int(info.winner))
        return pol, info
    pol0 = init_policy(m, KNOTS)
    pol0 = pol0.replace(values=torch.full_like(pol0.values, START_CTRL))
    res = mpc.mpc_rollout(m, pm, task, plan_fn, pol0,
                          make_state(m), None, NCYCLE, SIM_STEPS,
                          mpc.spline_action_fn(SplineOrder.LINEAR),
                          run_transition=True)
    assert winners == ref["winners"] and winners != [0] * NCYCLE
    assert rel_err(ref["mpc_states"], res.states) < 1e-9
    assert rel_err(ref["mpc_costs"], res.costs) < 1e-9
    assert rel_err(ref["mpc_best"], res.plan_returns) < 1e-9
    assert rel_err(ref["mpc_target"], res.final_task.mocap_pos) == 0.0
    assert res.states.shape == (NCYCLE, SIM_STEPS, m.nq)


def check_registry():
    assert registry.list_tasks() == [
        "Acrobot", "Allegro", "Bimanual Handover", "Bimanual Insert",
        "Bimanual Reorient", "Cartpole", "FreeFingers",
        "Humanoid Cap Stand", "Humanoid Cap Walk", "Humanoid Interact",
        "Humanoid Stand", "Humanoid Track", "Humanoid Walk", "OP3",
        "Panda", "Particle", "ParticleFixed", "PickAndPlace", "Quadrotor",
        "Quadruped Flat", "Quadruped Hill", "Rubik", "Shadow", "Swimmer",
        "Walker"]
    assert registry.list_tasks() == jregistry.list_tasks()
    task = registry.get_task("Swimmer", dtype=torch.float64, device="cpu")
    assert task.name == "Swimmer" and task.nres == 7
    m = registry.task_model("Swimmer", dtype=torch.float64, device="cpu")
    assert m.nv == 8
    assert torch.equal(registry.home_qpos("Swimmer", m), default_qpos(m))
    h = registry.task_model("Humanoid Cap Stand", device="cpu")
    assert registry.home_qpos("Humanoid Cap Stand", h).shape == (h.nq,)
    for name in registry.list_tasks():
        t = registry.get_task(name, device="cpu")
        assert t.name == name
        mm = registry.task_model(name, device="cpu")
        assert registry.home_qpos(name, mm).shape == (mm.nq,)
    with pytest.raises(KeyError):
        registry.get_task("Cartwheel")
    with pytest.raises(KeyError):
        registry.task_model("Cartwheel")


def one_hinge(builder, **kw):
    """A model without contacts or limits (the Acrobot's kind): one free
    hinge, no actuator."""
    b = builder()
    b.has_floor = False
    body = b.add_body("pole", -1, mass=1.0, inertia=(0.1, 0.1, 0.1))
    b.add_joint("hinge", body, JointType.HINGE)
    return b.finalize(**kw)


def check_no_rows_steps():
    """The one-hinge model takes the step's solver-free route and
    matches 20 JAX steps at 1e-9."""
    m = one_hinge(ModelBuilder, dtype=torch.float64, device="cpu")
    assert route(m) == "free"
    jm = one_hinge(JModelBuilder, dtype=jnp.float64)

    def run(s):
        def body(s, _):
            s2, info = j_step(jm, s, jnp.zeros(0))
            return s2, (s2.qpos, s2.qvel, info.qacc)
        return jax.lax.scan(body, s, None, length=STEPS)[1]
    ref = jax.jit(run)(j_make_state(jm, qpos=np.array([0.3]),
                                    qvel=np.array([1.2])))
    s = make_state(m, qpos=torch.tensor([0.3], dtype=torch.float64),
                   qvel=torch.tensor([1.2], dtype=torch.float64))
    outs = []
    for _ in range(STEPS):
        s, info = step(m, s, torch.zeros(1, 0))
        outs.append((s.qpos[0], s.qvel[0], info.qacc[0]))
        assert info.contact_force.shape == (1, 0)
        assert not bool(info.diverged.any())
    for name, r, o in zip(("qpos", "qvel", "qacc"), ref, zip(*outs)):
        o = torch.stack(o)
        assert np.asarray(r).shape == o.shape, name
        assert float(np.max(np.abs(np.asarray(r) - o.numpy()))) <= 1e-9 * (
            1.0 + float(np.max(np.abs(np.asarray(r))))), name
    assert abs(float(s.qpos[0, 0]) - (0.3 + 1.2 * STEPS * 0.002)) < 1e-12


def run_checks():
    check_model_leaves()
    check_transition()
    check_registry()
    check_no_rows_steps()
    check_steps()
    check_rollout()
    check_mpc()
