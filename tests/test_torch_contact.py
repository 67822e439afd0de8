"""Port parity: the contact-rich model family against JAX.

The upstream humanoid (Humanoid Stand, Walk and Track), OP3, Panda,
PickAndPlace, FreeFingers, the Quadrotor and the bimanual Handover, with
capsules, boxes, fixed tendons, gravity compensation and site actuators,
float64 on the CPU (the JAX side with x64), the same numpy-seeded inputs
through both packages; tolerances are max-abs error over max-abs value:

- models and tasks: every Structure field and model leaf of the eight
  models, of Insert and Reorient and of a small model with every
  primitive, pair kind, a tendon, gravcomp and both site actuators
  (`primitives_model`) equal the JAX builder's, and `model_from_jax_leaves`
  round-trips each; the registry holds the JAX registry's names; task
  leaves agree to float32 rounding (the JAX humanoid tasks are float32);
- `collide`: position, normal, gap and the three frictions of every
  slot, on 8 states near each model's home and 64 wide states of the
  primitives model, at 1e-9; targeted cases of the narrowphase helpers:
  points inside a box (a face tie among them), parallel and crossing
  segments, a capsule across a box edge; forward-mode tangents of
  `collide` through those cases are finite;
- the limit and tendon rows, gravcomp and site-actuator forces at 1e-9;
- 10 `step`s against the JAX CPU `step` at 1e-9 on Panda, PickAndPlace,
  FreeFingers and the Quadrotor (`max_contacts` 0, the same problem);
- on the upstream humanoid (Stand and Track's dt), OP3 and the
  Handover, which keep a top-16 selection in the JAX `forward`: 10 steps
  against the JAX step's selection-free kernel branch (JAX step.py:288-
  319 with B2's plain reference) at 1e-9, and against the JAX CPU step
  (top-16) at 1e-9 on the steps where the two solve the same problem
  iteration for iteration (`_same_problem`: no slot the selection drops
  is active anywhere on a line search; that every loaded slot is among
  the 16 smallest gaps is not enough for 8 unconverged iterations);
  how often each premise fails is reported;
- `forward(ift=True)` and `step(ift=True)` at 1e-9 and
  `step_tangent_jacobians` at one knot
  near home on the upstream humanoid and the Handover (top-16 in both
  packages): against central differences of the port's step at 1e-6,
  against JAX's jacfwd at 1e-7 on the humanoid (on the Handover JAX's
  jacfwd is 1.2e-5 off the differences on the cube's rows; held at
  1e-4, see `check_derivatives`); `step_rk4` on FreeFingers and the
  Quadrotor at 1e-9;
- every task's residual on the steps above at 1e-9, and the
  transitions: OP3's height goal, the Quadrotor's waypoint advance,
  PickAndPlace's staging, Panda's and the Handover's respawn rules (the
  draws themselves come from a torch.Generator in the port);
- a 2-iteration predictive-sampling plan on the Handover at nsample 16 x
  horizon 8 (4 linear knots, 1 solver iteration, the JAX draws) against
  the JAX plan rolled out on its kernel branch, at 1e-9; and the
  divergence witness of bench.py's Handover cell: six of its candidates
  (one solver iteration) rolled 40 steps, each diverging at the same
  step in the port as in the JAX kernel branch (`check_witness`);
- `route`: "contact" for the eight models, selection-free; and for
  Insert, Reorient, Allegro, Shadow, Humanoid Interact and Rubik, whose
  step keeps its top-k selection (held to JAX in
  tests/test_torch_topk.py), built here from the JAX leaves.

The JAX references (jit compiles of the steps, the derivatives and the
plan) are built in processes of their own by tests/test_torch_port.py;
`run_checks` builds them in this process. Each compile costs tens of
seconds, so the references share them: the Stand and Track models one
rollout program, the rollout and the witness one program (the
iteration count is its argument), forward(ift=True) and the next state
one step(ift=True).
"""

import dataclasses
import functools
import os

import numpy as np
import torch
from torch.autograd import forward_ad as fwAD

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu.physics import collision as jcol
from humanoid_mujoco_tpu.physics import engine as jengine
from humanoid_mujoco_tpu.physics import pallas_solver
from humanoid_mujoco_tpu.physics import solver as jsolver
from humanoid_mujoco_tpu.physics import step as jstep
from humanoid_mujoco_tpu.physics import model as jmodel
from humanoid_mujoco_tpu.physics.model import State as JState
from humanoid_mujoco_tpu.physics.step import StepInfo as JStepInfo
from humanoid_mujoco_tpu.planners import derivatives as jder
from humanoid_mujoco_tpu.planners import policy as jpolicy
from humanoid_mujoco_tpu.planners import sampling as jsampling
from humanoid_mujoco_tpu import rollout as jrollout
from humanoid_mujoco_tpu.tasks import registry as jregistry

from humanoid_mujoco_torch.ops.spline import SplineOrder, spline_sample
from humanoid_mujoco_torch.physics import collision as tcol
from humanoid_mujoco_torch.physics import engine as tengine
from humanoid_mujoco_torch.physics import model as tmodel
from humanoid_mujoco_torch.physics import tangent
from humanoid_mujoco_torch.physics.model import (_LEAVES, State, Structure,
                                                 model_from_jax_leaves)
from humanoid_mujoco_torch.ops import linalg
from humanoid_mujoco_torch.physics.solver import (contact_raw, finish_efc,
                                                  limit_rows_data,
                                                  limit_rows_static,
                                                  newton_solve,
                                                  rows_from_raw)
from humanoid_mujoco_torch.physics.step import (forward, keeps_selection,
                                                route, step, step_rk4)
from humanoid_mujoco_torch.planners import derivatives as tder
from humanoid_mujoco_torch.planners import (SamplingConfig, init_policy,
                                            sampling_plan)
from humanoid_mujoco_torch.planners.policy import SplinePolicy
from humanoid_mujoco_torch.planners.sampling import (plan_nominal,
                                                     sample_candidates)
from humanoid_mujoco_torch.tasks import aloha as taloha
from humanoid_mujoco_torch.tasks import registry

import test_torch_refs as refs
import test_torch_rl as trl

torch.set_num_threads(1)
# tests/conftest.py sets this too; the references run in processes of
# their own, which do not import conftest
jax.config.update("jax_enable_x64", True)

F64 = torch.float64
t64, tree_np = trl.t64, trl.tree_np


def rel(ref, out):
    """test_torch_rl.rel, 0 for an empty pair of equal shapes."""
    if np.asarray(ref).size == 0:
        assert np.asarray(ref).shape == tuple(out.shape)
        return 0.0
    return trl.rel(ref, out)

NEW = ("Bimanual Handover", "FreeFingers", "Humanoid Stand",
       "Humanoid Track", "Humanoid Walk", "OP3", "Panda", "PickAndPlace",
       "Quadrotor")
# the eight models (Humanoid Walk plans on Humanoid Stand's)
MODELS = ("Humanoid Stand", "Humanoid Track", "OP3", "Panda",
          "PickAndPlace", "FreeFingers", "Quadrotor", "Bimanual Handover")
PLAIN = ("Panda", "PickAndPlace", "FreeFingers", "Quadrotor")
TOPK = ("Humanoid Stand", "Humanoid Track", "OP3", "Bimanual Handover")
# the top-k tier: their step keeps its contact selection
SELECTING = ("Bimanual Insert", "Bimanual Reorient", "Allegro", "Shadow",
             "Humanoid Interact", "Rubik")
# RK4 on gravcomp, a box and site thrust; its JAX compile is four
# steps' (Panda's 10-deep chain ~2 min, FreeFingers ~50 s, the
# Quadrotor ~15 s)
RK4 = ("FreeFingers", "Quadrotor")
DERIVS = ("Humanoid Stand", "Bimanual Handover")
B, STEPS = 6, 10
PLAN_N, PLAN_K, PLAN_H = 16, 4, 8
# the divergence witness of bench.py's Handover cell (one solver
# iteration): B candidates of the cell (4 linear knots over 128 steps,
# exploration 0.05, candidate 0 the nominal) from standard normals of
# numpy seed WITNESS_SEED, rolled WITNESS_STEPS steps from the home;
# chip_smoke.py's `witness_noise` draws the same knots
WITNESS_SEED, WITNESS_STEPS, WITNESS_H = 12, 4 * STEPS, 128


# ---------------------------------------------------------------------------
# models and inputs
# ---------------------------------------------------------------------------

def primitives_model(builder_cls, jtype, atype, **finalize_kw):
    """A small model with every primitive, every pair kind, a fixed
    tendon, gravcomp and both kinds of site actuator, built by either
    package's ModelBuilder."""
    b = builder_cls(dt=0.005)
    base = b.add_body("base", -1, pos=(0.0, 0.0, 0.4), mass=2.0,
                      inertia=(0.02, 0.03, 0.04))
    b.add_joint("root", base, jtype.FREE)
    box_a = b.add_box(base, size=(0.1, 0.08, 0.06), friction=0.8)
    s0 = b.add_sphere(base, pos=(0.0, 0.0, 0.12), radius=0.05)
    c0 = b.add_capsule(base, p0=(-0.1, 0.0, 0.2), p1=(0.1, 0.0, 0.2),
                       radius=0.03, friction=0.6)
    arm = b.add_body("arm", base, pos=(0.0, 0.0, 0.1), mass=0.5,
                     inertia=(0.002, 0.002, 0.001), gravcomp=1.0)
    h1 = b.add_joint("h1", arm, jtype.HINGE, axis=(0, 1, 0),
                     jrange=(-1.0, 1.0), limited=True, damping=0.5)
    c1 = b.add_capsule(arm, p0=(-0.1, 0.0, 0.16), p1=(0.1, 0.0, 0.16),
                       radius=0.03, floor=False)
    box_b = b.add_box(arm, pos=(0.25, 0.0, 0.0), quat=(0.9, 0.1, 0.3, 0.0),
                      size=(0.05, 0.04, 0.03), floor=False)
    s1 = b.add_sphere(arm, pos=(0.18, 0.0, -0.02), radius=0.04,
                      floor=False)
    tip = b.add_body("tip", arm, pos=(0.3, 0.0, 0.0), mass=0.2,
                     inertia=(5e-4, 5e-4, 2e-4))
    h2 = b.add_joint("h2", tip, jtype.HINGE, axis=(0, 1, 0), damping=0.2)
    b.add_sphere(tip, pos=(0.05, 0.0, 0.0), radius=0.03)
    b.add_pair(s0, s1)
    b.add_pair_sc(s0, c1)
    b.add_pair_cc(c0, c1)
    b.add_pair_sb(s1, box_a)
    b.add_pair_cb(c1, box_a)
    b.add_pair_bb(box_a, box_b)
    b.add_tendon_limit([h1, h2], [0.5, -0.5], (-0.3, 0.3))
    b.add_actuator(h1, atype.MOTOR, gear=5.0)
    b.add_actuator(h2, atype.POSITION, kp=10.0, kv=0.5)
    site = b.add_site("thrust", base, pos=(0.05, 0.0, 0.05))
    b.add_thrust(site, gear=(0.0, 0.0, 1.0, 0.0, 0.0, 0.02),
                 ctrlrange=(0.0, 20.0), forcerange=(0.0, 20.0))
    b.add_thrust(site, gear=(10.0, 0.0, 0.0, 0.0, 1.0, 0.0),
                 ctrlrange=(-1.0, 1.0), world_frame=True)
    return b.finalize(**finalize_kw)


@functools.lru_cache(maxsize=None)
def jax_model(name):
    if name == "primitives":
        return primitives_model(jmodel.ModelBuilder, jmodel.JointType,
                                jmodel.ActuatorType, dtype=jnp.float64)
    return jregistry.task_model(name, dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def port_model(name):
    if name == "primitives":
        return primitives_model(tmodel.ModelBuilder, tmodel.JointType,
                                tmodel.ActuatorType, dtype=F64,
                                device="cpu")
    return registry.task_model(name, dtype=F64, device="cpu")


def port_task(name):
    """The port's task in float64 with the JAX task's float leaves (the
    JAX humanoid tasks build float32 ones)."""
    t = registry.get_task(name, dtype=F64, device="cpu")
    j = jax_task(name)
    return dataclasses.replace(
        t, weights=t64(j.weights), norm_params=t64(j.norm_params),
        params=t64(j.params), risk=t64(j.risk),
        mocap_pos=t64(j.mocap_pos), mocap_quat=t64(j.mocap_quat))


def jax_task(name):
    try:
        return jregistry.get_task(name, dtype=jnp.float64)
    except TypeError:           # the humanoid tasks take no dtype
        return jregistry.get_task(name)


def start(name, n=B, seed=0):
    """n numpy-seeded (qpos, qvel, ctrl) near the model's home: scalar
    joints + 0.03 N, qvel 0.1 N, controls in the middle 40% of the
    range (the Quadrotor: hover + 0.5 N, half the craft on the floor;
    the Handover: its home servo targets + 0.02 N). The primitives model
    takes wide poses (0.8 N on the hinges, the root tilted)."""
    rng = np.random.default_rng(seed)
    jm = jax_model(name)
    s = jm.struct
    q0 = np.asarray(jmodel.default_qpos(jm) if name == "primitives"
                    else jregistry.home_qpos(name, jm), np.float64)
    qpos = np.tile(q0, (n, 1))
    scale = 0.8 if name == "primitives" else 0.03
    for j in range(s.njnt):
        if s.jnt_type[j] in (jmodel.JointType.HINGE, jmodel.JointType.SLIDE):
            qpos[:, s.jnt_qadr[j]] += scale * rng.standard_normal(n)
    qvel = 0.1 * rng.standard_normal((n, s.nv))
    lo, hi = np.asarray(jm.act_ctrlrange, np.float64).T
    ctrl = rng.uniform(lo + 0.3 * (hi - lo), hi - 0.3 * (hi - lo), (n, s.nu))
    if name == "primitives":
        quat = np.concatenate([np.ones((n, 1)),
                               0.3 * rng.standard_normal((n, 3))], axis=1)
        qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
        qpos[:, 2] = rng.uniform(0.05, 0.4, n)
    elif name == "Quadrotor":
        ctrl = 13.0 * 9.81 / 4 / 10 + 0.5 * rng.standard_normal((n, 4))
        qpos[: n // 2, 2] = 0.02
    elif name == "Bimanual Handover":
        ctrl = np.asarray(taloha.home_ctrl(port_model(name))) \
            + 0.02 * rng.standard_normal((n, s.nu))
    return qpos, qvel, np.clip(ctrl, lo, hi)


def jax_contact_step(m, state, ctrl, xfrc=None, solver_iters=8):
    """The JAX step's selection-free kernel branch (step.py:288-319) as
    it runs off the TPU: the plain smooth stage, `collide` over every
    slot, contact_raw and limit_rows_data, then B2's plain reference
    (pallas_solver.solve_step_raw falls back to _jax_single_raw)."""
    h = m.dt
    kin, vel, M, qfs, contacts, _, _ = jstep._prepare_smooth(
        m, state, ctrl, xfrc)
    dmask, rel_, mu3, kc, bc, dc = jsolver.contact_raw(m, kin, contacts,
                                                       None)
    lpos, kl, bl, dl = jsolver.limit_rows_data(m, state.qpos)
    qacc, qvn, cf, qfc = pallas_solver.solve_step_raw(
        M, qfs, state.qvel, kin.cdof, rel_, contacts.normal, contacts.dist,
        mu3, dmask, kc, bc, dc, lpos, kl, bl, dl, h * m.dof_damping, h,
        lim_tab=jsolver.limit_rows_static(m), niter=solver_iters)
    diverged = (~jnp.all(jnp.isfinite(qacc))
                | (jnp.max(jnp.abs(state.qvel)) > 1e4)
                | ~jnp.all(jnp.isfinite(qvn)))
    qpn = jstep.integrate_pos(m, state.qpos, qvn, h)
    qpn = jnp.where(diverged, state.qpos, qpn)
    qvn = jnp.where(diverged, jnp.zeros_like(qvn), qvn)
    info = JStepInfo(
        xpos=kin.xpos, xquat=kin.xquat, xipos=kin.xipos,
        site_xpos=kin.site_xpos, com=kin.anchor, com_vel=vel.com_vel,
        body_com_vel=jengine.body_com_velocities(kin, vel),
        contact_dist=contacts.dist, contact_force=cf, qacc=qacc,
        actuator_force=jstep._actuator_force(m, state.qpos, state.qvel,
                                             ctrl, qacc.dtype),
        qfrc_total=qfs + qfc, diverged=diverged)
    return JState(qpn, qvn, state.time + h), info


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------

def _compile(fn, *args):
    """fn compiled for these arguments at XLA's optimization level 0
    (the same numbers, less compile time)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


def _geometry(name):
    """collide, the limit/tendon rows, gravcomp and thrust forces of the
    JAX package on `start` states."""
    jm = jax_model(name)
    n = 64 if name == "primitives" else 8
    qpos, qvel, ctrl = start(name, n, seed=3)

    def one(m, q, u):
        kin = jengine.fwd_position(m, q)
        c = jcol.collide(m, kin.xpos, kin.xmat)
        out = dict(pos=c.pos, normal=c.normal, dist=c.dist,
                   friction=c.friction, friction_tor=c.friction_tor,
                   friction_roll=c.friction_roll,
                   lim=jsolver.limit_rows_data(m, q))
        if m.struct.has_gravcomp:
            out["gravcomp"] = jengine.gravcomp_qfrc(m, kin)
        if any(t == jmodel.ActuatorType.SITE_THRUST
               for t in m.struct.act_type):
            out["thrust"] = jengine.thrust_qfrc(m, kin, u)
        return out
    args = (jm, jnp.asarray(qpos), jnp.asarray(ctrl))
    return tree_np(_cached(jax.vmap(one, in_axes=(None, 0, 0)), "geometry",
                           *args)(*args))


_COMPILED = {}


def _cached(fn, key, m, *args):
    """`fn` compiled once per key and model Structure, with the model
    an argument: the upstream humanoid's Stand and Track models (the same
    Structure, another dt) share one compile."""
    k = (key, m.struct) + tuple((a.shape, a.dtype) for a in args)
    if k not in _COMPILED:
        _COMPILED[k] = _compile(fn, m, *args)
    return _COMPILED[k]


def _plain_step(m, state, ctrl, solver_iters):
    """The JAX CPU step at its default iterations."""
    return jstep.step(m, state, ctrl)


def _steps(name, step_fn, qpos, qvel, ctrl, niter=8):
    """ctrl.shape[1] steps of `step_fn` from (qpos, qvel) at time 0
    under per-step controls ctrl (n, T, nu), vmapped: the end state and
    per step the state before it and the StepInfo. The iteration count
    is an argument of the compiled program (the kernel branch's Newton
    loop is a fori_loop), so the rollout's compile serves the witness's
    one-iteration steps too."""
    jm = jax_model(name)

    def one(m, q, v, u, k):
        def body(s, u_t):
            s2, info = step_fn(m, s, u_t, solver_iters=k)
            return s2, dict(qpos=s.qpos, qvel=s.qvel, time=s.time,
                            info=info)
        return jax.lax.scan(body, JState(q, v, jnp.asarray(0.0)), u)
    args = (jm,) + tuple(jnp.asarray(x) for x in (qpos, qvel, ctrl)) \
        + (jnp.asarray(niter),)
    return _cached(jax.vmap(one, in_axes=(None, 0, 0, 0, None)),
                   ("steps", step_fn.__name__), *args)(*args)


def _rollout(name, step_fn):
    """STEPS steps of `step_fn` from `start` (`_steps`): per step the
    state before it and the StepInfo; then each task's residual on them
    (Humanoid Stand's model also under the Walk task)."""
    jm = jax_model(name)
    qpos, qvel, ctrl = start(name)
    s_end, outs = _steps(name, step_fn, qpos, qvel,
                         np.repeat(ctrl[:, None], STEPS, axis=1))
    tasks = [name] + (["Humanoid Walk"] if name == "Humanoid Stand" else [])
    for tname in tasks:
        task = jax_task(tname)

        def res(q, v, t, info, u):
            return task.residual(jm, JState(q, v, t), info, u)
        r = jax.jit(jax.vmap(jax.vmap(res, in_axes=(0, 0, 0, 0, None))))(
            outs["qpos"], outs["qvel"], outs["time"], outs["info"],
            jnp.asarray(ctrl))
        outs["residual" if tname == name else "walk_residual"] = r
    return dict(end=tree_np(s_end), steps=tree_np(outs))


def _cpu_step_on(jm, qpos, qvel, ctrl):
    """The JAX CPU step (top-k where the model has it) from each of the
    given (n, T, ...) states."""
    n, T = qpos.shape[:2]

    def one(m, q, v, u):
        s2, info = jstep.step(m, JState(q, v, jnp.asarray(0.0)), u)
        return dict(qpos=s2.qpos, qvel=s2.qvel, qacc=info.qacc)
    args = (jm, jnp.asarray(qpos.reshape(n * T, -1)),
            jnp.asarray(qvel.reshape(n * T, -1)),
            jnp.asarray(np.repeat(ctrl, T, axis=0)))
    out = _cached(jax.vmap(one, in_axes=(None, 0, 0, 0)), "cpu_step",
                  *args)(*args)
    return {k: v.reshape((n, T) + v.shape[1:])
            for k, v in tree_np(out).items()}


def _transitions(name, ref):
    """The task's transition on the first env of the rollout's first
    step (and the deterministic cases of each rule)."""
    jm, task = jax_model(name), jax_task(name)
    st = ref["steps"]
    info = JStepInfo(**{k: jnp.asarray(v[0, 0])
                        for k, v in st["info"].items()})
    s = JState(jnp.asarray(st["qpos"][0, 0]), jnp.asarray(st["qvel"][0, 0]),
               jnp.asarray(0.01))
    out = {"plain": tree_np(task.transition(jm, s, info))}
    if name == "OP3":
        out["handstand"] = tree_np(task.set_mode("Handstand").transition(
            jm, s, info))
    if name == "Quadrotor":
        goal = task.mocap_pos.at[0].set(info.xpos[0] + 0.1)
        out["advance"] = tree_np(dataclasses.replace(
            task, mocap_pos=goal).transition(jm, s, info))
    return out


def _model_ref(name):
    jm = jax_model(name)
    out = {"geometry": _geometry(name)}
    if name in PLAIN:
        out["rollout"] = _rollout(name, _plain_step)
    else:
        out["rollout"] = _rollout(name, jax_contact_step)
        st = out["rollout"]["steps"]
        ctrl = start(name)[2]
        out["cpu_step"] = _cpu_step_on(jm, st["qpos"], st["qvel"], ctrl)
    out["transitions"] = _transitions(name, out["rollout"])
    if name in RK4:
        qpos, qvel, ctrl = start(name, seed=4)

        def rk4(m, q, v, u):
            s2, _ = jstep.step_rk4(m, JState(q, v, jnp.asarray(0.0)), u)
            return s2.qpos, s2.qvel
        args = (jm,) + tuple(jnp.asarray(x) for x in (qpos, qvel, ctrl))
        out["rk4"] = tree_np(_cached(jax.vmap(rk4, in_axes=(None, 0, 0, 0)),
                                     "rk4", *args)(*args))
    return out


def _derivs(name):
    """forward(ift=True)'s qacc, the next state of step(ift=True) (one
    compile gives both: that step runs forward(ift=True)) and the
    tangent Jacobians about it at one knot near home (the JAX forward
    keeps its top-16)."""
    jm = jax_model(name)
    qpos, qvel, ctrl = start(name, n=1, seed=8)
    q, v, u = (jnp.asarray(x[0]) for x in (qpos, qvel, ctrl))
    s = JState(q, v, jnp.asarray(0.0))
    s1, info = _compile(lambda s, u: jstep.step(jm, s, u, ift=True),
                        s, u)(s, u)
    A, Bm = _compile(lambda: jder.step_tangent_jacobians(
        jm, q, v, u, jnp.asarray(0.0), s1.qpos, s1.qvel, ift=True))()
    return dict(qacc=np.asarray(info.qacc), A=np.asarray(A),
                B=np.asarray(Bm), next_qpos=np.asarray(s1.qpos),
                next_qvel=np.asarray(s1.qvel))


def _plan():
    """Two sampling-plan iterations on the Handover (nsample 16 x horizon
    8, 4 linear knots, 1 solver iteration) from its home, the JAX
    rollouts on the kernel branch's step."""
    name = "Bimanual Handover"
    jm, task = jax_model(name), jax_task(name)
    from humanoid_mujoco_tpu.ops.spline import SplineOrder as JOrder
    from humanoid_mujoco_tpu.tasks.aloha import home_ctrl
    cfg = jsampling.SamplingConfig(nsample=PLAN_N, nknots=PLAN_K,
                                   horizon=PLAN_H, order=JOrder.LINEAR,
                                   solver_iters=1)
    s0 = jmodel.make_state(jm, qpos=jregistry.home_qpos(name, jm))
    pol = jpolicy.init_policy(jm, PLAN_K)
    pol = dataclasses.replace(pol, values=jnp.tile(
        jnp.asarray(home_ctrl(jm), jnp.float64)[None], (PLAN_K, 1)))
    saved = jrollout.step
    jrollout.step = jax_contact_step
    try:
        plan = _compile(lambda p, s, k: jsampling.sampling_plan(
            jm, task, cfg, p, s, k), pol, s0, jax.random.PRNGKey(0))
        iters = []
        for i in range(2):
            key = jax.random.PRNGKey(i)
            k_noise, _ = jax.random.split(key)
            noise = jax.random.normal(k_noise, (PLAN_N, PLAN_K, jm.nu),
                                      dtype=jnp.float64)
            pol, info = plan(pol, s0, key)
            iters.append(dict(noise=np.asarray(noise),
                              returns=np.asarray(info.returns),
                              winner=int(info.winner),
                              values=np.asarray(pol.values),
                              times=np.asarray(pol.times)))
    finally:
        jrollout.step = saved
    return iters


def witness_inputs(ctrlrange, home, dt):
    """The witness in numpy: the cell's fresh knot grid from t = 0 (K,),
    the candidates' knot values by sample_candidates' rule (home + 0.05
    of the half-range times the noise, clipped; (B, K, nu)), the noise,
    and each step's control, the linear spline at t dt (B,
    WITNESS_STEPS, nu)."""
    rng = np.random.default_rng(WITNESS_SEED)
    noise = rng.standard_normal((B, PLAN_K, len(home)))
    noise[0] = 0.0
    lo, hi = np.asarray(ctrlrange, np.float64).T
    values = np.clip(home + 0.05 * 0.5 * (hi - lo) * noise, lo, hi)
    span = WITNESS_H * dt / (PLAN_K - 1)
    times = span * np.arange(PLAN_K)
    t = dt * np.arange(WITNESS_STEPS)
    i = np.minimum((t // span).astype(int), PLAN_K - 2)
    w = ((t - times[i]) / span)[None, :, None]
    ctrl = np.clip(values[:, i] + w * (values[:, i + 1] - values[:, i]),
                   lo, hi)
    return times, values, noise, ctrl


def _first_diverged(div):
    """(n,) the first step at which each candidate diverged, -1 for
    none, from (n, T) flags."""
    div = np.asarray(div, bool)
    return np.where(div.any(axis=1), div.argmax(axis=1), -1)


def _witness():
    """The witness on the JAX kernel branch at one solver iteration, in
    chunks of STEPS steps through the rollout's compiled program
    (`_steps`): each candidate's first diverged step."""
    from humanoid_mujoco_tpu.tasks.aloha import home_ctrl
    name = "Bimanual Handover"
    jm = jax_model(name)
    _, values, _, ctrl = witness_inputs(
        jm.act_ctrlrange, np.asarray(home_ctrl(jm), np.float64),
        float(jm.dt))
    q = np.tile(np.asarray(jregistry.home_qpos(name, jm)), (B, 1))
    v = np.zeros((B, jm.nv))
    div = []
    for c in range(0, WITNESS_STEPS, STEPS):
        s_end, outs = _steps(name, jax_contact_step, q, v,
                             ctrl[:, c:c + STEPS], niter=1)
        div.append(np.asarray(outs["info"].diverged))
        q, v = s_end.qpos, s_end.qvel
    return dict(first=_first_diverged(np.concatenate(div, axis=1)),
                values=values, ctrl=ctrl)


# four processes of about equal work (~200-300 s of compiles each on
# a quiet machine)
_BUILD = {
    "light": lambda: {**{n: _model_ref(n) for n in PLAIN},
                      "primitives": {"geometry": _geometry("primitives")},
                      "plan": _plan()},
    "humanoid": lambda: {n: _model_ref(n) for n in ("Humanoid Stand",
                                                    "Humanoid Track")},
    "op3": lambda: {"OP3": _model_ref("OP3"),
                    "Humanoid Stand derivs": _derivs("Humanoid Stand")},
    "aloha": lambda: {"Bimanual Handover": _model_ref("Bimanual Handover"),
                      "witness": _witness(),
                      "Bimanual Handover derivs":
                      _derivs("Bimanual Handover")},
}
NAMES = tuple(_BUILD)
# the models each reference process builds
_MODELS = {"light": PLAIN + ("primitives", "Bimanual Handover"),
           "humanoid": ("Humanoid Stand", "Humanoid Track"),
           "op3": ("OP3", "Humanoid Stand"),
           "aloha": ("Bimanual Handover",)}
_RESULTS = {}
# XLA's CPU fusion recomputes a deep kinematic chain's shared terms in
# every consumer (the Panda's 10-deep chain: 0.4 s a forward kinematics
# call, 55 s a 6-state step); without the fusion pass a step runs in
# ~10 ms. Read when a process first initializes its XLA backend, which
# the references do in processes of their own.
XLA_FLAGS = "--xla_disable_hlo_passes=fusion"


def reference(name: str):
    """The JAX reference `name`, built once per process."""
    if name not in _RESULTS:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                   + XLA_FLAGS).strip()
        _RESULTS[name] = _BUILD[name]()
    return _RESULTS[name]


def mass_matrices(name):
    """Mass matrices of reference `name`'s models at their `start`
    states, for the loop-form Cholesky check (tests/test_torch_refs.py)."""
    out = []
    for n in _MODELS[name]:
        qpos, qvel, ctrl = start(n, n=1)
        out.append((n, *refs.port_mass_matrix(port_model(n), qpos[0],
                                              qvel[0], ctrl[0])))
    return out


def _merged(references):
    out = {}
    for name in NAMES:
        out.update(references[name] if references and name in references
                   else reference(name))
    return out


# ---------------------------------------------------------------------------
# checks that need no JAX reference run
# ---------------------------------------------------------------------------

def check_models_and_tasks():
    assert set(NEW) <= set(registry.list_tasks())
    assert set(registry.list_tasks()) <= set(jregistry.list_tasks())
    for name in MODELS + ("primitives", "Bimanual Insert",
                          "Bimanual Reorient"):
        jm = jax_model(name) if name in MODELS + ("primitives",) else \
            jregistry.task_model(name, dtype=jnp.float64)
        tm = port_model(name) if name in MODELS + ("primitives",) else (
            taloha.aloha_insert_model if name == "Bimanual Insert"
            else taloha.aloha_reorient_model)(dtype=F64, device="cpu")
        js, ts = dataclasses.asdict(jm.struct), dataclasses.asdict(tm.struct)
        assert js == ts, (name, [k for k in js if js[k] != ts.get(k)])
        leaves = {k: np.asarray(getattr(jm, k)) for k in _LEAVES}
        leaves["sol_iter"] = np.asarray(jm.sol_iter)
        back = model_from_jax_leaves(Structure(**js), leaves, device="cpu")
        for k in _LEAVES:
            assert rel(leaves[k], getattr(tm, k)) < 1e-15, (name, k)
            assert torch.equal(getattr(back, k), getattr(tm, k)), (name, k)
        assert int(tm.sol_iter) == int(jm.sol_iter), name
        assert tm.ncon == jm.ncon, name
    for name in NEW:
        jt, tt = jax_task(name), registry.get_task(name, dtype=F64,
                                                   device="cpu")
        assert [dataclasses.astuple(t) for t in tt.terms] == \
            [dataclasses.astuple(t) for t in jt.terms], name
        assert tt.param_names == jt.param_names, name
        assert tt.mode_names == jt.mode_names, name
        assert tt.mocap_names == jt.mocap_names, name
        for k in ("weights", "norm_params", "params", "mocap_pos",
                  "mocap_quat"):
            assert rel(np.asarray(getattr(jt, k)), getattr(tt, k)) < 1e-7, \
                (name, k)
        jm = jregistry.task_model(name, dtype=jnp.float64)
        assert rel(np.asarray(jregistry.home_qpos(name, jm)),
                   registry.home_qpos(name, port_model(
                       "Humanoid Stand" if name == "Humanoid Walk"
                       else name))) < 1e-15, name


def check_routes():
    for name in MODELS:
        m = port_model(name)
        assert route(m) == "contact" and not keeps_selection(m), name
    for name in SELECTING:
        jm = jregistry.task_model(name, dtype=jnp.float64)
        leaves = {k: np.asarray(getattr(jm, k)) for k in _LEAVES}
        m = model_from_jax_leaves(Structure(**dataclasses.asdict(jm.struct)),
                                  leaves, device="cpu")
        assert route(m) == "contact" and keeps_selection(m), name
    for model in (taloha.aloha_insert_model, taloha.aloha_reorient_model):
        m = model(dtype=F64, device="cpu")
        s, info = step(m, tmodel.make_state(m, batch=2), torch.zeros(
            (2, m.nu), dtype=F64))
        assert torch.isfinite(s.qvel).all() and not info.diverged.any()
        assert info.contact_force.shape == (2, m.ncon)


def check_narrowphase_cases():
    """The helpers against the JAX package's on crafted inputs: points
    inside a box (a face tie, the center), on its surface and outside;
    parallel, crossing and degenerate segments."""
    rng = np.random.default_rng(5)
    size = np.array([0.1, 0.08, 0.06])
    pts = np.concatenate([
        rng.uniform(-1.5, 1.5, (200, 3)) * size,
        [[0.0, 0.0, 0.0], [0.05, 0.03, 0.01], [0.09, 0.0, 0.04],
         [0.07, 0.05, 0.03], [0.1, 0.0, 0.0], [0.12, 0.1, 0.0]]])
    ref = jcol._point_box_local(jnp.asarray(pts), jnp.asarray(size))
    out = tcol._point_box_local(t64(pts), t64(size).expand(len(pts), 3))
    for r, o in zip(ref, out):
        assert rel(r, o) < 1e-12
    assert int((out[0] < 0).sum()) > 20          # inside points
    p1 = np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0.0]])
    q1 = np.array([[1, 0, 0], [1, 0, 0], [1, 0, 0], [0, 0, 0.0]])
    p2 = np.array([[0.5, 0.1, 0], [0.2, 0.1, 0.0], [2, 1, 0], [0, 1, 0.0]])
    q2 = np.array([[1.5, 0.1, 0], [0.2, -0.1, 0.1], [3, 1, 0], [0, 2, 0.0]])
    extra = rng.standard_normal((4, 50, 3))
    args = [np.concatenate([a, e]) for a, e in zip((p1, q1, p2, q2), extra)]
    ref = jcol._seg_seg_closest(*(jnp.asarray(a) for a in args))
    out = tcol._seg_seg_closest(*(t64(a) for a in args))
    for r, o in zip(ref, out):
        assert rel(r, o) < 1e-12


def check_tangents_finite():
    """Forward-mode tangents of `collide` through inside points,
    parallel capsules and capsule-box edges stay finite."""
    m = port_model("primitives")
    qpos, _, _ = start("primitives", 64, seed=3)
    q = t64(qpos)
    with fwAD.dual_level():
        qd = fwAD.make_dual(q, torch.ones_like(q))
        kin = tengine.fwd_position(m, qd)
        c = tcol.collide(m, kin.xpos, kin.xmat)
        for f in ("pos", "normal", "dist"):
            t = fwAD.unpack_dual(getattr(c, f)).tangent
            keep = (fwAD.unpack_dual(c.dist).primal < 1e8)
            if f != "dist":
                keep = keep[..., None].expand_as(t)
            assert bool(torch.isfinite(t[keep]).all()), f


def run_local_checks():
    check_models_and_tasks()
    check_routes()
    check_narrowphase_cases()
    check_tangents_finite()


# ---------------------------------------------------------------------------
# checks against the references
# ---------------------------------------------------------------------------

def check_geometry(refs):
    for name in MODELS + ("primitives",):
        ref = refs[name]["geometry"]
        m = port_model(name)
        n = 64 if name == "primitives" else 8
        qpos, _, ctrl = start(name, n, seed=3)
        kin = tengine.fwd_position(m, t64(qpos))
        c = tcol.collide(m, kin.xpos, kin.xmat)
        for f in ("pos", "normal", "dist", "friction", "friction_tor",
                  "friction_roll"):
            assert rel(ref[f], getattr(c, f)) < 1e-9, (name, f)
        lim = limit_rows_data(m, t64(qpos))
        for r, o in zip(ref["lim"], lim):
            assert rel(r, o) < 1e-9, name
        tab = np.asarray(limit_rows_static(m))
        assert np.array_equal(tab, np.asarray(
            jsolver.limit_rows_static(jax_model(name)))), name
        if "gravcomp" in ref:
            assert rel(ref["gravcomp"], tengine.gravcomp_qfrc(m, kin)) \
                < 1e-9, name
        if "thrust" in ref:
            assert rel(ref["thrust"], tengine.thrust_qfrc(
                m, kin, t64(ctrl))) < 1e-9, name
    # the primitives model reaches every case: inside a box, below the
    # floor, every pair group with some contact
    d = refs["primitives"]["geometry"]["dist"]
    assert (d < 0).any(axis=0).sum() > 8


def _port_rollout(name):
    m, task = port_model(name), port_task(name)
    qpos, qvel, ctrl = start(name)
    s = State(t64(qpos), t64(qvel), torch.zeros(B, dtype=F64))
    u = t64(ctrl)
    outs = []
    for _ in range(STEPS):
        s2, info = step(m, s, u)
        outs.append((s, info, task.residual(m, s, info, u)))
        s = s2
    return outs, s


def check_steps(refs):
    """The steps, their StepInfo and the tasks' residuals."""
    fields = ("xpos", "xquat", "site_xpos", "com", "com_vel",
              "body_com_vel", "contact_dist", "contact_force", "qacc",
              "actuator_force", "qfrc_total")
    report = {}
    for name in MODELS:
        ref = refs[name]["rollout"]
        st = ref["steps"]
        outs, s_end = _port_rollout(name)
        for t, (s, info, res) in enumerate(outs):
            assert rel(st["qpos"][:, t], s.qpos) < 1e-9, (name, t)
            assert rel(st["qvel"][:, t], s.qvel) < 1e-9, (name, t)
            for f in fields:
                assert rel(st["info"][f][:, t], getattr(info, f)) < 1e-9, \
                    (name, t, f)
            assert not bool(info.diverged.any()), (name, t)
            assert rel(st["residual"][:, t], res) < 1e-9, (name, t)
        assert rel(ref["end"]["qpos"], s_end.qpos) < 1e-9, name
        loaded = np.asarray(st["info"]["contact_force"]) > 0
        if name != "Quadrotor":
            assert loaded.any(), (name, "no slot carries force")
        if name == "Humanoid Stand":
            walk = port_task("Humanoid Walk")
            for t, (s, info, _) in enumerate(outs):
                assert rel(st["walk_residual"][:, t], walk.residual(
                    port_model(name), s, info, t64(start(name)[2]))) < 1e-9
        if name in TOPK:
            # the JAX CPU step keeps the 16 smallest gaps: the usual
            # premise is that every loaded slot is among them; the same
            # 8-iteration solve needs more, that no dropped slot's row is
            # active at any point of any iteration's line search
            cpu = refs[name]["cpu_step"]
            gaps = np.asarray(st["info"]["contact_dist"])
            cut = np.sort(gaps, axis=-1)[..., 15:16]
            ok = np.all(~loaded | (gaps <= cut), axis=-1)       # (B, T)
            same = np.stack([_same_problem(port_model(name), s.qpos, s.qvel,
                                           t64(start(name)[2]), 16)
                             for s, _, _ in outs], axis=1)
            report[name] = dict(premise_fails=int((~ok).sum()),
                                solve_differs=int((ok & ~same).sum()),
                                steps=int(ok.size))
            assert same.any(), (name, report[name])
            for t in range(STEPS):
                for e in np.flatnonzero(same[:, t]):
                    nxt = outs[t + 1][0] if t + 1 < STEPS else s_end
                    assert rel(cpu["qvel"][e, t], nxt.qvel[e]) < 1e-9, \
                        (name, t, e)
    return report


def _same_problem(m, qpos, qvel, ctrl, k):
    """(B,) whether the top-k solve is the selection-free one, step for
    step: every slot outside the k smallest gaps (a stable sort, as the
    selection) has each of its pyramid rows inactive (r >= 0) at every
    point of every iteration's line-search grid (r + 4 J p >= 0), so it
    adds nothing to any gradient, Hessian or line search."""
    kin, _, M, qf = tengine.prepare_smooth(m, qpos, qvel, ctrl)
    c = tcol.collide(m, kin.xpos, kin.xmat)
    dmask, rel_, mu3, kc, bc, dc = contact_raw(m, kin, c)
    lpos, kl, bl, dl = limit_rows_data(m, qpos)
    rows = rows_from_raw(kin.cdof, dmask, rel_, c.normal, c.dist, mu3, kc,
                         bc, dc, limit_rows_static(m), lpos, kl, bl, dl)
    Mchol = linalg.chol_factor(M)
    trace = []
    newton_solve(M, Mchol, qf, finish_efc(rows, qvel, Mchol), trace=trace)
    B, K, nlim = qpos.shape[0], m.ncon, lpos.shape[1]
    kept = torch.zeros((B, K), dtype=torch.bool)
    kept.scatter_(1, torch.sort(c.dist, dim=-1, stable=True).indices[:, :k],
                  True)
    ok = torch.ones(B, dtype=torch.bool)
    for r, Jp in trace:
        act = (r[:, nlim:] < 0) | (r[:, nlim:] + 4.0 * Jp[:, nlim:] < 0)
        act = act.reshape(B, 10, K).any(dim=1)
        ok &= ~(act & ~kept).any(dim=1)
    return ok.numpy()


def check_transitions(refs):
    for name in MODELS:
        ref = refs[name]["transitions"]
        st = refs[name]["rollout"]["steps"]
        m, task = port_model(name), port_task(name)
        info = tstepinfo(st["info"], 0)
        s = State(t64(st["qpos"][0:1, 0]), t64(st["qvel"][0:1, 0]),
                  torch.full((1,), 0.01, dtype=F64))
        out = task.transition(m, s, info)
        _same_task(ref["plain"], out, name)
        if name == "OP3":
            out = task.set_mode("Handstand").transition(m, s, info)
            _same_task(ref["handstand"], out, name)
            assert abs(float(out.params[0]) - 0.57) < 1e-12
        if name == "Quadrotor":
            pos = task.mocap_pos.clone()
            pos[0] = info.xpos[0, 0] + 0.1
            out = dataclasses.replace(task, mocap_pos=pos).transition(
                m, s, info)
            _same_task(ref["advance"], out, name)
            assert int(out.mode) == 1
    # the respawn rules where the goal is reached: a new goal in range
    for name, off in (("Panda", None), ("Bimanual Handover", None)):
        m, task = port_model(name), port_task(name)
        st = refs[name]["rollout"]["steps"]
        info = tstepinfo(st["info"], 0)
        s = State(t64(st["qpos"][0:1, 0]), t64(st["qvel"][0:1, 0]),
                  torch.full((1,), 0.5, dtype=F64))
        if name == "Panda":
            sx = info.site_xpos[0]
            mid = 0.5 * (sx[m.struct.site_id("box1")]
                         + sx[m.struct.site_id("box2")])
            pos = task.mocap_pos.clone()
            pos[0] = mid
            q = task.mocap_quat.clone()
            # the box's own orientation puts its faces on the target's
            q[0] = info.xquat[0, m.struct.body_id("box")]
            t = dataclasses.replace(task, mocap_pos=pos, mocap_quat=q)
            out = t.transition(m, s, info)
            assert not torch.equal(out.mocap_pos[0], pos[0])
            assert -0.5 <= float(out.mocap_pos[0, 0]) <= 0.5
            assert 0.03 <= float(out.mocap_pos[0, 2]) <= 1.0
            assert abs(float(out.mocap_quat[0].norm()) - 1.0) < 1e-12
        else:
            pos = task.mocap_pos.clone()
            pos[0] = info.xpos[0, m.struct.body_id("box")]
            out = dataclasses.replace(task, mocap_pos=pos).transition(
                m, s, info)
            new = out.mocap_pos[0]
            assert 0.3 <= abs(float(new[0])) <= 0.4
            assert float(new[0]) * float(pos[0, 0]) <= 0.0
            assert 0.2 <= abs(float(new[1])) <= 0.3
            assert 0.25 <= float(new[2]) <= 0.7


def tstepinfo(info_np, t):
    """The port's StepInfo of batch 1 from a reference rollout's env 0
    at step t."""
    from humanoid_mujoco_torch.physics.step import StepInfo
    return StepInfo(**{k: t64(v[0:1, t]) if np.asarray(v).ndim > 1
                       else torch.as_tensor(np.asarray(v)[0:1, t])
                       for k, v in info_np.items()})


def _same_task(ref, out, name):
    for k in ("weights", "params", "mocap_pos", "mocap_quat"):
        assert rel(ref[k], getattr(out, k)) < 1e-12, (name, k)
    assert int(ref["mode"]) == int(out.mode), name


def check_rk4(refs):
    for name in RK4:
        m = port_model(name)
        qpos, qvel, ctrl = start(name, seed=4)
        s2, _ = step_rk4(m, State(t64(qpos), t64(qvel),
                                  torch.zeros(B, dtype=F64)), t64(ctrl))
        rq, rv = refs[name]["rk4"]
        assert rel(rq, s2.qpos) < 1e-9 and rel(rv, s2.qvel) < 1e-9, name


def check_derivatives(refs):
    """forward(ift=True) and step(ift=True) against JAX at 1e-9; the
    tangent Jacobians
    against central differences of the port's own step(ift=True) (eps
    1e-6, every column) at 1e-6 of the largest entry, and against JAX's
    jacfwd: at 1e-7 on the upstream humanoid; on the Handover JAX's
    jacfwd sits 1.2e-5 (relative) off both the port and the central
    differences on the cube's rows (e.g. A[41, 18]: port and differences
    178.0809410, JAX 178.0787859), so there it is held at 1e-4 and the
    differences decide."""
    for name in DERIVS:
        ref = refs[f"{name} derivs"]
        m = port_model(name)
        qpos, qvel, ctrl = (t64(x) for x in start(name, n=1, seed=8))
        t0 = torch.zeros(1, dtype=F64)
        s = State(qpos, qvel, t0)
        qacc = forward(m, s, ctrl, ift=True)[0]
        assert rel(ref["qacc"], qacc[0]) < 1e-9, name
        q1, v1 = t64(ref["next_qpos"])[None], t64(ref["next_qvel"])[None]
        s1, _ = step(m, s, ctrl, ift=True)
        assert rel(q1, s1.qpos) < 1e-9 and rel(v1, s1.qvel) < 1e-9, name
        A, Bm = tder.step_tangent_jacobians(m, qpos, qvel, ctrl, t0, q1, v1,
                                            ift=True)
        J = torch.cat([A[0], Bm[0]], dim=1)
        nv, n = m.nv, 2 * m.nv + m.nu
        eps = 1e-6
        Z = eps * torch.eye(n, dtype=F64)
        Z = torch.cat([Z, -Z])
        sp = State(qpos=tangent.state_add(m, qpos.expand(2 * n, -1),
                                          Z[:, :nv]),
                   qvel=qvel + Z[:, nv:2 * nv], time=t0.expand(2 * n))
        s2, _ = step(m, sp, ctrl + Z[:, 2 * nv:], ift=True)
        fd = tangent.state_diff(m, s2.qpos[:n], s2.qvel[:n], s2.qpos[n:],
                                s2.qvel[n:]) / (2 * eps)
        assert rel(fd.T, J) < 1e-6, (name, rel(fd.T, J))
        tol = 1e-7 if name == "Humanoid Stand" else 1e-4
        assert rel(ref["A"], A[0]) < tol, (name, rel(ref["A"], A[0]))
        assert rel(ref["B"], Bm[0]) < tol, (name, rel(ref["B"], Bm[0]))
        assert bool(torch.isfinite(J).all())


def check_plan(refs):
    name = "Bimanual Handover"
    m, task = port_model(name), port_task(name)
    cfg = SamplingConfig(nsample=PLAN_N, nknots=PLAN_K, horizon=PLAN_H,
                         order=SplineOrder.LINEAR, solver_iters=1)
    s0 = tmodel.make_state(m, qpos=registry.home_qpos(name, m))
    pol = init_policy(m, PLAN_K)
    pol = SplinePolicy(times=pol.times, values=taloha.home_ctrl(m)[None]
                       .expand(PLAN_K, -1).clone())
    for it in refs["plan"]:
        pol, info = sampling_plan(m, task, cfg, pol, s0,
                                  noise=t64(it["noise"]))
        assert rel(it["returns"], info.returns) < 1e-9
        assert int(info.winner) == it["winner"]
        assert rel(it["values"], pol.values) < 1e-12
        assert rel(it["times"], pol.times) < 1e-12


def check_witness(refs):
    """The port's step at one solver iteration diverges each witness
    candidate at the step the JAX kernel branch does (float64): the
    Handover cell's candidates diverging (PERF.md) is the reference's
    behaviour, not the port's. The port makes the candidates and their
    controls as its sampling plan does."""
    name = "Bimanual Handover"
    ref = refs["witness"]
    m = port_model(name)
    cfg = SamplingConfig(nsample=B, nknots=PLAN_K, horizon=WITNESS_H,
                         order=SplineOrder.LINEAR, solver_iters=1)
    s0 = tmodel.make_state(m, qpos=registry.home_qpos(name, m))
    pol = init_policy(m, PLAN_K)
    pol = SplinePolicy(times=pol.times, values=taloha.home_ctrl(m)[None]
                       .expand(PLAN_K, -1).clone())
    nominal = plan_nominal(m, cfg, pol, s0, "witness")
    times, _, noise, _ = witness_inputs(m.act_ctrlrange.numpy(),
                                        taloha.home_ctrl(m).numpy(),
                                        float(m.dt))
    cands = sample_candidates(m, cfg, nominal.values, noise=t64(noise))
    assert rel(times, nominal.times) < 1e-12
    assert rel(ref["values"], cands) < 1e-12
    lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
    s = State(s0.qpos.expand(B, -1), s0.qvel.expand(B, -1),
              torch.zeros(B, dtype=F64))
    div = []
    for t in range(WITNESS_STEPS):
        u = torch.clamp(spline_sample(nominal.times, cands, s.time,
                                      SplineOrder.LINEAR), lo, hi)
        assert rel(ref["ctrl"][:, t], u) < 1e-12, t
        s, info = step(m, s, u, solver_iters=1)
        div.append(info.diverged.numpy())
    first = _first_diverged(np.stack(div, axis=1))
    assert np.array_equal(first, ref["first"]), (first, ref["first"])
    return first.tolist()


def run_reference_checks(references=None):
    refs = _merged(references)
    check_geometry(refs)
    report = check_steps(refs)
    check_transitions(refs)
    check_rk4(refs)
    check_derivatives(refs)
    check_plan(refs)
    witness = check_witness(refs)
    print("top-16 premise failures (steps):", report)
    print("Handover witness, first diverged step per candidate:", witness)


def run_checks(references=None):
    run_local_checks()
    run_reference_checks(references)
