"""Port parity: the serving slice against the JAX package.

Float64 on the CPU (the JAX side runs with x64), the same numpy-seeded
inputs through both packages; tolerances are max-abs error over max-abs
value:

- `collision.select_contacts` against the JAX `select_contacts` on the
  stand pose, whose mirrored spheres tie at the 32nd slot, and on gaps
  with ties planted across the cut (`sel` equal);
- `step.forward` on the stand pose and three noisy states at 1e-9: qacc,
  qfrc_total, M and every StepInfo leaf;
- `find_ideal_root_height`: the 200 candidate scores (the JAX package's
  score of a height, written out over its vmapped `forward` with 6
  solver iterations) at 1e-9 and the chosen candidate's index exactly;
  the grid itself agrees to one unit in the last place, since
  `jnp.linspace` and `torch.linspace` round differently;
  `set_robot_state` (with the search) at 1e-12;
- `mppi_plan` and two `cem_plan` iterations (the second from the first's
  `CEMState.std`) on a plan model of dt 0.02, with the JAX draws fed in,
  at 1e-9; the stable elite order on tied returns against
  `jax.lax.top_k`;
- `Agent` with the sampling planner (4 samples, horizon 3): two
  `planner_step`s with the noise the JAX agent derives from its key,
  `get_action` at the state's time, at a given time and averaged over 3
  sim steps, `step`, the cost-weight, task-parameter, residual and
  cost-term verbs, `set_anything` on the task, `best_trajectory`, at
  1e-9; `set_anything` on the model (a new Model, the old leaves kept),
  the default planner ("ilqg", held to JAX in tests/test_torch_ilqg.py)
  and the unknown-planner error;
- `MPCServer.handle` over `socket.socketpair()` (timeouts 10 s): the
  round trip against `compute_action` of a twin agent, a malformed
  request's error reply, two coalesced requests, position mode; the
  async mode answering a request, an unknown filter's ValueError, the
  EKF mode accepted (tests/test_torch_estimation.py serves through it);
- `rl.evaluate.run_episodes`: 2 episodes x 5 steps at randomization
  factors 0 and 1, the policy's parameters carried from flax
  (`params_from_flax`), the reset and step draws from the JAX keys,
  against the JAX policy's actions and the JAX env (on its kernel path,
  as tests/test_torch_rl.py runs it) at 1e-6; `evaluate` end to end on a
  port checkpoint (eval.csv, traj files);
- a 3-tick `mpc_in_env.run` on the CPU, which returns the JAX `run`'s
  keys, and a 1-tick run with the default planner, iLQG. Its parts are
  held to JAX above; the loop as a whole is not compared, since the
  port's env draws and torque noise come from torch generators and the
  JAX package's from its keys.

The JAX planners step on the CPU with the JAX `step`, which keeps the 32
contact slots with the smallest gaps; the port's step is selection-free
(ROADMAP queue 3 item 3). The states here are near the stand pose,
where every loaded slot is among those 32, so the two solve the same
problem. The four JAX references (physics, planners, agent, evaluate;
jit compiles of the humanoid step) are built in processes of their own
by tests/test_torch_port.py, which runs these checks as the port's one
collected test and hands the results to `run_reference_checks`.
"""

import contextlib
import dataclasses
import functools
import json
import os
import socket
import tempfile
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu import rollout as jrollout
from humanoid_mujoco_tpu.agent import Agent as JAgent
from humanoid_mujoco_tpu.mpc import make_plan_model as j_plan_model
from humanoid_mujoco_tpu.physics import collision as jcol
from humanoid_mujoco_tpu.physics import engine as jengine
from humanoid_mujoco_tpu.physics import humanoid as jh
from humanoid_mujoco_tpu.physics import step as jstep
from humanoid_mujoco_tpu.physics.model import State as JState
from humanoid_mujoco_tpu.physics.model import make_state as j_make_state
from humanoid_mujoco_tpu.planners import cem as jcem
from humanoid_mujoco_tpu.planners import mppi as jmppi
from humanoid_mujoco_tpu.planners import policy as jpolicy
from humanoid_mujoco_tpu.rl import env as jenv
from humanoid_mujoco_tpu.rl import networks as jnet
from humanoid_mujoco_tpu.serving import state_estimation as jse
from humanoid_mujoco_tpu.tasks import stand_task as j_stand_task

from humanoid_mujoco_torch import mpc_in_env
from humanoid_mujoco_torch.agent import Agent
from humanoid_mujoco_torch.mpc import make_plan_model
from humanoid_mujoco_torch.physics import collision as tcol
from humanoid_mujoco_torch.physics import engine as tengine
from humanoid_mujoco_torch.physics import humanoid as th
from humanoid_mujoco_torch.physics.model import make_state
from humanoid_mujoco_torch.physics.step import forward
from humanoid_mujoco_torch.planners import (CEMConfig, MPPIConfig, cem_init,
                                            cem_plan, init_policy,
                                            mppi_plan)
from humanoid_mujoco_torch.planners.cem import CEMState, elite_indices
from humanoid_mujoco_torch.rl import env as tenv
from humanoid_mujoco_torch.rl import evaluate as teval
from humanoid_mujoco_torch.rl.networks import params_from_flax
from humanoid_mujoco_torch.serving import (MPCServer, find_ideal_root_height,
                                           root_height_scores,
                                           set_robot_state)
from humanoid_mujoco_torch.tasks import home_qpos, stand_task, task_model

import test_torch_refs as refs
import test_torch_rl as trl

torch.set_num_threads(1)
# tests/conftest.py sets this too; the references run in processes of
# their own, which do not import conftest
jax.config.update("jax_enable_x64", True)

F64 = torch.float64
N, KNOTS, HORIZON, PLAN_DT = 4, 3, 3, 0.02
CEM_N, CEM_ELITE = 8, 3
EVAL_EPISODES, EVAL_STEPS, EVAL_RFS = 2, 5, (0.0, 1.0)
EVAL_HIDDEN = (128, 128, 128)    # the JAX load_policy's widths


def rel(ref, out):
    r = np.asarray(ref, np.float64)
    o = (out.detach().cpu().numpy() if torch.is_tensor(out)
         else np.asarray(out)).astype(np.float64)
    assert r.shape == o.shape, (r.shape, o.shape)
    return float(np.max(np.abs(r - o)) / (np.max(np.abs(r)) + 1e-300))


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


@functools.lru_cache(maxsize=None)
def jm64():
    return jh.build_humanoid(dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def tm64():
    return th.build_humanoid(dtype=F64, device="cpu")


def inputs():
    """The numpy-seeded inputs every reference and check shares."""
    rng = np.random.default_rng(0)
    q0 = np.asarray(jh.stand_qpos(jm64()))
    qpos = np.tile(q0, (4, 1))
    qpos[1:, 7:] += 0.02 * rng.standard_normal((3, 12))
    qpos[3, 2] -= 0.005
    qvel = 0.1 * rng.standard_normal((4, 18))
    qvel[0] = 0.0
    ctrl = 0.2 * rng.standard_normal((4, 12))
    quat = q0[3:7] + 0.02 * rng.standard_normal(4)
    quat = 1.02 * quat / np.linalg.norm(quat)      # not a unit quaternion
    obs = dict(joint_pos=q0[7:] + 0.02 * rng.standard_normal(12),
               joint_vel=0.1 * rng.standard_normal(12),
               ang_vel=0.1 * rng.standard_normal(3), quat=quat)
    agent_q = q0 + np.concatenate([np.zeros(7),
                                   0.01 * rng.standard_normal(12)])
    agent_v = 0.05 * rng.standard_normal(18)
    dist = rng.uniform(-0.01, 0.2, 67)
    dist[[3, 10, 40, 41, 66]] = np.sort(dist)[31]  # ties across the cut
    return dict(qpos=qpos, qvel=qvel, ctrl=ctrl, obs=obs, agent_q=agent_q,
                agent_v=agent_v, dist=dist)


def tie_cut(dist):
    """A k that cuts between two exactly equal gaps: the mirrored
    spheres of the symmetric stand pose tie."""
    d = np.sort(dist)
    i = int(np.flatnonzero(d[1:] == d[:-1])[0])
    return i + 1


# ---------------------------------------------------------------------------
# JAX references (each built in a process of its own)
# ---------------------------------------------------------------------------

def _jax_physics():
    jm = jm64()
    x = inputs()
    # select_contacts at the stand pose and on planted ties
    kin = jengine.fwd_position(jm, jnp.asarray(x["qpos"][0]))
    con = jcol.collide(jm, kin.xpos, kin.xmat)
    _, sel = jcol.select_contacts(con, 32)
    k_tie = tie_cut(np.asarray(con.dist))
    _, sel_k = jcol.select_contacts(con, k_tie)
    tied = dataclasses.replace(con, dist=jnp.asarray(x["dist"]))
    _, sel_tied = jcol.select_contacts(tied, 32)
    # forward on the stand pose and three noisy states
    fwd = jax.jit(jax.vmap(lambda q, v, c: jstep.forward(
        jm, JState(q, v, jnp.asarray(0.0)), c)))
    qacc, qfrc, M, info = fwd(x["qpos"], x["qvel"], x["ctrl"])
    # the root-height search: the JAX package's score of each candidate
    # (state_estimation.py:40-53) over its vmapped forward, and its pick
    o = x["obs"]
    zs = jnp.linspace(-0.7, -0.2, 200)

    def score(z):
        q = j_make_state(jm).qpos
        q = q.at[0:3].set(jnp.asarray([0.0, 0.0, z]))
        q = q.at[3:7].set(jnp.asarray(o["quat"]))
        q = q.at[7:].set(jnp.asarray(o["joint_pos"]))
        s = JState(qpos=q, qvel=jnp.zeros(jm.nv), time=jnp.asarray(0.0))
        qa, _, _, inf = jstep.forward(jm, s, jnp.zeros(jm.nu),
                                      solver_iters=6)
        pen = jnp.sum(jnp.clip(-inf.contact_dist, 0.0, jnp.inf))
        return jnp.abs(qa[2]) + 100.0 * pen
    scores = jax.jit(jax.vmap(score))(zs)
    z = jse.find_ideal_root_height(jm, jnp.asarray(o["joint_pos"]),
                                   jnp.asarray(o["quat"]))
    state = jse.set_robot_state(jm, o["joint_pos"], o["joint_vel"],
                                o["ang_vel"], o["quat"])
    return dict(sel=np.asarray(sel), k_tie=k_tie, sel_k=np.asarray(sel_k),
                sel_tied=np.asarray(sel_tied),
                forward=[np.asarray(qacc), np.asarray(qfrc), np.asarray(M),
                         trl.tree_np(info)],
                zs=np.asarray(zs), scores=np.asarray(scores),
                z=float(z), robot_state=trl.tree_np(state))


@contextlib.contextmanager
def kernel_path_rollouts():
    """Within the block, the JAX rollouts step on the kernel path's
    semantics (selection-free, test_torch_rl.jax_kernel_path_step), as
    the port does everywhere."""
    step = jrollout.step
    jrollout.step = trl.jax_kernel_path_step
    try:
        yield
    finally:
        jrollout.step = step


def _jax_planners():
    """MPPI and CEM on the kernel path: CEM's candidates (std 0.1) load
    a slot outside the 32 smallest gaps within 3 plan steps, where the
    JAX CPU step's top-32 selection is another algorithm."""
    with kernel_path_rollouts():
        return _jax_planners_on_kernel_path()


def _jax_planners_on_kernel_path():
    jm = jm64()
    pm = j_plan_model(jm, PLAN_DT)
    task = j_stand_task(dtype=jnp.float64)
    s0 = j_make_state(jm, qpos=jh.stand_qpos(jm))
    pol = jpolicy.init_policy(jm, KNOTS)
    mcfg = jmppi.MPPIConfig(nsample=N, nknots=KNOTS, horizon=HORIZON)
    key = jax.random.PRNGKey(1)
    new_pol, info = jax.jit(lambda p, s, k: jmppi.mppi_plan(
        pm, task, mcfg, p, s, k))(pol, s0, key)
    k_noise, _ = jax.random.split(key)
    out = dict(mppi=dict(
        noise=np.asarray(jax.random.normal(k_noise, (N, KNOTS, 12),
                                           dtype=jnp.float64)),
        values=np.asarray(new_pol.values), times=np.asarray(new_pol.times),
        info=trl.tree_np(info)))
    ccfg = jcem.CEMConfig(nsample=CEM_N, nknots=KNOTS, horizon=HORIZON,
                          n_elite=CEM_ELITE)
    plan = jax.jit(lambda p, c, s, k: jcem.cem_plan(pm, task, ccfg, p, c, s,
                                                    k))
    cs, p, iters = jcem.cem_init(jm, ccfg), pol, []
    for key in (jax.random.PRNGKey(2), jax.random.PRNGKey(3)):
        p, cs, info = plan(p, cs, s0, key)
        iters.append(dict(
            noise=np.asarray(jax.random.normal(key, (CEM_N, KNOTS, 12),
                                               dtype=jnp.float64)),
            values=np.asarray(p.values), std=np.asarray(cs.std),
            info=trl.tree_np(info)))
    out["cem"] = iters
    return out


def _agent_noise(rng):
    """The JAX agent's split, then sample_candidates' noise draw."""
    rng, key = jax.random.split(rng)
    k_noise, _ = jax.random.split(key)
    return rng, np.asarray(jax.random.normal(k_noise, (N, KNOTS, 12),
                                             dtype=jnp.float64))


def _jax_agent():
    jm = jm64()
    x = inputs()
    a = JAgent(jm, j_stand_task(dtype=jnp.float64), planner="sampling",
               horizon=HORIZON, nsample=N, seed=0)
    a.set_state(qpos=x["agent_q"], qvel=x["agent_v"], time=0.0)
    rng, noise1 = _agent_noise(jax.random.PRNGKey(0))
    r = dict(noise1=noise1)
    r["best1"] = a.planner_step()
    r["returns1"] = np.asarray(a._last_info.returns)
    r["traj1"] = a.best_trajectory()
    r["action"] = a.get_action()
    r["action_t"] = a.get_action(time=0.013)
    r["action_avg"] = a.get_action(averaging_duration=0.006)
    r["u_step"] = a.step()
    r["state"] = a.get_state()
    r["residuals"] = a.get_residuals()
    r["terms"] = a.get_cost_term_values()
    a.set_cost_weights({"Balance": 20.0})
    a.set_task_parameter("Height Goal", 0.4)
    r["weights"] = a.get_cost_weights()
    r["terms2"] = a.get_cost_term_values()
    a.set_anything(task={"risk": 0.3, "Control": 0.05})
    r["terms3"] = a.get_cost_term_values()
    rng, r["noise2"] = _agent_noise(rng)
    r["best2"] = a.planner_step()
    r["returns2"] = np.asarray(a._last_info.returns)
    r["traj2"] = a.best_trajectory()
    return r


def _jax_evaluate():
    """The JAX evaluate's episode loop (rl/evaluate.py:49-76) on its
    kernel-path env: 2 episodes x 5 steps per randomization factor, the
    deterministic actor of a flax GaussianPolicy at the widths of the JAX
    load_policy, with the draws each reset and step takes."""
    jm = trl.jm_f64()
    cfg = trl.CFG
    policy = jnet.GaussianPolicy(12, EVAL_HIDDEN, state_dependent_std=True)
    params = policy.init(jax.random.PRNGKey(3), jnp.zeros((1, 30)))
    act = jax.jit(lambda o: jnp.tanh(policy.apply(params, o)[0]))
    reset = jax.jit(lambda rf, k: jenv.batch_reset(cfg, jm, rf, k))
    stp = jax.jit(lambda e, a: jenv.batch_step(cfg, jm, e, a))
    out = dict(params=trl.tree_np(params), rfs=[])
    for rf in EVAL_RFS:
        keys = jax.random.split(jax.random.PRNGKey(0), EVAL_EPISODES)
        es, obs = reset(jnp.asarray(rf), keys)
        rd = trl.tree_np(jax.vmap(lambda k: trl.jax_reset_draws(
            k, jm.struct))(keys))
        total_r = np.zeros(EVAL_EPISODES)
        alive = np.ones(EVAL_EPISODES, bool)
        lengths = np.zeros(EVAL_EPISODES)
        success = np.zeros(EVAL_EPISODES, bool)
        rec = dict(obs=[np.asarray(obs)], act=[], qpos=[], draws=[])
        for t in range(EVAL_STEPS):
            sd, _ = jax.vmap(trl.jax_step_draws)(es.rng)
            rec["draws"].append(trl.tree_np(sd))
            a = act(obs)
            es, obs, r, term, trunc = stp(es, a)
            term, trunc = np.array(term), np.array(trunc)
            total_r += np.array(r) * alive
            lengths += alive
            success |= trunc & alive
            alive &= ~(term | trunc)
            rec["act"].append(np.asarray(a))
            rec["obs"].append(np.asarray(obs))
            rec["qpos"].append(np.asarray(es.phys.qpos))
            if not alive.any():
                break
        out["rfs"].append(dict(
            reset_draws=rd, **rec,
            stats=dict(mean_reward=float(total_r.mean()),
                       mean_episode_len=float(lengths.mean()),
                       success_rate=float(success.mean()))))
    return out


_BUILD = {"physics": _jax_physics, "planners": _jax_planners,
          "agent": _jax_agent, "evaluate": _jax_evaluate}
_RESULTS = {}
NAMES = tuple(_BUILD)


def reference(name: str):
    """The JAX reference `name`, built once per process; the evaluate
    reference's env steps on the JAX kernel path (test_torch_rl)."""
    if name not in _RESULTS:
        with trl.kernel_path():
            _RESULTS[name] = _BUILD[name]()
    return _RESULTS[name]


def mass_matrices(name):
    """Mass matrices of reference `name`'s model (the RL env's humanoid
    for evaluate, else the humanoid), at the stand pose, for the
    loop-form Cholesky check (tests/test_torch_refs.py)."""
    m = trl.base_f64() if name == "evaluate" else tm64()
    return [refs.at_rest(name, m, th.stand_qpos(m).numpy())]


# ---------------------------------------------------------------------------
# checks against the references
# ---------------------------------------------------------------------------

def check_select_contacts():
    c, x, m = reference("physics"), inputs(), tm64()
    kin = tengine.fwd_position(m, t64(x["qpos"][:1]))
    con = tcol.collide(m, kin.xpos, kin.xmat)
    red, sel = tcol.select_contacts(con, 32)
    assert np.array_equal(sel[0].numpy(), c["sel"])
    assert torch.equal(red.dist[0], con.dist[0, sel[0]])
    assert torch.equal(red.normal[0], con.normal[0, sel[0]])
    k = tie_cut(con.dist[0].numpy())
    assert k == c["k_tie"]
    _, sel_k = tcol.select_contacts(con, k)
    assert np.array_equal(sel_k[0].numpy(), c["sel_k"])
    tied = dataclasses.replace(con, dist=t64(x["dist"])[None])
    _, sel_t = tcol.select_contacts(tied, 32)
    assert np.array_equal(sel_t[0].numpy(), c["sel_tied"])


def check_forward():
    c, x, m = reference("physics"), inputs(), tm64()
    s = make_state(m, qpos=t64(x["qpos"]), qvel=t64(x["qvel"]))
    qacc, qfrc, M, info = forward(m, s, t64(x["ctrl"]))
    ref_qacc, ref_qfrc, ref_M, ref_info = c["forward"]
    assert rel(ref_qacc, qacc) < 1e-9
    assert rel(ref_qfrc, qfrc) < 1e-9
    assert rel(ref_M, M) < 1e-9
    for f in dataclasses.fields(info):
        r, o = ref_info[f.name], getattr(info, f.name)
        if o.dtype == torch.bool:
            assert np.array_equal(r, o.numpy()), f.name
        else:
            assert rel(r, o) < 1e-9, (f.name, rel(r, o))
    assert float(info.contact_force.sum()) > 0


def check_root_height_and_robot_state():
    c, x, m = reference("physics"), inputs(), tm64()
    o = x["obs"]
    zs, scores = root_height_scores(m, o["joint_pos"], o["quat"])
    assert np.max(np.abs(zs.numpy() - c["zs"]) / np.spacing(c["zs"])) <= 1
    assert rel(c["scores"], scores) < 1e-9
    z = find_ideal_root_height(m, o["joint_pos"], o["quat"])
    i_ref = int(np.argmin(c["scores"]))
    assert int(torch.argmin(scores)) == i_ref
    assert c["z"] == c["zs"][i_ref]
    assert abs(float(z) - c["z"]) <= np.spacing(abs(c["z"]))
    s = set_robot_state(m, o["joint_pos"], o["joint_vel"], o["ang_vel"],
                        o["quat"])
    ref = c["robot_state"]
    assert s.batch == 1
    assert rel(ref["qpos"], s.qpos[0]) < 1e-12
    assert rel(ref["qvel"], s.qvel[0]) < 1e-12
    assert float(s.time[0]) == float(ref["time"])


def check_mppi_and_cem():
    c = reference("planners")
    m = tm64()
    pm = make_plan_model(m, PLAN_DT)
    task = stand_task(dtype=F64, device="cpu")
    s0 = make_state(m, qpos=th.stand_qpos(m))
    pol = init_policy(m, KNOTS)
    r = c["mppi"]
    new_pol, info = mppi_plan(pm, task, MPPIConfig(nsample=N, nknots=KNOTS,
                                                   horizon=HORIZON),
                              pol, s0, noise=t64(r["noise"]))
    assert rel(r["info"]["returns"], info.returns) < 1e-9
    assert int(info.winner) == int(r["info"]["winner"])
    assert rel(r["info"]["best_return"], info.best_return) < 1e-9
    assert rel(r["values"], new_pol.values) < 1e-9
    assert rel(r["times"], new_pol.times) < 1e-12
    cfg = CEMConfig(nsample=CEM_N, nknots=KNOTS, horizon=HORIZON,
                    n_elite=CEM_ELITE)
    cs, p = cem_init(m, cfg), pol
    for it in c["cem"]:
        p, cs, info = cem_plan(pm, task, cfg, p, cs, s0,
                               noise=t64(it["noise"]))
        assert rel(it["info"]["returns"], info.returns) < 1e-9
        assert int(info.winner) == int(it["info"]["winner"])
        assert rel(it["values"], p.values) < 1e-9
        assert rel(it["std"], cs.std) < 1e-9
    assert isinstance(cs, CEMState)


def check_stable_elites():
    """Ties at MAX_RETURN and among finite returns: the elites and their
    order are lax.top_k's."""
    r = np.array([1e6, 3.0, 1e6, 2.0, 3.0, 1e6, 1e6, 0.5, 3.0, 1e6])
    for k in (3, 5, 6, 8):
        _, idx = jax.lax.top_k(-jnp.asarray(r), k)
        assert np.array_equal(np.asarray(idx),
                              elite_indices(t64(r), k).numpy()), k


def check_agent():
    c, x = reference("agent"), inputs()
    m = tm64()
    a = Agent(m, stand_task(dtype=F64, device="cpu"), planner="sampling",
              horizon=HORIZON, nsample=N, seed=0)
    a.set_state(qpos=x["agent_q"], qvel=x["agent_v"], time=0.0)
    best = a.planner_step(noise=t64(c["noise1"]))
    assert rel(c["returns1"], a._last_info.returns) < 1e-9
    assert rel(c["best1"], best) < 1e-9
    for k in ("times", "knots"):
        assert rel(c["traj1"][k], a.best_trajectory()[k]) < 1e-9, k
    assert rel(c["action"], a.get_action()) < 1e-9
    assert rel(c["action_t"], a.get_action(time=0.013)) < 1e-9
    assert rel(c["action_avg"], a.get_action(averaging_duration=0.006)) \
        < 1e-9
    assert rel(c["u_step"], a.step()) < 1e-9
    st = a.get_state()
    for k in ("qpos", "qvel"):
        assert rel(c["state"][k], st[k]) < 1e-9, k
    assert abs(st["time"] - c["state"]["time"]) < 1e-15
    assert rel(c["residuals"], a.get_residuals()) < 1e-9

    def same_terms(ref, out):
        assert ref.keys() == out.keys()
        assert rel(list(ref.values()), list(out.values())) < 1e-9
    same_terms(c["terms"], a.get_cost_term_values())
    a.set_cost_weights({"Balance": 20.0})
    a.set_task_parameter("Height Goal", 0.4)
    assert a.get_cost_weights() == pytest.approx(c["weights"], rel=1e-15)
    same_terms(c["terms2"], a.get_cost_term_values())
    a.set_anything(task={"risk": 0.3, "Control": 0.05})
    same_terms(c["terms3"], a.get_cost_term_values())
    best = a.planner_step(noise=t64(c["noise2"]))
    assert rel(c["returns2"], a._last_info.returns) < 1e-9
    assert rel(c["best2"], best) < 1e-9
    for k in ("times", "knots"):
        assert rel(c["traj2"][k], a.best_trajectory()[k]) < 1e-9, k


def _eval_actor(c):
    return teval.policy_actor(params_from_flax(c["params"]), device="cpu",
                              dtype=F64)


def check_run_episodes():
    c = reference("evaluate")
    base = trl.base_f64()
    act = _eval_actor(c)
    for rf, r in zip(EVAL_RFS, c["rfs"]):
        es, obs = tenv.env_reset(trl.TCFG, base, rf,
                                 trl.reset_draws(r["reset_draws"]))
        seen = dict(obs=[], act=[], qpos=[])
        draws = iter(r["draws"])

        def recording_act(o):
            a = act(o)
            seen["obs"].append(o)
            seen["act"].append(a)
            return a

        def next_draws(e):
            if len(seen["act"]) > 1:      # the state after the last step
                seen["qpos"].append(e.phys.qpos)
            return trl.step_draws(next(draws))
        stats, traj = teval.run_episodes(trl.TCFG, base, recording_act, es,
                                         obs, EVAL_STEPS, next_draws)
        n = len(r["act"])
        assert len(seen["act"]) == n
        for t in range(n):
            assert rel(r["obs"][t], seen["obs"][t]) < 1e-6, (rf, t)
            assert rel(r["act"][t], seen["act"][t]) < 1e-6, (rf, t)
        for t in range(n - 1):
            assert rel(r["qpos"][t], seen["qpos"][t]) < 1e-6, (rf, t)
        for k, v in r["stats"].items():
            assert abs(v - stats[k]) <= 1e-6 * max(1.0, abs(v)), (rf, k)
        assert rel(r["qpos"][0][0], traj[0]) < 1e-6
        assert traj.shape == (1, 19)


# ---------------------------------------------------------------------------
# checks of the port alone
# ---------------------------------------------------------------------------

def small_agent(seed=0, dtype=torch.float32):
    m = th.build_humanoid(dtype=dtype, device="cpu")
    return Agent(m, stand_task(dtype=dtype, device="cpu"),
                 planner="sampling", horizon=HORIZON, nsample=N, seed=seed)


def check_agent_errors_and_model_edit():
    m = tm64()
    task = stand_task(dtype=F64, device="cpu")
    a = Agent(m, task, horizon=2)                # the default, "ilqg"
    assert a.planner == "ilqg" and a.cfg.horizon == 2
    with pytest.raises(ValueError, match="unknown planner"):
        Agent(m, task, planner="bogus")
    for p in ("cem", "mppi"):
        a = Agent(m, task, planner=p, horizon=2, nsample=8)
        a.set_state(qpos=th.stand_qpos(m))
        assert np.isfinite(a.planner_step())
        assert a.get_action().shape == (12,)
    a = Agent(m, "Humanoid Cap Stand", planner="sampling", horizon=2,
              nsample=2)
    assert a.task.name == "Humanoid Cap Stand"
    old, old_gravity = a.model, a.model.gravity.clone()
    a.set_anything(model={"gravity": [0.0, 0.0, -5.0]},
                   state={"time": 0.5})
    assert a.model is not old and not a.model.cache
    assert torch.equal(old.gravity, old_gravity)
    assert a.model.gravity.tolist() == [0.0, 0.0, -5.0]
    assert a.plan_model.gravity.tolist() == [0.0, 0.0, -5.0]
    assert float(a.plan_model.dt) == 0.02 and a.get_state()["time"] == 0.5
    with pytest.raises(AttributeError):
        a.set_anything(model={"no_such_leaf": 1.0})
    with pytest.raises(KeyError):
        a.set_anything(task={"no_such_field": 1.0})
    assert a.get_mode() == "default" and a.get_mocap() == {}
    a.reset()
    assert a.get_state()["time"] == 0.0
    assert torch.equal(a.pstate.values, init_policy(a.model, 3).values)
    # a task with a mocap goal and a transition, by registry id
    sw = task_model("Swimmer", dtype=F64, device="cpu")
    a = Agent(sw, "Swimmer", planner="sampling", horizon=2, nsample=4)
    a.set_mocap("target", pos=[0.3, -0.2, 0.05])
    assert a.get_mocap()["target"]["pos"].tolist() == [0.3, -0.2, 0.05]
    a.set_state(qpos=home_qpos("Swimmer", sw))
    assert np.isfinite(a.planner_step()) and a.step().shape == (sw.nu,)


def recv_json(conn, n):
    """Read n JSON values from the stream (replies are not delimited)."""
    dec, buf, out = json.JSONDecoder(), "", []
    while len(out) < n:
        data = conn.recv(65536)
        assert data, "the server closed the connection"
        buf += data.decode()
        while buf.strip():
            try:
                v, end = dec.raw_decode(buf.lstrip())
            except json.JSONDecodeError:
                break
            out.append(v)
            buf = buf.lstrip()[end:]
    return out


def served(server, chunks, n_replies):
    """Send `chunks` (bytes) over a socketpair to server.handle, running
    in a thread; return the n_replies decoded replies."""
    a, b = socket.socketpair()
    a.settimeout(10.0)
    b.settimeout(10.0)
    worker = threading.Thread(target=server.handle, args=(b,), daemon=True)
    worker.start()
    try:
        for chunk in chunks:
            a.sendall(chunk)
        out = recv_json(a, n_replies)
    finally:
        a.close()
        worker.join(timeout=10.0)
    assert not worker.is_alive(), "handle did not return"
    return out


def check_server():
    x = inputs()
    o = {k: np.asarray(v).tolist() for k, v in x["obs"].items()}
    o2 = dict(o, joint_pos=(np.asarray(o["joint_pos"]) + 0.01).tolist())
    twin = MPCServer(small_agent(), planner_iterations=2)
    want = [twin.compute_action(**r) for r in (o, o2, o)]
    # a round trip, then two requests coalesced into one send
    srv = MPCServer(small_agent(), planner_iterations=2)
    got = served(srv, [json.dumps(o).encode()], 1)
    got += served(srv, [(json.dumps(o2) + json.dumps(o)).encode()], 2)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert len(g) == 12 and np.all(np.isfinite(g))
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      w.astype(np.float32))
    # a request split across sends, and malformed ones
    half = json.dumps(o).encode()
    short = json.dumps(dict(o, joint_pos=[1.0, 2.0])).encode()
    bad = served(srv, [half[:20], half[20:] + short, b' {"joint_vel": []}',
                       b' [1, 2]'], 4)
    assert len(bad[0]) == 12
    assert "joint_pos" in bad[1]["error"]
    assert set(bad[2]) == {"error"} and set(bad[3]) == {"error"}
    # position mode: joint_pos + 0.3 * torque
    pos = MPCServer(small_agent(), planner_iterations=2, position_mode=True)
    got = served(pos, [json.dumps(o).encode()], 1)[0]
    np.testing.assert_allclose(
        got, np.asarray(o["joint_pos"]) + 0.3 * want[0], rtol=0,
        atol=1e-6)
    # the async mode answers from the plan thread's published policy
    # (tests/test_torch_host.py holds it further)
    srv = MPCServer(small_agent(), async_mode=True)
    got = served(srv, [json.dumps(o).encode()], 1)[0]
    assert len(got) == 12 and np.all(np.isfinite(got))
    srv.stop()
    assert MPCServer(small_agent(), filter="ekf").filter_mode == "ekf"
    with pytest.raises(ValueError):
        MPCServer(small_agent(), filter="ukf")


def check_evaluate_end_to_end():
    """evaluate() on a port checkpoint: one row per randomization factor,
    eval.csv and the trajectories written."""
    pi = teval.GaussianPolicy(30, 12, (16, 16), "tanh", False,
                              generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt.pt")
        torch.save(dict(state=dict(pi=pi.state_dict()), iter=0), ckpt)
        rows = teval.evaluate(ckpt, rand_factors=EVAL_RFS, n_episodes=2,
                              max_steps=3, out=tmp, device="cpu")
        assert [r["rand_factor"] for r in rows] == list(EVAL_RFS)
        assert all(np.isfinite(list(r.values())).all() for r in rows)
        with open(os.path.join(tmp, "eval.csv")) as f:
            assert len(f.read().strip().splitlines()) == 1 + len(EVAL_RFS)
        for rf in EVAL_RFS:
            traj = np.load(os.path.join(tmp, f"traj_rf{rf:.2f}.npy"))
            assert traj.shape == (1, 19) and np.isfinite(traj).all()
        act = teval.load_policy(ckpt, device="cpu")
        o = torch.randn(3, 30)
        with torch.no_grad():
            assert torch.equal(act(o), torch.tanh(pi(o)[0]))


def check_mpc_in_env():
    out = mpc_in_env.run(seconds=0.006, randomization_factor=0.1,
                         planner="sampling", planner_iterations=1,
                         horizon=HORIZON, verbose=False, device="cpu")
    # the keys of the JAX mpc_in_env.run's result
    assert set(out) == {"survival_s", "fell", "mean_reward", "control_hz",
                        "steps"}
    assert out["steps"] == 3 and np.isfinite(out["mean_reward"])
    # the default planner, iLQG (one tick, a short horizon)
    out = mpc_in_env.run(seconds=0.002, horizon=2, planner_iterations=1,
                         verbose=False, device="cpu")
    assert out["steps"] == 1 and np.isfinite(out["mean_reward"])


def run_local_checks():
    """The checks that need no JAX reference process."""
    check_stable_elites()
    check_agent_errors_and_model_edit()
    check_server()
    check_evaluate_end_to_end()
    check_mpc_in_env()


def run_reference_checks(references=None):
    """The checks against the four JAX references; `references` holds
    results of `reference` built elsewhere (in other processes)."""
    _RESULTS.update(references or {})
    check_select_contacts()
    check_forward()
    check_root_height_and_robot_state()
    check_mppi_and_cem()
    check_agent()
    check_run_episodes()


def run_checks():
    run_local_checks()
    run_reference_checks()
