"""Port parity: the top-k contact tier against JAX.

Allegro, Shadow, Bimanual Insert and Reorient, Humanoid Interact and
Rubik: models whose step keeps its top-k contact selection (nv·(nlim +
10 ncon) over 16384, `max_contacts` 16 or 24), so that kernel B2 takes
a per-env chain mask (B, k, nv), and Rubik at nv 36, B2's two rows a
lane. Float64 on the CPU (the JAX side with x64), the same numpy-seeded
inputs (tests/test_torch_contact.py's `start`: hinges + 0.03 N, qvel
0.1 N, controls in the middle 40% of their range) through both
packages, B = 2; tolerances are max-abs error over max-abs value:

- models and tasks: every Structure field and model leaf of the six
  models equals the JAX builder's, and `model_from_jax_leaves`
  round-trips each; task terms, names and leaves agree; the home
  keyframes agree; `route` is "contact" with the selection kept;
- on the states of step 5 of the rollout below, from the port's
  kinematics and `collide` (held to JAX by the steps): the selection
  `sel` (a stable sort, as `lax.top_k`) and `contact_raw(..., sel)`
  (the per-env mask contact_dmask[sel], rel, friction, k, b, d) and
  the limit data against the JAX package's at 1e-12; B2's twin
  (`solve_step_raw_reference`) with the (B, k, nv) mask against JAX's
  `_jax_single_raw` under vmap at 1e-9;
- 10 `step`s against the JAX CPU `step` at 1e-9 (states, StepInfo,
  the per-slot forces scattered through `sel`): both keep the same
  top-k, so the two solve the same problem and no filter applies;
- every task's residual on those steps at 1e-9, also Humanoid
  Interact's with a contact pair authored (`set_contact_pair`) and
  Rubik's in its Solve mode on injected scramble goals; the
  transitions: the hands' and Reorient's goal rules (unmatched: the
  JAX result; matched: a new unit goal from the port's generator),
  Rubik's solve counter (Solve mode, the face angles at the goal: one
  goal fewer, then Wait) at 1e-12.

The JAX reference is built in a process of its own by
tests/test_torch_port.py (`run_checks` builds it in this process), with
tests/test_torch_contact.py's compile helpers (XLA optimization level
0, its fusion pass off). In that process the JAX package's Cholesky
factor and solve (`ops/linalg.py`, unrolled element by element at
trace time: Rubik's nv-36 step took ~460 s to compile) run as loops
over columns and rows in the package's order of operations
(tests/test_torch_refs.py's `loop_linalg`), held to the unrolled forms
at 1e-13 on each model's mass matrix first.
"""

import dataclasses
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu.physics import pallas_solver
from humanoid_mujoco_tpu.physics import solver as jsolver
from humanoid_mujoco_tpu.physics.model import State as JState
from humanoid_mujoco_tpu.physics.step import StepInfo as JStepInfo
from humanoid_mujoco_tpu.tasks import interact as jinteract
from humanoid_mujoco_tpu.tasks import registry as jregistry

from humanoid_mujoco_torch.physics import collision as tcol
from humanoid_mujoco_torch.physics import engine as tengine
from humanoid_mujoco_torch.physics import fused_solver
from humanoid_mujoco_torch.physics.model import (_LEAVES, State, Structure,
                                                 model_from_jax_leaves)
from humanoid_mujoco_torch.physics.solver import (contact_dmask,
                                                  contact_raw,
                                                  limit_rows_data,
                                                  limit_rows_static)
from humanoid_mujoco_torch.physics.step import keeps_selection, route, step
from humanoid_mujoco_torch.tasks import interact as tinteract
from humanoid_mujoco_torch.tasks import registry

import test_torch_contact as tc
import test_torch_refs as refs

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

F64 = torch.float64
t64, tree_np, rel = tc.t64, tc.tree_np, tc.rel
XLA_FLAGS = tc.XLA_FLAGS
NAMES = ("Allegro", "Shadow", "Bimanual Insert", "Bimanual Reorient",
         "Humanoid Interact", "Rubik")
N, STEPS, PROBE = 2, 10, 5
# Humanoid Interact's authored pair: the pelvis onto the chair's seat
PAIR = dict(i=0, body1="pelvis", body2="chair", local1=(0.0, 0.0, -0.05),
            local2=(0.0, 0.0, 0.17))
# Rubik's injected scramble: 3 quarter-turns, numpy seed SCRAMBLE_SEED
SCRAMBLE_SEED = 4
# the goal orientation of the transitions' unmatched case (the Allegro's
# cube starts at the default goal)
FAR_GOAL = (0.5, 0.5, 0.5, 0.5)


def scramble(n=3):
    """The injected scramble goals (n + 1, 6), most scrambled first."""
    rng = np.random.default_rng(SCRAMBLE_SEED)
    angles, cache = np.zeros(6), []
    for _ in range(n):
        cache.append(angles.copy())
        angles[rng.integers(0, 6)] += rng.choice((-1.0, 1.0)) * 0.5 * np.pi
    cache.append(angles.copy())
    return np.stack(cache[::-1])


def _pair_args(m):
    s = m.struct
    return (PAIR["i"], s.body_id(PAIR["body1"]), s.body_id(PAIR["body2"]),
            PAIR["local1"], PAIR["local2"])


def _solve_task(task, goal, remaining):
    """Rubik's task in Solve mode at face goal `goal` with `remaining`
    goals left (either package)."""
    p = np.asarray(task.params, np.float64).copy()
    p[:6], p[6] = goal, remaining
    t = task.set_mode("Solve")
    params = (jnp.asarray(p, t.params.dtype) if isinstance(t.params,
                                                            jax.Array)
              else torch.tensor(p, dtype=t.params.dtype))
    return dataclasses.replace(t, params=params)


# ---------------------------------------------------------------------------
# the JAX reference
# ---------------------------------------------------------------------------

def _probe(name, qpos, qvel, ctrl):
    """On the given states, from the port's smooth stage and `collide`
    (held to JAX by the steps): the JAX package's `select_contacts` and
    `contact_raw(..., sel)` per env, eagerly, and `_jax_single_raw` on
    its outputs under vmap (the JAX kernel branch with a per-env mask,
    off the TPU), compiled."""
    import functools
    import types
    from humanoid_mujoco_tpu.physics import collision as jcol
    m, jm = tc.port_model(name), tc.jax_model(name)
    kin, _, M, qf = tengine.prepare_smooth(m, t64(qpos), t64(qvel),
                                           t64(ctrl))
    full = tcol.collide(m, kin.xpos, kin.xmat)
    fields = ("pos", "normal", "dist", "friction", "friction_tor",
              "friction_roll")
    cols = {k: [] for k in ("sel", "nrm", "dist", "dmask", "rel", "mu3",
                            "kc", "bc", "dc", "lpos", "kl", "bl", "dl")}
    for e in range(qpos.shape[0]):
        c, sel = jcol.select_contacts(jcol.Contacts(**{
            f: jnp.asarray(getattr(full, f)[e].numpy()) for f in fields}),
            m.struct.max_contacts)
        kin_e = types.SimpleNamespace(cdof=jnp.asarray(kin.cdof[e].numpy()),
                                      anchor=jnp.asarray(
                                          kin.anchor[e].numpy()))
        raw = jsolver.contact_raw(jm, kin_e, c, sel)
        lim = jsolver.limit_rows_data(jm, jnp.asarray(qpos[e]))
        for k, v in zip(cols, (sel, c.normal, c.dist) + tuple(raw)
                        + tuple(lim)):
            cols[k].append(np.asarray(v))
    cols = {k: np.stack(v) for k, v in cols.items()}
    ins = (M.numpy(), qf.numpy(), np.asarray(qvel), kin.cdof.numpy(),
           cols["rel"], cols["nrm"], cols["dist"], cols["mu3"],
           cols["dmask"], cols["kc"], cols["bc"], cols["dc"], cols["lpos"],
           cols["kl"], cols["bl"], cols["dl"])
    one = functools.partial(
        pallas_solver._jax_single_raw,
        hdamp=jm.dt * jm.dof_damping, dt=jm.dt,
        lim_tab=jsolver.limit_rows_static(jm), niter=8, ls_iter=16)
    args = tuple(jnp.asarray(x) for x in ins)
    out = tc._compile(jax.vmap(one), *args)(*args)
    return dict(cols, out=tree_np(out))


def _residuals(name, task, st, ctrl):
    """task's residual on every step of the rollout outputs `st`."""
    jm = tc.jax_model(name)

    def res(q, v, t, info, u):
        return task.residual(jm, JState(q, v, t), info, u)
    info = JStepInfo(**{k: jnp.asarray(v) for k, v in st["info"].items()})
    return np.asarray(jax.jit(jax.vmap(jax.vmap(
        res, in_axes=(0, 0, 0, 0, None))))(
        jnp.asarray(st["qpos"]), jnp.asarray(st["qvel"]),
        jnp.asarray(st["time"]), info, jnp.asarray(ctrl)))


def _state_info(st, t=0, env=0):
    info = JStepInfo(**{k: jnp.asarray(v[env, t])
                        for k, v in st["info"].items()})
    s = JState(jnp.asarray(st["qpos"][env, t]),
               jnp.asarray(st["qvel"][env, t]), jnp.asarray(0.01))
    return s, info


def _far(task):
    """task with its goal orientation at FAR_GOAL (either package)."""
    if task.mocap_quat.shape[0] == 0:
        return task
    if isinstance(task.mocap_quat, jax.Array):
        q = task.mocap_quat.at[0].set(jnp.asarray(FAR_GOAL))
    else:
        q = task.mocap_quat.clone()
        q[0] = torch.tensor(FAR_GOAL, dtype=q.dtype)
    return dataclasses.replace(task, mocap_quat=q)


def _task_leaves(task):
    """The leaves a transition may change (the task's functions do not
    cross a process boundary)."""
    return {k: np.asarray(getattr(task, k)) for k in
            ("weights", "params", "mocap_pos", "mocap_quat", "mode")}


def _transitions(name, st):
    """The goal rules' unmatched case (goal at FAR_GOAL) and Rubik's
    counter on env 0 of the rollout's first step."""
    jm, task = tc.jax_model(name), _far(tc.jax_task(name))
    s, info = _state_info(st)
    out = {"plain": _task_leaves(task.transition(jm, s, info))}
    if name == "Rubik":
        faces = np.asarray(s.qpos[31:37])
        for left in (2.0, 1.0):
            out[f"solve_{int(left)}"] = _task_leaves(_solve_task(
                task, faces, left).transition(jm, s, info))
    return out


def _model_ref(name):
    qpos, qvel, ctrl = tc.start(name, n=N)
    _, outs = tc._steps(name, tc._plain_step, qpos, qvel,
                        np.repeat(ctrl[:, None], STEPS, axis=1))
    st = tree_np(outs)
    jm, task = tc.jax_model(name), tc.jax_task(name)
    out = {"steps": st, "residual": _residuals(name, task, st, ctrl)}
    if name == "Humanoid Interact":
        paired = jinteract.set_contact_pair(task, *_pair_args(jm))
        out["pair_residual"] = _residuals(name, paired, st, ctrl)
    if name == "Rubik":
        out["solve_residual"] = _residuals(
            name, _solve_task(task, scramble()[0], 3.0), st, ctrl)
    out["probe"] = _probe(name, st["qpos"][:, PROBE], st["qvel"][:, PROBE],
                          ctrl)
    out["transitions"] = _transitions(name, st)
    return out


def mass_matrices(name=None):
    """Each model's mass matrix at its `start` state, for the loop-form
    Cholesky check (tests/test_torch_refs.py)."""
    out = []
    for n in NAMES:
        qpos, qvel, ctrl = tc.start(n, n=1)
        out.append((n, *refs.port_mass_matrix(tc.port_model(n), qpos[0],
                                              qvel[0], ctrl[0])))
    return out


_RESULT = {}


def reference(name=None):
    """The JAX reference of the six models, built once per process (with
    the package's Cholesky and solve in their loop forms, checked
    against the unrolled ones); `name` is unused (one reference)."""
    if not _RESULT:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                   + tc.XLA_FLAGS).strip()
        saved = refs.loop_linalg()
        _RESULT["linalg"] = refs.loop_linalg_errors(saved, mass_matrices())
        _RESULT.update({n: _model_ref(n) for n in NAMES})
    return _RESULT


# ---------------------------------------------------------------------------
# checks that need no JAX reference run
# ---------------------------------------------------------------------------

def check_models_and_tasks():
    assert registry.list_tasks() == jregistry.list_tasks()
    for name in NAMES:
        jm, tm = tc.jax_model(name), tc.port_model(name)
        js, ts = dataclasses.asdict(jm.struct), dataclasses.asdict(tm.struct)
        assert js == ts, (name, [k for k in js if js[k] != ts.get(k)])
        leaves = {k: np.asarray(getattr(jm, k)) for k in _LEAVES}
        leaves["sol_iter"] = np.asarray(jm.sol_iter)
        back = model_from_jax_leaves(Structure(**js), leaves, device="cpu")
        for k in _LEAVES:
            assert rel(leaves[k], getattr(tm, k)) < 1e-15, (name, k)
            assert torch.equal(getattr(back, k), getattr(tm, k)), (name, k)
        assert int(tm.sol_iter) == int(jm.sol_iter), name
        assert route(tm) == route(back) == "contact", name
        assert keeps_selection(tm), name
        assert rel(np.asarray(jregistry.home_qpos(name, jm)),
                   registry.home_qpos(name, tm)) < 1e-15, name
        jt, tt = tc.jax_task(name), registry.get_task(name, dtype=F64,
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
    # the sizes the slice is about (nv, slots, limit rows, k)
    sizes = {n: (tc.port_model(n).nv, tc.port_model(n).ncon,
                 len(limit_rows_static(tc.port_model(n))),
                 tc.port_model(n).struct.max_contacts) for n in NAMES}
    assert sizes == {"Allegro": (22, 74, 32, 16), "Shadow": (30, 58, 48, 16),
                     "Bimanual Insert": (28, 92, 32, 16),
                     "Bimanual Reorient": (22, 104, 32, 16),
                     "Humanoid Interact": (27, 116, 46, 24),
                     "Rubik": (36, 256, 48, 16)}, sizes
    # B2's per-env chain area: the k longest slot chains of the model
    for name in NAMES:
        m = tc.port_model(name)
        k = m.struct.max_contacts
        per_slot = (contact_dmask(m) != 0).sum(dim=1)
        assert fused_solver.chain_bound(contact_dmask(m), k) == int(
            per_slot.sort(descending=True).values[:k].sum())


def check_rubik_scramble():
    """The port's scramble follows the JAX rule (quarter turns from the
    solved cube, most scrambled first) on its generator's draws."""
    from humanoid_mujoco_torch.tasks.rubik import scramble_goals
    gen = torch.Generator().manual_seed(3)
    goals = scramble_goals(gen, 5)
    assert goals.shape == (6, 6) and np.all(goals[-1] == 0.0)
    steps = np.abs(np.diff(goals, axis=0))
    assert np.all(np.isclose(steps.sum(axis=1), 0.5 * np.pi))
    assert np.array_equal(goals, scramble_goals(
        torch.Generator().manual_seed(3), 5))


def run_local_checks():
    check_models_and_tasks()
    check_rubik_scramble()


# ---------------------------------------------------------------------------
# checks against the reference
# ---------------------------------------------------------------------------

def _port_rollout(name):
    m, task = tc.port_model(name), tc.port_task(name)
    qpos, qvel, ctrl = tc.start(name, n=N)
    s = State(t64(qpos), t64(qvel), torch.zeros(N, dtype=F64))
    u = t64(ctrl)
    outs = []
    for _ in range(STEPS):
        s2, info = step(m, s, u)
        outs.append((s, info))
        s = s2
    return outs, u, task


def check_probe(name, ref):
    """The selection and contact_raw(sel) against the JAX package's on
    the same kinematics and contacts at 1e-12, and B2's twin with the
    per-env mask against `_jax_single_raw` at 1e-9, on the probe
    states."""
    m = tc.port_model(name)
    st, pr = ref["steps"], ref["probe"]
    qpos, qvel = t64(st["qpos"][:, PROBE]), t64(st["qvel"][:, PROBE])
    ctrl = t64(tc.start(name, n=N)[2])
    kin, _, M, qf = tengine.prepare_smooth(m, qpos, qvel, ctrl)
    c, sel = tcol.select_contacts(tcol.collide(m, kin.xpos, kin.xmat),
                                  m.struct.max_contacts)
    assert np.array_equal(pr["sel"], sel.numpy()), name
    raw = contact_raw(m, kin, c, sel)
    lim = limit_rows_data(m, qpos)
    for k, o in zip(("dmask", "rel", "mu3", "kc", "bc", "dc", "lpos", "kl",
                     "bl", "dl", "nrm", "dist"),
                    raw + lim + (c.normal, c.dist)):
        assert rel(pr[k], o) < 1e-12, (name, k, rel(pr[k], o))
    dmask = raw[0]
    assert dmask.shape == (N, m.struct.max_contacts, m.nv)
    assert torch.equal(dmask, contact_dmask(m)[sel])
    out = fused_solver.solve_step_raw_reference(
        M, qf, qvel, kin.cdof, raw[1], c.normal, c.dist, raw[2], dmask,
        *raw[3:], *lim, m.dt * m.dof_damping, m.dt,
        lim_tab=limit_rows_static(m))
    for r, o in zip(pr["out"], out):
        assert rel(r, o) < 1e-9, (name, rel(r, o))
    # a slot carries force somewhere in the batch
    assert float(out[2].max()) > 0, name


def check_steps(name, ref):
    st = ref["steps"]
    outs, u, task = _port_rollout(name)
    m = tc.port_model(name)
    fields = ("xpos", "xquat", "site_xpos", "com", "com_vel",
              "body_com_vel", "contact_dist", "contact_force", "qacc",
              "actuator_force", "qfrc_total")
    extra = []
    if name == "Humanoid Interact":
        extra.append(("pair_residual", tinteract.set_contact_pair(
            task, *_pair_args(m))))
    if name == "Rubik":
        extra.append(("solve_residual", _solve_task(task, scramble()[0],
                                                    3.0)))
    for t, (s, info) in enumerate(outs):
        assert rel(st["qpos"][:, t], s.qpos) < 1e-9, (name, t)
        assert rel(st["qvel"][:, t], s.qvel) < 1e-9, (name, t)
        for f in fields:
            assert rel(st["info"][f][:, t], getattr(info, f)) < 1e-9, \
                (name, t, f, rel(st["info"][f][:, t], getattr(info, f)))
        assert not bool(info.diverged.any()), (name, t)
        assert rel(ref["residual"][:, t], task.residual(m, s, info, u)) \
            < 1e-9, (name, t)
        for key, tk in extra:
            assert rel(ref[key][:, t], tk.residual(m, s, info, u)) < 1e-9, \
                (name, key, t)
    k = m.struct.max_contacts
    loaded = (np.asarray(st["info"]["contact_force"]) > 0).sum(axis=-1)
    assert loaded.max() <= k, name
    # the selection-free premise: every penetrating slot among the k kept
    over = (np.asarray(st["info"]["contact_dist"]) < 0).sum(axis=-1) > k
    return {"most_loaded": int(loaded.max()),
            "steps_over_k_penetrating": int(over.sum()),
            "steps": int(over.size)}


def check_transitions(name, ref):
    m, task = tc.port_model(name), _far(tc.port_task(name))
    st, tr = ref["steps"], ref["transitions"]
    info = tc.tstepinfo(st["info"], 0)
    s = State(t64(st["qpos"][0:1, 0]), t64(st["qvel"][0:1, 0]),
              torch.full((1,), 0.01, dtype=F64))
    tc._same_task(tr["plain"], task.transition(m, s, info), name)
    if name == "Rubik":
        faces = st["qpos"][0, 0, 31:37]
        for left in (2.0, 1.0):
            out = _solve_task(task, faces, left).transition(m, s, info)
            tc._same_task(tr[f"solve_{int(left)}"], out, name)
            assert float(out.params[6]) == left - 1.0
            assert int(out.mode) == (2 if left > 1 else 0)
    if name in ("Allegro", "Shadow", "Bimanual Reorient"):
        # matched goal: a new unit quaternion from the port's generator
        q = task.mocap_quat.clone()
        cube = m.struct.body_id("cube" if name != "Bimanual Reorient"
                                else "cross")
        q[0] = info.xquat[0, cube]
        t = dataclasses.replace(task, mocap_quat=q)
        if name == "Bimanual Reorient":
            pos = task.mocap_pos.clone()
            pos[0] = info.xpos[0, cube]
            t = dataclasses.replace(t, mocap_pos=pos)
        out = t.transition(m, s, info)
        assert not torch.equal(out.mocap_quat[0], q[0]), name
        assert abs(float(out.mocap_quat[0].norm()) - 1.0) < 1e-12, name


def run_reference_checks(reference_result=None):
    ref = reference_result if reference_result else reference()
    for name, errs in ref["linalg"].items():
        assert max(errs) < 1e-13, (name, errs)
    loaded = {}
    for name in NAMES:
        check_probe(name, ref[name])
        loaded[name] = check_steps(name, ref[name])
        check_transitions(name, ref[name])
    print("top-k tier: most loaded slots of an env, and (env, step) pairs "
          "with more penetrating slots than k:", loaded)


def run_checks(reference_result=None):
    run_local_checks()
    run_reference_checks(reference_result)
