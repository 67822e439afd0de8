"""Port parity: the rest of the planner library and the RL tools.

The planners (robust, sample-gradient, gradient, iLQS, the parallel
Riccati pass), the rollout's per-step wrench sequence and the OU wrench
model, and the RL tools (tune, plot, videos with the renderer and the
viewer), each against the JAX package on the same numpy-seeded inputs,
the JAX draws fed to the port. Float64; tolerances are max-abs error
over max-abs value:

- `ou_wrench_sequence` at 1e-12; the humanoid `rollout_spline` with
  per-env wrench sequences (B, T, nbody, 6) at 1e-9, and with one
  sequence shared by the batch (a batch stride of 0) equal to the
  per-env run of that sequence;
- `robust_plan` at tests/test_planners_extra.py's config (6 candidates,
  horizon 4, the best 2 under 2 wrench sequences), against the JAX plan
  on its step's kernel branch (selection-free, as the port; two of the
  candidates load a slot outside the 32 smallest gaps, where the CPU
  step's top-32 is another algorithm): the same top 2 and winner, the
  returns, the winner's average perturbed return and the policy at
  1e-6;
- `sample_gradient_plan`, 3 iterations on the pendulum: the gradient
  estimate, returns and policy at 1e-6;
- `interp_weights` at 1e-12 and `spline_fit` at 1e-9;
- `gradient_plan`: 10 iterations on the pendulum and one on the
  humanoid at horizon 4, returns and policy at 1e-6;
- `ilqs_plan`: both iterations of the JAX test (spline, iLQG policy,
  returns) at 1e-6, the second started from the JAX state's leaves
  (`ILQSState.from_numpy`);
- `parallel_riccati` and `sequential_riccati` against the JAX functions
  on the JAX test's random LQR at 1e-12, and the test's
  finite-horizon-optimality check;
- the JAX tests' own bounds (tests/test_planners_extra.py:73-139) on the
  port;
- a fault of the reference repaired: on the humanoid's own
  linearization at the stand, tiled to 128 steps, the JAX recursion
  (no symmetrization of P) loses symmetry and grows past 1e20; the
  port's stays bounded and its parallel pass agrees at 1e-10;
- tune: tests/test_tune.py's six scenarios on the port's samplers and
  pruner, trial by trial equal to the JAX ones (same parameters, states
  and values) and each scenario's bound; one PPO-objective trial of the
  port's trainer (iters 2, 4 envs), finite reports;
- `plot_curves` writes a PNG from a log of the port's `rl.train`;
- `render_frame` against the JAX renderer on the same qpos (at most 1%
  of the pixels differ, by rounding at the edges of the circles);
  `trajectory_scene` at 1e-9;
- `record_episode` for 10 control steps with the JAX draws at 1e-6,
  against the JAX `record_episode` run in the RL slice's env reference
  process (tests/test_torch_rl.py).

The port is selection-free and the JAX CPU step keeps the 32 smallest
gaps (ROADMAP queue 3 item 3), so every humanoid `step` the port takes
against a JAX CPU step is checked first: each loaded slot is among the
32 smallest gaps.

The JAX references are built in two processes of tests/test_torch_port.py
("humanoid", the one jitting a humanoid step: the wrench rollout, the
robust plan and the gradient plan; "light": the pendulum planners,
Riccati, the renderer and the viewer).
"""

import functools
import json
import os
import tempfile

import numpy as np
import torch

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu import rollout as jroll
from humanoid_mujoco_tpu.mpc import make_plan_model as j_plan_model
from humanoid_mujoco_tpu.ops.spline import SplineOrder as JOrder
from humanoid_mujoco_tpu.physics import humanoid as jh
from humanoid_mujoco_tpu.physics.model import make_state as j_make_state
from humanoid_mujoco_tpu.planners import gradient as jgrad
from humanoid_mujoco_tpu.planners import ilqs as jilqs
from humanoid_mujoco_tpu.planners import ilqg as jilqg
from humanoid_mujoco_tpu.planners import parallel_riccati as jpr
from humanoid_mujoco_tpu.planners import policy as jpolicy
from humanoid_mujoco_tpu.planners import robust as jrobust
from humanoid_mujoco_tpu.planners import sample_gradient as jsg
from humanoid_mujoco_tpu.planners import sampling as jsampling
from humanoid_mujoco_tpu.rl import tune as jtune
from humanoid_mujoco_tpu.tasks import stand_task as j_stand_task

from humanoid_mujoco_torch import rollout as troll
from humanoid_mujoco_torch.mpc import make_plan_model
from humanoid_mujoco_torch.ops.spline import SplineOrder, spline_sample
from humanoid_mujoco_torch.physics import humanoid as th
from humanoid_mujoco_torch.physics.model import make_state
from humanoid_mujoco_torch.physics.step import step
from humanoid_mujoco_torch.planners import gradient as tgrad
from humanoid_mujoco_torch.planners import (GradientConfig, ILQGConfig,
                                            ILQSConfig, ILQSState,
                                            RobustConfig,
                                            SampleGradientConfig,
                                            SamplingConfig, gradient_plan,
                                            ilqs_init, ilqs_plan,
                                            init_policy, robust_plan,
                                            sample_gradient_init,
                                            sample_gradient_plan,
                                            sample_gradient_state_from_numpy)
from humanoid_mujoco_torch.planners.cem import elite_indices
from humanoid_mujoco_torch.planners.derivatives import trajectory_derivatives
from humanoid_mujoco_torch.planners.ilqs import spline_fit
from humanoid_mujoco_torch.planners.parallel_riccati import (
    parallel_riccati, sequential_riccati)
from humanoid_mujoco_torch.rl import plot as tplot
from humanoid_mujoco_torch.rl import train as ttrain
from humanoid_mujoco_torch.rl import tune as ttune
from humanoid_mujoco_torch.rl import videos as tvid
from humanoid_mujoco_torch.tasks import stand_task
from humanoid_mujoco_torch.viz import render as trender
from humanoid_mujoco_torch.viz import viewer as tviewer

import test_torch_ilqg as tilqg_test
import test_torch_refs as refs
import test_torch_rl as trl

torch.set_num_threads(1)
# tests/conftest.py sets this too; the references run in processes of
# their own, which do not import conftest
jax.config.update("jax_enable_x64", True)

F64 = torch.float64
PLAN_DT = 0.02
rel, t64, tree_np = trl.rel, trl.t64, trl.tree_np

# tests/test_planners_extra.py's configurations
ROBUST = dict(nsample=6, nknots=3, horizon=4, solver_iters=3)
ROBUST_BEST, ROBUST_REPS = 2, 2
SG = dict(nsample=16, nknots=3, horizon=10, solver_iters=3,
          exploration=0.1)
GRAD = dict(nknots=5, horizon=25, n_linesearch=10)
ILQS_S = dict(nsample=6, nknots=3, horizon=10, solver_iters=3)
ILQS_G = dict(horizon=10, n_linesearch=4, solver_iters=3,
              deriv_solver_iters=2)
# the wrench rollout and the humanoid gradient iteration
ROLL_B, ROLL_T, GRAD_H = 3, 6, 4


def inputs():
    """The numpy-seeded inputs the references and the checks share."""
    rng = np.random.default_rng(11)
    nbody = 14
    return dict(
        roll_values=0.3 * rng.standard_normal((ROLL_B, 3, 12)),
        roll_xfrc=1.0 * rng.standard_normal((ROLL_B, ROLL_T, nbody, 6)),
        knot_times=np.sort(rng.uniform(0.0, 1.0, 5)),
        times=np.linspace(-0.1, 1.1, 23),
        fit_u=rng.standard_normal((23, 3)),
        render_dq=0.05 * rng.standard_normal(12),
        scene_dq=0.05 * rng.standard_normal((10, 12)))


# ---------------------------------------------------------------------------
# JAX references
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jm64():
    return jh.build_humanoid(dtype=jnp.float64)


def _o0(fn, *args):
    """fn jitted and compiled at XLA's backend optimization level 0
    (the same numbers, less compile time), called on args."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


def _jax_humanoid():
    """The wrench rollout, one robust plan and one gradient plan on the
    float64 humanoid from the stand pose, and the draws they used."""
    jm = jm64()
    pm = j_plan_model(jm, PLAN_DT)
    task = j_stand_task(dtype=jnp.float64)
    x = inputs()
    s0 = j_make_state(jm, qpos=jh.stand_qpos(jm))
    out = {}

    # rollout_spline with per-env wrench sequences
    times = jnp.asarray([0.0, 0.04, 0.08])

    def roll(values, xfrc):
        return jroll.rollout_spline(jm, task, s0, times, values, JOrder.ZERO,
                                    ROLL_T, xfrc_seq=xfrc).total_return
    out["roll"] = np.asarray(_o0(jax.vmap(roll), jnp.asarray(
        x["roll_values"]), jnp.asarray(x["roll_xfrc"])))

    # robust_plan and its draws (k_cand, k_ou = split(key);
    # sample_candidates' normals from split(k_cand)[0])
    cfg = jrobust.RobustConfig(
        sampling=jsampling.SamplingConfig(**ROBUST), n_best=ROBUST_BEST,
        repetitions=ROBUST_REPS)
    pol = jpolicy.init_policy(jm, ROBUST["nknots"])
    key = jax.random.PRNGKey(0)
    # on the kernel branch of the JAX step (selection-free, as the
    # port): two of the candidates load a slot outside the 32 smallest
    # gaps, where the CPU step's top-32 is another algorithm
    saved, jroll.step = jroll.step, trl.jax_kernel_path_step
    try:
        pol2, info = _o0(lambda p, s, k: jrobust.robust_plan(
            pm, task, cfg, p, s, k), pol, s0, key)
    finally:
        jroll.step = saved
    k_cand, k_ou = jax.random.split(key)
    noise = jax.random.normal(jax.random.split(k_cand)[0],
                              (ROBUST["nsample"], ROBUST["nknots"], 12),
                              dtype=jnp.float64)
    ou = jnp.stack([jax.random.normal(k, (ROBUST["horizon"], 14, 6),
                                      dtype=jnp.float64)
                    for k in jax.random.split(k_ou, ROBUST_REPS)])
    _, top = jax.lax.top_k(-info.returns, ROBUST_BEST)
    out["robust"] = dict(values=np.asarray(pol2.values),
                         times=np.asarray(pol2.times), info=tree_np(info),
                         top=np.asarray(top), noise=np.asarray(noise),
                         ou=np.asarray(ou))

    # one gradient iteration at horizon 4
    gcfg = jgrad.GradientConfig(horizon=GRAD_H)
    gpol = jpolicy.init_policy(jm, gcfg.nknots)
    gpol2, ginfo = _o0(lambda p, s, k: jgrad.gradient_plan(pm, task, gcfg,
                                                           p, s, k),
                       gpol, s0, key)
    out["gradient"] = dict(values=np.asarray(gpol2.values),
                           times=np.asarray(gpol2.times),
                           info=tree_np(ginfo))
    return out


def _pendulum():
    m = tilqg_jax().pendulum_model(dt=0.05)
    return m, tilqg_jax().pendulum_task(), j_make_state(m)


@functools.lru_cache(maxsize=None)
def tilqg_jax():
    import test_ilqg
    return test_ilqg


def _jax_light():
    """The pendulum planners, the spline maps, OU sequences, the Riccati
    passes, the renderer and the viewer."""
    x = inputs()
    m, task, s0 = _pendulum()
    out = {}

    # the gradient planner, 10 iterations (tests/test_planners_extra.py)
    cfg = jgrad.GradientConfig(order=JOrder.LINEAR, **GRAD)
    pol = jpolicy.init_policy(m, cfg.nknots, dtype=jnp.float64)
    plan = jax.jit(lambda p, s, k: jgrad.gradient_plan(m, task, cfg, p, s,
                                                       k))
    its = []
    for i in range(10):
        pol, info = plan(pol, s0, jax.random.PRNGKey(i))
        its.append(dict(values=np.asarray(pol.values), info=tree_np(info)))
    out["gradient"] = its

    # sample-gradient, 3 iterations, and each iteration's normals
    cfg = jsg.SampleGradientConfig(sampling=jsampling.SamplingConfig(
        **{**SG, "exploration": jnp.asarray(SG["exploration"])}))
    pol = jpolicy.init_policy(m, 3, dtype=jnp.float64)
    gs = jsg.sample_gradient_init(m, cfg)
    plan = jax.jit(lambda p, g, s, k: jsg.sample_gradient_plan(
        m, task, cfg, p, g, s, k))
    its = []
    for i in range(3):
        key = jax.random.PRNGKey(i)
        pol, gs, info = plan(pol, gs, s0, key)
        its.append(dict(
            values=np.asarray(pol.values), grad=np.asarray(gs.grad),
            info=tree_np(info), noise=np.asarray(jax.random.normal(
                jax.random.split(key)[0], (SG["nsample"], 3, 1),
                dtype=jnp.float64))))
    out["sample_gradient"] = its

    # iLQS, the JAX test's two iterations
    cfg = jilqs.ILQSConfig(sampling=jsampling.SamplingConfig(**ILQS_S),
                           ilqg=jilqg.ILQGConfig(**ILQS_G))
    ps = jilqs.ilqs_init(m, cfg, s0, jpolicy.init_policy(m, 3,
                                                         dtype=jnp.float64))
    plan = jax.jit(lambda ps, s, k: jilqs.ilqs_plan(m, task, cfg, ps, s, k))
    its = [dict(state=tree_np(ps))]
    for i in range(2):
        key = jax.random.PRNGKey(i)
        ps, info = plan(ps, s0, key)
        its.append(dict(state=tree_np(ps), info=tree_np(info),
                        noise=np.asarray(jax.random.normal(
                            jax.random.split(key)[0],
                            (ILQS_S["nsample"], 3, 1), dtype=jnp.float64))))
    out["ilqs"] = its

    # the spline maps
    kt, tt = jnp.asarray(x["knot_times"]), jnp.asarray(x["times"])
    out["interp"] = {int(o): np.asarray(jgrad.interp_weights(tt, kt, o))
                     for o in JOrder}
    out["spline_fit"] = {int(o): np.asarray(jilqs.spline_fit(
        jnp.asarray(x["fit_u"]), tt, kt, o)) for o in JOrder}

    # OU sequences (the robust planner's R = 3 at its defaults), and the
    # normals each key gives, for the port
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    out["ou"] = np.stack([np.asarray(jroll.ou_wrench_sequence(
        k, 17, 14, jnp.asarray(0.1), jnp.asarray(0.1), 0.02,
        dtype=jnp.float64)) for k in keys])
    out["ou_noise"] = np.stack([np.asarray(jax.random.normal(
        k, (17, 14, 6), dtype=jnp.float64)) for k in keys])

    # the Riccati passes on tests/test_parallel_riccati.py's LQRs
    out["riccati"] = {}
    for key_, shape in (("64", (64, 6, 3, 0)), ("40", (40, 3, 2, 3))):
        args = _random_lqr(*shape)
        out["riccati"][key_] = dict(
            par=[np.asarray(a) for a in jpr.parallel_riccati(
                *map(jnp.asarray, args))],
            seq=[np.asarray(a) for a in jpr.sequential_riccati(
                *map(jnp.asarray, args))])

    # the renderer and the viewer on the float64 humanoid
    from humanoid_mujoco_tpu.viz import render as jrender
    from humanoid_mujoco_tpu.viz import viewer as jviewer
    jm = jm64()
    q0 = np.asarray(jh.stand_qpos(jm))
    q = q0.copy()
    q[7:] += x["render_dq"]
    out["frame"] = jrender.render_frame(jm, q, width=160, height=120)
    out["frame_green"] = jrender.render_frame(jm, q, width=160, height=120,
                                              greenscreen=True)
    out["scene"] = jviewer.trajectory_scene(jm, scene_traj(q0), stride=2)
    return out


def scene_traj(q0):
    q = np.tile(q0, (10, 1))
    q[:, 7:] += inputs()["scene_dq"]
    q[:, 2] += 0.01 * np.arange(10)
    return q


def _random_lqr(T, n, nu, seed=0):
    """tests/test_parallel_riccati.py's random LQR, as numpy."""
    rng = np.random.default_rng(seed)

    def spd(T, n, scale):
        M = rng.standard_normal((T, n, n)) * scale
        return M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(n)

    A = np.stack([np.eye(n) + 0.05 * rng.standard_normal((n, n))
                  for _ in range(T)])
    B = 0.1 * rng.standard_normal((T, n, nu))
    c = 0.01 * rng.standard_normal((T, n))
    cxx = spd(T, n, 0.3)
    cuu = spd(T, nu, 0.3)
    cxu = 0.05 * rng.standard_normal((T, n, nu))
    cx = 0.1 * rng.standard_normal((T, n))
    cu = 0.1 * rng.standard_normal((T, nu))
    PT = spd(1, n, 0.3)[0]
    pT = 0.1 * rng.standard_normal(n)
    return [A, B, c, cxx, cxu, cuu, cx, cu, PT, pT]


_BUILD = {"humanoid": _jax_humanoid, "light": _jax_light}
_RESULTS = {}
NAMES = tuple(_BUILD)


def reference(name: str):
    """The JAX reference `name`, built once per process."""
    if name not in _RESULTS:
        _RESULTS[name] = _BUILD[name]()
    return _RESULTS[name]


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def tm64():
    return th.build_humanoid(dtype=F64, device="cpu")


def mass_matrices(name):
    """Mass matrices of reference `name`'s model (the humanoid at its
    stand pose, or the pendulum), for the loop-form Cholesky check
    (tests/test_torch_refs.py)."""
    if name == "light":
        m = tilqg_test.pendulum_model(dt=0.05)
        return [refs.at_rest("pendulum", m, np.array([0.3]))]
    return [refs.at_rest("humanoid", tm64(), th.stand_qpos(tm64()).numpy())]


class premise:
    """Within the block, every humanoid `step` of the modules' rollouts
    is held to the top-32 premise (tests/test_torch_ilqg.py)."""

    def __init__(self, *modules):
        self.modules = modules
        self.n = 0

    def __enter__(self):
        self.saved = [m.step for m in self.modules]

        def spy(*a, **kw):
            out = step(*a, **kw)
            if a[0].struct.nbody > 2:
                tilqg_test.assert_top32_premise(out[1])
                self.n += 1
            return out
        for m in self.modules:
            m.step = spy
        return self

    def __exit__(self, *exc):
        for m, s in zip(self.modules, self.saved):
            m.step = s


def pendulum():
    m = tilqg_test.pendulum_model(dt=0.05)
    return m, tilqg_test.pendulum_task(), make_state(m)


def check_ou_wrench_sequence():
    ref = reference("light")
    out = troll.ou_wrench_sequence(17, 14, 0.1, 0.1, 0.02,
                                   noise=t64(ref["ou_noise"]))
    assert rel(ref["ou"], out) < 1e-12, rel(ref["ou"], out)
    # a shared model dt as a 0-d tensor gives the same numbers
    out2 = troll.ou_wrench_sequence(17, 14, 0.1, 0.1,
                                    torch.tensor(0.02, dtype=F64),
                                    noise=t64(ref["ou_noise"]))
    assert torch.equal(out, out2)
    g = torch.Generator().manual_seed(0)
    drawn = troll.ou_wrench_sequence(5, 14, 0.1, 0.1, 0.02, generator=g,
                                     repetitions=2, dtype=F64)
    assert drawn.shape == (2, 5, 14, 6) and bool(torch.isfinite(drawn).all())


def check_rollout_wrenches():
    ref, x = reference("humanoid"), inputs()
    m, task = tm64(), stand_task(dtype=F64, device="cpu")
    s0 = make_state(m, qpos=th.stand_qpos(m), batch=ROLL_B)
    times = t64([0.0, 0.04, 0.08])
    with premise(troll) as spy:
        res = troll.rollout_spline(m, task, s0, times, t64(x["roll_values"]),
                                   SplineOrder.ZERO, ROLL_T,
                                   xfrc_seq=t64(x["roll_xfrc"]))
        assert rel(ref["roll"], res.total_return) < 1e-9
        # one sequence shared by the batch (batch stride 0) against the
        # same sequence given per env
        seq = t64(x["roll_xfrc"][0])
        shared = troll.rollout_spline(m, task, s0, times,
                                      t64(x["roll_values"]),
                                      SplineOrder.ZERO, ROLL_T,
                                      xfrc_seq=seq)
        each = troll.rollout_spline(m, task, s0, times,
                                    t64(x["roll_values"]), SplineOrder.ZERO,
                                    ROLL_T,
                                    xfrc_seq=seq.expand(ROLL_B, -1, -1,
                                                        -1).clone())
    assert spy.n == 3 * ROLL_T
    assert rel(each.total_return, shared.total_return) < 1e-12
    assert rel(shared.final_state.qpos, res.final_state.qpos) > 1e-9
    assert float(res.total_return.max()) < troll.MAX_RETURN


def check_robust():
    ref = reference("humanoid")["robust"]
    m = tm64()
    pm = make_plan_model(m, PLAN_DT)
    task = stand_task(dtype=F64, device="cpu")
    s0 = make_state(m, qpos=th.stand_qpos(m))
    cfg = RobustConfig(sampling=SamplingConfig(**ROBUST), n_best=ROBUST_BEST,
                       repetitions=ROBUST_REPS)
    pol, info = robust_plan(pm, task, cfg, init_policy(m, 3), s0,
                            noise=t64(ref["noise"]), ou_noise=t64(ref["ou"]))
    top = elite_indices(info.returns, ROBUST_BEST).numpy()
    assert np.array_equal(top, ref["top"]), (top, ref["top"])
    assert int(info.winner) == int(ref["info"]["winner"])
    for k in ("returns", "best_return", "nominal_return", "improvement"):
        err = rel(ref["info"][k], getattr(info, k))
        assert err < 1e-6, (k, err)
    assert rel(ref["values"], pol.values) < 1e-6
    assert rel(ref["times"], pol.times) < 1e-12
    # the JAX test's bounds
    assert pol.values.shape == (3, m.nu)
    assert np.isfinite(float(info.best_return))


def check_sample_gradient():
    its = reference("light")["sample_gradient"]
    m, task, s0 = pendulum()
    cfg = SampleGradientConfig(sampling=SamplingConfig(**SG))
    pol = init_policy(m, 3, dtype=F64)
    gs = sample_gradient_init(m, cfg)
    for it in its:
        pol, gs, info = sample_gradient_plan(m, task, cfg, pol, gs, s0,
                                             noise=t64(it["noise"]))
        assert rel(it["grad"], gs.grad) < 1e-6, rel(it["grad"], gs.grad)
        assert rel(it["values"], pol.values) < 1e-6
        for k in ("returns", "best_return", "improvement"):
            assert rel(it["info"][k], getattr(info, k)) < 1e-6, k
    # the JAX test's bounds
    assert float(gs.grad.abs().sum()) > 0.0
    assert float(info.improvement) >= -1e-6
    # a state carried across from the JAX estimate
    gs2 = sample_gradient_state_from_numpy(its[-1]["grad"], dtype=F64)
    assert torch.equal(gs2.grad, t64(its[-1]["grad"]))


def check_spline_maps():
    ref, x = reference("light"), inputs()
    kt, tt = t64(x["knot_times"]), t64(x["times"])
    for o in SplineOrder:
        W = tgrad.interp_weights(tt, kt, o)
        assert rel(ref["interp"][int(o)], W) < 1e-12, o
        fit = spline_fit(t64(x["fit_u"]), tt, kt, o)
        assert rel(ref["spline_fit"][int(o)], fit) < 1e-9, o
    # tests/test_planners_extra.py: W reproduces the spline; fitting
    # samples of a spline recovers its knots
    kt, tt = torch.linspace(0, 1, 5, dtype=F64), torch.linspace(0, 1, 20,
                                                                dtype=F64)
    vals = torch.sin(kt)[:, None]
    W = tgrad.interp_weights(tt, kt, SplineOrder.LINEAR)
    assert float((W @ vals - spline_sample(kt, vals, tt,
                                           SplineOrder.LINEAR)).abs().max()) \
        < 1e-6
    kt, tt = torch.linspace(0, 1, 4, dtype=F64), torch.linspace(0, 1, 30,
                                                                dtype=F64)
    knots = t64([[0.1], [0.5], [-0.3], [0.2]])
    u = spline_sample(kt, knots, tt, SplineOrder.LINEAR)
    assert float((spline_fit(u, tt, kt, SplineOrder.LINEAR)
                  - knots).abs().max()) < 1e-3


def check_gradient_pendulum():
    its = reference("light")["gradient"]
    m, task, s0 = pendulum()
    cfg = GradientConfig(order=SplineOrder.LINEAR, **GRAD)
    pol = init_policy(m, cfg.nknots, dtype=F64)
    nominal0 = None
    for it in its:
        pol, info = gradient_plan(m, task, cfg, pol, s0)
        if nominal0 is None:
            nominal0 = float(info.nominal_return)
        for k in ("returns", "best_return", "improvement"):
            assert rel(it["info"][k], getattr(info, k)) < 1e-6, k
        assert rel(it["values"], pol.values) < 1e-6
    # the JAX test's bounds
    assert float(info.best_return) < 0.7 * nominal0
    assert float(info.improvement) >= -1e-6


def check_gradient_humanoid():
    ref = reference("humanoid")["gradient"]
    m = tm64()
    pm = make_plan_model(m, PLAN_DT)
    task = stand_task(dtype=F64, device="cpu")
    s0 = make_state(m, qpos=th.stand_qpos(m))
    cfg = GradientConfig(horizon=GRAD_H)
    with premise(troll, tgrad) as spy:
        pol, info = gradient_plan(pm, task, cfg,
                                  init_policy(m, cfg.nknots), s0)
    assert spy.n == GRAD_H * (1 + 1)
    for k in ("returns", "best_return", "nominal_return", "improvement"):
        err = rel(ref["info"][k], getattr(info, k))
        assert err < 1e-6, (k, err)
    assert int(info.winner) == int(ref["info"]["winner"])
    assert rel(ref["values"], pol.values) < 1e-6
    assert rel(ref["times"], pol.times) < 1e-12


def check_ilqs():
    its = reference("light")["ilqs"]
    m, task, s0 = pendulum()
    cfg = ILQSConfig(sampling=SamplingConfig(**ILQS_S),
                     ilqg=ILQGConfig(**ILQS_G))
    ps = ilqs_init(m, cfg, s0, init_policy(m, 3, dtype=F64))
    start = ILQSState.from_numpy(its[0]["state"], dtype=F64)
    for a, b in ((ps.spline.values, start.spline.values),
                 (ps.ilqg.policy.u_nom, start.ilqg.policy.u_nom),
                 (ps.ilqg.reg, start.ilqg.reg)):
        assert torch.equal(a, b)
    infos = []
    for i, it in enumerate(its[1:]):
        if i:
            # the second iteration starts from the JAX state's leaves
            ps = ILQSState.from_numpy(its[i]["state"], dtype=F64)
        ps, info = ilqs_plan(m, task, cfg, ps, s0, noise=t64(it["noise"]))
        ref = it["state"]
        assert rel(ref["spline"]["values"], ps.spline.values) < 1e-6
        for k in ("u_nom", "K", "qpos_nom", "qvel_nom"):
            err = rel(ref["ilqg"]["policy"][k], getattr(ps.ilqg.policy, k))
            assert err < 1e-6, (i, k, err)
        assert rel(ref["ilqg"]["reg"], ps.ilqg.reg) < 1e-6
        assert bool(ps.active_ilqg) == bool(ref["active_ilqg"])
        for k in ("returns", "best_return", "nominal_return", "improvement"):
            assert rel(it["info"][k], getattr(info, k)) < 1e-6, (i, k)
        infos.append(info)
    # the JAX test's bounds
    assert np.isfinite(float(infos[0].best_return))
    assert float(infos[1].best_return) < 0.75 * float(
        infos[0].nominal_return)


def check_riccati():
    ref = reference("light")["riccati"]
    for key, shape in (("64", (64, 6, 3, 0)), ("40", (40, 3, 2, 3))):
        args = [t64(a) for a in _random_lqr(*shape)]
        par, seq = parallel_riccati(*args), sequential_riccati(*args)
        for name, mine, theirs in (("par", par, ref[key]["par"]),
                                   ("seq", seq, ref[key]["seq"])):
            for a, r in zip(mine, theirs):
                assert rel(r, a) < 1e-12, (key, name, rel(r, a))
        T = shape[0]
        for a, b in zip(par, seq):
            assert rel(b, a[:T]) < 1e-12
    # tests/test_parallel_riccati.py: the policy is finite-horizon
    # optimal against perturbed policies
    T, n, nu = 40, 3, 2
    A, B, c, cxx, cxu, cuu, cx, cu, PT, pT = _random_lqr(T, n, nu, seed=3)
    Kp, kp, _, _ = (a.numpy() for a in parallel_riccati(
        *(t64(a) for a in (A, B, c, cxx, cxu, cuu, cx, cu, PT, pT))))

    def cost(K, k):
        x = np.ones(n) * 0.3
        total = 0.0
        for t in range(T):
            u = -K[t] @ x - k[t]
            total += (0.5 * x @ cxx[t] @ x + cx[t] @ x + 0.5 * u @ cuu[t] @ u
                      + cu[t] @ u + x @ cxu[t] @ u)
            x = A[t] @ x + B[t] @ u + c[t]
        return total + 0.5 * x @ PT @ x + pT @ x
    base = cost(Kp, kp)
    rng = np.random.default_rng(11)
    for _ in range(5):
        assert cost(Kp + 0.03 * rng.standard_normal(Kp.shape),
                    kp + 0.03 * rng.standard_normal(kp.shape)) > base - 1e-9


def humanoid_lqr(T: int):
    """The humanoid's linearization at the stand (plan dt 0.02, a
    17-step zero-control nominal, `trajectory_derivatives`), its 17
    knots tiled to T steps, with the stand task's cost expansions and
    the last knot's as the terminal cost: LQR inputs as float64
    tensors."""
    d = _stand_derivatives()
    idx = torch.arange(T) % d.A.shape[0]
    return [d.A[idx], d.B[idx], torch.zeros((T, d.A.shape[1]), dtype=F64),
            d.cxx[idx], d.cxu[idx], d.cuu[idx], d.cx[idx], d.cu[idx],
            d.cxx[-1], d.cx[-1]]


@functools.lru_cache(maxsize=None)
def _stand_derivatives():
    pm = make_plan_model(tm64(), PLAN_DT)
    s = make_state(pm, qpos=th.stand_qpos(pm))
    u = torch.zeros((17, pm.nu), dtype=F64)
    qp, qv, tt = [s.qpos[0]], [s.qvel[0]], [s.time[0]]
    for t in range(17):
        s, _ = step(pm, s, u[t:t + 1])
        qp.append(s.qpos[0])
        qv.append(s.qvel[0])
        tt.append(s.time[0])
    return trajectory_derivatives(pm, stand_task(dtype=F64, device="cpu"),
                                  torch.stack(qp), torch.stack(qv), u,
                                  torch.stack(tt))


def check_riccati_long_horizon():
    """The fault of the reference's recursion and the port's repair: at
    128 steps of the humanoid's own linearization, the JAX sequential
    pass (P never symmetrized) has lost symmetry and grown past 1e20,
    the port's sequential pass holds P symmetric and bounded, and the
    parallel pass agrees with it at 1e-10."""
    args = humanoid_lqr(128)
    _, _, Pj, _ = jpr.sequential_riccati(*(jnp.asarray(a.numpy())
                                           for a in args))
    assert float(np.abs(np.asarray(Pj)).max()) > 1e20
    par, seq = parallel_riccati(*args), sequential_riccati(*args)
    assert float(seq[2].abs().max()) < 1e4
    assert torch.equal(seq[2], seq[2].transpose(-1, -2))
    for a, b in zip(par, seq):
        assert rel(b, a[:128]) < 1e-10, rel(b, a[:128])


# tests/test_tune.py's scenarios, on either package's study classes

def _quadratic_objective(trial):
    x = trial.suggest_float("x", 1e-3, 1.0, log=True)
    y = trial.suggest_categorical("y", ("a", "b", "c"))
    return -((np.log10(x) - np.log10(0.3)) ** 2) + {"a": 0.0, "b": 0.5,
                                                    "c": 0.1}[y]


def _tune_scenarios(T):
    """Each scenario's trial records on the tune module `T`."""
    off = dict(n_startup_trials=10 ** 9)
    out = {}

    def study(sampler, pruner, objective, n):
        s = T.Study(sampler=sampler, pruner=pruner)
        s.optimize(objective, n_trials=n, verbose=False)
        return s
    for seed in range(3):
        for name, smp in (("tpe", T.TPESampler(seed=seed)),
                          ("random", T.RandomSampler(seed=seed))):
            s = study(smp, T.MedianPruner(**off), _quadratic_objective, 40)
            out[f"best_of_{name}{seed}"] = s.trials
    out["exploits"] = study(T.TPESampler(n_startup_trials=10, seed=1),
                            T.MedianPruner(**off), _quadratic_objective,
                            50).trials
    out["categorical"] = study(T.TPESampler(n_startup_trials=8, seed=2),
                               T.MedianPruner(**off), _quadratic_objective,
                               40).trials

    def curves(trial):
        x = trial.suggest_float("x", 0.0, 1.0)
        for st in range(1, 4):
            trial.report(x * st, step=st)
            if trial.should_prune():
                raise T.TrialPruned()
        return 3.0 * x
    out["prunes"] = study(T.RandomSampler(seed=3),
                          T.MedianPruner(n_startup_trials=4,
                                         n_warmup_steps=1), curves,
                          30).trials

    def once(trial):
        x = trial.suggest_float("x", 0.0, 1.0)
        trial.report(x, step=1)
        if trial.should_prune():
            raise T.TrialPruned()
        return x
    s = study(T.RandomSampler(seed=4),
              T.MedianPruner(n_startup_trials=3, n_warmup_steps=1), once, 20)
    out["best_ignores_pruned"] = s.trials + [s.best_trial]
    return out


def check_tune():
    ref, out = _tune_scenarios(jtune), _tune_scenarios(ttune)
    assert ref.keys() == out.keys()
    for k in ref:
        assert out[k] == ref[k], k
    # the scenarios' bounds (tests/test_tune.py)

    def best(trials):
        return max(t["value"] for t in trials if t["state"] == "COMPLETE")
    tpe = np.mean([best(out[f"best_of_tpe{s}"]) for s in range(3)])
    rnd = np.mean([best(out[f"best_of_random{s}"]) for s in range(3)])
    assert tpe > -0.05 and tpe >= rnd - 1e-9
    late = [t["params"]["x"] for t in out["exploits"][30:]]
    assert np.mean([abs(np.log10(v) - np.log10(0.3)) < 0.5
                    for v in late]) >= 0.5
    late = [t["params"]["y"] for t in out["categorical"][25:]]
    assert late.count("b") > len(late) // 2
    pruned = [t for t in out["prunes"] if t["state"] == "PRUNED"]
    done = [t for t in out["prunes"] if t["state"] == "COMPLETE"]
    assert len(pruned) >= 5
    assert (np.median([t["params"]["x"] for t in pruned])
            < np.median([t["params"]["x"] for t in done]))
    p = ttune.MedianPruner(n_startup_trials=2, n_warmup_steps=2)
    assert not p.should_prune(1, -100.0, [{1: 0.0}, {1: 0.0}])
    assert not p.should_prune(2, -100.0, [{2: 0.0}])
    assert p.should_prune(2, -100.0, [{2: 0.0}, {2: 1.0}])
    *trials, top = out["best_ignores_pruned"]
    assert top["state"] == "COMPLETE" and top["value"] == best(trials)


def check_tune_objective():
    """One trial of the port's PPO objective on the CPU (iters 2, 4
    envs): two finite reports, a finite value, one JSON line logged."""
    with tempfile.TemporaryDirectory() as d:
        log = os.path.join(d, "tune.jsonl")
        study = ttune.Study(sampler=ttune.TPESampler(seed=0),
                            pruner=ttune.MedianPruner(), log_path=log)
        best = study.optimize(ttune.make_objective(iters=2, n_envs=4,
                                                   n_evals=2, device="cpu"),
                              n_trials=1, verbose=False)
        rec = [json.loads(ln) for ln in open(log)]
    assert best["state"] == "COMPLETE" and np.isfinite(best["value"])
    assert len(study.completed_curves[0]) == 2
    assert all(np.isfinite(v) for v in study.completed_curves[0].values())
    assert rec == study.trials


def check_plot():
    """plot_curves draws a PNG from the log of the port's rl.train."""
    with tempfile.TemporaryDirectory() as d:
        ttrain.main(["--algo", "sac", "--envs", "2", "--eval-every", "1",
                     "--device", "cpu", "--steps", "128", "--out", d])
        log = os.path.join(d, "train.log.jsonl")
        rows = tplot.load_log(log)
        assert len(rows) == 2 and "mean_reward" in rows[0]
        png = tplot.plot_curves(log, os.path.join(d, "curves.png"), "sac")
        with open(png, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def check_render_and_scene():
    ref = reference("light")
    m = tm64()
    q0 = th.stand_qpos(m).numpy()
    q = q0.copy()
    q[7:] += inputs()["render_dq"]
    for key, kw in (("frame", {}), ("frame_green", dict(greenscreen=True))):
        img = trender.render_frame(m, q, width=160, height=120, **kw)
        assert img.shape == ref[key].shape and img.dtype == np.uint8
        differ = np.any(img != ref[key], axis=-1).mean()
        assert differ <= 0.01, (key, differ)
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 10
    scene = tviewer.trajectory_scene(m, scene_traj(q0), stride=2)
    r = ref["scene"]
    assert scene.keys() == r.keys()
    for k in scene:
        if k in ("frames", "radii", "hfield_halfsize"):
            assert rel(r[k], np.asarray(scene[k])) < 1e-9, k
        else:
            assert scene[k] == r[k], k
    json.loads(json.dumps(scene))
    with tempfile.TemporaryDirectory() as d:
        html = open(tviewer.export_html(scene, os.path.join(d, "v.html"))
                    ).read()
    assert html.startswith("<!DOCTYPE html>") and "const S = {" in html


def check_record_episode(env_ref):
    """record_episode for 10 control steps against the JAX one, on the
    same draws (the RL env reference's)."""
    v = env_ref["video"]
    rd = trl.reset_draws({k: np.asarray(a)[None] for k, a in
                          v["reset_draws"].items()})
    sd = [trl.step_draws({k: np.asarray(a)[None] for k, a in d.items()})
          for d in v["step_draws"]]
    em, traj = tvid.record_episode(None, seconds=0.02, device="cpu",
                                   dtype=F64, reset_draws=rd, step_draws=sd)
    assert traj.shape == v["traj"].shape, (traj.shape, v["traj"].shape)
    assert rel(v["traj"], traj) < 1e-6, rel(v["traj"], traj)
    assert rel(v["hfield"], trender.hfield(em)) < 1e-12
    # the port's own draws: a generator seeded 0
    em, traj = tvid.record_episode(None, seconds=0.01, device="cpu")
    assert traj.shape == (6, 19) and np.all(np.isfinite(traj))


def run_local_checks():
    """The checks that need no JAX reference process."""
    check_tune()
    check_tune_objective()
    check_plot()
    check_riccati_long_horizon()


def run_reference_checks(references=None, env_ref=None):
    """The checks against the JAX references; `references` holds results
    of `reference` built elsewhere (in other processes), `env_ref` the
    RL slice's env reference (tests/test_torch_rl.py)."""
    _RESULTS.update(references or {})
    check_ou_wrench_sequence()
    check_rollout_wrenches()
    check_robust()
    check_sample_gradient()
    check_spline_maps()
    check_gradient_pendulum()
    check_gradient_humanoid()
    check_ilqs()
    check_riccati()
    check_render_and_scene()
    check_record_episode(env_ref if env_ref is not None
                         else trl.reference("env"))


def run_checks(references=None, env_ref=None):
    run_local_checks()
    run_reference_checks(references, env_ref)
