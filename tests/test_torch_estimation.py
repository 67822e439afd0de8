"""Port parity: state estimation and the direct trajectory optimizer.

Float64 on the CPU (the JAX side with x64) on the full-width humanoid
unless noted, the same numpy-seeded inputs through both packages;
tolerances are max-abs error over max-abs value:

- `measure` and `measurement_jacobian` on 4 states near the stand pose
  at 1e-12, and `default_sensor_model`'s noise (float32 unless given);
- `ekf_update` (with the services' default float32 sensor noise, the
  JAX ServingFilter's own compiled update), `ukf_update` and
  `batch_update` (window 4, one Gauss-Newton iteration), two filters in
  lockstep from two wrong starts inside the joint ranges on measurements
  of a simulated stand: the state, covariance and innovation (the batch
  estimator's window and estimate) after one update at 1e-9 (the EKF's
  and the batch estimator's at 2e-8, `JITTER_TOL`; the EKF's at 1e-12
  against JAX with that jitter at 0), and after each of 10 chained
  updates at 1e-6;
- `direct_residuals` and its Jacobian (the port's one dual pass against
  JAX's `jacfwd`) on a noisy 8-knot window without contact forces,
  and with them and `estimate_params=("mass_scale",)` at theta 0.05
  (the θ column on its own) at 1e-9;
- `direct_optimize` with 2 Gauss-Newton iterations on the humanoid at
  T = 5 (against the JAX DirectService's optimize of the same window
  and settings; the root's coordinates at 1e-3, see `result_held`) and
  on ParticleFixed (the generic (qpos, qvel) measurement, the "free"
  route) at T = 8, at 1e-6;
- `ServingFilter` over 10 observations of a shoved stand, the first one
  through the root-height search (at 1e-9), the first update at 2e-8,
  all at 1e-6; every `FilterService` verb (tests/test_serving.py
  :190-207, tests/test_grpc_estimation.py's filter half) and every
  `DirectService` verb (tests/test_grpc_estimation.py's direct half),
  the optimize against the JAX service's;
- the JAX package's own estimator and direct scenarios on the port's
  float64 CPU twins, their jax.random draws reproduced, with their
  thresholds: EKF from a 0.1 rad wrong start inside the joint ranges
  (30 updates, error < 0.3 err0, finite covariance; from the test's own
  start, three joints past their limits, the port equals the JAX EKF on
  its kernel branch at 1e-6, over the bound: `check_estimator_scenarios`)
  and its covariance after 10 (eigenvalues in (-1e-9, 1)); UKF (20,
  < 0.5 err0); batch
  (window 4, one iteration, 12 updates, error < 0.05); direct: the
  denoised window (T 10, 3 iterations: the cost falls, the error below
  0.7 of its start), the contact residual under 0.2 of the smooth one
  at the truth, and the mass scale 1.15 ± 0.05 from an actuated flight
  (6 iterations); and `MPCServer(filter="ekf")` serving two requests
  (tests/test_serving.py:209-222).

The JAX CPU step keeps the 32 contact slots with the smallest gaps, the
port's step none (ROADMAP queue 3 item 3): every non-derivative `step`
the port's estimators take in a parity check is held to the premise
that each loaded slot is among the 32 smallest gaps, where the two
solve the same problem. The measurements come from the port's float64
step; both packages read the same numbers.

The JAX references (jit compiles of the updates and of the optimizer)
are built in processes of their own by tests/test_torch_port.py;
`run_checks` builds them in this process.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu import estimators as jest
from humanoid_mujoco_tpu.direct import optimizer as jdirect
from humanoid_mujoco_tpu.direct.service import DirectService as JDirectService
from humanoid_mujoco_tpu.estimators import kalman as jkalman
from humanoid_mujoco_tpu.estimators import sensors as jsens
from humanoid_mujoco_tpu.estimators import unscented as junscented
from humanoid_mujoco_tpu.ops import linalg as jlinalg
from humanoid_mujoco_tpu.physics import humanoid as jh
from humanoid_mujoco_tpu.physics import tangent as jtan
from humanoid_mujoco_tpu.physics.model import State as JState
from humanoid_mujoco_tpu.serving import filtering as jfilt
from humanoid_mujoco_tpu.tasks import registry as jregistry

from humanoid_mujoco_torch import estimators as est
from humanoid_mujoco_torch.agent import Agent
from humanoid_mujoco_torch.direct import DirectService
from humanoid_mujoco_torch.direct import optimizer as tdirect
from humanoid_mujoco_torch.estimators import batch as tbatch
from humanoid_mujoco_torch.estimators import kalman as tkalman
from humanoid_mujoco_torch.estimators import sensors as tsens
from humanoid_mujoco_torch.estimators import unscented as tukf
from humanoid_mujoco_torch.physics import humanoid as th
from humanoid_mujoco_torch.physics.model import State, make_state
from humanoid_mujoco_torch.physics.step import step
from humanoid_mujoco_torch.serving import FilterService, MPCServer, \
    ServingFilter
from humanoid_mujoco_torch.tasks import registry, stand_task

import test_torch_refs as refs
import test_torch_rl as trl

torch.set_num_threads(1)
# tests/conftest.py sets this too; the references run in processes of
# their own, which do not import conftest
jax.config.update("jax_enable_x64", True)

F64 = torch.float64
rel, t64, tree_np = trl.rel, trl.t64, trl.tree_np
CHAIN = 10                       # chained updates held at 1e-6
STARTS = (0.1, 0.05)             # the two filters' joint offsets
BATCH_W = 4
DIRECT_T, PARTICLE_T = 5, 8
RES_T, RES_THETA = 8, 0.05
RES_CASES = (("smooth", dict(contact_forces=False)),
             ("contact_mass", dict(contact_forces=True,
                                   estimate_params=("mass_scale", ))))
SERVE_OBS = 10


@functools.lru_cache(maxsize=None)
def jm64():
    return jh.build_humanoid(dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def tm64():
    return th.build_humanoid(dtype=F64, device="cpu")


def jsensor(jm=None):
    return jsens.default_sensor_model(jm or jm64(), dtype=jnp.float64)


def tsensor(m=None):
    return tsens.default_sensor_model(m or tm64(), dtype=F64)


def jstate(q, v, t=0.0):
    return JState(jnp.asarray(q), jnp.asarray(v), jnp.asarray(t,
                                                               jnp.float64))


def run_o0(fn, *args):
    """fn(*args) jit-compiled at XLA optimization level 0: the same
    numbers, less compile time."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


@functools.lru_cache(maxsize=None)
def simulate(n, seed, noise=0.01, q0=None, qvel0=None, ctrl=0.0,
             mass=1.0):
    """The port's float64 step from the stand pose (or q0) with a
    constant control, n steps: (qpos (n+1, nq), qvel (n+1, nv), noisy
    measurements ys (n+1, ny) of every state, numpy seed)."""
    m = tm64()
    if mass != 1.0:
        m = m.replace(body_mass=m.body_mass * mass)
    q = th.stand_qpos(m) if q0 is None else t64(q0)
    s = make_state(m, qpos=q, qvel=None if qvel0 is None else t64(qvel0))
    u = torch.full((1, m.nu), ctrl, dtype=F64)
    qs, vs = [s.qpos], [s.qvel]
    for _ in range(n):
        s, _ = step(m, s, u)
        qs.append(s.qpos)
        vs.append(s.qvel)
    qs, vs = torch.cat(qs), torch.cat(vs)
    ys = tsens.measure(m, qs, vs).numpy()
    ys = ys + noise * np.random.default_rng(seed).standard_normal(ys.shape)
    return qs.numpy(), vs.numpy(), ys


def jax_noise(n, key, scale, ny=30):
    """The measurement noise of tests/test_estimators.py's
    `simulate_measurements` (and the direct test's): per step, a split
    of `key` and `scale` times its float64 normals (n, ny)."""
    out = []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, (ny, ), jnp.float64)))
    return scale * np.stack(out)


def jax_scenario(n, key, scale=0.01):
    """The truth (qpos, qvel) of n steps from the stand pose at zero
    control (the port's float64 step) and the JAX tests' noisy
    measurements of steps 1..n (ys[0], the start's, noise-free)."""
    qs, vs, ys = simulate(n, 0, noise=0.0)
    ys = ys.copy()
    ys[1:] += jax_noise(n, jax.random.PRNGKey(key), scale)
    return qs, vs, ys


def near_stand(B, seed):
    """B states near the stand pose (joints 0.03 N, qvel 0.1 N)."""
    rng = np.random.default_rng(seed)
    q = np.tile(th.stand_qpos(tm64()).numpy(), (B, 1))
    q[:, 7:] += 0.03 * rng.standard_normal((B, 12))
    return q, 0.1 * rng.standard_normal((B, 18))


def wrong_start(off):
    """The stand pose with every joint moved by `off` (rad) into its
    range: -off on the three arm joints whose upper limit is 0, +off on
    the others. The JAX tests move every joint by +off, which puts those
    three past their limits (see `check_estimator_scenarios`)."""
    m = tm64()
    q = th.stand_qpos(m).numpy().copy()
    hi = m.jnt_range.numpy()[1:, 1]
    q[7:] += np.where(hi >= off, off, -off)
    return q


def filter_starts():
    """(qpos (2, nq), qvel (2, nv)): `wrong_start` of each of STARTS, at
    rest."""
    return np.stack([wrong_start(o) for o in STARTS]), np.zeros((2, 18))


def batch_start():
    q0 = th.stand_qpos(tm64()).numpy()
    return np.stack([q0, q0]), np.zeros((2, 18))


def residual_window(seed=4):
    """A noisy RES_T-knot window of the simulated stand: (qs, ys, us)."""
    qs, _, ys = simulate(RES_T - 1, 40)
    qs = qs.copy()
    qs[:, 7:] += 0.01 * np.random.default_rng(seed).standard_normal(
        (RES_T, 12))
    return qs, ys, np.zeros((RES_T, 12))


def direct_window():
    """A noisy DIRECT_T-knot window of the simulated stand."""
    qs, _, ys = simulate(DIRECT_T - 1, 41)
    qs = qs.copy()
    qs[:, 7:] += 0.03 * np.random.default_rng(5).standard_normal(
        (DIRECT_T, 12))
    return qs, ys, np.zeros((DIRECT_T, 12))


def particle_window():
    """ParticleFixed's model: an 8-knot window from a moving start under
    a constant control, noisy positions and measurements."""
    m = registry.task_model("ParticleFixed", dtype=F64, device="cpu")
    rng = np.random.default_rng(6)
    s = make_state(m, qpos=t64([0.05, -0.02]), qvel=t64([0.3, -0.1]))
    u = t64([[0.4, -0.2]])
    qs = [s.qpos]
    for _ in range(PARTICLE_T - 1):
        s, _ = step(m, s, u)
        qs.append(s.qpos)
    qs = torch.cat(qs).numpy()
    vs = np.vstack([np.zeros((1, 2)), np.diff(qs, axis=0) / float(m.dt)])
    ys = np.hstack([qs, vs]) + 0.01 * rng.standard_normal((PARTICLE_T, 4))
    return (qs + 0.005 * rng.standard_normal(qs.shape), ys,
            np.tile([0.4, -0.2], (PARTICLE_T, 1)))


def serve_observations():
    """SERVE_OBS robot reports (joint_pos, joint_vel, ang_vel, quat) of
    a stand shoved at 0.3 m/s along x, and the truth's root velocity."""
    q0 = th.stand_qpos(tm64()).numpy()
    v0 = np.zeros(18)
    v0[0] = 0.3
    qs, vs, _ = simulate(SERVE_OBS - 1, 0, q0=tuple(q0), qvel0=tuple(v0))
    return [(q[7:], v[6:], v[3:6], q[3:7]) for q, v in zip(qs, vs)], vs


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------

def _chain(update, init, starts, ys):
    """Each start's filter through `update` over ys[1:CHAIN+1]: per
    filter, the list of (state leaves, innovation) after each update."""
    out = []
    for q, v in zip(*starts):
        f = init(jstate(q, v))
        steps = []
        for y in ys[1:CHAIN + 1]:
            f, extra = update(f, jnp.asarray(y))
            steps.append(tree_np((f, extra)))
        out.append(steps)
    return out


def _jax_sensors():
    jm = jm64()
    q, v = near_stand(4, 1)
    return dict(
        y=np.asarray(jax.vmap(lambda a, b: jsens.measure(jm, a, b))(q, v)),
        H=np.asarray(jax.vmap(lambda a, b: jsens.measurement_jacobian(
            jm, a, b))(q, v)),
        noise32=np.asarray(jsens.default_sensor_model(jm).noise),
        noise_particle=np.asarray(jsens.default_sensor_model(
            jregistry.task_model("ParticleFixed", dtype=jnp.float64),
            dtype=jnp.float64).noise))


@functools.lru_cache(maxsize=None)
def jax_serving_update():
    """The JAX ServingFilter's jitted `ekf_update` (EKFConfig(), the
    default float32 sensor noise, the float64 humanoid): the EKF chain,
    the ServingFilter and the FilterService references share its one
    compile."""
    return jfilt.ServingFilter(jm64())._update


def _jax_ekf():
    jm, u = jm64(), jnp.zeros(12, jnp.float64)
    upd = jax_serving_update()
    return _chain(lambda e, y: upd(e, u, y),
                  lambda s: jest.ekf_init(jm, jest.EKFConfig(), s),
                  filter_starts(), simulate(CHAIN, 0)[2])


def _jax_ukf():
    """The JAX UKF run eagerly around a jitted step: jit-compiling the
    whole update unrolls its 36 x 36 Cholesky (ops/linalg.py) into a
    program whose XLA compile takes over 12 GB on the CPU, while the
    eager update runs the same operations."""
    jm, sensor, u = jm64(), jsensor(), jnp.zeros(12, jnp.float64)
    cfg = jest.UKFConfig()
    saved = junscented.step
    stepj = jax.jit(lambda s, c: saved(jm, s, c,
                                       solver_iters=cfg.solver_iters))
    junscented.step = lambda m, s, c, solver_iters: stepj(s, c)
    try:
        return _chain(lambda e, y: jest.ukf_update(jm, cfg, sensor, e, u, y),
                      lambda s: jest.ukf_init(jm, cfg, s), filter_starts(),
                      simulate(CHAIN, 2)[2])
    finally:
        junscented.step = saved


def _jax_batch():
    jm, sensor, u = jm64(), jsensor(), jnp.zeros(12, jnp.float64)
    cfg = jest.BatchConfig(window=BATCH_W, gn_iters=1)
    b0 = jest.batch_init(jm, cfg, jstate(*(x[0] for x in batch_start())))
    upd = jax.jit(lambda b, y: jest.batch_update(jm, cfg, sensor, b, u, y)
                  ).lower(b0, jnp.zeros(30, jnp.float64)).compile(
                      {"xla_backend_optimization_level": 0})
    return _chain(upd, lambda s: jest.batch_init(jm, cfg, s), batch_start(),
                  simulate(CHAIN, 3, noise=0.005)[2])


def _jax_ekf_kernel_branch():
    """tests/test_estimators.py's EKF scenario (every joint +0.1, its
    PRNGKey(0) draws), 30 updates, the predict through the JAX step's
    kernel branch with its plain references (test_torch_rl's
    `jax_kernel_path_step`, selection-free)."""
    jm, sensor, u = jm64(), jsensor(), jnp.zeros(12, jnp.float64)
    cfg = jest.EKFConfig()
    qs, _, ys = jax_scenario(30, 0)
    bad = qs[0].copy()
    bad[7:] += 0.1
    saved = jkalman.step
    jkalman.step = trl.jax_kernel_path_step
    try:
        upd = jax.jit(lambda e, y: jest.ekf_update(jm, cfg, sensor, e, u,
                                                   y))
        e = jest.ekf_init(jm, cfg, jstate(bad, np.zeros(18)))
        out = {k: [] for k in ("qpos", "qvel", "cov", "innov")}
        for y in ys[1:31]:
            e, innov = upd(e, jnp.asarray(y))
            for k, v in (("qpos", e.state.qpos), ("qvel", e.state.qvel),
                         ("cov", e.cov), ("innov", innov)):
                out[k].append(np.asarray(v))
    finally:
        jkalman.step = saved
    return out


def _jax_ekf_no_jitter():
    """The first update of `_jax_ekf`'s filters with the 1e-10 diagonal
    jitter of JAX's native-scope Cholesky set to 0: the factorizations
    of its derivative path (`step_tangent_jacobians` runs in
    `native_scope`) then factor what the port's do."""
    saved = jlinalg._JITTER
    jlinalg._JITTER = 0.0
    try:
        jm, u = jm64(), jnp.zeros(12, jnp.float64)
        sensor = jsens.default_sensor_model(jm)
        cfg = jest.EKFConfig()
        upd = jax.jit(lambda e, y: jest.ekf_update(jm, cfg, sensor, e, u,
                                                   y))
        y = jnp.asarray(simulate(CHAIN, 0)[2][1])
        return [tree_np(upd(jest.ekf_init(jm, cfg, jstate(q, v)), y))
                for q, v in zip(*filter_starts())]
    finally:
        jlinalg._JITTER = saved


def _jax_dense_jacobian(jm, cfg, sensor, qs, ys, us, dt, theta):
    """direct_optimize's own (r, J) at dx = 0: jacfwd over the stacked
    tangent of the window and the parameters, in its native_scope."""
    T, nv = qs.shape[0], jm.nv
    npar = len(jdirect._param_names(cfg))

    def res_of(dx):
        qp = jax.vmap(lambda q, d: jtan.state_add(jm, q, d))(
            qs, dx[:T * nv].reshape(T, nv))
        return jdirect.direct_residuals(jm, cfg, sensor, qp, ys, us, dt,
                                        theta + dx[T * nv:])

    z = jnp.zeros(T * nv + npar, jnp.float64)
    r = res_of(z)
    with jlinalg.native_scope():
        return r, jax.jacfwd(res_of)(z)


def _jax_residuals():
    jm, sensor = jm64(), jsensor()
    qs, ys, us = (jnp.asarray(x) for x in residual_window())
    out = {}
    for name, kw in RES_CASES:
        cfg = jdirect.DirectConfig(**kw)
        npar = len(jdirect._param_names(cfg))
        theta = jnp.full((npar, ), RES_THETA, jnp.float64)
        out[name] = [np.asarray(x) for x in run_o0(
            lambda q, y, u, th_: _jax_dense_jacobian(
                jm, cfg, sensor, q, y, u, float(jm.dt), th_),
            qs, ys, us, theta)]
    return out


def _jax_direct():
    """`direct_optimize` on ParticleFixed's window, 2 iterations."""
    cfg = jdirect.DirectConfig(gn_iters=2)
    pm = jregistry.task_model("ParticleFixed", dtype=jnp.float64)
    ps = jsens.default_sensor_model(pm, dtype=jnp.float64)
    qs, ys, us = (jnp.asarray(x) for x in particle_window())
    return tree_np(run_o0(
        lambda q: jdirect.direct_optimize(pm, cfg, ps, q, ys, us,
                                          float(pm.dt)), qs))


def _jax_serving_filter():
    """ServingFilter over the shoved stand's reports; FilterService's
    update from the stand pose (the service's filter reuses the first
    one's jitted update: the same model, config and sensor). The
    services' default float32 sensor noise, float64 models."""
    jm = jm64()
    obs, _ = serve_observations()
    f = jfilt.ServingFilter(jm)
    f._update = jax_serving_update()
    u = np.zeros(12)
    states = []
    for o in obs:
        s = f.update(*o, last_ctrl=u)
        states.append(tree_np(s) | dict(cov=np.asarray(f.covariance),
                                        innovation=f.innovation))
    svc = jfilt.FilterService(jm)
    svc._f._update = jax_serving_update()
    q0 = np.asarray(jh.stand_qpos(jm))
    svc.init(q0)
    y = np.asarray(jsens.measure(jm, jnp.asarray(q0),
                                 jnp.zeros(18, jnp.float64)))
    innov = svc.update(np.zeros(12), y)
    return dict(filter=states,
                service=dict(innov=innov, cov=svc.covariance(),
                             **svc.state()))


def _jax_direct_service():
    """DirectService's optimize on `direct_window` after the settings of
    tests/test_grpc_estimation.py (gn_iters 2, the default weight and
    regularization): `direct_optimize` on the humanoid at T 5."""
    ds = JDirectService(jm64(), configuration_length=DIRECT_T)
    ds.set_settings(gn_iters=2, force_weight=1e-4, regularization=1e-4)
    qs, ys, us = direct_window()
    ds.set_data(qs, sensor=ys, ctrl=us)
    # ds.optimize(), compiled at XLA optimization level 0
    ys, us = jnp.asarray(ds._sensor), jnp.asarray(ds._ctrl)
    return tree_np(run_o0(lambda q: jdirect.direct_optimize(
        ds.m, ds.cfg, ds.sensor, q, ys, us, ds.dt), jnp.asarray(ds._qpos)))


_KINDS = {"sensors": _jax_sensors, "ekf": _jax_ekf, "ukf": _jax_ukf,
          "ekf_kernel_branch": _jax_ekf_kernel_branch,
          "ekf_no_jitter": _jax_ekf_no_jitter, "batch": _jax_batch,
          "residuals": _jax_residuals, "direct": _jax_direct,
          "serving_filter": _jax_serving_filter,
          "direct_service": _jax_direct_service}
# the references in groups of about equal compile time, one process each
_GROUPS = {"filters": ("sensors", "ekf", "serving_filter", "ukf"),
           "ekf_variants": ("ekf_kernel_branch", "ekf_no_jitter"),
           "batch": ("batch", ), "residuals": ("residuals", "direct"),
           "direct_service": ("direct_service", )}
_RESULTS = {}
NAMES = tuple(_GROUPS)


def reference(name: str):
    """The JAX references of group `name` as {kind: result}, built once
    per process."""
    if name not in _RESULTS:
        _RESULTS[name] = {k: _KINDS[k]() for k in _GROUPS[name]}
    return _RESULTS[name]


def mass_matrices(name):
    """Mass matrices of group `name`'s models (the humanoid at its stand
    pose; ParticleFixed where the group builds it), for the loop-form
    Cholesky check (tests/test_torch_refs.py)."""
    out = [refs.at_rest("humanoid", tm64(), th.stand_qpos(tm64()).numpy())]
    if name in ("filters", "residuals"):
        pm = registry.task_model("ParticleFixed", dtype=F64, device="cpu")
        out.append(refs.at_rest("ParticleFixed", pm, registry.home_qpos(
            "ParticleFixed", pm).numpy()))
    return out


def all_references():
    return {k: v for n in NAMES for k, v in reference(n).items()}


# ---------------------------------------------------------------------------
# the premise of the JAX CPU step's top-32 selection
# ---------------------------------------------------------------------------

def assert_top32_premise(info):
    """Every slot that carries force is among the 32 smallest gaps, in
    every env of a step: where the JAX CPU step's top-32 selection and
    the port's selection-free step solve the same problem."""
    gaps = info.contact_dist.numpy()
    loaded = info.contact_force.numpy() > 0
    cut = np.sort(gaps, axis=1)[:, 31:32]
    assert np.all(~loaded | (gaps <= cut)), np.argwhere(loaded & (gaps > cut))


@contextlib.contextmanager
def premise_on_steps():
    """Within the block, every `step` of the estimators (the predicts,
    the sigma points, the window knots) is checked against the top-32
    premise; yields the count of checked steps."""
    mods = (tkalman, tukf, tbatch)
    saved = [mod.step for mod in mods]
    count = [0]

    def spy(*a, **kw):
        out = saved[0](*a, **kw)
        assert_top32_premise(out[1])
        count[0] += 1
        return out
    for mod in mods:
        mod.step = spy
    try:
        yield count
    finally:
        for mod, s in zip(mods, saved):
            mod.step = s


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

def check_sensors():
    c = all_references()["sensors"]
    m = tm64()
    q, v = near_stand(4, 1)
    assert rel(c["y"], tsens.measure(m, t64(q), t64(v))) < 1e-12
    assert rel(c["H"], tsens.measurement_jacobian(m, t64(q), t64(v))) \
        < 1e-12
    noise = tsens.default_sensor_model(m).noise
    assert noise.dtype == torch.float32
    np.testing.assert_array_equal(noise.numpy(), c["noise32"])
    pm = registry.task_model("ParticleFixed", dtype=F64, device="cpu")
    np.testing.assert_array_equal(
        tsens.default_sensor_model(pm, dtype=F64).noise.numpy(),
        c["noise_particle"])
    assert not tsens._is_robot_model(pm)
    y = tsens.measure(pm, t64([[0.1, 0.2]]), t64([[0.3, 0.4]]))
    np.testing.assert_array_equal(y.numpy(), [[0.1, 0.2, 0.3, 0.4]])


def held(ref_chain, outs, leaves, first_tol=1e-9):
    """The port's lockstep outputs against the JAX chains: after the
    first update at `first_tol`, after each of CHAIN updates at 1e-6.
    `outs[k]` is the port's k-th update as a list of batch-leading
    leaves, `leaves(r)` the matching JAX leaves of one filter's record
    r. Returns the largest errors of the first update and of all."""
    first = worst = 0.0
    for k, out in enumerate(outs):
        for i, o in enumerate(out):
            ref = np.stack([leaves(chain[k])[i] for chain in ref_chain])
            err = rel(ref, o)
            assert err < (first_tol if k == 0 else 1e-6), (k, i, err)
            worst = max(worst, err)
            if k == 0:
                first = max(first, err)
    return first, worst


def run_chain(update, f, ys):
    """`update` of the two-filter batch f over ys[1:CHAIN+1]."""
    outs = []
    u = torch.zeros((2, 12), dtype=F64)
    for y in ys[1:CHAIN + 1]:
        f, extra = update(f, u, t64(np.stack([y, y])))
        outs.append((f, extra))
    return outs


# The EKF's and the batch estimator's A come from JAX's
# `step_tangent_jacobians`, which factors in `native_scope`: its Cholesky
# adds 1e-10 to the diagonal of M, M + h·D and the Newton Hessian (and
# the batch estimator's window system gets the same), where the port
# factors them as they are. That moves A by ~6e-9 relative and one
# update's state by up to 6.5e-9 (EKF) and 1.04e-8 (batch window); with
# the jitter set to 0 in the reference (`_jax_ekf_no_jitter`) the EKF's
# first update agrees to 1e-12. So those first updates are held at 2e-8.
JITTER_TOL = 2e-8


def check_filters():
    refs = all_references()
    m, sensor = tm64(), tsensor()
    q, v = filter_starts()
    s0 = State(t64(q), t64(v), torch.zeros(2, dtype=F64))
    with premise_on_steps() as n:
        cfg = est.EKFConfig()
        s32 = tsens.default_sensor_model(m)       # as the ServingFilter's
        outs = run_chain(lambda f, u, y: est.ekf_update(m, cfg, s32, f, u,
                                                        y),
                         est.ekf_init(m, cfg, s0), simulate(CHAIN, 0)[2])
        leaves = [[f.state.qpos, f.state.qvel, f.cov, e] for f, e in outs]
        held(refs["ekf"], leaves,
             lambda r: [r[0]["state"]["qpos"], r[0]["state"]["qvel"],
                        r[0]["cov"], r[1]], first_tol=JITTER_TOL)
        held([[r] for r in refs["ekf_no_jitter"]], leaves[:1],
             lambda r: [r[0]["state"]["qpos"], r[0]["state"]["qvel"],
                        r[0]["cov"], r[1]], first_tol=1e-12)
        assert n[0] == CHAIN
        cfg = est.UKFConfig()
        outs = run_chain(lambda f, u, y: est.ukf_update(m, cfg, sensor, f,
                                                        u, y),
                         est.ukf_init(m, cfg, s0), simulate(CHAIN, 2)[2])
        held(refs["ukf"], [[f.state.qpos, f.state.qvel, f.state.time, f.cov,
                            e] for f, e in outs],
             lambda r: [r[0]["state"]["qpos"], r[0]["state"]["qvel"],
                        r[0]["state"]["time"], r[0]["cov"], r[1]])
        cfg = est.BatchConfig(window=BATCH_W, gn_iters=1)
        q, v = batch_start()
        s0 = State(t64(q), t64(v), torch.zeros(2, dtype=F64))
        outs = run_chain(lambda f, u, y: est.batch_update(m, cfg, sensor, f,
                                                          u, y),
                         est.batch_init(m, cfg, s0),
                         simulate(CHAIN, 3, noise=0.005)[2])
        held(refs["batch"], [[f.qpos_win, f.qvel_win, f.ctrl_win, f.y_win,
                              f.time, f.filled, e.qpos, e.qvel]
                             for f, e in outs],
             lambda r: [r[0]["qpos_win"], r[0]["qvel_win"],
                        r[0]["ctrl_win"], r[0]["y_win"], r[0]["time"],
                        r[0]["filled"], r[1]["qpos"], r[1]["qvel"]],
             first_tol=JITTER_TOL)
        # the shift-in's step and one of the W - 1 knots an iteration
        assert n[0] == 4 * CHAIN


def check_direct_residuals():
    refs = all_references()["residuals"]
    m, sensor = tm64(), tsensor()
    qs, ys, us = (t64(x) for x in residual_window())
    for name, kw in RES_CASES:
        cfg = tdirect.DirectConfig(**kw)
        npar = len(tdirect._param_names(cfg))
        theta = torch.full((npar, ), RES_THETA, dtype=F64)
        r_ref, J_ref = refs[name]
        r, J = tdirect.residual_jacobian(m, cfg, sensor, qs, ys, us,
                                         float(m.dt), theta)
        r2 = tdirect.direct_residuals(m, cfg, sensor, qs, ys, us,
                                      float(m.dt), theta)
        assert rel(r_ref, r) < 1e-9, (name, rel(r_ref, r))
        assert rel(r_ref, r2) < 1e-9, (name, rel(r_ref, r2))
        assert rel(J_ref, J) < 1e-9, (name, rel(J_ref, J))
        if npar:
            # the θ column: the tangent carried by the model's leaf
            assert np.abs(J_ref[:, -1]).max() > 0
            assert rel(J_ref[:, -1], J[:, -1]) < 1e-9, name


def result_held(ref, res, free_root=False):
    """A DirectResult against the JAX one at 1e-6 (an empty leaf by its
    shape). With `free_root` (the humanoid) the root's coordinates
    (qpos[:, :7]), the velocities and the final cost are held at 1e-3,
    the first cost at 1e-12 and the joints at 1e-6: no sensor reads the
    root's x and y (nor its yaw), and the force residual does not change
    when the window moves as a whole, so the Gauss-Newton matrix has
    eigenvalues at the regularization (1e-4) against a largest of ~7e8
    (condition ~7e12). The step along them (~1.6 m at T 5) is set by the
    regularization alone, and two Cholesky solves of that matrix differ
    there by ~1e-4 (numpy's LAPACK against the same factor with JAX's
    1e-10 native-scope jitter: 1.9e-4); the second iteration reads those
    differences through the root's finite-difference velocities, so its
    velocities and cost differ at up to ~2.5e-4."""
    for f in dataclasses.fields(res):
        out = getattr(res, f.name)
        if out.numel() == 0:
            assert ref[f.name].shape == tuple(out.shape), f.name
            continue
        r = ref[f.name]
        tol = 1e-6
        if free_root and f.name == "qpos":
            # each part's max-abs error over the leaf's max-abs value
            d = np.abs(r - out.numpy()) / np.abs(r).max()
            assert d[:, :7].max() < 1e-3, d[:, :7].max()
            assert d[:, 7:].max() < 1e-6, d[:, 7:].max()
            continue
        elif free_root and f.name in ("qvel", "cost"):
            tol = 1e-3
        elif f.name == "cost_initial":
            tol = 1e-12
        assert rel(r, out) < tol, (f.name, rel(r, out))


def check_direct_optimize():
    refs = all_references()
    m = tm64()
    cfg = tdirect.DirectConfig(gn_iters=2)
    qs, ys, us = (t64(x) for x in direct_window())
    res = tdirect.direct_optimize(m, cfg, tsens.default_sensor_model(m), qs,
                                  ys, us, float(m.dt))
    result_held(refs["direct_service"], res, free_root=True)
    assert float(res.cost) < float(res.cost_initial)
    c = refs["direct"]
    pm = registry.task_model("ParticleFixed", dtype=F64, device="cpu")
    ps = tsens.default_sensor_model(pm, dtype=F64)
    qs, ys, us = (t64(x) for x in particle_window())
    res = tdirect.direct_optimize(pm, cfg, ps, qs, ys, us, float(pm.dt))
    result_held(c, res)
    assert float(res.cost) < float(res.cost_initial)


def check_serving():
    c = all_references()["serving_filter"]
    m = tm64()
    obs, _ = serve_observations()
    f = ServingFilter(m)
    assert f.sensor.noise.dtype == torch.float32
    assert f.state is None and f.covariance is None
    with premise_on_steps():
        for k, o in enumerate(obs):
            s = f.update(*o, last_ctrl=np.zeros(12))
            ref = c["filter"][k]
            tol = (1e-9, JITTER_TOL)[k] if k < 2 else 1e-6
            for name, out in (("qpos", s.qpos[0]), ("qvel", s.qvel[0]),
                              ("time", s.time[0]), ("cov", f.covariance)):
                assert rel(ref[name], out) < tol, (k, name)
            assert abs(ref["innovation"] - f.innovation) <= tol * max(
                1.0, abs(ref["innovation"])), k
    f.reset()
    assert f.state is None and f.innovation == 0.0
    # FilterService (tests/test_serving.py:190-207 and the filter half
    # of tests/test_grpc_estimation.py)
    svc = FilterService(m)
    try:
        svc.update(np.zeros(12), np.zeros(30))
        raise AssertionError("update before init must raise")
    except RuntimeError:
        pass
    q0 = th.stand_qpos(m).numpy()
    svc.init(q0)
    st = svc.state()
    np.testing.assert_array_equal(st["qpos"], q0)
    np.testing.assert_array_equal(st["qvel"], np.zeros(18))
    cov = svc.covariance()
    assert cov.shape == (36, 36)
    np.testing.assert_allclose(cov, cov.T, atol=1e-12)
    assert np.all(np.diag(cov) > 0)
    noise = svc.noise()
    assert noise.shape == (30, ) and np.all(noise > 0)
    y = tsens.measure(m, t64(q0)[None], torch.zeros((1, 18),
                                                    dtype=F64))[0].numpy()
    innov = svc.update(np.zeros(12), y)
    ref = c["service"]
    assert np.isfinite(innov)
    assert abs(innov - ref["innov"]) < JITTER_TOL * max(1.0,
                                                        abs(ref["innov"]))
    for name, out in (("cov", svc.covariance()),
                      ("qpos", svc.state()["qpos"]),
                      ("qvel", svc.state()["qvel"])):
        assert rel(ref[name], out) < JITTER_TOL, (name, rel(ref[name], out))
    assert abs(svc.state()["qpos"][2] - q0[2]) < 0.05
    assert np.all(np.isfinite(svc.covariance()))
    svc.reset()
    assert svc.state() is None and svc.covariance() is None
    # DirectService (the direct half of tests/test_grpc_estimation.py)
    ds = DirectService(m, configuration_length=DIRECT_T)
    try:
        DirectService(m, configuration_length=2)
        raise AssertionError("a window under 3 knots must raise")
    except ValueError:
        pass
    for verb in (ds.optimize, ds.cost):
        try:
            verb()
            raise AssertionError(f"{verb.__name__} before data must raise")
        except RuntimeError:
            pass
    assert not ds.status()["optimized"] and np.isnan(ds.status()["cost"])
    assert not ds.status()["improved"]
    ds.set_settings(gn_iters=2, force_weight=1e-4, regularization=1e-4)
    ds.set_settings()            # zero and None change nothing
    assert ds.settings() == dict(gn_iters=2, estimate_mass=False,
                                 force_weight=1e-4, regularization=1e-4,
                                 estimate_params=())
    qs, ys, us = direct_window()
    ds.set_data(qs, sensor=ys, ctrl=us)
    out = ds.optimize()
    assert out.qpos.shape == (DIRECT_T, m.nq)
    assert out.qvel.shape == (DIRECT_T - 1, m.nv)
    result_held(all_references()["direct_service"], out, free_root=True)
    assert np.isfinite(ds.cost()) and ds.cost() <= float(out.cost_initial)
    st = ds.status()
    assert st["optimized"] and st["cost"] == ds.cost()
    assert st["improved"] == (ds.cost() < float(out.cost_initial))
    assert st["improved"]
    assert st["gn_iters"] == 2
    ds.set_settings(estimate_mass=True, estimate_params=("damping_scale", ))
    assert ds.settings()["estimate_mass"] is True
    assert tdirect._param_names(ds.cfg) == ("mass_scale", "damping_scale")
    ds.reset()
    try:
        ds.optimize()
        raise AssertionError("optimize after reset must raise")
    except RuntimeError:
        pass


# ---------------------------------------------------------------------------
# the JAX package's own scenarios on the port's float64 CPU twins
# ---------------------------------------------------------------------------

def track(update, f, ys, n):
    u = torch.zeros((1, 12), dtype=F64)
    for y in ys[1:n + 1]:
        f, _ = update(f, u, t64(y)[None])
    return f


def ekf_track(m, sensor, start, ys, n=30):
    cfg = est.EKFConfig()
    return track(lambda e, u, y: est.ekf_update(m, cfg, sensor, e, u, y),
                 est.ekf_init(m, cfg, make_state(m, qpos=t64(start))), ys,
                 n)


def check_estimator_scenarios():
    """tests/test_estimators.py's scenarios, their jax.random draws
    reproduced from its keys, and its thresholds.

    The EKF's wrong start there moves every joint by +0.1 rad, which puts
    three arm joints (upper limit 0) 0.1 rad past their limits. The
    first predict's limit rows whip the arms at ~6,000 rad/s², and the
    selection-free step (the port, and the JAX package's own kernel
    path) then loads the floor slots of four arm spheres 0.25-0.36 m
    above the floor, which the JAX CPU step's top-32 selection drops
    (ROADMAP queue 3 item 3). From that start the port's EKF ends at
    0.321 err0, as does the JAX package's EKF on its kernel branch, to
    1e-6 (`check_ekf_kernel_branch`); the JAX CPU step reaches 0.07. So
    the 0.3 bound is held here on the same 0.1 rad start moved into the
    three joints' ranges (`wrong_start`), where every predict meets the
    top-32 premise and the two steps agree."""
    m, sensor = tm64(), tsensor()
    # EKF from a wrong start: error < 0.3 err0, a finite covariance
    qs, _, ys = jax_scenario(30, 0)
    bad = wrong_start(0.1)
    with premise_on_steps() as n:
        f = ekf_track(m, sensor, bad, ys)
    assert n[0] == 30
    err0 = np.linalg.norm(bad[7:] - qs[1, 7:])
    err = np.linalg.norm(f.state.qpos[0, 7:].numpy() - qs[30, 7:])
    assert err < 0.3 * err0, (err, err0)
    assert bool(torch.isfinite(f.cov).all())
    # EKF covariance after 10 updates from the truth
    qs, _, ys = jax_scenario(10, 1)
    f = ekf_track(m, sensor, qs[0], ys, 10)
    w = np.linalg.eigvalsh(f.cov[0].numpy())
    assert w.max() < 1.0 and w.min() > -1e-9, (w.min(), w.max())
    # UKF from every joint off by +0.08: error < 0.5 err0
    qs, _, ys = jax_scenario(20, 2)
    bad = qs[0].copy()
    bad[7:] += 0.08
    cfg = est.UKFConfig()
    f = track(lambda e, u, y: est.ukf_update(m, cfg, sensor, e, u, y),
              est.ukf_init(m, cfg, make_state(m, qpos=t64(bad))), ys, 20)
    err0 = np.linalg.norm(bad[7:] - qs[1, 7:])
    err = np.linalg.norm(f.state.qpos[0, 7:].numpy() - qs[20, 7:])
    assert err < 0.5 * err0, (err, err0)
    # the batch estimator, window 4, one iteration: error < 0.05
    qs, _, ys = jax_scenario(12, 3, scale=0.005)
    cfg = est.BatchConfig(window=4, gn_iters=1)
    b = est.batch_init(m, cfg, make_state(m, qpos=t64(qs[0])))
    u = torch.zeros((1, 12), dtype=F64)
    for y in ys[1:]:
        b, e = est.batch_update(m, cfg, sensor, b, u, t64(y)[None])
    err = np.linalg.norm(e.qpos[0, 7:].numpy() - qs[12, 7:])
    assert err < 0.05, err
    assert bool(torch.isfinite(e.qpos).all())


def check_ekf_kernel_branch():
    """The EKF of tests/test_estimators.py from its own start (every
    joint +0.1) and draws, 30 updates, against the JAX package's EKF
    whose predict runs the JAX step's kernel branch with its plain
    references (selection-free, as the port): the state and covariance
    at 1e-6 after every update, and the same error ratio over the 0.3
    bound (see `check_estimator_scenarios`)."""
    c = all_references()["ekf_kernel_branch"]
    m, sensor = tm64(), tsensor()
    qs, _, ys = jax_scenario(30, 0)
    bad = qs[0].copy()
    bad[7:] += 0.1
    cfg = est.EKFConfig()
    f = est.ekf_init(m, cfg, make_state(m, qpos=t64(bad)))
    u = torch.zeros((1, 12), dtype=F64)
    for k, y in enumerate(ys[1:31]):
        f, innov = est.ekf_update(m, cfg, sensor, f, u, t64(y)[None])
        for name, out in (("qpos", f.state.qpos[0]), ("qvel", f.state.qvel[0]),
                          ("cov", f.cov[0]), ("innov", innov[0])):
            err = rel(c[name][k], out)
            assert err < 1e-6, (k, name, err)
    err0 = np.linalg.norm(bad[7:] - qs[1, 7:])
    ratio = np.linalg.norm(f.state.qpos[0, 7:].numpy() - qs[30, 7:]) / err0
    ratio_jax = np.linalg.norm(c["qpos"][-1][7:] - qs[30, 7:]) / err0
    assert abs(ratio - ratio_jax) < 1e-6 and ratio > 0.3, (ratio, ratio_jax)


def ukf_float32_witness(n=20, seed=42, off=0.08):
    """The UKF of tests/test_estimators.py from its own start (every
    joint +off) in float32 on the CPU, as chip_smoke's `estimation_loops`
    runs it on the card: the truth from the port's float32 step from the
    stand pose at zero control, numpy-seeded 0.01 measurement noise. Runs
    the JAX UKF in float32 (its predict through the JAX CPU step, and
    through the step's selection-free kernel branch) and the port's
    float32 and float64 twins; per run, the first update (1-based) after
    which the covariance or the state is not finite (None if none is),
    the smallest eigenvalue of the last finite covariance and the error
    ratio after n updates. Not a check: the record behind PERF.md's
    float32 UKF finding. Run: `cd tests && python -c "import
    test_torch_estimation as t; print(t.ukf_float32_witness())"`."""
    m32 = th.build_humanoid(device="cpu")
    s = make_state(m32, qpos=th.stand_qpos(m32))
    u32 = torch.zeros((1, 12))
    qs, vs = [s.qpos], [s.qvel]
    for _ in range(n):
        s, _ = step(m32, s, u32)
        qs.append(s.qpos)
        vs.append(s.qvel)
    qs = torch.cat(qs)
    ys = tsens.measure(m32, qs, torch.cat(vs)).double().numpy()
    ys = ys + 0.01 * np.random.default_rng(seed).standard_normal(ys.shape)
    qs = qs.double().numpy()
    bad = qs[0].copy()
    bad[7:] += off
    err0 = np.linalg.norm(bad[7:] - qs[1, 7:])

    def summary(states):
        first, eig, err = None, None, None
        for k, (q, cov) in enumerate(states, 1):
            if not (np.isfinite(q).all() and np.isfinite(cov).all()):
                first = k
                break
            eig = float(np.linalg.eigvalsh(0.5 * (cov + cov.T)).min())
            err = float(np.linalg.norm(q[7:] - qs[k, 7:]) / err0)
        return {"first_nonfinite_update": first, "last_finite_eig_min": eig,
                "ratio": err if first is None else None}

    out = {}
    for label, dtype in (("port_float32", torch.float32),
                         ("port_float64", F64)):
        m = th.build_humanoid(dtype=dtype, device="cpu")
        sensor = tsens.default_sensor_model(m, dtype=dtype)
        cfg = est.UKFConfig()
        f = est.ukf_init(m, cfg, make_state(
            m, qpos=torch.tensor(bad, dtype=dtype)))
        u = torch.zeros((1, 12), dtype=dtype)
        states = []
        for y in ys[1:n + 1]:
            f, _ = est.ukf_update(m, cfg, sensor, f, u,
                                  torch.tensor(y[None], dtype=dtype))
            states.append((f.state.qpos[0].double().numpy(),
                           f.cov[0].double().numpy()))
        out[label] = summary(states)
    jm = jh.build_humanoid(dtype=jnp.float32)
    sensor = jsens.default_sensor_model(jm)
    cfg = jest.UKFConfig()
    u = jnp.zeros(12, jnp.float32)
    saved = junscented.step
    for label, raw in (("jax_float32_cpu_step", saved),
                       ("jax_float32_kernel_branch",
                        trl.jax_kernel_path_step)):
        stepj = jax.jit(lambda s, c, raw=raw: raw(
            jm, s, c, solver_iters=cfg.solver_iters))
        junscented.step = lambda m, s, c, solver_iters: stepj(s, c)
        try:
            f = jest.ukf_init(jm, cfg, JState(
                jnp.asarray(bad, jnp.float32), jnp.zeros(18, jnp.float32),
                jnp.asarray(0.0, jnp.float32)))
            states = []
            for y in ys[1:n + 1]:
                f, _ = jest.ukf_update(jm, cfg, sensor, f, u,
                                       jnp.asarray(y, jnp.float32))
                states.append((np.asarray(f.state.qpos, np.float64),
                               np.asarray(f.cov, np.float64)))
        finally:
            junscented.step = saved
        out[label] = summary(states)
    return out


def check_direct_scenarios():
    """tests/test_direct.py's thresholds."""
    m, sensor = tm64(), tsensor()
    dt = float(m.dt)
    # denoising: T 10, 3 iterations, the cost falls, error < 0.7 x start
    # (the test's corruption: a split of PRNGKey(0), 0.03 normals)
    qs, _, ys = simulate(9, 0, noise=0.0)
    k = jax.random.split(jax.random.PRNGKey(0))[1]
    noisy = qs.copy()
    noisy[:, 7:] += 0.03 * np.asarray(jax.random.normal(k, (10, 12),
                                                        jnp.float64))
    res = tdirect.direct_optimize(m, tdirect.DirectConfig(gn_iters=3),
                                  sensor, t64(noisy), t64(ys),
                                  torch.zeros((10, 12), dtype=F64), dt)
    before = np.abs(noisy[1:-1, 7:] - qs[1:-1, 7:]).mean()
    after = np.abs(res.qpos[1:-1, 7:].numpy() - qs[1:-1, 7:]).mean()
    assert float(res.cost) < float(res.cost_initial)
    assert after < 0.7 * before, (after, before)
    # at the truth (feet in contact) the contact-force residual is
    # under 0.2 of the smooth-only one
    qs, _, ys = simulate(7, 0, noise=0.0)
    args = (t64(qs), t64(ys), torch.zeros((8, 12), dtype=F64), dt,
            torch.zeros(0, dtype=F64))
    ny = 6 * 30
    rc = tdirect.direct_residuals(m, tdirect.DirectConfig(), sensor,
                                  *args)[ny:]
    rs = tdirect.direct_residuals(
        m, tdirect.DirectConfig(contact_forces=False), sensor, *args)[ny:]
    assert float(rc.norm()) < 0.2 * float(rs.norm())
    # the mass scale from an actuated flight of a 15% heavier model
    q0 = th.stand_qpos(m).numpy().copy()
    q0[2] = 1.0
    qs, _, ys = simulate(9, 0, noise=0.0, q0=tuple(q0), ctrl=0.4,
                         mass=1.15)
    cfg = tdirect.DirectConfig(gn_iters=6, estimate_params=("mass_scale", ),
                               contact_forces=True, force_weight=1e-2)
    res = tdirect.direct_optimize(m, cfg, sensor, t64(qs), t64(ys),
                                  torch.full((10, 12), 0.4, dtype=F64), dt)
    assert float(res.cost) < float(res.cost_initial)
    assert abs(float(res.mass_scale) - 1.15) < 0.05, float(res.mass_scale)


def check_server_ekf_mode():
    """tests/test_serving.py:209-222: two requests through the EKF."""
    m = th.build_humanoid(device="cpu")
    a = Agent(m, stand_task(device="cpu"), planner="sampling", nsample=4,
              horizon=3)
    srv = MPCServer(a, planner_iterations=1, filter="ekf")
    jp = np.zeros(12)
    quat = [-0.7071, 0, 0, 0.7071]
    out1 = srv.compute_action(jp, np.zeros(12), np.zeros(3), quat)
    out2 = srv.compute_action(jp, np.zeros(12), np.zeros(3), quat)
    assert out1.shape == out2.shape == (12, )
    assert np.all(np.isfinite(out1)) and np.all(np.isfinite(out2))
    assert srv._filter is not None and srv._filter.ekf is not None
    np.testing.assert_array_equal(srv._last_action, out2)
    assert float(srv._filter.state.time[0]) > 0.0


def run_local_checks():
    """The checks that need no JAX reference process."""
    check_estimator_scenarios()
    check_direct_scenarios()
    check_server_ekf_mode()


def run_reference_checks(references=None):
    """The checks against the JAX references; `references` holds results
    of `reference` built elsewhere (in other processes)."""
    _RESULTS.update(references or {})
    check_sensors()
    check_filters()
    check_ekf_kernel_branch()
    check_direct_residuals()
    check_direct_optimize()
    check_serving()


def run_checks(references=None):
    run_local_checks()
    run_reference_checks(references)
