"""Port parity: the golden MuJoCo replay, and the JAX package's last
public functions of the engine and the solver.

`tests/fixtures/golden_mujoco.npz` holds two 250-step trajectories of
the cap humanoid recorded from real MuJoCo (`tests/make_golden.py`):
zero control and a multi-sine control, from `qpos0`.

- The port's `step` on `build_humanoid(device="cpu")` (float32, batch
  1, selection-free as the JAX kernel branch) replays both from `qpos0`
  (chip_smoke.py's `golden_replay`, which the card's `golden` phase
  runs too) and meets tests/test_parity.py's bounds against MuJoCo
  unchanged (chip_smoke.py's `golden_bounds`): the
  actuator order equals `act_names`; zero control: root height < 0.03,
  hinges < 0.10, the last height no more than 0.05 under MuJoCo's;
  sine control: the first 25 steps < 0.25, step 124's height within
  0.08.
- The float64 twin's replay against the JAX kernel branch
  (tests/test_torch_rl.py's `jax_kernel_path_step`, selection-free like
  the port) on the same model built by both packages: qpos within 1e-8
  (max-abs) over the first 25 steps; the whole 250 steps are reported.
- How far the port's float32 replay lies from the JAX CPU step's
  (top-32 selection, float32, as tests/test_parity.py runs it) is
  reported, not asserted: on these states the selection changes which
  slots the solve sees (ROADMAP, queue 3 item 3).
- `engine.kinetic_energy`, `engine.inverse_dynamics` (the humanoid on
  the replay's states, and the Swimmer, whose fluid drag enters the
  passive force), `engine.point_jacobian` (several bodies, a batch of
  points each) and `solver.make_efc` (the humanoid's full slot set and
  its top-32 selection; the Swimmer's limit rows) against the JAX
  package's at 1e-9 (max-abs error over max-abs value), float64, on
  numpy-seeded inputs. The port's contact rows are edge-major and the
  JAX rows contact-major: the JAX rows are permuted before comparing.

The JAX replays are built in a process of their own by
tests/test_torch_port.py (`reference`); `run_checks` builds them in this
process when none is passed.
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu.ops import linalg as jlinalg
from humanoid_mujoco_tpu.physics import collision as jcol
from humanoid_mujoco_tpu.physics import engine as jengine
from humanoid_mujoco_tpu.physics import humanoid as jh
from humanoid_mujoco_tpu.physics import solver as jsolver
from humanoid_mujoco_tpu.physics.model import make_state as j_make_state
from humanoid_mujoco_tpu.physics.step import step as j_step
from humanoid_mujoco_tpu.tasks import swimmer as jswimmer

from humanoid_mujoco_torch.ops import linalg as tlinalg
from humanoid_mujoco_torch.physics import collision as tcol
from humanoid_mujoco_torch.physics import engine as tengine
from humanoid_mujoco_torch.physics import humanoid as th
from humanoid_mujoco_torch.physics import solver as tsolver
from humanoid_mujoco_torch.tasks import swimmer as tswimmer

import chip_smoke
import test_torch_refs as refs
import test_torch_rl as trl

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

SEQS = chip_smoke.GOLDEN_SEQS
F64 = torch.float64
NAMES = ("golden",)


@functools.lru_cache(maxsize=None)
def golden():
    with np.load(chip_smoke.GOLDEN_FIXTURE) as g:
        return {k: g[k] for k in g.files}


def rel(ref, out):
    r = np.asarray(ref, np.float64)
    o = (out.detach().numpy() if isinstance(out, torch.Tensor)
         else np.asarray(out)).astype(np.float64)
    assert r.shape == o.shape, (r.shape, o.shape)
    return float(np.max(np.abs(r - o)) / (np.max(np.abs(r)) + 1e-300))


# ---------------------------------------------------------------------------
# the JAX replays (a reference process of tests/test_torch_port.py)
# ---------------------------------------------------------------------------

def _jax_replay(stepj, jm):
    def run(q0, cs):
        def body(s, c):
            s2 = stepj(jm, s, c)[0]
            return s2, s2.qpos
        return jax.lax.scan(body, j_make_state(jm, qpos=q0), cs)[1]
    return run


def _jax_golden():
    g = golden()
    out = {}
    for dtype, label, stepj in ((jnp.float64, "kernel64",
                                 trl.jax_kernel_path_step),
                                (jnp.float32, "cpu32", j_step)):
        jm = jh.build_humanoid(dtype=dtype)
        run = jax.jit(_jax_replay(stepj, jm))
        for name in SEQS:
            out[(name, label)] = np.asarray(run(
                jnp.asarray(g["qpos0"], dtype), jnp.asarray(
                    g[f"{name}_ctrl"], dtype))).astype(np.float64)
    return out


_RESULTS = {}


def reference(name="golden"):
    """The JAX replays of both sequences, {(sequence, "kernel64" |
    "cpu32"): qpos (250, nq)}, and the JAX functions' outputs on the
    checks' inputs, built once per process."""
    if name not in _RESULTS:
        _RESULTS[name] = {**_jax_golden(), **_jax_functions()}
    return _RESULTS[name]


def mass_matrices(name="golden"):
    """The float64 humanoid's mass matrix at qpos0 and at the last state
    of the zero-control recording, for the loop-form Cholesky check."""
    m, g = tm64(), golden()
    return [(f"humanoid {i}", *refs.port_mass_matrix(
        m, q, np.zeros(m.nv), np.zeros(m.nu)))
        for i, q in enumerate((g["qpos0"], g["zero_qpos"][-1]))]


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def tm64():
    return th.build_humanoid(dtype=F64, device="cpu")


def check_actuator_order():
    names = [str(s) for s in golden()["act_names"]]
    assert names == list(th.ACTUATED_JOINT_ORDER)


def check_replays(reference_result):
    g = golden()
    m32 = th.build_humanoid(device="cpu")
    report = {}
    for name in SEQS:
        q32 = chip_smoke.golden_replay(m32, g, name)
        q64 = chip_smoke.golden_replay(tm64(), g, name)
        kernel64 = reference_result[(name, "kernel64")]
        twin = np.abs(q64 - kernel64).max(axis=1)
        assert twin[:25].max() < 1e-8, (name, twin[:25].max())
        report[name] = {
            "mujoco_f32": chip_smoke.golden_bounds(g, name, q32),
            "mujoco_f64": chip_smoke.golden_bounds(g, name, q64),
            "f64_vs_jax_kernel_first25": float(twin[:25].max()),
            "f64_vs_jax_kernel_250": float(twin.max()),
            "f64_vs_jax_kernel_first_step_over_1e-8":
                int(np.argmax(twin > 1e-8)) if (twin > 1e-8).any() else None,
            "f32_vs_jax_cpu_top32_first25": float(np.abs(
                q32 - reference_result[(name, "cpu32")])[:25].max()),
            "f32_vs_jax_cpu_top32_250": float(np.abs(
                q32 - reference_result[(name, "cpu32")]).max()),
        }
    print("golden replay (max-abs qpos errors):", report)
    return report


def _humanoid_inputs(n=6, seed=0):
    """n recorded states of both sequences (every 40th step), with
    numpy-seeded velocities and accelerations."""
    g = golden()
    rng = np.random.default_rng(seed)
    qpos = np.concatenate([g["zero_qpos"][::80], g["sine_qpos"][::80]])[:n]
    qvel = np.concatenate([g["zero_qvel"][::80], g["sine_qvel"][::80]])[:n]
    qvel = qvel + 0.1 * rng.standard_normal(qvel.shape)
    qacc = rng.standard_normal(qvel.shape)
    return qpos, qvel, qacc


def _swimmer_inputs(n=4, seed=1):
    rng = np.random.default_rng(seed)
    qpos = np.zeros((n, 8))
    qpos[:, :3] = 0.2 * rng.standard_normal((n, 3))
    qpos[:, 3:] = rng.uniform(-1.5, 1.5, (n, 5))
    return qpos, 0.8 * rng.standard_normal((n, 8)), \
        rng.standard_normal((n, 8))


BODIES = (1, 3, 7, 12)


def _point_inputs(m, qpos, seed=2):
    """Five points around each body of BODIES, per state."""
    rng = np.random.default_rng(seed)
    kin = tengine.fwd_position(m, torch.tensor(qpos))
    return {b: kin.xpos[:, b, None].numpy()
            + 0.2 * rng.standard_normal((len(qpos), 5, 3)) for b in BODIES}


def _jax_functions():
    """The JAX package's inverse_dynamics, kinetic_energy,
    point_jacobian and make_efc on the checks' inputs."""
    jm = jh.build_humanoid(dtype=jnp.float64)
    jsw = jswimmer.swimmer_model(dtype=jnp.float64)
    out = {}
    for name, jmod, (qpos, qvel, qacc) in (
            ("humanoid", jm, _humanoid_inputs()),
            ("swimmer", jsw, _swimmer_inputs())):
        def dyn(q, v, a, jmod=jmod):
            M = jengine.crb_mass_matrix(jmod, jengine.fwd_position(jmod, q))
            return (jengine.inverse_dynamics(jmod, q, v, a),
                    jengine.kinetic_energy(M, v))
        out[name] = [np.asarray(x) for x in
                     jax.jit(jax.vmap(dyn))(qpos, qvel, qacc)]
    qpos, qvel, _ = _humanoid_inputs()
    pts = _point_inputs(tm64(), qpos)

    def jacs(q, p):
        k = jengine.fwd_position(jm, q)
        return [jax.vmap(lambda x, b=b: jengine.point_jacobian(
            jm, k, b, x))(p[i]) for i, b in enumerate(BODIES)]
    got = jax.jit(jax.vmap(jacs))(qpos, np.stack([pts[b] for b in BODIES],
                                                 axis=1))
    out["point_jacobian"] = {b: np.asarray(x) for b, x in zip(BODIES, got)}

    def efc(jmod, q, v, k):
        kin = jengine.fwd_position(jmod, q)
        M = jengine.crb_mass_matrix(jmod, kin)
        con = jcol.collide(jmod, kin.xpos, kin.xmat)
        sel = None
        if k:
            con, sel = jcol.select_contacts(con, k)
        e = jsolver.make_efc(jmod, kin, q, v, con, jlinalg.chol_factor(M),
                             sel)
        return e.J, e.aref, e.D, e.pos
    for k in (0, 32):
        out[("efc", k)] = [np.asarray(x) for x in jax.jit(jax.vmap(
            lambda q, v: efc(jm, q, v, k)))(qpos, qvel)]
    qpos, qvel, _ = _swimmer_inputs()
    out[("efc", "swimmer")] = [np.asarray(x) for x in jax.jit(jax.vmap(
        lambda q, v: efc(jsw, q, v, 0)))(qpos, qvel)]
    return out


def check_inverse_dynamics_and_energy(c):
    tsw = tswimmer.swimmer_model(dtype=F64, device="cpu")
    assert tsw.struct.fluid_density or tsw.struct.fluid_viscosity
    for name, tmod, (qpos, qvel, qacc) in (
            ("humanoid", tm64(), _humanoid_inputs()),
            ("swimmer", tsw, _swimmer_inputs())):
        ref_tau, ref_energy = c[name]
        q, v = torch.tensor(qpos), torch.tensor(qvel)
        tau = tengine.inverse_dynamics(tmod, q, v, torch.tensor(qacc))
        assert rel(ref_tau, tau) < 1e-9, name
        M = tengine.crb_mass_matrix(tmod, tengine.fwd_position(tmod, q))
        assert rel(ref_energy, tengine.kinetic_energy(M, v)) < 1e-9, name


def check_point_jacobian(c):
    m = tm64()
    qpos, _, _ = _humanoid_inputs()
    kin = tengine.fwd_position(m, torch.tensor(qpos))
    for body, pts in _point_inputs(m, qpos).items():
        ref = c["point_jacobian"][body]                  # (B, 5, 3, nv)
        out = tengine.point_jacobian(m, kin, body, torch.tensor(pts))
        assert rel(ref, out) < 1e-9, body
        one = tengine.point_jacobian(m, kin, body, torch.tensor(pts[:, 0]))
        assert rel(ref[:, 0], one) < 1e-9, body


def _contact_major(x, nlim, K):
    """The JAX contact-major rows [limits; c0 e0..e9; c1 ...] in the
    port's edge-major order [limits; e0 c0..cK-1; e1 ...]."""
    lim, con = x[:, :nlim], x[:, nlim:]
    con = con.reshape((x.shape[0], K, 10) + x.shape[2:])
    return np.concatenate([lim, np.swapaxes(con, 1, 2).reshape(
        (x.shape[0], K * 10) + x.shape[2:])], axis=1)


def check_make_efc(c):
    m = tm64()
    qpos, qvel, _ = _humanoid_inputs()
    nlim = len(tsolver.limit_rows_static(m))
    q, v = torch.tensor(qpos), torch.tensor(qvel)
    kin = tengine.fwd_position(m, q)
    Mchol = tlinalg.chol_factor(tengine.crb_mass_matrix(m, kin))
    con = tcol.collide(m, kin.xpos, kin.xmat)
    for k in (0, 32):
        cs, sel = (con, None) if not k else tcol.select_contacts(con, k)
        e = tsolver.make_efc(m, kin, q, v, cs, Mchol, sel)
        for r, o in zip(c[("efc", k)], (e.J, e.aref, e.D, e.pos)):
            assert rel(_contact_major(r, nlim, k or m.ncon), o) < 1e-9, k
    # a model without contact slots: its limit rows alone
    tsw = tswimmer.swimmer_model(dtype=F64, device="cpu")
    assert tsw.ncon == 0
    qpos, qvel, _ = _swimmer_inputs()
    q, v = torch.tensor(qpos), torch.tensor(qvel)
    kin = tengine.fwd_position(tsw, q)
    e = tsolver.make_efc(tsw, kin, q, v, None, tlinalg.chol_factor(
        tengine.crb_mass_matrix(tsw, kin)))
    for r, o in zip(c[("efc", "swimmer")], (e.J, e.aref, e.D, e.pos)):
        assert rel(r, o) < 1e-9


def run_local_checks():
    check_actuator_order()


def run_reference_checks(reference_result=None):
    c = reference_result or reference()
    check_inverse_dynamics_and_energy(c)
    check_point_jacobian(c)
    check_make_efc(c)
    return check_replays(c)


def run_checks(reference_result=None):
    run_local_checks()
    return run_reference_checks(reference_result)
