"""Port parity: the Swimmer's constraint stage against JAX.

Swimmer states from a numpy seed, with hinges near and past their ±90°
limits (active limit rows) and moving links (fluid drag):

- `engine.fluid_force` against the JAX `fluid_force`, float64 at 1e-9;
- `solver.make_rows` (the limit rows of a model without contacts)
  against the JAX `make_rows`, at the sim dt and at a plan model's dt,
  float64 at 1e-12;
- `fused_solver.solve_constraints_euler_reference`, the twin of kernel
  B3, against `pallas_solver._jax_single` in float64 at 1e-9, and
  against the TPU kernel program itself (`pallas_solver.fused_batched`
  in interpret mode) in float32 at 5e-5, the tolerance of
  tests/test_pallas.py;
- `engine.prepare_smooth` (the plain smooth stage of the Swimmer's step)
  against the JAX `_prepare_smooth`, float64 at 1e-9;
- kernel B3's shared-memory sizing against a hand count of its layout,
  its refusals, and its argument builder reading the inputs in place
  (the kernel itself runs on the card, in chip_smoke.py).

Tolerances are max-abs error over max-abs value. The interpret-mode
reference takes ~20 s and is built in a background thread by
tests/test_torch_port.py, which runs these checks as the port's one
collected test (ROADMAP.md, "Keep the count of collected test items
small").
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu.mpc import make_plan_model as j_make_plan_model
from humanoid_mujoco_tpu.physics import engine as jengine
from humanoid_mujoco_tpu.physics import pallas_solver
from humanoid_mujoco_tpu.physics.model import make_state as j_make_state
from humanoid_mujoco_tpu.physics.step import _prepare
from humanoid_mujoco_tpu.tasks import swimmer as jswimmer

from humanoid_mujoco_torch.mpc import make_plan_model
from humanoid_mujoco_torch.physics import engine, fused_solver
from humanoid_mujoco_torch.physics.solver import make_rows
from humanoid_mujoco_torch.tasks import swimmer as tswimmer

torch.set_num_threads(1)

B = 4
OUT = ("qacc", "qvel_new", "f", "qfrc_constraint")


def rel_err(ref, out):
    r = np.asarray(ref, np.float64)
    o = out.detach().numpy().astype(np.float64)
    assert r.shape == o.shape, (r.shape, o.shape)
    return float(np.max(np.abs(r - o)) / (np.max(np.abs(r)) + 1e-12))


def swimmer_states(n=B, seed=0):
    """(qpos, qvel, ctrl) of n Swimmer states: root offsets, hinges in
    ±1.3 rad with one per state at or past ±90°, moving links."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((n, 8))
    qpos[:, :3] = 0.3 * rng.standard_normal((n, 3))
    qpos[:, 3:] = rng.uniform(-1.3, 1.3, (n, 5))
    lim = np.pi / 2
    for i in range(n):
        qpos[i, 3 + i % 5] = (lim + 0.02 * (i - 1)) * (-1) ** i
    qvel = 0.8 * rng.standard_normal((n, 8))
    ctrl = rng.uniform(-1.0, 1.0, (n, 5))
    return qpos, qvel, ctrl


@functools.lru_cache(maxsize=None)
def jax_swimmer_rows(dtype_name="float64", plan_dt=None):
    """Per state, from the JAX package: (M, qfrc_smooth, qvel, J, pos,
    k, b, d) of the Swimmer's step, and the fluid force."""
    dtype = getattr(jnp, dtype_name)
    jm = jswimmer.swimmer_model(dtype=dtype)
    if plan_dt is not None:
        jm = j_make_plan_model(jm, plan_dt)
    qpos, qvel, ctrl = swimmer_states()
    out, fluid = [], []
    with jax.disable_jit():
        for i in range(B):
            s = j_make_state(jm, qpos=qpos[i], qvel=qvel[i])
            kin, vel, M, qf, _, _, _, rows = _prepare(
                jm, s, jnp.asarray(ctrl[i], dtype), None)
            out.append([np.asarray(a) for a in (M, qf, s.qvel, rows.J,
                                                rows.pos, rows.k, rows.b,
                                                rows.d)])
            fluid.append(np.asarray(jengine.fluid_force(jm, kin, vel)))
    args = [np.stack(a) for a in zip(*out)]
    return dict(args=args, fluid=np.stack(fluid),
                hdamp=np.asarray(jm.dt * jm.dof_damping),
                dt=float(jm.dt))


@functools.lru_cache(maxsize=None)
def jax_b3_interpret():
    """The TPU kernel program B3 in interpret mode on the float32 rows."""
    c = jax_swimmer_rows("float32")
    args = [jnp.asarray(a, jnp.float32) for a in c["args"]]
    hd = jnp.broadcast_to(jnp.asarray(c["hdamp"], jnp.float32), (B, 8))
    dt = jnp.full((B,), c["dt"], jnp.float32)
    out = pallas_solver.fused_batched(*args, hd, dt, interpret=True)
    return [np.asarray(o) for o in out]


def check_fluid_force():
    c = jax_swimmer_rows()
    m = tswimmer.swimmer_model(dtype=torch.float64, device="cpu")
    qpos, qvel, _ = swimmer_states()
    kin = engine.fwd_position(m, torch.tensor(qpos))
    vel = engine.fwd_velocity(m, kin, torch.tensor(qvel))
    out = engine.fluid_force(m, kin, vel)
    assert rel_err(c["fluid"], out) < 1e-9, rel_err(c["fluid"], out)
    assert np.abs(c["fluid"]).max() > 1e-4        # the drag is not zero


def check_make_rows(plan_dt):
    c = jax_swimmer_rows(plan_dt=plan_dt)
    m = tswimmer.swimmer_model(dtype=torch.float64, device="cpu")
    if plan_dt is not None:
        m = make_plan_model(m, plan_dt)
    qpos, _, _ = swimmer_states()
    rows = make_rows(m, torch.tensor(qpos))
    for name, r, o in zip(("J", "pos", "k", "b", "d"), c["args"][3:],
                          (rows.J, rows.pos, rows.k, rows.b, rows.d)):
        assert rel_err(r, o) < 1e-12, (name, plan_dt, rel_err(r, o))
    assert rows.J.shape == (B, 10, 8)


def check_prepare_smooth():
    c = jax_swimmer_rows()
    m = tswimmer.swimmer_model(dtype=torch.float64, device="cpu")
    qpos, qvel, ctrl = swimmer_states()
    _, _, M, qf = engine.prepare_smooth(m, torch.tensor(qpos),
                                        torch.tensor(qvel),
                                        torch.tensor(ctrl))
    assert rel_err(c["args"][0], M) < 1e-12
    assert rel_err(c["args"][1], qf) < 1e-9


def check_b3_twin_f64():
    c = jax_swimmer_rows()
    args = [torch.tensor(a) for a in c["args"]]
    hd, dt = torch.tensor(c["hdamp"]), c["dt"]
    out = fused_solver.solve_constraints_euler_reference(*args, hd, dt)
    refs = []
    with jax.disable_jit():
        for i in range(B):
            refs.append([np.asarray(r) for r in pallas_solver._jax_single(
                *(a[i] for a in c["args"]), c["hdamp"], c["dt"],
                niter=8, ls_iter=16)])
    for name, r, o in zip(OUT, [np.stack(x) for x in zip(*refs)], out):
        assert rel_err(r, o) < 1e-9, (name, rel_err(r, o))
    # some limit rows carry force, most do not
    f = out[2].numpy()
    assert 0 < np.count_nonzero(f) < f.size


def check_b3_twin_against_kernel_program():
    c = jax_swimmer_rows("float32")
    ref = jax_b3_interpret()
    args = [torch.tensor(a, dtype=torch.float32) for a in c["args"]]
    out = fused_solver.solve_constraints_euler(
        *args, torch.tensor(c["hdamp"], dtype=torch.float32),
        torch.tensor(c["dt"], dtype=torch.float32))
    for name, r, o in zip(OUT, ref, out):
        assert rel_err(r, o) < 5e-5, (name, rel_err(r, o))


def check_b3_on_cpu_is_the_twin():
    c = jax_swimmer_rows()
    args = [torch.tensor(a) for a in c["args"]] + [
        torch.tensor(c["hdamp"]), c["dt"]]
    n0 = fused_solver.EULER_LAUNCHES
    out = fused_solver.solve_constraints_euler(*args)
    ref = fused_solver.solve_constraints_euler_reference(*args)
    for name, r, o in zip(OUT, ref, out):
        assert torch.equal(r, o), name
    assert fused_solver.EULER_LAUNCHES == n0


def check_euler_shared_memory_sizing():
    """Kernel B3's shared memory (`euler_smem_bytes`) against a hand count
    of csrc/euler.cu's layout, its block shapes, and the models it
    refuses before any launch."""
    def hand(nv, ne):
        ld = nv | 1                        # odd row stride
        floats = (2 * nv * ld              # M and H
                  + ne * ld                # J
                  + 3 * ne                 # D, aref, r
                  + max(nv * ld, 2 * ne)   # L⁻¹ / (Da, Da r) per row
                  + 6 * nv                 # six nv-vectors
                  + ne)                    # active-row list
        return 4 * (-(-floats // 4) * 4)
    cases = {(8, 10): (396 * 4, 4), (18, 694): (18144 * 4, 3),
             (36, 360): (18972 * 4, 3)}    # Swimmer, humanoid rows, nv 36
    for (nv, ne), (nbytes, envs) in cases.items():
        assert fused_solver.euler_smem_bytes(nv, ne) == hand(nv, ne) == nbytes
        assert fused_solver.euler_block_shape(nv, ne) == (
            envs, envs * nbytes)
        assert envs * nbytes <= fused_solver.SMEM_MAX
    for nv, ne, what in ((65, 4, "dofs"), (0, 4, "dofs"),
                         (36, 1400, "bytes of shared memory")):
        try:
            fused_solver.euler_block_shape(nv, ne)
        except ValueError as e:
            assert what in str(e), e
        else:
            raise AssertionError(f"nv {nv}, {ne} rows not refused")


def check_euler_launch_args():
    """Kernel B3's argument builder on the Swimmer's step inputs reads
    them in place at their strides, copying nothing: the static limit
    Jacobian expanded over the batch (batch stride 0), the shared b
    (expanded over rows too) and M as the transposed view the smooth
    stage returns; outputs are contiguous batch-first; bad shared
    damping is refused."""
    m = tswimmer.swimmer_model(dtype=torch.float32, device="cpu")
    qpos, qvel, ctrl = (torch.tensor(x, dtype=torch.float32)
                        for x in swimmer_states())
    _, _, M, qf = engine.prepare_smooth(m, qpos, qvel, ctrl)
    rows = make_rows(m, qpos)
    args = (M, qf, qvel, rows.J, rows.pos, rows.k, rows.b, rows.d)
    hd = m.dt * m.dof_damping
    ins, (strides, *ints), outs = fused_solver._euler_launch_args(
        *args, hd, m.dt, 8, 16)
    ne = rows.J.shape[1]
    assert all(x is y for x, y in zip(ins, args))
    assert strides.dtype == torch.int32 and strides.device.type == "cpu"
    assert strides.tolist() == [s for x in args for s in x.stride()]
    assert rows.J.stride()[0] == 0 and rows.b.stride() == (0, 0)
    assert not M[0].is_contiguous()
    assert ints == [B, 8, ne, 8, 16, 4,
                    4 * fused_solver.euler_smem_bytes(8, ne)]
    assert [tuple(o.shape) for o in outs] == [(B, 8), (B, 8), (B, ne),
                                              (B, 8)]
    assert all(o.is_contiguous() for o in outs)
    try:
        fused_solver._euler_launch_args(*args, hd[:5], m.dt, 8, 16)
    except ValueError:
        pass
    else:
        raise AssertionError("hdamp of the wrong shape was not refused")


def run_checks():
    check_euler_shared_memory_sizing()
    check_euler_launch_args()
    check_fluid_force()
    check_prepare_smooth()
    for plan_dt in (None, 0.02):
        check_make_rows(plan_dt)
    check_b3_twin_f64()
    check_b3_on_cpu_is_the_twin()
    check_b3_twin_against_kernel_program()
