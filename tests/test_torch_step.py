"""Port parity: the twin of kernel B2 and the whole step against JAX.

One numpy-seeded standing state of the flagship humanoid, with a few
joints just past their limits (active limit rows, moderate
accelerations). The JAX references run eagerly (jit off) in one
process-wide cache, so the tests share the compiled eager ops:

- `fused_solver.solve_step_raw_reference` (the twin of the CUDA solver
  kernel) against pallas_solver._jax_single_raw (the JAX oracle of the
  TPU row-building solve kernel), fed the same raw rows from the JAX
  smooth oracle; float64 at 1e-9, float32 (port in float32 against the
  float64 reference) at 5e-4;
- `step` against the JAX selection-free composition jax_smooth_single
  -> _jax_single_raw -> integrate_pos (the oracle of
  tools/tpu_kernel_check.py), float64 at 1e-9;
- `step` against the JAX `step` on the standing state. The JAX CPU step
  takes the top-32 contact selection (step.py:98-103); the port is
  selection-free over all 67 slots, as the JAX kernel path is. They
  agree when every slot that carries force is among the 32 smallest
  gaps, which the test asserts first; float64 at 1e-9.

Tolerances are max-abs error over max-abs value. Also: the divergence
freeze, the 64 x 64 floor through the "contact" route, a top-k model
through B2's per-env twin, and the shared-memory sizing
of kernel B2 (one env's working set, and the refusal of a model too
large for a block). tests/test_torch_port.py
runs these checks as the port's one collected test (ROADMAP.md, "Keep
the count of collected test items small").
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu.physics import humanoid as jh
from humanoid_mujoco_tpu.physics import pallas_smooth, pallas_solver
from humanoid_mujoco_tpu.physics import solver as jsolver
from humanoid_mujoco_tpu.physics.model import make_state as j_make_state
from humanoid_mujoco_tpu.physics.step import integrate_pos as j_integrate
from humanoid_mujoco_tpu.physics.step import step as j_step

from humanoid_mujoco_torch.physics import fused_solver
from humanoid_mujoco_torch.physics import humanoid as th
from humanoid_mujoco_torch.physics.model import (JointType, ModelBuilder,
                                                 make_state)
from humanoid_mujoco_torch.physics.solver import (contact_dmask,
                                                  limit_rows_static)
from humanoid_mujoco_torch.physics.step import (forward, keeps_selection,
                                                route, step)

torch.set_num_threads(1)

OUT = ("qacc", "qvel_new", "fslot", "qfrc_constraint")


@functools.lru_cache(maxsize=None)
def inputs():
    jm = jh.build_humanoid(dtype=jnp.float64)
    rng = np.random.default_rng(0)
    qpos = np.asarray(jh.stand_qpos(jm))[None].copy()
    qpos[:, 7:] += 0.03 * rng.standard_normal((1, 12))
    lo, hi = np.asarray(jm.jnt_range[1:]).T
    qpos[:, 7:] = np.clip(qpos[:, 7:], lo - 0.004, hi - 0.02)
    qvel = 0.2 * rng.standard_normal((1, 18))
    ctrl = 0.3 * rng.standard_normal((1, 12))
    return jm, qpos, qvel, ctrl


@functools.lru_cache(maxsize=None)
def jax_composition():
    """The raw rows (JAX smooth oracle), the solve outputs and the next
    qpos of the selection-free JAX pipeline, float64, batch of one."""
    jm, qpos, qvel, ctrl = inputs()
    lim_tab = jsolver.limit_rows_static(jm)
    dmask = np.asarray(jsolver.contact_dmask(jm), np.float64)
    hd = np.asarray(jm.dt * jm.dof_damping)
    raws, refs, qnew = [], [], []
    with jax.disable_jit():
        for i in range(1):
            raw = pallas_smooth.jax_smooth_single(jm, qpos[i], qvel[i],
                                                  ctrl[i])[:14]
            M, qf = raw[0], raw[1]
            out = pallas_solver._jax_single_raw(
                M, qf, qvel[i], *raw[2:7], dmask, *raw[7:14], hd, jm.dt,
                lim_tab=lim_tab, niter=8, ls_iter=16)
            qnew.append(np.asarray(
                j_integrate(jm, jnp.asarray(qpos[i]), out[1], jm.dt)))
            raws.append([np.asarray(r) for r in raw])
            refs.append([np.asarray(r) for r in out])
    raw = [np.stack(r) for r in zip(*raws)]
    ref = [np.stack(r) for r in zip(*refs)]
    return dict(raw=raw, ref=ref, qpos_new=np.stack(qnew), hd=hd,
                dt=float(jm.dt), lim_tab=lim_tab, dmask=dmask)


def rel_err(ref, out):
    r = np.asarray(ref, np.float64)
    o = out.detach().numpy().astype(np.float64)
    assert r.shape == o.shape, (r.shape, o.shape)
    return float(np.max(np.abs(r - o)) / (np.max(np.abs(r)) + 1e-12))


def solve_args(c, dtype):
    M, qf, cdof, rel, nrm, dist, mu3, kc, bc, dc, lpos, kl, bl, dl = c["raw"]
    _, _, qvel, _ = inputs()
    arrays = (M, qf, qvel, cdof, rel, nrm, dist, mu3, c["dmask"], kc, bc,
              dc, lpos, kl, bl, dl, c["hd"], c["dt"])
    return [torch.tensor(a, dtype=dtype) for a in arrays]


def check_solver_twin(name, tol):
    c = jax_composition()
    out = fused_solver.solve_step_raw_reference(
        *solve_args(c, getattr(torch, name)), lim_tab=c["lim_tab"])
    for n, r, o in zip(OUT, c["ref"], out):
        assert rel_err(r, o) < tol, (n, rel_err(r, o))
    # some limit rows are violated (active), the others are not
    assert c["raw"][10].min() < 0 < c["raw"][10].max()


def check_step_composition():
    c = jax_composition()
    _, qpos, qvel, ctrl = inputs()
    m = th.build_humanoid(dtype=torch.float64, device="cpu")
    s1, info = step(m, make_state(m, qpos=qpos, qvel=qvel),
                    torch.tensor(ctrl))
    qacc, qvn, fslot, _ = c["ref"]
    for name, r, o in (("qpos", c["qpos_new"], s1.qpos),
                       ("qvel", qvn, s1.qvel), ("qacc", qacc, info.qacc),
                       ("contact_force", fslot, info.contact_force),
                       ("contact_dist", c["raw"][5], info.contact_dist)):
        assert rel_err(r, o) < 1e-9, name
    assert not bool(info.diverged.any())
    np.testing.assert_allclose(s1.time.numpy(), c["dt"])


def check_step_standing():
    jm, qpos, qvel, ctrl = inputs()
    m = th.build_humanoid(dtype=torch.float64, device="cpu")
    s1, info = step(m, make_state(m, qpos=qpos, qvel=qvel),
                    torch.tensor(ctrl))
    # premise of the JAX top-32 selection: every slot with force is
    # among the 32 smallest gaps
    gaps = info.contact_dist[0].numpy()
    loaded = np.nonzero(info.contact_force[0].numpy() > 0)[0]
    assert 0 < len(loaded) <= 32
    assert np.all(gaps[loaded] <= np.sort(gaps)[31])
    with jax.disable_jit():
        js1, jinfo = j_step(jm, j_make_state(jm, qpos=qpos[0], qvel=qvel[0]),
                            jnp.asarray(ctrl[0]))
    for name, r, o in (
            ("qpos", js1.qpos, s1.qpos[0]), ("qvel", js1.qvel, s1.qvel[0]),
            ("qacc", jinfo.qacc, info.qacc[0]),
            ("contact_force", jinfo.contact_force, info.contact_force[0]),
            ("contact_dist", jinfo.contact_dist, info.contact_dist[0]),
            ("xpos", jinfo.xpos, info.xpos[0]),
            ("site_xpos", jinfo.site_xpos, info.site_xpos[0]),
            ("com_vel", jinfo.com_vel, info.com_vel[0]),
            ("body_com_vel", jinfo.body_com_vel, info.body_com_vel[0]),
            ("qfrc_total", jinfo.qfrc_total, info.qfrc_total[0]),
            ("actuator_force", jinfo.actuator_force,
             info.actuator_force[0])):
        assert rel_err(r, o) < 1e-9, (name, rel_err(r, o))


def check_solve_step_raw_on_cpu_is_the_twin():
    c = jax_composition()
    args = solve_args(c, torch.float32)
    n0 = fused_solver.LAUNCHES
    out = fused_solver.solve_step_raw(*args, lim_tab=c["lim_tab"])
    ref = fused_solver.solve_step_raw_reference(*args, lim_tab=c["lim_tab"])
    for n, r, o in zip(OUT, ref, out):
        assert torch.equal(r, o), n
    assert fused_solver.LAUNCHES == n0


def check_static_tables_feed_the_twin():
    """The port's own limit table and slot mask are the ones the JAX
    reference used, so `step` and the solve test run the same rows."""
    jm = inputs()[0]
    m = th.build_humanoid(dtype=torch.float64, device="cpu")
    assert limit_rows_static(m) == jsolver.limit_rows_static(jm)
    np.testing.assert_array_equal(contact_dmask(m).numpy(),
                                  np.asarray(jsolver.contact_dmask(jm)))


def check_nan_qpos_freezes_the_state():
    m = th.build_humanoid(device="cpu")
    qpos = th.stand_qpos(m).repeat(3, 1)
    qpos[1, 8] = float("nan")
    s = make_state(m, qpos=qpos, qvel=0.1 * torch.ones(3, m.nv))
    s1, info = step(m, s, torch.zeros(3, m.nu))
    assert info.diverged.tolist() == [False, True, False]
    assert torch.equal(s1.qvel[1], torch.zeros(m.nv))
    torch.testing.assert_close(s1.qpos[1], qpos[1], equal_nan=True)
    assert torch.isfinite(s1.qpos[[0, 2]]).all()
    assert torch.isfinite(s1.qvel).all()


def check_exploding_qvel_is_flagged():
    m = th.build_humanoid(device="cpu")
    qvel = torch.zeros(2, m.nv)
    qvel[0, 10] = 2e4
    s1, info = step(m, make_state(m, qpos=th.stand_qpos(m), qvel=qvel),
                    torch.zeros(2, m.nu))
    assert info.diverged.tolist() == [True, False]
    assert torch.equal(s1.qvel[0], torch.zeros(m.nv))


def check_later_slice_paths_raise():
    m = th.build_humanoid(device="cpu")
    s = make_state(m, qpos=th.stand_qpos(m))
    # the implicit-function step of slice 5 runs (held to the plain step
    # in tests/test_torch_ilqg.py)
    s_ift, _ = step(m, s, torch.zeros(1, m.nu), ift=True)
    assert torch.isfinite(s_ift.qpos).all() and torch.isfinite(
        s_ift.qvel).all()
    # a 64 x 64 floor is over B1's heightfield gate: since slice 6 the
    # step takes the plain smooth stage and B2 ("contact", as the JAX
    # step), on a flat field the same step as B1's twin + B2's
    big = th.build_humanoid(device="cpu", hfield_shape=(64, 64))
    assert route(m) == "smooth" and route(big) == "contact"
    u = 0.3 * torch.ones(1, m.nu)
    s_big, info_big = step(big, make_state(big, qpos=th.stand_qpos(big)), u)
    s_ref, info_ref = step(m, s, u)
    torch.testing.assert_close(s_big.qvel, s_ref.qvel, rtol=0, atol=1e-6)
    torch.testing.assert_close(info_big.contact_force,
                               info_ref.contact_force, rtol=0, atol=1e-4)
    # gravcomp steps since slice 9 ("contact"): a fully compensated
    # ball above the floor stays at rest; since slice 10 a contact model
    # whose JAX step keeps its top-k selection steps too, B2 (here its
    # twin) on the k selected slots with their per-env mask
    b = ModelBuilder()
    body = b.add_body("ball", -1, pos=(0.0, 0.0, 1.0), mass=1.0,
                      inertia=(0.1, 0.1, 0.1), gravcomp=1.0)
    b.add_joint("root", body, JointType.FREE)
    b.add_sphere(body, radius=0.1)
    heavy = b.finalize(device="cpu")
    assert route(heavy) == "contact"
    s_heavy, info_heavy = step(heavy, make_state(heavy), torch.zeros(1, 0))
    assert float(info_heavy.qacc.abs().max()) < 1e-5
    torch.testing.assert_close(s_heavy.qpos, make_state(heavy).qpos,
                               rtol=0, atol=1e-7)
    b = ModelBuilder()
    body = b.add_body("ball", -1, mass=1.0, inertia=(0.1, 0.1, 0.1))
    b.add_joint("root", body, JointType.FREE)
    for i in range(300):
        b.add_sphere(body, pos=(0.001 * i, 0.0, 0.0), radius=0.1)
    b.max_contacts = 16
    many = b.finalize(dtype=torch.float64, device="cpu")
    assert route(many) == "contact" and keeps_selection(many)
    s_many = make_state(many, qvel=0.1 * torch.ones(1, many.nv,
                                                    dtype=torch.float64))
    s1_many, info_many = step(many, s_many, torch.zeros(1, 0))
    qacc_fwd = forward(many, s_many, torch.zeros(1, 0))[0]
    torch.testing.assert_close(info_many.qacc, qacc_fwd, rtol=0,
                               atol=1e-10)
    assert info_many.contact_force.shape == (1, 300)
    loaded = torch.nonzero(info_many.contact_force[0] > 0)[:, 0]
    kept = torch.sort(info_many.contact_dist[0], stable=True).indices[:16]
    assert 0 < len(loaded) <= 16 and set(loaded.tolist()) <= set(
        kept.tolist())
    assert torch.isfinite(s1_many.qvel).all()
    with pytest.raises(ValueError):
        step(m, s.replace(qpos=s.qpos.double()), torch.zeros(1, m.nu))


def check_solver_shared_memory_sizing():
    """Kernel B2 keeps one env's working set in a block's shared memory:
    the compressed chain layout of the humanoid's contact mask, its byte
    count against a hand count, and the refusal of a model too large."""
    m = th.build_humanoid(device="cpu")
    dmask = contact_dmask(m)
    ptr, dof, sgn = fused_solver.chain_layout(dmask)[:3]
    assert fused_solver.chain_layout(dmask) is fused_solver.chain_layout(
        dmask)
    per_slot = (dmask != 0).sum(dim=1).numpy()
    np.testing.assert_array_equal(np.diff(ptr), per_slot)
    assert per_slot.max() == 9 and per_slot.sum() == 376 == len(dof)
    tab = dmask.numpy()
    np.testing.assert_array_equal(dof, np.nonzero(tab)[1])
    np.testing.assert_array_equal(sgn, tab[tab != 0])
    nv, K, nlim = m.nv, m.ncon, len(limit_rows_static(m))
    assert (nv, K, nlim) == (18, 67, 24)
    # tables: slot offsets 4 x 68, dofs 376, positions 67 x 18, pairs
    # 2 x 171 -> 2196 bytes, to 16; one env: M and H at row stride 19,
    # 6 x 376 base rows, D / aref / r of 670 edges, friction 3 x 67, the
    # work area max(17 x 67, 670 + 24, 18 x 19), 3 x 24 limit values,
    # six 18-vectors, 67 active-slot entries -> 6537 floats, to 4
    tables = 2208
    env = 4 * 6540
    assert 2 * 18 * 19 + 6 * 376 + 30 * 67 + 3 * 67 + 17 * 67 + 3 * 24 \
        + 6 * 18 + 67 == 6537
    assert fused_solver.solver_smem_bytes(nv, K, nlim, 376) == tables + env
    envs, smem = fused_solver.solver_block_shape(nv, K, nlim, 376)
    assert (envs, smem) == (4, tables + 4 * env)
    assert smem <= fused_solver.SMEM_MAX == 227 * 1024
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fused_solver.solver_block_shape(nv, 2000, nlim, 2000 * nv)
    with pytest.raises(ValueError, match="at most 64 dofs"):
        fused_solver.solver_block_shape(70, K, nlim, 376)
    # a per-env mask: the block keeps only the lower-triangle pairs; each
    # env adds its chain signs, K + 1 offsets and its dofs and (slot,
    # dof) positions as bytes, for `chain` entries
    assert fused_solver.solver_smem_bytes(nv, K, nlim, 376, 1, True) == \
        _round16(nv * (nv + 1)) + 4 * _round4(
            6537 + 376 + K + 1 + -(-376 // 4) + -(-K * nv // 4))


def _round16(x):
    return -(-x // 16) * 16


def _round4(x):
    return -(-x // 4) * 4


def run_checks():
    for name, tol in (("float64", 1e-9), ("float32", 5e-4)):
        check_solver_twin(name, tol)
    check_step_composition()
    check_step_standing()
    check_solve_step_raw_on_cpu_is_the_twin()
    check_static_tables_feed_the_twin()
    check_nan_qpos_freezes_the_state()
    check_exploding_qvel_is_flagged()
    check_later_slice_paths_raise()
    check_solver_shared_memory_sizing()
