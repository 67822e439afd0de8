"""Port parity: the twin of kernel B1 against pallas_smooth.jax_smooth_single.

`fused_smooth.smooth_raw_reference` (the plain PyTorch twin of the CUDA
smooth kernel) and the JAX oracle of the TPU smooth kernel get the same
numpy-seeded states. All 22 outputs are compared by max-abs error over
max-abs value: float64 at 1e-9 (same formulas, other summation order),
float32 (the port in float32 against the float64 reference) at 2e-4,
the f32 rounding of a long chain through the tree. Inactive `dist`
slots carry the 1e9 sentinel and are compared by identity. The JAX
reference runs once, with wrenches on envs 1-2 and zero wrenches on
envs 0 and 3, so one call covers both the xfrc and the no-xfrc path.

The host-side tables of the kernel (fused_smooth.tree_tables) are
checked on the humanoid and on a small hinge/slide model of the kernel
family: the depth levels put every body after its parent, the child
lists cover every non-root body once, the nonzero-entry list of M holds
every structural nonzero of the twin's M, `smooth_smem_bytes` equals an
independent count of the kernel's shared-memory layout, and the block
shape refuses a model whose env does not fit a block.
tests/test_torch_port.py runs these checks as the port's one collected
test (ROADMAP.md, "Keep the count of collected test items small").
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu.physics import humanoid as jh
from humanoid_mujoco_tpu.physics import pallas_smooth

import chip_smoke
from humanoid_mujoco_torch.physics import fused_smooth
from humanoid_mujoco_torch.physics import humanoid as th
from humanoid_mujoco_torch.physics.model import (ActuatorType, JointType,
                                                 ModelBuilder, default_qpos)

torch.set_num_threads(1)

NO_XFRC = [0, 3]      # envs with a zero wrench; env 3 is at rest


@functools.lru_cache(maxsize=None)
def jax_case():
    jm = jh.build_humanoid(dtype=jnp.float64)
    B = 4
    rng = np.random.default_rng(0)
    qpos = np.tile(np.asarray(jh.stand_qpos(jm)), (B, 1))
    qpos[:3, 7:] += 0.07 * rng.standard_normal((3, 12))
    # tilt the root so floor normals and pair contacts vary per env
    qpos[:3, 3:7] += 0.05 * rng.standard_normal((3, 4))
    qvel = 0.3 * rng.standard_normal((B, 18))
    ctrl = 0.4 * rng.standard_normal((B, 12))
    xfrc = 2.0 * rng.standard_normal((B, 14, 6))
    qvel[3] = 0.0
    ctrl[3] = 0.0
    xfrc[NO_XFRC] = 0.0
    ref = jax.jit(jax.vmap(
        lambda a, b, c, x: pallas_smooth.jax_smooth_single(jm, a, b, c, x))
    ).lower(qpos, qvel, ctrl, xfrc).compile(
        {"xla_backend_optimization_level": 0})(qpos, qvel, ctrl, xfrc)
    ref = [np.asarray(r) for r in ref]
    return dict(qpos=qpos, qvel=qvel, ctrl=ctrl, xfrc=xfrc, ref=ref)


def twin(case, dtype, envs=None, with_xfrc=True):
    m = th.build_humanoid(dtype=dtype, device="cpu")
    envs = list(range(4)) if envs is None else envs

    def t(name):
        return torch.tensor(case[name][envs], dtype=dtype)

    out = fused_smooth.smooth_raw_reference(
        m, t("qpos"), t("qvel"), t("ctrl"), t("xfrc") if with_xfrc else None)
    return out, [r[envs] for r in case["ref"]]


def check(ref, out, tol):
    for name, r, o in zip(fused_smooth.NAMES, ref, out):
        o = o.numpy().astype(np.float64)
        assert r.shape == o.shape, (name, r.shape, o.shape)
        if name == "dist":
            sent = r > 1e8
            assert np.array_equal(sent, o > 1e8), name
            r, o = r[~sent], o[~sent]
        if r.size == 0:
            continue
        err = np.max(np.abs(r - o)) / (np.max(np.abs(r)) + 1e-12)
        assert err < tol, (name, err)


def check_float64(case):
    out, ref = twin(case, torch.float64, NO_XFRC, with_xfrc=False)
    check(ref, out, 1e-9)
    out, ref = twin(case, torch.float64)          # with wrenches
    check(ref, out, 1e-9)


def check_float32(case):
    for with_xfrc in (False, True):
        envs = None if with_xfrc else NO_XFRC
        out, ref = twin(case, torch.float32, envs, with_xfrc)
        check(ref, out, 2e-4)


def check_gravity_load_float32(case):
    """At rest the smooth force is the passive spring minus the gravity
    load (~19 N on the root). In float32 it must hold to 1e-5 of the
    float64 value: a bf16 or TF32 contraction (the reference's round-5
    bf16 bug) is off by ~1e-3."""
    out, ref = twin(case, torch.float32, [3], with_xfrc=False)
    for i in (0, 1):        # M and qfrc_smooth
        r, o = ref[i], out[i].numpy().astype(np.float64)
        assert np.max(np.abs(r - o)) / np.max(np.abs(r)) < 1e-5, i
    assert 15.0 < np.max(np.abs(ref[1])) < 25.0


def check_smooth_raw_on_cpu_is_the_twin(case):
    m = th.build_humanoid(device="cpu")
    args = [torch.tensor(case[k], dtype=torch.float32)
            for k in ("qpos", "qvel", "ctrl")]
    n0 = fused_smooth.LAUNCHES
    out = fused_smooth.smooth_raw(m, *args)
    ref = fused_smooth.smooth_raw_reference(m, *args)
    for name, r, o in zip(fused_smooth.NAMES, ref, out):
        assert torch.equal(r, o), name
    assert fused_smooth.LAUNCHES == n0


def small_model():
    """A small hinge/slide model in the kernel family: a root body with a
    slide and a limited hinge; two branches under it, one of a hinge and
    a limited slide, one of two hinges; spheres on four bodies with two
    pairs; a motor and a position actuator on one joint; a site."""
    b = ModelBuilder(dt=0.002)
    b.hfield_shape = (3, 4)

    def body(name, parent, pos, mass):
        return b.add_body(name, parent, pos=pos, mass=mass,
                          ipos=(0.01, 0.0, -0.02),
                          inertia=(0.01, 0.02, 0.015))
    root = body("root", -1, (0.0, 0.0, 0.5), 1.0)
    b.add_joint("root_z", root, JointType.SLIDE, axis=(0, 0, 1))
    yaw = b.add_joint("root_yaw", root, JointType.HINGE, axis=(0, 0, 1),
                      limited=True, jrange=(-1.0, 1.0), stiffness=0.5)
    a1 = body("a1", root, (0.1, 0.0, 0.0), 0.5)
    ja1 = b.add_joint("a1_pitch", a1, JointType.HINGE, axis=(0, 1, 0),
                      damping=0.1, armature=0.01)
    c1 = body("c1", root, (-0.1, 0.0, 0.0), 0.4)
    b.add_joint("c1_roll", c1, JointType.HINGE, axis=(1, 0, 0),
                pos=(0.0, 0.0, 0.05))
    a2 = body("a2", a1, (0.2, 0.0, 0.0), 0.3)
    b.add_joint("a2_slide", a2, JointType.SLIDE, axis=(1, 0, 0),
                limited=True, jrange=(-0.1, 0.1))
    c2 = body("c2", c1, (-0.2, 0.0, 0.0), 0.3)
    b.add_joint("c2_pitch", c2, JointType.HINGE, axis=(0, 1, 0),
                limited=True, jrange=(-0.5, 1.5))
    for bb in (root, a2, c2, c1):
        b.add_sphere(bb, radius=0.05)
    b.add_pair(1, 2)
    b.add_pair(0, 3)
    b.add_actuator(ja1, ActuatorType.MOTOR, gear=2.0)
    b.add_actuator(ja1, ActuatorType.POSITION, kp=3.0, kv=0.1)
    b.add_actuator(yaw, ActuatorType.POSITION, kp=1.0)
    b.add_site("tip", a2, pos=(0.05, 0.0, 0.0))
    return b.finalize(dtype=torch.float64, device="cpu")


def check_tree_tables(m, seed):
    """The kernel's host tables on one model (see the module docstring)."""
    s = m.struct
    assert fused_smooth.supported(m)
    tt = fused_smooth.tree_tables(s)
    lvl_ptr, lvl_body = tt["lvl_ptr"], tt["lvl_body"]
    assert sorted(lvl_body) == list(range(s.nbody))
    level = {b: L for L in range(len(lvl_ptr) - 1)
             for b in lvl_body[lvl_ptr[L]:lvl_ptr[L + 1]]}
    for b in range(s.nbody):
        p = s.body_parent[b]
        assert level[b] == (0 if p < 0 else level[p] + 1), b
        if p >= 0:
            assert lvl_body.index(p) < lvl_body.index(b), b
    ch_ptr, ch_idx = tt["ch_ptr"], tt["ch_idx"]
    assert sorted(ch_idx) == [b for b in range(s.nbody)
                              if s.body_parent[b] >= 0]
    for b in range(s.nbody):
        assert all(s.body_parent[c] == b
                   for c in ch_idx[ch_ptr[b]:ch_ptr[b + 1]])
    # every structural nonzero of M is in the list, once
    rng = np.random.default_rng(seed)
    B = 3
    qpos = torch.tensor(np.tile(default_qpos(m).numpy(), (B, 1))
                        + 0.1 * rng.standard_normal((B, s.nq)))
    qvel = torch.tensor(rng.standard_normal((B, s.nv)))
    ctrl = torch.tensor(rng.standard_normal((B, s.nu)))
    M = fused_smooth.smooth_raw_reference(m, qpos, qvel, ctrl)[0]
    pairs = {(min(u, w), max(u, w)) for u, w in tt["mnz"]}
    assert len(pairs) == len(tt["mnz"])
    scattered = torch.zeros_like(M)
    for u, w in tt["mnz"]:
        # the kernel's premise: dof u moves the body of dof w
        assert s.body_dof[s.dof_body[w], u], (u, w)
        scattered[:, u, w] = M[:, u, w]
        scattered[:, w, u] = M[:, w, u]
    assert torch.equal(scattered, M)
    acts = sorted(tt["dof_aidx"])
    assert acts == list(range(s.nu))
    for v in range(s.nv):
        for i in tt["dof_aidx"][tt["dof_aptr"][v]:tt["dof_aptr"][v + 1]]:
            assert s.jnt_vadr[s.act_jnt[i]] == v


def check_smem_layout(m):
    """smooth_smem_bytes against a count of the layout region by region:
    the block's int table and packs, then per env the inputs, the 22
    outputs of the twin (as many floats as the kernel stages) and the
    intermediates, at an env stride of 4 mod 32 floats."""
    s = m.struct
    d = fused_smooth.smooth_dims(m)
    outs = fused_smooth.smooth_raw_reference(
        m, default_qpos(m)[None], torch.zeros((1, s.nv), dtype=m.dtype),
        torch.zeros((1, s.nu), dtype=m.dtype))
    tab = fused_smooth._int_table(s, m.ncon)
    packs = fused_smooth._pack_params(m)
    block = len(tab) + (-len(tab)) % 4 + sum(p.numel() for p in packs)
    block += (-block) % 4
    regions = {"qpos": s.nq, "qvel": s.nv, "ctrl": s.nu,
               "xfrc": 6 * s.nbody,
               "outputs": sum(o[0].numel() for o in outs),
               "joint anchors": 3 * s.njnt, "inertias": 10 * s.nbody,
               "composite inertias": 10 * s.nbody,
               "body velocities": 6 * s.nbody,
               "accelerations, forces": 6 * s.nbody,
               "cdof_dot": 6 * s.nv, "CRB forces": 6 * s.nv,
               "sphere centres": 3 * s.nsph}
    env = sum(regions.values())
    while env % 32 != 4:
        env += 1
    for envs in (1, 3, fused_smooth.ENVS_MAX):
        assert fused_smooth.smooth_smem_bytes(d, envs) == \
            4 * (block + envs * env), envs


def check_block_shape():
    """The humanoid takes full blocks; a hinge chain whose M alone
    outgrows a block's shared memory is refused."""
    m = th.build_humanoid(device="cpu")
    envs, smem = fused_smooth.smooth_block_shape(fused_smooth.smooth_dims(m))
    assert envs == fused_smooth.ENVS_MAX and smem <= fused_smooth.SMEM_MAX
    big = chip_smoke.smooth_oversize_model("cpu")
    assert fused_smooth.supported(big)
    try:
        fused_smooth.smooth_block_shape(fused_smooth.smooth_dims(big))
    except ValueError as e:
        assert "bytes of shared memory" in str(e), e
    else:
        raise AssertionError("an oversize model was not refused")


def run_checks():
    case = jax_case()
    check_float64(case)
    check_float32(case)
    check_gravity_load_float32(case)
    check_smooth_raw_on_cpu_is_the_twin(case)
    small = small_model()
    for seed, m in enumerate((th.build_humanoid(dtype=torch.float64,
                                                device="cpu"), small)):
        check_tree_tables(m, seed)
        check_smem_layout(m)
    check_block_shape()
