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

from humanoid_mujoco_torch.physics import fused_smooth
from humanoid_mujoco_torch.physics import humanoid as th

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


def run_checks():
    case = jax_case()
    check_float64(case)
    check_float32(case)
    check_gravity_load_float32(case)
    check_smooth_raw_on_cpu_is_the_twin(case)
