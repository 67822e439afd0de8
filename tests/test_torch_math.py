"""Port parity: math, linalg, spline and norm ops against the JAX package.

The same numpy-seeded inputs go through each JAX function and its
counterpart in humanoid_mujoco_torch, in float32 and float64. Tolerance:
max-abs error over max-abs value, 1e-12 in float64 (same formulas, other
summation order) and 1e-5 in float32.

tests/test_torch_port.py runs these checks as the port's one collected
test (ROADMAP.md, "Keep the count of collected test items small").
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu.ops import linalg as jlinalg
from humanoid_mujoco_tpu.ops import norms as jnorms
from humanoid_mujoco_tpu.ops import spline as jspline
from humanoid_mujoco_tpu.physics import math as jm

from humanoid_mujoco_torch.ops import linalg as tlinalg
from humanoid_mujoco_torch.ops import norms as tnorms
from humanoid_mujoco_torch.ops import spline as tspline
from humanoid_mujoco_torch.physics import math as tm

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, torch.float32, 1e-5),
          "float64": (np.float64, torch.float64, 1e-12)}


def rel_err(ref, out):
    r = np.asarray(ref, np.float64)
    o = out.detach().numpy().astype(np.float64)
    assert r.shape == o.shape, (r.shape, o.shape)
    return float(np.max(np.abs(r - o)) / (np.max(np.abs(r)) + 1e-12))


def both(x, np_dtype, torch_dtype):
    x = np.asarray(x, np_dtype)
    return jnp.asarray(x), torch.tensor(x, dtype=torch_dtype)


def check_quaternion_ops(dtype):
    npd, td, tol = dtype
    rng = np.random.default_rng(0)
    qa, ta = both(rng.standard_normal((16, 4)), npd, td)
    qb, tb = both(rng.standard_normal((16, 4)), npd, td)
    vj, vt = both(rng.standard_normal((16, 3)), npd, td)

    def ops(m, qa, qb, v):
        na, nb = m.quat_normalize(qa), m.quat_normalize(qb)
        return (na, m.quat_mul(qa, qb), m.quat_conj(qa),
                m.quat_rotate(na, v), m.quat_rotate_inv(na, v),
                m.quat_to_mat(na),
                m.axis_angle_to_quat(m.normalize(v), v[:, 0]),
                m.safe_norm(v), m.quat_exp(v), m.quat_log(na),
                m.quat_integrate(na, v, 0.01), m.quat_sub(na, nb),
                m.quat_exp(0.0 * v))                 # identity branch

    ref = jax.jit(lambda *a: ops(jm, *a))(qa, qb, vj)
    out = ops(tm, ta, tb, vt)
    for i, (r, o) in enumerate(zip(ref, out)):
        assert rel_err(r, o) < tol, i


def check_rotations_and_gravity(dtype):
    """quat_id, mat_to_quat (random rotations: each of its four pivots
    is the largest for some) and local_gravity."""
    npd, td, tol = dtype
    rng = np.random.default_rng(5)
    q = rng.standard_normal((64, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qj, qt = both(q, npd, td)
    R = np.asarray(jm.quat_to_mat(qj), np.float64)
    d0, d1, d2 = R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]
    piv = np.stack([1 + d0 + d1 + d2, 1 + d0 - d1 - d2, 1 - d0 + d1 - d2,
                    1 - d0 - d1 + d2], axis=-1)
    assert set(np.argmax(piv, axis=-1).tolist()) == {0, 1, 2, 3}
    ref = jax.jit(lambda a: (jm.mat_to_quat(jm.quat_to_mat(a)),
                             jm.local_gravity(a)))(qj)
    out = (tm.mat_to_quat(tm.quat_to_mat(qt)), tm.local_gravity(qt))
    for i, (r, o) in enumerate(zip(ref, out)):
        assert rel_err(r, o) < tol, i
    ident = tm.quat_id(td, device="cpu")
    assert ident.dtype == td and ident.device.type == "cpu"
    assert rel_err(jm.quat_id(npd), ident) == 0.0


def check_spatial_ops(dtype):
    npd, td, tol = dtype
    rng = np.random.default_rng(1)
    aj, at = both(rng.standard_normal((8, 6)), npd, td)
    bj, bt = both(rng.standard_normal((8, 6)), npd, td)
    cj, ct = both(rng.standard_normal((8, 3)), npd, td)
    mj, mt = both(rng.uniform(0.1, 2.0, (8,)), npd, td)
    A = rng.standard_normal((8, 3, 3))
    ij, it = both(A @ np.swapaxes(A, -1, -2), npd, td)

    def ops(m, a, b, c, mass, inertia):
        return (m.motion_cross(a, b), m.force_cross(a, b), m.skew(c),
                m.spatial_inertia(mass, inertia, c), m.normalize(c))

    ref = jax.jit(lambda *a: ops(jm, *a))(aj, bj, cj, mj, ij)
    out = ops(tm, at, bt, ct, mt, it)
    for i, (r, o) in enumerate(zip(ref, out)):
        assert rel_err(r, o) < tol, i


def check_linalg(dtype):
    npd, td, tol = dtype
    rng = np.random.default_rng(2)
    # 8 x 8: the JAX factor unrolls over the size, and eager dispatch of
    # the 18 x 18 unroll costs seconds; the port's code is size-generic
    A = rng.standard_normal((4, 8, 8))
    A = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(8)
    aj, at = both(A, npd, td)
    bj, bt = both(rng.standard_normal((4, 8)), npd, td)
    Bj, Bt = both(rng.standard_normal((4, 8, 5)), npd, td)

    def ops(la, a, b, B):
        L = la.chol_factor(a)
        return L, la.chol_solve(L, b), la.chol_solve(L, B), la.solve_psd(a, b)

    ref = ops(jlinalg, aj, bj, Bj)
    out = ops(tlinalg, at, bt, Bt)
    # the conditioning of A (up to ~1e3) enters the solves
    for i, (r, o) in enumerate(zip(ref, out)):
        assert rel_err(r, o) < (tol if i == 0 else 1e3 * tol), i


def check_cholesky_clamps_the_pivot():
    """A singular matrix factors with the 1e-10 clamp instead of NaN."""
    A = np.zeros((1, 3, 3))
    A[0, 0, 0] = 1.0
    Lj = jlinalg.chol_factor(jnp.asarray(A))
    Lt = tlinalg.chol_factor(torch.tensor(A))
    assert torch.isfinite(Lt).all()
    np.testing.assert_allclose(np.asarray(Lj), Lt.numpy(), rtol=1e-12)


def check_spline(order):
    rng = np.random.default_rng(3)
    times = np.sort(rng.uniform(0.0, 1.0, 5))
    values = rng.standard_normal((5, 4))
    t = np.linspace(-0.2, 1.2, 23)
    ref = jspline.spline_sample(jnp.asarray(times), jnp.asarray(values),
                                jnp.asarray(t), int(order))
    out = tspline.spline_sample(torch.tensor(times), torch.tensor(values),
                                torch.tensor(t), order)
    assert rel_err(ref, out) < 1e-12
    # per-env values (B, K, dim) at per-env times (B,)
    vb = rng.standard_normal((3, 5, 4))
    tb = rng.uniform(-0.1, 1.1, 3)
    out_b = tspline.spline_sample(torch.tensor(times), torch.tensor(vb),
                                  torch.tensor(tb), order)
    ref_b = jax.vmap(lambda v, t: jspline.spline_sample(
        jnp.asarray(times), v, t, int(order)))(jnp.asarray(vb),
                                               jnp.asarray(tb))
    assert rel_err(ref_b, out_b) < 1e-12


def check_spline_resample(order):
    """The spline at a new knot grid (a policy shifted to now)."""
    rng = np.random.default_rng(6)
    times = np.sort(rng.uniform(0.0, 1.0, 6))
    values = rng.standard_normal((6, 3))
    for new_times in (times + 0.13, np.linspace(-0.1, 1.1, 9)):
        ref = jspline.spline_resample(jnp.asarray(times), jnp.asarray(values),
                                      jnp.asarray(new_times), int(order))
        out = tspline.spline_resample(torch.tensor(times),
                                      torch.tensor(values),
                                      torch.tensor(new_times), order)
        assert rel_err(ref, out) < 1e-12, order


def check_norm_value(norm):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 5))
    for p, q in ((0.3, 2.5), (0.1, 1.5), (0.0, 2.0)):
        if norm in (tnorms.NormType.COSH, tnorms.NormType.L22,
                    tnorms.NormType.SMOOTH_ABS2) and p == 0.0:
            continue          # these shapes need p > 0
        ref = jnorms.norm_value(jnp.asarray(x), int(norm), p, q)
        out = tnorms.norm_value(torch.tensor(x), norm, p, q)
        assert rel_err(ref, out) < 1e-12, (norm, p, q)


def run_checks():
    for dtype in DTYPES.values():
        check_quaternion_ops(dtype)
        check_rotations_and_gravity(dtype)
        check_spatial_ops(dtype)
        check_linalg(dtype)
    check_cholesky_clamps_the_pivot()
    for order in tspline.SplineOrder:
        check_spline(order)
    for order in tspline.SplineOrder:
        check_spline_resample(order)
    for norm in tnorms.NormType:
        check_norm_value(norm)
        assert tnorms.norm_param_dim(norm) == jnorms.norm_param_dim(
            int(norm)), norm
