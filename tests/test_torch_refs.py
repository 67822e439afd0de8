"""Helpers for the JAX reference builds of the port's CPU parity suite.

tests/test_torch_port.py builds the JAX references of the other
tests/test_torch_*.py modules in processes of their own, a fresh one
each, through `build`. A module's XLA flags (`XLA_FLAGS`, read once,
when the backend starts) are set first. Then the JAX package's Cholesky
factor and solve (`ops/linalg.py`, unrolled element by element at trace
time: Rubik's nv-36 step took ~460 s to compile with them) are routed
to loops over columns and rows that keep the package's order of
operations (`chol_factor_loop`, `chol_solve_loop`). The loop forms are
held to the unrolled forms at 1e-13 twice: before the build, on the
mass matrices of the models that process builds (each module's
`mass_matrices(name)`), and after it, on a sample of the matrices and
right-hand sides the build itself factored and solved at each call
site (the UKF's covariances, iLQG's Quu, the solver's Newton H, ...),
which a host callback beside each routed call keeps as the build runs.

No item is collected from this module.
"""

import importlib
import os
import sys
import threading

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax import lax

from humanoid_mujoco_tpu.ops import linalg as jlinalg

from humanoid_mujoco_torch.physics import engine as tengine

jax.config.update("jax_enable_x64", True)

LINALG_TOL = 1e-13
# recorded inputs kept per call site: calls (a reservoir over all the
# site's calls) and matrices of a call's batch (its first, its last and
# the one with the widest spread of its diagonal)
KEEP_CALLS = 4


# ---------------------------------------------------------------------------
# the loop forms of the JAX package's Cholesky factor and solve
# ---------------------------------------------------------------------------

_UNROLLED = (jlinalg.chol_factor, jlinalg.chol_solve)


def chol_factor_loop(A):
    """The JAX package's `linalg.chol_factor` as a loop over columns,
    right-looking: after column k, every entry left to factor has had
    L_ik L_jk taken off. Each entry so sees the package's operations in
    its order (s = a_ij, s - L_i0 L_j0, s - L_i1 L_j1, ..., the pivot
    clamp, L_ij = s (1 / L_jj)), so the two agree to the rounding; the
    package's form unrolls every element at trace time (~nv³/6 scalar
    ops a factorization). Inside the package's `native_scope` the
    package's own function runs (it takes XLA's native factor there)."""
    if jlinalg._NATIVE:
        return _UNROLLED[0](A)
    n = A.shape[-1]
    idx = jnp.arange(n)

    def body(k, c):
        S, L = c
        d = jnp.sqrt(jnp.maximum(S[..., k, k], jlinalg._JITTER))
        col = jnp.where(idx == k, d[..., None],
                        S[..., :, k] * (1.0 / d)[..., None])
        col = jnp.where(idx < k, 0.0, col)
        S = S - col[..., :, None] * col[..., None, :]
        return S, L.at[..., :, k].set(col)
    return lax.fori_loop(0, n, body, (A, jnp.zeros_like(A)))[1]


def chol_solve_loop(L, b):
    """The package's `linalg.chol_solve` as loops: forward substitution
    right-looking (row i takes off L_ik y_k as each y_k comes, k
    ascending), backward row by row (row i takes off L_ki x_k, k
    ascending over the rows below); each in the package's order of
    operations. The package's own inside its `native_scope`."""
    if jlinalg._NATIVE:
        return _UNROLLED[1](L, b)
    n = L.shape[-1]
    vec = b.ndim == L.ndim - 1
    bb = b[..., None] if vec else b
    idx = jnp.arange(n)

    def fwd(k, c):
        s, y = c
        yk = s[..., k, :] / L[..., k, k, None]
        s = jnp.where((idx > k)[:, None],
                      s - L[..., :, k, None] * yk[..., None, :], s)
        return s, y.at[..., k, :].set(yk)
    y = lax.fori_loop(0, n, fwd, (bb, jnp.zeros_like(bb)))[1]

    def bwd(t, x):
        i = n - 1 - t

        def take(k, s):
            return jnp.where(k > i, s - L[..., k, i, None] * x[..., k, :],
                             s)
        s = lax.fori_loop(0, n, take, y[..., i, :])
        return x.at[..., i, :].set(s / L[..., i, i, None])
    x = lax.fori_loop(0, n, bwd, jnp.zeros_like(bb))
    return x[..., 0] if vec else x


# ---------------------------------------------------------------------------
# routing the package's calls, and keeping a sample of their inputs
# ---------------------------------------------------------------------------

_KEPT = {}
_SEEN = {}
_LOCK = threading.Lock()
_RNG = np.random.default_rng(0)
_HERE = (os.path.abspath(__file__), os.path.abspath(jlinalg.__file__))


def _site():
    """file:line of the package's call into linalg (the first frame
    outside linalg and this module)."""
    f = sys._getframe(1)
    while f is not None and os.path.abspath(f.f_code.co_filename) in _HERE:
        f = f.f_back
    if f is None:
        return "?"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def _picks(diag):
    """Indices of a call's batch to keep: the first, the last and the
    widest spread of the diagonal (diag (k, n))."""
    d = np.abs(diag)
    spread = d.max(axis=-1) / np.maximum(d.min(axis=-1), 1e-300)
    return sorted({0, len(d) - 1, int(np.argmax(spread))})


def _keep(key, mats):
    """Keep `mats` (arrays (k, n, ·), the call's batch flattened) of one
    call at `key` in a reservoir of KEEP_CALLS calls."""
    diag = np.diagonal(mats[0], axis1=-2, axis2=-1)
    sample = [m[_picks(diag)].copy() for m in mats]
    with _LOCK:
        seen = _SEEN[key] = _SEEN.get(key, 0) + 1
        kept = _KEPT.setdefault(key, [])
        if len(kept) < KEEP_CALLS:
            kept.append(sample)
        else:
            j = int(_RNG.integers(seen))
            if j < KEEP_CALLS:
                kept[j] = sample


def _tap(kind, out, *inputs):
    """`out`, tied to a host callback that passes `inputs` (each (...,
    n, ·), their leading dims broadcast together) to `_keep` whenever
    the traced call runs, under the key (kind, the call site, the
    inputs' trailing shapes, their dtype). The callback returns 0, and
    `out` is selected where it is 0, so the values are untouched; vmap
    hands it the whole batch at once."""
    nd = inputs[0].ndim
    key = (kind, _site(), *(x.shape[-2:] for x in inputs),
           np.dtype(out.dtype).name)

    def keep(*xs):
        extra = xs[0].ndim - nd
        lead = np.broadcast_shapes(*(x.shape[:-2] for x in xs))
        _keep(key, [np.broadcast_to(x, lead + x.shape[-2:]).reshape(
            (-1,) + x.shape[-2:]) for x in xs])
        return np.zeros(xs[0].shape[:extra], out.dtype)
    z = jax.pure_callback(keep, jax.ShapeDtypeStruct((), out.dtype),
                          *(lax.stop_gradient(x) for x in inputs),
                          vmap_method="broadcast_all")
    return jnp.where(z == 0, out, jnp.nan)


def _factor_kept(A):
    if jlinalg._NATIVE:
        return _UNROLLED[0](A)
    return _tap("chol_factor", chol_factor_loop(A), A)


def _solve_kept(L, b):
    if jlinalg._NATIVE:
        return _UNROLLED[1](L, b)
    bb = b[..., None] if b.ndim == L.ndim - 1 else b
    return _tap("chol_solve", chol_solve_loop(L, b), L, bb)


def loop_linalg():
    """Route the JAX package's Cholesky and solve to the loop forms in
    this process (its modules call them as `linalg.chol_factor` and
    `linalg.chol_solve`), keeping a sample of their inputs; returns the
    unrolled originals."""
    jlinalg.chol_factor = _factor_kept
    jlinalg.chol_solve = _solve_kept
    return _UNROLLED


def _rel(ref, out):
    """max-abs error over max-abs value, per matrix of a stack (0 where
    both are 0; NaN in both at the same places counts as equal)."""
    ax = tuple(range(1, ref.ndim))
    diff = np.where(np.isnan(ref) & np.isnan(out), 0.0, np.abs(ref - out))
    return diff.max(axis=ax) / np.maximum(
        np.nanmax(np.abs(ref), axis=ax, initial=0.0), 1e-300)


def _tol(dtype):
    """LINALG_TOL in float64; the same number of ulps in float32."""
    return LINALG_TOL * np.finfo(dtype).eps / np.finfo(np.float64).eps


def kept_linalg_errors(saved):
    """The loop forms against the unrolled ones `saved` (eagerly) on the
    inputs kept so far: {key: (matrices, largest error)} (`_tap`'s keys),
    the error max-abs over max-abs value, per factor and per solved
    column. The sites' inputs of one kind, size and dtype run as one
    batch (a solve's columns as systems of their own)."""
    factor, solve = saved
    groups = {}
    for key, calls in sorted(_KEPT.items()):
        kind, dtype = key[0], key[-1]
        mats = [np.concatenate(c) for c in zip(*calls)]
        if kind == "chol_solve":
            L, b = mats
            mats = [np.repeat(L, b.shape[-1], axis=0),
                    np.moveaxis(b, -1, 1).reshape(-1, b.shape[-2], 1)]
        groups.setdefault((kind, mats[0].shape[-1], dtype),
                          []).append((key, mats))
    out = {}
    for (kind, _, dtype), items in groups.items():
        xs = [jnp.asarray(np.concatenate(x))
              for x in zip(*(m for _, m in items))]
        with jax.disable_jit():
            if kind == "chol_factor":
                err = _rel(np.asarray(factor(*xs)),
                           np.asarray(chol_factor_loop(*xs)))
            else:
                err = _rel(np.asarray(solve(*xs)),
                           np.asarray(chol_solve_loop(*xs)))
        at = 0
        for key, mats in items:
            e = err[at:at + len(mats[0])]
            at += len(mats[0])
            out[key] = (len(e), float(e.max()))
    return out


def check_kept_linalg(saved):
    errs = kept_linalg_errors(saved)
    for key, (_, e) in errs.items():
        assert e < _tol(key[-1]), (key, e)
    return errs


def loop_linalg_errors(saved, matrices):
    """The loop forms against the unrolled ones `saved` (eagerly) on each
    (label, M, b) of `matrices`: {label: (factor error, solve error)},
    max-abs error over max-abs value. b is (nv, k)."""
    factor, solve = saved
    out = {}
    for label, M, b in matrices:
        A, bj = jnp.asarray(M), jnp.asarray(b)
        with jax.disable_jit():
            L0, L1 = factor(A), chol_factor_loop(A)
            x0, x1 = solve(L0, bj), chol_solve_loop(L1, bj)
        out[label] = (float(np.abs(np.asarray(L0 - L1)).max()
                            / np.abs(np.asarray(L0)).max()),
                      float(np.abs(np.asarray(x0 - x1)).max()
                            / np.abs(np.asarray(x0)).max()))
    return out


def check_loop_linalg(saved, matrices):
    errs = loop_linalg_errors(saved, matrices)
    for label, e in errs.items():
        assert max(e) < LINALG_TOL, (label, e)
    return errs


def port_mass_matrix(m, qpos, qvel, ctrl, seed=11):
    """(M, b) of the port's float64 model `m` at one state (numpy rows
    of one env): M its mass matrix, b its smooth force beside a
    numpy-seeded column."""
    f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64)).reshape(1, -1)
    _, _, M, qf = tengine.prepare_smooth(m, f64(qpos), f64(qvel), f64(ctrl))
    rng = np.random.default_rng(seed)
    b = np.stack([qf[0].numpy(), rng.standard_normal(m.nv)], axis=-1)
    return M[0].numpy(), b


def at_rest(label, m, qpos):
    """(label, M, b) of the port's float64 model `m` at qpos, at rest
    with zero controls."""
    return (label, *port_mass_matrix(m, qpos, np.zeros(m.nv),
                                     np.zeros(m.nu)))


def build(module, name, *args):
    """In a reference process of its own (a fresh one: the XLA flags are
    read once, when the backend starts): `module.XLA_FLAGS` where it has
    them, the JAX Cholesky routed to its loop forms (checked on
    `module.mass_matrices(name)`), then `module.reference(name, *args)`,
    and the loop forms checked again on the inputs the build kept;
    returns the reference."""
    mod = importlib.import_module(module)
    # the module's XLA flags (tests/test_torch_contact.py's), before the
    # check below starts the backend
    flags = getattr(mod, "XLA_FLAGS", "")
    if flags and flags not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                   + flags).strip()
    saved = loop_linalg()
    check_loop_linalg(saved, mod.mass_matrices(name))
    out = mod.reference(name, *args)
    check_kept_linalg(saved)
    return out
