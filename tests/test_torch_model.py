"""Port parity: the model, its builder and keyframes against the JAX package.

Every Model leaf of the port's `build_humanoid` must equal the JAX
builder's leaf (both come from the same host-side float64 numpy), the
static structure must be the same, and `model_from_jax_leaves` must carry
a JAX model's leaves into the port unchanged. tests/test_torch_port.py
runs these checks as the port's one collected test (ROADMAP.md, "Keep
the count of collected test items small").
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from humanoid_mujoco_tpu.physics import humanoid as jh
from humanoid_mujoco_tpu.physics import pallas_smooth
from humanoid_mujoco_tpu.physics import solver as jsolver
from humanoid_mujoco_tpu.physics.model import default_qpos as j_default_qpos

from humanoid_mujoco_torch.physics import fused_smooth
from humanoid_mujoco_torch.physics import humanoid as th
from humanoid_mujoco_torch.physics import solver as tsolver
from humanoid_mujoco_torch.physics.model import (_LEAVES, default_qpos,
                                                 make_state,
                                                 model_from_jax_leaves)

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "float64": (jnp.float64, torch.float64)}


def check_every_leaf(name):
    jd, td = DTYPES[name]
    jmod = jh.build_humanoid(dtype=jd)
    tmod = th.build_humanoid(dtype=td, device="cpu")
    for leaf in _LEAVES + ("sol_iter",):
        a = np.asarray(getattr(jmod, leaf))
        b = getattr(tmod, leaf).numpy()
        assert a.shape == b.shape, leaf
        assert a.dtype == b.dtype, (leaf, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=leaf)


def check_structure():
    js = jh.build_humanoid().struct
    ts = th.build_humanoid(device="cpu").struct
    for f in dataclasses.fields(js):
        assert getattr(js, f.name) == getattr(ts, f.name), f.name
    assert (ts.nq, ts.nv, ts.nu, ts.nbody, ts.njnt) == (19, 18, 12, 14, 13)
    assert (ts.nsph, ts.npair, ts.nhrow, ts.nhcol) == (22, 45, 8, 8)


def check_model_from_jax_leaves_round_trip():
    jmod = jh.build_humanoid(dtype=jnp.float64)
    rng = np.random.default_rng(0)
    leaves = {k: np.asarray(getattr(jmod, k)) for k in _LEAVES}
    # move every float leaf, so the test sees a carried value
    leaves = {k: v + 0.01 * rng.standard_normal(v.shape)
              for k, v in leaves.items()}
    leaves["sol_iter"] = np.asarray(jmod.sol_iter)
    tstruct = th.build_humanoid(device="cpu").struct
    tmod = model_from_jax_leaves(tstruct, leaves, device="cpu")
    for k in _LEAVES:
        np.testing.assert_array_equal(getattr(tmod, k).numpy(), leaves[k],
                                      err_msg=k)
    assert tmod.dtype == torch.float64
    assert tmod.struct is tstruct
    with pytest.raises(KeyError):
        model_from_jax_leaves(tstruct, {"body_pos": leaves["body_pos"]},
                              device="cpu")


def check_keyframes_and_state():
    jmod = jh.build_humanoid(dtype=jnp.float64)
    tmod = th.build_humanoid(dtype=torch.float64, device="cpu")
    for jf, tf in ((jh.stand_qpos, th.stand_qpos),
                   (jh.standup_qpos, th.standup_qpos),
                   (j_default_qpos, default_qpos)):
        np.testing.assert_array_equal(np.asarray(jf(jmod)), tf(tmod).numpy())
    s = make_state(tmod, qpos=th.stand_qpos(tmod), batch=3)
    assert s.qpos.shape == (3, 19) and s.qvel.shape == (3, 18)
    assert s.time.shape == (3,)
    s2 = make_state(tmod, qpos=torch.zeros(5, 19, dtype=torch.float64))
    assert s2.batch == 5


def check_static_tables():
    jmod = jh.build_humanoid()
    tmod = th.build_humanoid(device="cpu")
    assert tsolver.limit_rows_static(tmod) == jsolver.limit_rows_static(jmod)
    np.testing.assert_array_equal(np.asarray(jsolver.contact_dmask(jmod)),
                                  tsolver.contact_dmask(tmod).numpy())
    assert tmod.ncon == jmod.ncon == 67


def check_supported_gate(kw):
    assert fused_smooth.supported(th.build_humanoid(device="cpu", **kw)) \
        == pallas_smooth.supported(jh.build_humanoid(**kw))


def check_entry_points_run_on_cuda_by_default():
    """Without device="cpu" the port asks for the card and raises when
    there is none; it never falls back to the CPU quietly."""
    if torch.cuda.is_available():
        m = th.build_humanoid()
        assert m.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            th.build_humanoid()


def run_checks():
    for name in sorted(DTYPES):
        check_every_leaf(name)
    check_structure()
    check_model_from_jax_leaves_round_trip()
    check_keyframes_and_state()
    check_static_tables()
    for kw in ({}, {"hfield_shape": (64, 64)}, {"with_floor": False},
               {"self_collision": False}):
        check_supported_gate(kw)
    check_entry_points_run_on_cuda_by_default()
