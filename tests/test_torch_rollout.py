"""Port parity: rollouts, stand-task costs and the sampling planner.

One JAX `sampling_plan` call (float64, 4 candidates x 8 steps from the
stand pose) is the reference. Its Gaussian knot noise is drawn from the
JAX key and handed to the port as numpy, so both packages plan with the
same numbers; its returns are JAX `rollout_spline` total returns of the
same candidates. Tolerance: max-abs error over max-abs value 1e-9
(float64); the winner and the new policy must be identical.
tests/test_torch_port.py runs these checks as the port's one collected
test (ROADMAP.md, "Keep the count of collected test items small").
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from humanoid_mujoco_tpu.ops.spline import SplineOrder as JOrder
from humanoid_mujoco_tpu.physics import humanoid as jh
from humanoid_mujoco_tpu.physics.model import make_state as j_make_state
from humanoid_mujoco_tpu.planners import policy as jpolicy
from humanoid_mujoco_tpu.planners import sampling as jsampling
from humanoid_mujoco_tpu.tasks import base as jbase
from humanoid_mujoco_tpu.tasks import stand_task as j_stand_task

from humanoid_mujoco_torch.ops.spline import SplineOrder, spline_sample
from humanoid_mujoco_torch.physics import humanoid as th
from humanoid_mujoco_torch.physics.model import make_state
from humanoid_mujoco_torch.planners import (SamplingConfig, init_policy,
                                            sample_candidates, sampling_plan)
from humanoid_mujoco_torch.rollout import (MAX_RETURN, rollout_actions,
                                           rollout_spline)
from humanoid_mujoco_torch.tasks import base as tbase
from humanoid_mujoco_torch.tasks import stand_task

torch.set_num_threads(1)

N, KNOTS, HORIZON = 4, 3, 8


def rel_err(ref, out):
    r = np.asarray(ref, np.float64)
    o = out.detach().numpy().astype(np.float64)
    assert r.shape == o.shape, (r.shape, o.shape)
    return float(np.max(np.abs(r - o)) / (np.max(np.abs(r)) + 1e-12))


@functools.lru_cache(maxsize=None)
def jax_plan():
    jm = jh.build_humanoid(dtype=jnp.float64)
    task = j_stand_task(dtype=jnp.float64)
    s0 = j_make_state(jm, qpos=jh.stand_qpos(jm))
    pol = jpolicy.init_policy(jm, KNOTS)
    cfg = jsampling.SamplingConfig(nsample=N, nknots=KNOTS, horizon=HORIZON)
    key = jax.random.PRNGKey(0)
    # O0: same numbers, a third less compile time
    plan = jax.jit(
        lambda p, s, k: jsampling.sampling_plan(jm, task, cfg, p, s, k)
    ).lower(pol, s0, key).compile({"xla_backend_optimization_level": 0})
    new_pol, info = plan(pol, s0, key)
    # the numbers sample_candidates draws inside sampling_plan
    k_noise, _ = jax.random.split(key)
    noise = jax.random.normal(k_noise, (N, KNOTS, 12), dtype=jnp.float64)
    nominal = jpolicy.resample_policy(pol, s0.time, HORIZON * jm.dt, KNOTS,
                                      JOrder.ZERO)
    cands = jsampling.sample_candidates(jm, cfg, nominal.values, key)
    return dict(noise=np.asarray(noise), cands=np.asarray(cands),
                times=np.asarray(nominal.times),
                returns=np.asarray(info.returns), winner=int(info.winner),
                values=np.asarray(new_pol.values),
                new_times=np.asarray(new_pol.times))


def port():
    m = th.build_humanoid(dtype=torch.float64, device="cpu")
    return m, stand_task(dtype=torch.float64, device="cpu")


def check_rollout_total_return():
    ref = jax_plan()
    m, task = port()
    s0 = make_state(m, qpos=th.stand_qpos(m), batch=N)
    res = rollout_spline(m, task, s0, torch.tensor(ref["times"]),
                         torch.tensor(ref["cands"]), SplineOrder.ZERO,
                         HORIZON)
    assert rel_err(ref["returns"], res.total_return) < 1e-9
    assert res.costs.shape == (N, HORIZON)
    assert res.residuals.shape == (N, HORIZON, task.nres)
    assert not bool(res.diverged.any())


def check_sampling_plan():
    ref = jax_plan()
    m, task = port()
    cfg = SamplingConfig(nsample=N, nknots=KNOTS, horizon=HORIZON)
    s0 = make_state(m, qpos=th.stand_qpos(m))
    new_pol, info = sampling_plan(m, task, cfg, init_policy(m, KNOTS), s0,
                                  noise=torch.tensor(ref["noise"]))
    assert rel_err(ref["returns"], info.returns) < 1e-9
    assert int(info.winner) == ref["winner"]
    np.testing.assert_allclose(new_pol.values.numpy(), ref["values"],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(new_pol.times.numpy(), ref["new_times"],
                               rtol=1e-12, atol=1e-15)
    assert float(info.best_return) <= float(info.nominal_return)


def check_sample_candidates_with_a_generator():
    m = th.build_humanoid(device="cpu")
    nominal = init_policy(m, KNOTS).values
    cfg = SamplingConfig(nsample=64, nknots=KNOTS, exploration=0.5,
                         exploration2=2.0)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return sample_candidates(m, cfg, nominal, generator=g)

    a, b = draw(3), draw(3)
    assert a.shape == (64, KNOTS, m.nu)
    assert torch.equal(a, b)
    assert not torch.equal(a, draw(4))
    assert torch.equal(a[0], nominal)
    lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
    assert bool(((a >= lo) & (a <= hi)).all())
    assert bool((a.abs() == 1.0).any())       # the wide std hits the clamp


def check_rollout_actions_matches_zero_order_spline():
    m, task = port()
    rng = np.random.default_rng(1)
    times = torch.linspace(0.0, HORIZON * float(m.dt), KNOTS + 1,
                           dtype=torch.float64)[:-1]
    values = torch.tensor(0.3 * rng.standard_normal((2, KNOTS, m.nu)))
    s0 = make_state(m, qpos=th.stand_qpos(m), batch=2)
    res = rollout_spline(m, task, s0, times, values, SplineOrder.ZERO,
                         HORIZON)
    t = (torch.arange(HORIZON, dtype=torch.float64) * m.dt)
    actions = torch.stack([spline_sample(times, values, t[i].expand(2))
                           for i in range(HORIZON)], dim=1)
    res2 = rollout_actions(m, task, s0, actions)
    torch.testing.assert_close(res.total_return, res2.total_return,
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(res.final_state.qpos, res2.final_state.qpos)


def check_diverged_rollout_returns_max_return():
    m, task = port()
    qpos = th.stand_qpos(m).repeat(2, 1)
    qpos[0, 10] = float("nan")
    res = rollout_spline(m, task, make_state(m, qpos=qpos),
                         init_policy(m, KNOTS).times,
                         init_policy(m, KNOTS).values, SplineOrder.ZERO, 3)
    assert res.diverged.tolist() == [True, False]
    assert float(res.total_return[0]) == MAX_RETURN
    assert float(res.total_return[1]) < MAX_RETURN


def check_costs(risk):
    rng = np.random.default_rng(2)
    res = 0.5 * rng.standard_normal((3, 5, 28))
    div = np.zeros((3, 5), bool)
    div[1, 2] = True
    jt = j_stand_task(risk=risk, dtype=jnp.float64)
    tt = stand_task(risk=risk, dtype=torch.float64, device="cpu")
    assert rel_err(jbase.cost_terms(jt, jnp.asarray(res)),
                   tbase.cost_terms(tt, torch.tensor(res))) < 1e-12
    assert rel_err(jbase.cost_value(jt, jnp.asarray(res)),
                   tbase.cost_value(tt, torch.tensor(res))) < 1e-12
    assert rel_err(
        jbase.trajectory_cost(jt, jnp.asarray(res), jnp.asarray(div)),
        tbase.trajectory_cost(tt, torch.tensor(res), torch.tensor(div))) \
        < 1e-12


def run_checks():
    check_rollout_total_return()
    check_sampling_plan()
    for risk in (0.0, 0.5):
        check_costs(risk)
    check_sample_candidates_with_a_generator()
    check_rollout_actions_matches_zero_order_spline()
    check_diverged_rollout_returns_max_return()
