"""Port parity: multi-GPU (parallel/) over a two-rank gloo process group
on the CPU, against the one-process port and the JAX package.

Two spawned processes join one gloo group on 127.0.0.1 and run, in
float64:

- `sharded_sampling_plan` (each rank half the candidates, the winner
  from all_gather) equal to the one-process `sampling_plan` on the same
  draws, bit for bit: ParticleFixed (8 candidates, horizon 5) and the
  cap humanoid (8, horizon 5);
- the same plan against the JAX `sharded_sampling_plan` on a 2-device
  virtual CPU mesh at 1e-9 (tests/test_distributed.py's setting:
  ParticleFixed at dt 0.02, 8 candidates, horizon 5, 3 knots, key 0,
  here in float64), the JAX candidates' normals injected (rank 0 runs
  the JAX plan);
- `dp_sharded_ppo_step` (each rank 2 of 4 envs, the rollout gathered,
  each rank a part of every global minibatch, gradients summed) from
  the JAX PPO reference of tests/test_torch_rl.py (flax parameters, env
  state and observations carried across, the JAX draws), against
  `ppo_train_step_core` on the whole batch at 1e-9 (parameters, metrics,
  the rank's env shard) and against the JAX step at 1e-5, as
  test_torch_rl.check_ppo;
- `rl.train.main` under the group (PPO, 4 envs, one iteration): rank 0
  writes one checkpoint holding the whole env batch.

Then `parallel.dryrun.dryrun_multichip(2, "cpu")` (its own two
processes). tests/test_torch_port.py runs `run_checks` with the PPO
reference it already builds; the JAX sharded plan compiles in rank 0's
process, so no JAX reference process is added.
"""

import multiprocessing
import os
import socket
import tempfile

import numpy as np
import torch

F64 = torch.float64
WORLD = 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _plans_bitwise(mesh):
    from humanoid_mujoco_torch.parallel import sharded_sampling_plan
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.planners import (SamplingConfig, init_policy,
                                                sampling_plan)
    from humanoid_mujoco_torch.tasks import get_task, task_model
    cases = [("ParticleFixed", task_model("ParticleFixed", device="cpu",
                                          dtype=F64), [0.2, -0.1])]
    hm = humanoid.build_humanoid(dtype=F64, device="cpu")
    cases.append(("Humanoid Cap Stand", hm, humanoid.stand_qpos(hm)))
    for name, m, q in cases:
        task = get_task(name, device="cpu", dtype=F64)
        cfg = SamplingConfig(nsample=8, horizon=5, nknots=3)
        s = make_state(m, qpos=torch.as_tensor(q, dtype=F64))
        pol = init_policy(m, 3)
        outs = []
        for plan, kw in ((sharded_sampling_plan, dict(mesh=mesh)),
                         (sampling_plan, {})):
            g = torch.Generator()
            g.manual_seed(3)
            args = (m, task, cfg, pol, s)
            outs.append(plan(kw["mesh"], *args, generator=g) if kw
                        else plan(*args, generator=g))
        (p1, i1), (p2, i2) = outs
        assert torch.equal(i1.returns, i2.returns), name
        assert torch.equal(p1.values, p2.values), name
        assert int(i1.winner) == int(i2.winner), name


def _plan_against_jax(mesh):
    """The port's sharded plan on the JAX candidates' normals; rank 0
    also runs the JAX sharded plan on a 2-device mesh and compares."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from humanoid_mujoco_torch.parallel import sharded_sampling_plan
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.planners import SamplingConfig, init_policy
    from humanoid_mujoco_torch.tasks import get_task, task_model

    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0], (8, 3, 2),
                                         dtype=jnp.float64))
    m = task_model("ParticleFixed", device="cpu", dtype=F64, dt=0.02)
    task = get_task("ParticleFixed", device="cpu", dtype=F64)
    cfg = SamplingConfig(nsample=8, horizon=5, nknots=3)
    pol, info = sharded_sampling_plan(
        mesh, m, task, cfg, init_policy(m, 3),
        make_state(m, qpos=torch.tensor([0.2, -0.1], dtype=F64)),
        noise=torch.tensor(noise))
    assert float(info.best_return) <= float(info.nominal_return) + 1e-12
    if mesh.rank != 0:
        return
    from humanoid_mujoco_tpu.parallel.mesh import (make_mesh,
                                                   sharded_sampling_plan as
                                                   jplan)
    from humanoid_mujoco_tpu.physics.model import make_state as jstate
    from humanoid_mujoco_tpu.planners.policy import init_policy as jinit
    from humanoid_mujoco_tpu.planners.sampling import \
        SamplingConfig as JConfig
    from humanoid_mujoco_tpu.tasks import get_task as jtask
    from humanoid_mujoco_tpu.tasks import particle_model
    jm = particle_model(dt=0.02, dtype=jnp.float64)
    jcfg = JConfig(nsample=8, horizon=5, nknots=3)
    jpol, jinfo = jplan(make_mesh(2), jm,
                        jtask("ParticleFixed", dtype=jnp.float64), jcfg,
                        jinit(jm, 3), jstate(jm, qpos=jnp.array([0.2, -0.1])),
                        key)
    for ref, out in ((jinfo.returns, info.returns),
                     (jpol.values, pol.values), (jpol.times, pol.times)):
        ref = np.asarray(ref)
        assert np.max(np.abs(ref - out.numpy())) <= 1e-9 * max(
            1.0, np.max(np.abs(ref))), (ref, out)
    assert int(jinfo.winner) == int(info.winner)


def _ppo_from_jax(ref):
    """A port PPOState at the JAX reference's start (test_torch_rl's
    converter) and the JAX draws as PPODraws."""
    import test_torch_rl as R
    from humanoid_mujoco_torch.rl import env as tenv
    from humanoid_mujoco_torch.rl import ppo as tppo
    base = R.base_f64()
    cfg = tppo.PPOConfig(**R.PPO_CFG)
    st = tppo.ppo_init(cfg, R.TCFG, base, 1.0, torch.Generator())
    R.load_flax(st.pi, ref["st0"]["params"]["pi"])
    R.load_flax(st.v, ref["st0"]["params"]["v"])
    st.env_state = tenv.env_state_from_jax(ref["st0"]["env_state"],
                                           device="cpu", dtype=F64)
    st.obs = R.t64(ref["st0"]["obs"])
    draws = tppo.PPODraws(
        act=[R.t64(a) for a in ref["act"]],
        env=[R.step_draws(d) for d in ref["env"]],
        reset=[R.reset_draws(d) for d in ref["reset"]],
        perm=[torch.tensor(p, dtype=torch.int64) for p in ref["perm"]])
    return cfg, base, st, draws


def _dp_ppo(mesh, ref):
    import test_torch_rl as R
    from humanoid_mujoco_torch.parallel.distributed import (
        dp_sharded_ppo_step, shard_env_batch)
    from humanoid_mujoco_torch.rl import ppo as tppo
    cfg, base, st, draws = _ppo_from_jax(ref)
    st.env_state = shard_env_batch(mesh, st.env_state)
    st.obs = shard_env_batch(mesh, st.obs)
    st, met = dp_sharded_ppo_step(mesh, cfg, R.TCFG, base, st, draws=draws)
    _, _, whole, _ = _ppo_from_jax(ref)
    whole, wmet = tppo.ppo_train_step_core(cfg, R.TCFG, base, whole, draws)
    for a, b in zip(st.params(), whole.params()):
        assert R.rel(b.detach(), a) < 1e-9
    for k in met:
        assert abs(float(met[k]) - float(wmet[k])) <= 1e-9 * max(
            1.0, abs(float(wmet[k]))), (k, met[k], wmet[k])
        assert abs(ref["met"][k] - float(met[k])) <= 1e-5 * max(
            1.0, abs(ref["met"][k])), (k, ref["met"][k], met[k])
    assert R.rel(shard_env_batch(mesh, whole.obs), st.obs) < 1e-9
    assert R.rel(shard_env_batch(mesh, whole.env_state.phys.qpos),
                 st.env_state.phys.qpos) < 1e-9
    R.check_params(st.pi, ref["st1"]["params"]["pi"], 1e-5)
    R.check_params(st.v, ref["st1"]["params"]["v"], 1e-5)


def _train(mesh, out_dir):
    from humanoid_mujoco_torch.rl import train
    _, path = train.main(["--algo", "ppo", "--envs", "4", "--steps", "256",
                          "--out", out_dir, "--device", "cpu"])
    torch.distributed.barrier()
    if mesh.rank == 0:
        ck = torch.load(path, weights_only=True)
        assert ck["state"]["obs"].shape == (4, 30)
        assert ck["state"]["env_state"]["phys"]["qpos"].shape == (4, 19)
        assert ck["iter"] == 1


def _rank(rank, init_method, ppo_ref, out_dir, results):
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=2").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    torch.set_num_threads(1)
    import torch.distributed as dist
    from humanoid_mujoco_torch.parallel import make_mesh
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=WORLD)
    try:
        mesh = make_mesh("cpu")
        assert (mesh.size, mesh.rank) == (WORLD, rank)
        _plans_bitwise(mesh)
        _plan_against_jax(mesh)
        _dp_ppo(mesh, ppo_ref)
        _train(mesh, out_dir)
        results.put((rank, "ok"))
    except BaseException as e:   # noqa: BLE001, reported to the parent
        import traceback
        results.put((rank, traceback.format_exc()))
        raise e
    finally:
        dist.destroy_process_group()


def run_checks(ppo_ref=None):
    """The two-rank checks; `ppo_ref` is test_torch_rl's "ppo" reference
    (built here when not given)."""
    if ppo_ref is None:
        import test_torch_rl
        ppo_ref = test_torch_rl.reference("ppo")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as out_dir:
        init = f"tcp://127.0.0.1:{_free_port()}"
        procs = [ctx.Process(target=_rank,
                             args=(r, init, ppo_ref, out_dir, results))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        got = dict(results.get(timeout=900) for _ in procs)
        for p in procs:
            p.join(timeout=120)
        assert got == {r: "ok" for r in range(WORLD)}, got
        assert all(p.exitcode == 0 for p in procs), [p.exitcode
                                                      for p in procs]
    from humanoid_mujoco_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(WORLD, "cpu")
