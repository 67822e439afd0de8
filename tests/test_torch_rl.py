"""Port parity: the RL slice (rl/) against humanoid_mujoco_tpu/rl.

The port's RL cores take their draws as tensors; here they are fed the
JAX package's exact draws, reproduced from its key splits (env_reset's
five-way split and its sub-splits, env_step's three splits, the
auto-reset's fold_in, SAC's and PPO's per-round keys), so both packages
run the same arithmetic on the same numbers. Float64 (the JAX side runs
with x64, as tests/conftest.py sets), 4 envs, hidden widths (16, 16):

- rewards, `_gae`, `_ring_push_read`, `curriculum_update` at 1e-12;
  one Adam step against optax.adam and the global-norm clip against
  optax.clip_by_global_norm;
- `env_reset` at randomization factor 1 (patch, qpos, delays, obs) and 3
  `env_step`s (obs, reward, terminal, truncated, qpos, qvel, then every
  leaf of the state) at 1e-9;
- the per-env twin of kernel B1 (`smooth_raw_reference` on a patched
  model) against pallas_smooth.jax_smooth_single vmapped over the
  patched models, at 1e-9 (the plain reference, not interpret mode);
- one `sac_train_step` (2 rounds) and one `ppo_train_step` (rollout 2,
  2 minibatches, 1 epoch) from flax parameters carried across
  (`params_from_flax`) and the JAX env state (`env_state_from_jax`): at
  1e-5 relative on parameters and losses (flax keeps float32
  parameters);
- the model-cache repair (a dataclasses.replace'd model gets fresh packs
  and table) and the structure tables built once across env steps;
- a checkpoint-resume of `rl.train.main` on the CPU (1 iteration, then
  resumed to 2) equal to the bit to an uninterrupted run.

The JAX env runs the physics as it does on the TPU: the kernel branch
of its `step` (step.py:252-287), B1 and B2 through their plain JAX
references (pallas_smooth.smooth_raw and pallas_solver.solve_step_raw
off the TPU), selection-free over all 67 slots, as the port is. Its CPU
`step` keeps the 32 smallest gaps instead (ROADMAP queue 3 item 3), and
on these states that premise fails: lying at the standup pose on a 10 cm
bumpy floor (rf 1), three of the four envs put force on a slot outside
the 32 smallest gaps in the first step, so the CPU `step` is another
algorithm here, not a reference for the kernel path.

Tolerances are max-abs error over max-abs value. The three JAX
references (env, SAC, PPO; each a jit trace and compile of the humanoid
step, mostly Python under the GIL) are built in three processes of
their own by tests/test_torch_port.py, which runs these checks as the
port's one collected test and hands their results to
`run_reference_checks`.
"""

import contextlib
import dataclasses
import functools
import tempfile

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from humanoid_mujoco_tpu.physics import pallas_smooth, pallas_solver
from humanoid_mujoco_tpu.physics import solver as jsolver
from humanoid_mujoco_tpu.physics.model import State as JState
from humanoid_mujoco_tpu.physics.step import StepInfo as JStepInfo
from humanoid_mujoco_tpu.physics.step import integrate_pos as j_integrate
from humanoid_mujoco_tpu.rl import curriculum as jcur
from humanoid_mujoco_tpu.rl import env as jenv
from humanoid_mujoco_tpu.rl import networks as jnet
from humanoid_mujoco_tpu.rl import ppo as jppo
from humanoid_mujoco_tpu.rl import rewards as jrew
from humanoid_mujoco_tpu.rl import sac as jsac

from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
from humanoid_mujoco_torch.physics import humanoid as th
from humanoid_mujoco_torch.physics.solver import contact_dmask
from humanoid_mujoco_torch.rl import curriculum as tcur
from humanoid_mujoco_torch.rl import env as tenv
from humanoid_mujoco_torch.rl import ppo as tppo
from humanoid_mujoco_torch.rl import rewards as trew
from humanoid_mujoco_torch.rl import sac as tsac
from humanoid_mujoco_torch.rl import train as ttrain
from humanoid_mujoco_torch.rl.networks import params_from_flax

import test_torch_refs as refs

torch.set_num_threads(1)
# tests/conftest.py sets this too; the references also run in processes
# of their own (tests/test_torch_port.py), which do not import conftest
jax.config.update("jax_enable_x64", True)

B = 4
F64 = torch.float64
HIDDEN = (16, 16)
CFG = jenv.EnvConfig(standup=True)
TCFG = tenv.EnvConfig(standup=True)
SAC_CFG = dict(n_envs=B, buffer_size=64, batch_size=8, hidden=HIDDEN,
               steps_per_update=2)
PPO_CFG = dict(n_envs=B, rollout_len=2, n_minibatch=2, n_epochs=1,
               hidden=HIDDEN)


def tree_np(x):
    """A JAX dataclass / dict tree as nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(x):
        return {f.name: tree_np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: tree_np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [tree_np(v) for v in x]
    return np.asarray(x)


def rel(ref, out):
    r = np.asarray(ref, np.float64)
    o = (out.detach().cpu().numpy() if torch.is_tensor(out)
         else np.asarray(out)).astype(np.float64)
    assert r.shape == o.shape, (r.shape, o.shape)
    return float(np.max(np.abs(r - o)) / (np.max(np.abs(r)) + 1e-300))


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


# ---------------------------------------------------------------------------
# the JAX env on the kernel path's semantics
# ---------------------------------------------------------------------------

def jax_kernel_path_step(m, state, ctrl, xfrc=None, solver_iters=8):
    """The kernel branch of the JAX `step` (step.py:252-287), with B1 and
    B2 as they run off the TPU: pallas_smooth.smooth_raw and
    pallas_solver.solve_step_raw fall back to their plain references
    (jax_smooth_single, _jax_single_raw), selection-free."""
    h = m.dt
    (M, qfs, cdof, rel, nrm, dist, mu3, kc, bc, dc, lpos, kl, bl, dl,
     xpos, xquat, xipos, bcv, sitex, anchor, com_vel,
     actf) = pallas_smooth.smooth_raw(m, state.qpos, state.qvel, ctrl, xfrc)
    qacc, qvel_new, cf, qfc = pallas_solver.solve_step_raw(
        M, qfs, state.qvel, cdof, rel, nrm, dist, mu3,
        jsolver.contact_dmask(m), kc, bc, dc, lpos, kl, bl, dl,
        h * m.dof_damping, h, lim_tab=jsolver.limit_rows_static(m),
        niter=solver_iters)
    diverged = (~jnp.all(jnp.isfinite(qacc))
                | (jnp.max(jnp.abs(state.qvel)) > 1e4)
                | ~jnp.all(jnp.isfinite(qvel_new)))
    qpos_new = j_integrate(m, state.qpos, qvel_new, h)
    qpos_new = jnp.where(diverged, state.qpos, qpos_new)
    qvel_new = jnp.where(diverged, jnp.zeros_like(qvel_new), qvel_new)
    info = JStepInfo(
        xpos=xpos, xquat=xquat, xipos=xipos, site_xpos=sitex, com=anchor,
        com_vel=com_vel, body_com_vel=bcv, contact_dist=dist,
        contact_force=cf, qacc=qacc, actuator_force=actf,
        qfrc_total=qfs + qfc, diverged=diverged)
    return JState(qpos=qpos_new, qvel=qvel_new, time=state.time + h), info


@contextlib.contextmanager
def kernel_path():
    """Within the block, the JAX env steps with `jax_kernel_path_step`."""
    step = jenv.step
    jenv.step = jax_kernel_path_step
    try:
        yield
    finally:
        jenv.step = step


# ---------------------------------------------------------------------------
# the JAX package's draws, reproduced from its key splits
# ---------------------------------------------------------------------------

def jax_reset_draws(key, s):
    """The unit draws of env_reset(key) (rl/env.py's split structure)."""
    u = jax.random.uniform
    k_model, k_pose, k_delay, k_tgt, k_next = jax.random.split(key, 5)
    ks = jax.random.split(k_model, 11)
    noise, kn = [], ks[9]
    for o in range(3):
        kn, k = jax.random.split(kn)
        noise.append(u(k, (2 ** o + 2, 2 ** o + 2)))
    kp = jax.random.split(k_pose, 4)
    kd = jax.random.split(k_delay, 4)
    kv, ky = jax.random.split(k_tgt)
    k_obs, _ = jax.random.split(k_next)
    return dict(
        friction=u(ks[0], ()), mass=u(ks[1], (s.nbody,)),
        ext_body=jax.random.randint(ks[2], (), 1, s.nbody, dtype=jnp.int32),
        ext_mass=u(ks[3], ()), armature=u(ks[4], (s.nv,)),
        margin=u(ks[5], (s.njnt,)), range=u(ks[6], (s.njnt, 2)),
        kp=u(ks[7], (s.nu,)), forcerange=u(ks[8], (s.nu, 2)),
        noise0=noise[0], noise1=noise[1], noise2=noise[2],
        z=u(kp[0], ()), quat=u(kp[1], (4,)), joint=u(kp[2], (12,)),
        delay=jnp.stack([u(k, ()) for k in kd]),
        target_velocity=u(kv, (2,)), target_yaw=u(ky, (1,)),
        obs=jax.random.normal(k_obs, (31,), dtype=jnp.float64))


def jax_step_draws(rng):
    """The draws of env_step with env rng `rng`, and the rng after it."""
    k_noise, k_rest = jax.random.split(rng)
    k_force, k_next = jax.random.split(k_rest)
    k_obs, k_after = jax.random.split(k_next)
    return dict(action=jax.random.normal(k_noise, (12,), dtype=jnp.float64),
                force=jax.random.uniform(k_force, (6,)),
                obs=jax.random.normal(k_obs, (31,), dtype=jnp.float64)
                ), k_after


def reset_draws(d) -> tenv.ResetDraws:
    kw = {k: t64(v) for k, v in d.items() if not k.startswith("noise")}
    kw["ext_body"] = torch.tensor(np.asarray(d["ext_body"]),
                                  dtype=torch.int64)
    kw["noise"] = tuple(t64(d[f"noise{o}"]) for o in range(3))
    return tenv.ResetDraws(**kw)


def step_draws(d) -> tenv.StepDraws:
    return tenv.StepDraws(**{k: t64(v) for k, v in d.items()})


def env_round_draws(rng, step_count):
    """One env step's draws for every env and the auto-reset's draws
    (fold_in of the post-step rng with the post-step count), from the
    batch's rng (B, 2); returns them with the post-step rng."""
    sd, rng_after = jax.vmap(jax_step_draws)(rng)
    rkeys = jax.vmap(jax.random.fold_in)(rng_after, step_count + 1)
    rd = jax.vmap(lambda k: jax_reset_draws(k, jm_f64().struct))(rkeys)
    return tree_np(sd), tree_np(rd), rng_after


@functools.lru_cache(maxsize=None)
def jm_f64():
    return jenv.rl_humanoid_model(dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def base_f64():
    return tenv.rl_humanoid_model(dtype=F64, device="cpu")


# ---------------------------------------------------------------------------
# JAX references (built in background threads by test_torch_port.py)
# ---------------------------------------------------------------------------

def _jax_env():
    """Reset at rf 1 and 3 steps under numpy-seeded actions, the draws
    they used, and kernel B1's plain reference on the reset's patched
    models with numpy-seeded velocities, controls and wrenches."""
    jm = jm_f64()
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    es, obs = jax.jit(lambda k: jenv.batch_reset(CFG, jm, 1.0, k))(keys)
    rd = tree_np(jax.vmap(lambda k: jax_reset_draws(k, jm.struct))(keys))
    rng = np.random.default_rng(0)
    actions = 0.3 * rng.standard_normal((3, B, 12))
    step = jax.jit(lambda e, a: jenv.batch_step(CFG, jm, e, a))
    steps, sdraws, es_i = [], [], es
    for t in range(3):
        sd, _ = jax.vmap(jax_step_draws)(es_i.rng)
        sdraws.append(tree_np(sd))
        es_i, o, r, term, trunc = step(es_i, actions[t])
        steps.append(dict(obs=o, reward=r, terminal=term, truncated=trunc,
                          qpos=es_i.phys.qpos, qvel=es_i.phys.qvel))
    qvel = 0.3 * rng.standard_normal((B, 18))
    ctrl = 0.4 * rng.standard_normal((B, 12))
    xfrc = 2.0 * rng.standard_normal((B, 14, 6))
    xfrc[0] = 0.0
    smooth = jax.jit(jax.vmap(
        lambda p, q, v, c, x: pallas_smooth.jax_smooth_single(
            p.apply(jm), q, v, c, x)))(es.patch, es.phys.qpos, qvel, ctrl,
                                       xfrc)
    return dict(es=tree_np(es), es3=tree_np(es_i), obs=np.asarray(obs),
                video=_jax_record_episode(jm), reset_draws=rd,
                actions=actions, steps=[tree_np(s) for s in steps],
                step_draws=sdraws, smooth_in=(qvel, ctrl, xfrc),
                smooth=[np.asarray(x) for x in smooth])


def _jax_record_episode(jm, seed=0):
    """rl/videos.py's record_episode with the zero policy for 10 control
    steps (0.02 s) on the float64 model, and the reset and step draws it
    used (its reset key and the env rng's chain): the reference of
    tests/test_torch_planners.py's videos check."""
    from humanoid_mujoco_tpu.rl import videos as jvid
    model = jenv.rl_humanoid_model
    jenv.rl_humanoid_model = lambda: jm
    try:
        em, traj = jvid.record_episode(None, seconds=0.02, seed=seed)
    finally:
        jenv.rl_humanoid_model = model
    key = jax.random.PRNGKey(seed)
    # env_reset keeps the fifth key of its split, and its observation
    # splits that once more
    rng = jax.random.split(jax.random.split(key, 5)[4])[1]
    sdraws = []
    for _ in range(traj.shape[0] - 1):
        d, rng = jax_step_draws(rng)
        sdraws.append(tree_np(d))
    return dict(traj=traj, hfield=np.asarray(em.hfield_data),
                reset_draws=tree_np(jax_reset_draws(key, jm.struct)),
                step_draws=sdraws)


def _jax_sac():
    """SACState from sac_init, one sac_train_step, and the draws of its
    rounds."""
    jm = jm_f64()
    cfg = jsac.SACConfig(**SAC_CFG)
    st0 = jax.jit(lambda k: jsac.sac_init(cfg, CFG, jm, 1.0, k)[0])(
        jax.random.PRNGKey(1))
    nets = (jnet.GaussianPolicy(12, cfg.hidden, state_dependent_std=True),
            jnet.DoubleQ(cfg.hidden), optax.adam(cfg.lr))
    st1, met = jax.jit(lambda s: jsac.sac_train_step(cfg, CFG, jm, nets, s))(
        st0)
    rounds = []
    rng, count = st0.env_state.rng, st0.env_state.step_count
    size = 0
    for key in jax.random.split(st0.rng, cfg.steps_per_update + 1)[:-1]:
        k_act, k_samp, k_crit, k_pi = jax.random.split(key, 4)
        sd, rd, rng = env_round_draws(rng, count)
        count = count + 1
        size = min(size + B, cfg.buffer_size)
        idx = jax.random.randint(
            k_samp, (cfg.batch_size,), 0,
            jnp.maximum(jnp.asarray(size, jnp.int32), 1))
        rounds.append(dict(
            act=jax.random.normal(k_act, (B, 12), dtype=jnp.float64),
            env=sd, reset=rd, idx=np.asarray(idx),
            crit=jax.random.normal(k_crit, (cfg.batch_size, 12),
                                   dtype=jnp.float64),
            pi=jax.random.normal(k_pi, (cfg.batch_size, 12),
                                 dtype=jnp.float64)))
    return dict(st0=tree_np(st0), st1=tree_np(st1),
                met={k: float(v) for k, v in met.items()}, rounds=rounds)


def _jax_ppo():
    """PPOState from ppo_init, one ppo_train_step, and its draws."""
    jm = jm_f64()
    cfg = jppo.PPOConfig(**PPO_CFG)
    st0 = jax.jit(lambda k: jppo.ppo_init(cfg, CFG, jm, 1.0, k)[0])(
        jax.random.PRNGKey(2))
    pol = jnet.GaussianPolicy(12, cfg.hidden, state_dependent_std=False)
    nets = (pol, jnet.VFunction(cfg.hidden),
            optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                        optax.adam(cfg.lr)))
    st1, met = jax.jit(lambda s: jppo.ppo_train_step(cfg, CFG, jm, nets, s))(
        st0)
    keys = jax.random.split(st0.rng, cfg.rollout_len + 2)
    rng, count = st0.env_state.rng, st0.env_state.step_count
    act, env, reset = [], [], []
    for t in range(cfg.rollout_len):
        act.append(jax.random.normal(keys[t], (B, 12), dtype=jnp.float64))
        sd, rd, rng = env_round_draws(rng, count)
        count = count + 1
        env.append(sd)
        reset.append(rd)
    N = cfg.rollout_len * B
    perm = [np.asarray(jax.random.permutation(k, N))
            for k in jax.random.split(keys[-2], cfg.n_epochs)]
    return dict(st0=tree_np(st0), st1=tree_np(st1),
                met={k: float(v) for k, v in met.items()},
                act=act, env=env, reset=reset, perm=perm)


_BUILD = {"env": _jax_env, "sac": _jax_sac, "ppo": _jax_ppo}
_RESULTS = {}


def reference(name: str):
    """The JAX reference `name` ("env", "sac" or "ppo"), built once per
    process, with the JAX env on the kernel path's semantics."""
    if name not in _RESULTS:
        with kernel_path():
            _RESULTS[name] = _BUILD[name]()
    return _RESULTS[name]


def mass_matrices(name):
    """The RL env's float64 humanoid at its stand pose, for the
    loop-form Cholesky check (tests/test_torch_refs.py)."""
    m = base_f64()
    return [refs.at_rest(name, m, th.stand_qpos(m).numpy())]


def jax_env():
    return reference("env")


def jax_sac():
    return reference("sac")


def jax_ppo():
    return reference("ppo")


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def reward_args(rng):
    quat = rng.standard_normal((B, 4))
    return dict(
        velocity=rng.standard_normal((B, 3)),
        target_velocity=rng.standard_normal((B, 2)),
        torso_quat=quat, target_yaw=rng.standard_normal((B, 1)),
        z_pos=np.array([-0.7, -0.5, -0.375, -0.2]),
        joint_torques=2.0 * rng.standard_normal((B, 12)),
        previous_ctrl=rng.standard_normal((B, 12)),
        latest_ctrl=rng.standard_normal((B, 12)),
        is_self_colliding=np.array([False, True, False, True]),
        time=np.array([1.0, 10.0, 12.0, 3.0]))


def check_rewards():
    rng = np.random.default_rng(1)
    a = reward_args(rng)
    a["torso_quat"][2] = [1.0, 0.0, 0.0, 0.0]      # upright env
    for jf, tf, limit in ((jrew.standup_reward, trew.standup_reward, 10.0),
                          (jrew.control_input_reward,
                           trew.control_input_reward, -1.0)):
        ref = jax.vmap(lambda *x: jf(*x, max_simulation_time=limit))(
            *(jnp.asarray(v) for v in a.values()))
        out = tf(**{k: (torch.tensor(v) if v.dtype == bool else t64(v))
                    for k, v in a.items()}, max_simulation_time=limit)
        assert rel(ref.reward, out.reward) < 1e-12
        for name in ("terminal", "truncated"):
            assert np.array_equal(np.asarray(getattr(ref, name)),
                                  getattr(out, name).numpy()), name
    assert not np.all(np.asarray(ref.terminal))


def check_gae_ring_curriculum():
    rng = np.random.default_rng(2)
    T = 5
    r, v = rng.standard_normal((T, B)), rng.standard_normal((T, B))
    last = rng.standard_normal(B)
    d = (rng.random((T, B)) < 0.3).astype(np.float64)
    ref = jppo._gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(last),
                    jnp.asarray(d), 0.99, 0.95)
    out = tppo._gae(t64(r), t64(v), t64(last), t64(d), 0.99, 0.95)
    for a, b in zip(ref, out):
        assert rel(a, b) < 1e-12
    buf = rng.standard_normal((B, tenv.DELAY_CAP, 3))
    val = rng.standard_normal((B, 3))
    delay = np.array([0, 3, 25, 40], np.int32)
    rb, rr = jax.vmap(lambda b, x, dd: jenv._ring_push_read(b, x, 0, dd))(
        jnp.asarray(buf), jnp.asarray(val), jnp.asarray(delay))
    ob, orr = tenv._ring_push_read(t64(buf), t64(val),
                                   torch.tensor(delay))
    assert rel(rb, ob) < 1e-12 and rel(rr, orr) < 1e-12
    jc, tc = jcur.curriculum_init(0.98), tcur.curriculum_init(0.98)
    for sr in (0.9, 0.9, 0.9, 0.2, 0.7, 0.7, 0.7):
        jc = jcur.curriculum_update(jc, jnp.asarray(sr))
        tc = tcur.curriculum_update(tc, sr)
        assert abs(float(jc.randomization_factor)
                   - tc.randomization_factor) < 1e-12
        assert int(jc.successes_at_max) == tc.successes_at_max
        assert bool(jc.done) == tc.done
    assert tc.successes_at_max > 0
    # _sample_delays rounds with torch.round, half to even as jnp.round
    halves = np.array([0.5, 1.5, 2.5, 3.5, -0.5])
    assert np.array_equal(np.asarray(jnp.round(halves)),
                          torch.round(t64(halves)).numpy())


def check_optimizer_steps():
    """One torch Adam step against optax.adam(3e-4), and the port's
    global-norm clip against optax.clip_by_global_norm(0.5)."""
    rng = np.random.default_rng(3)
    p0 = [rng.standard_normal((3, 4)), rng.standard_normal(5)]
    g0 = [rng.standard_normal((3, 4)), 1e-3 * rng.standard_normal(5)]
    tx = optax.adam(3e-4)
    jp = [jnp.asarray(p) for p in p0]
    up, _ = tx.update([jnp.asarray(g) for g in g0], tx.init(jp), jp)
    ref = optax.apply_updates(jp, up)
    tp = [t64(p).requires_grad_() for p in p0]
    opt = torch.optim.Adam(tp, lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
    for p, g in zip(tp, g0):
        p.grad = t64(g)
    opt.step()
    for r, o in zip(ref, tp):
        assert rel(r, o) < 1e-12
    for scale in (1.0, 1e-3):
        gs = [scale * g for g in g0]
        clip = optax.clip_by_global_norm(0.5)
        ref, _ = clip.update([jnp.asarray(g) for g in gs], clip.init(None))
        out = [t64(g) for g in gs]
        tppo.clip_by_global_norm_(out, 0.5)
        for r, o in zip(ref, out):
            assert rel(r, o) < 1e-12


def check_env():
    c = jax_env()
    base = base_f64()
    jm = jm_f64()
    # the RL model: POSITION servos, kp 2, kv 0, ctrl range ±π/2
    assert base.struct.act_type == jm.struct.act_type
    for k in ("act_kp", "act_kv", "act_ctrlrange", "body_mass",
              "jnt_range", "hfield_data"):
        assert rel(getattr(jm, k), getattr(base, k)) < 1e-15, k
    es, obs = tenv.env_reset(TCFG, base, 1.0, reset_draws(c["reset_draws"]))
    ref = c["es"]
    for k, r in ref["patch"].items():
        assert rel(r, getattr(es.patch, k)) < 1e-9, k
    assert rel(ref["phys"]["qpos"], es.phys.qpos) < 1e-9
    for k in ("d_action", "d_joint", "d_angvel", "d_gravity", "force_body"):
        assert np.array_equal(ref[k], getattr(es, k).numpy()), k
    assert rel(c["obs"], obs) < 1e-9
    # the converter gives the same state
    conv = tenv.env_state_from_jax(ref, device="cpu", dtype=F64)
    assert rel(ref["buf_gravity"], conv.buf_gravity) == 0.0
    assert rel(conv.patch.hfield_data, es.patch.hfield_data) < 1e-9
    for t in range(3):
        es, obs, r, term, trunc = tenv.env_step(
            TCFG, base, es, t64(c["actions"][t]),
            step_draws(c["step_draws"][t]))
        s = c["steps"][t]
        for name, o in (("obs", obs), ("reward", r),
                        ("qpos", es.phys.qpos), ("qvel", es.phys.qvel)):
            assert rel(s[name], o) < 1e-9, (t, name, rel(s[name], o))
        assert np.array_equal(s["terminal"], term.numpy())
        assert np.array_equal(s["truncated"], trunc.numpy())
    # every leaf of the state after 3 steps: the delay buffers hold the
    # noisy readings the observation will show, the force schedule its
    # draws
    ref = c["es3"]
    got = tenv.env_state_to_dict(es)
    for k, r in ref.items():
        if k == "rng":
            continue
        for kk, rr in (r.items() if isinstance(r, dict) else [(k, r)]):
            o = got[k][kk] if isinstance(r, dict) else got[k]
            if np.issubdtype(rr.dtype, np.integer):
                assert np.array_equal(rr, o.numpy()), (k, kk)
            else:
                assert rel(rr, o) < 1e-9, (k, kk, rel(rr, o))
    assert np.abs(ref["buf_jpos"][:, -3:]).min() > 0


def check_per_env_smooth_twin():
    c = jax_env()
    es = tenv.env_state_from_jax(c["es"], device="cpu", dtype=F64)
    m = es.patch.apply(base_f64())
    assert m.env_batch == B and m.per_env("hfield_data")
    qvel, ctrl, xfrc = (t64(x) for x in c["smooth_in"])
    out = fused_smooth.smooth_raw_reference(m, es.phys.qpos, qvel, ctrl,
                                            xfrc)
    for name, r, o in zip(fused_smooth.NAMES, c["smooth"], out):
        o = o.numpy()
        if name == "dist":
            sent = r > 1e8
            assert np.array_equal(sent, o > 1e8)
            r, o = r[~sent], o[~sent]
        if r.size:
            assert rel(r, o) < 1e-9, (name, rel(r, o))
    # the envs' heightfields differ
    assert np.ptp(c["es"]["patch"]["hfield_data"], axis=0).max() > 0.01


def load_flax(module, tree):
    module.load_state_dict(params_from_flax(tree))


def check_params(module, tree, tol):
    ref = params_from_flax(tree)
    out = module.state_dict()
    assert ref.keys() == out.keys()
    for k in ref:
        assert rel(ref[k], out[k]) < tol, (k, rel(ref[k], out[k]))


def check_sac():
    c = jax_sac()
    base = base_f64()
    cfg = tsac.SACConfig(**SAC_CFG)
    st = tsac.sac_init(cfg, TCFG, base, 1.0, torch.Generator())
    p0 = c["st0"]["params"]
    load_flax(st.pi, p0["pi"])
    load_flax(st.q, p0["q"])
    load_flax(st.q_target, p0["q_target"])
    st.env_state = tenv.env_state_from_jax(c["st0"]["env_state"],
                                           device="cpu", dtype=F64)
    st.obs = t64(c["st0"]["obs"])

    def draws(d):
        return tsac.SACDraws(
            act=t64(d["act"]), env=step_draws(d["env"]),
            reset=reset_draws(d["reset"]),
            idx=torch.tensor(d["idx"], dtype=torch.int64),
            crit=t64(d["crit"]), pi=t64(d["pi"]))
    st, met = tsac.sac_train_step_core(cfg, TCFG, base, st,
                                       [draws(d) for d in c["rounds"]])
    assert c["met"]["episodes_done"] == 0 == float(met["episodes_done"])
    for k in ("q_loss", "pi_loss", "alpha", "mean_reward"):
        assert rel(c["met"][k], met[k]) < 1e-5, (k, c["met"][k],
                                                 float(met[k]))
    p1 = c["st1"]["params"]
    for name in ("pi", "q", "q_target"):
        check_params(getattr(st, name), p1[name], 1e-5)
    assert rel(p1["log_alpha"], st.log_alpha) < 1e-5
    assert st.buffer.size == cfg.steps_per_update * B
    assert rel(c["st1"]["buffer"]["obs"], st.buffer.obs) < 1e-9


def check_ppo():
    c = jax_ppo()
    base = base_f64()
    cfg = tppo.PPOConfig(**PPO_CFG)
    st = tppo.ppo_init(cfg, TCFG, base, 1.0, torch.Generator())
    p0 = c["st0"]["params"]
    load_flax(st.pi, p0["pi"])
    load_flax(st.v, p0["v"])
    st.env_state = tenv.env_state_from_jax(c["st0"]["env_state"],
                                           device="cpu", dtype=F64)
    st.obs = t64(c["st0"]["obs"])
    draws = tppo.PPODraws(
        act=[t64(a) for a in c["act"]],
        env=[step_draws(d) for d in c["env"]],
        reset=[reset_draws(d) for d in c["reset"]],
        perm=[torch.tensor(p, dtype=torch.int64) for p in c["perm"]])
    st, met = tppo.ppo_train_step_core(cfg, TCFG, base, st, draws)
    for k in ("loss", "mean_reward", "episode_done_rate", "success_rate"):
        assert abs(c["met"][k] - float(met[k])) <= 1e-5 * max(
            1.0, abs(c["met"][k])), (k, c["met"][k], float(met[k]))
    p1 = c["st1"]["params"]
    check_params(st.pi, p1["pi"], 1e-5)
    check_params(st.v, p1["v"], 1e-5)
    assert rel(c["st1"]["obs"], st.obs) < 1e-9


def check_model_cache_repair():
    """A dataclasses.replace'd model starts an empty cache, so its packs
    and int table follow the replaced leaf and structure (the RL model's
    POSITION servos and kp 2)."""
    m = th.build_humanoid(device="cpu")
    d = fused_smooth.smooth_dims(m)
    tab = fused_smooth._tab(m)
    m2 = tenv.rl_humanoid_model(device="cpu")
    assert m2.cache is not m.cache and "smooth_packs" not in m2.cache
    m3 = dataclasses.replace(m, act_kp=torch.full((m.nu,), 2.0))
    assert m3.cache == {} and m3.struct is m.struct
    actp = fused_smooth._pack_params(m3)[4].reshape(m.nu, 7)
    assert torch.equal(actp[:, 1], torch.full((m.nu,), 2.0))
    tab2 = fused_smooth._tab(m2)
    assert fused_smooth.smooth_dims(m2).ntab == d.ntab
    act0 = tab[16 + 8]                  # the actuator records' offset
    assert tab[act0] == 0 and tab2[act0] == 1      # MOTOR -> POSITION
    assert fused_smooth._tab(m3) is tab


def check_struct_tables_built_once():
    """Across env steps (a new patched model each step), B1's int table,
    the launch shape and meta, the contact mask and B2's chain layout are
    built once per structure; the per-env packs are (B, n) at env stride
    n, six of the nine."""
    base = tenv.rl_humanoid_model(device="cpu")
    builds = []
    int_table = fused_smooth._int_table

    def counting(*a):
        builds.append(1)
        return int_table(*a)
    fused_smooth._int_table = counting
    try:
        g = torch.Generator()
        g.manual_seed(0)
        es, _ = tenv.batch_reset(TCFG, base, 1.0, 3, g)
        masks = set()
        for _ in range(3):
            es, *_ = tenv.batch_step(TCFG, base, es, torch.zeros(3, 12), g)
            m = es.patch.apply(base)
            z = torch.zeros(3, 14, 6)
            ins, _, meta, ints = fused_smooth._smooth_launch_args(
                m, es.phys.qpos, es.phys.qvel, torch.zeros(3, 12), z)
            masks.add(id(fused_solver.chain_layout(contact_dmask(m))))
    finally:
        fused_smooth._int_table = int_table
    assert len(builds) == 1 and len(masks) == 1
    d = fused_smooth.smooth_dims(m)
    assert d.pstride == (252, 130, 36, 0, 84, 0, 0, 20, 64)
    assert d.psize[:3] == (252, 130, 36) and sum(d.pstride) == 586
    packs = ins[4:13]
    assert [tuple(p.shape) for p in packs if p.ndim == 2] == [
        (3, 252), (3, 130), (3, 36), (3, 84), (3, 20), (3, 64)]
    assert torch.equal(packs[0].reshape(3, 14, 18)[:, :, 17],
                       es.patch.body_mass)
    assert torch.equal(packs[8], es.patch.hfield_data.reshape(3, 64))
    assert meta[48 + 9:48 + 18].tolist() == list(d.pstride)
    # per env the six packs add 586 floats to one env's shared memory
    shared = fused_smooth.smooth_dims(base)
    extra = (fused_smooth.smooth_smem_bytes(d, 1)
             - fused_smooth.smooth_smem_bytes(d, 0)
             - fused_smooth.smooth_smem_bytes(shared, 1)
             + fused_smooth.smooth_smem_bytes(shared, 0))
    assert 4 * 586 <= extra < 4 * (586 + 32)
    assert ints[1:] == fused_smooth.smooth_block_shape(d)


def check_checkpoint_resume():
    """rl.train.main for 1 iteration, then a resume from its checkpoint
    to 2, gives the parameters, buffer and env batch of an uninterrupted
    2-iteration run, to the bit."""
    common = ["--algo", "sac", "--envs", "2", "--eval-every", "1",
              "--device", "cpu", "--seed", "3"]
    spi = 32 * 2
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        _, ckpt = ttrain.main(common + ["--out", a, "--steps", str(spi)])
        resumed, _ = ttrain.main(common + ["--out", a, "--steps",
                                           str(2 * spi), "--ckpt", ckpt])
        fresh, _ = ttrain.main(common + ["--out", b, "--steps",
                                         str(2 * spi)])
    for name in ("pi", "q", "q_target"):
        ra, fa = (getattr(x, name).state_dict() for x in (resumed, fresh))
        assert all(torch.equal(ra[k], fa[k]) for k in ra), name
    assert torch.equal(resumed.buffer.obs, fresh.buffer.obs)
    assert torch.equal(resumed.env_state.phys.qpos,
                       fresh.env_state.phys.qpos)
    assert resumed.step_count == fresh.step_count == 2 * spi


def run_local_checks():
    """The checks that need no JAX reference of the env or trainers."""
    check_rewards()
    check_gae_ring_curriculum()
    check_optimizer_steps()
    check_model_cache_repair()
    check_struct_tables_built_once()
    check_checkpoint_resume()


def run_reference_checks(references=None):
    """The checks against the JAX env, SAC and PPO; `references` holds
    results of `reference` built elsewhere (in other processes), by
    name."""
    _RESULTS.update(references or {})
    check_env()
    check_per_env_smooth_twin()
    check_sac()
    check_ppo()


def run_checks():
    run_local_checks()
    run_reference_checks()
