"""PPO over the lockstep env batch, on one device.

Counterpart of humanoid_mujoco_tpu/rl/ppo.py (the reference's SB3 PPO
search space, 3×256 tanh): one `ppo_train_step` collects `rollout_len`
steps from every env, computes GAE, normalizes the advantages and runs
`n_epochs` passes of `n_minibatch` clipped-surrogate updates over a
random permutation (optax.chain(clip_by_global_norm, adam), written
out: the clip scales by max / norm when norm >= max, as optax does).

The draws are kept apart from the arithmetic: `ppo_train_step_core`
takes them (`PPODraws`); `ppo_train_step` draws them from the state's
generator. The networks and the optimizer are updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..physics.model import Model
from .env import (EnvConfig, EnvState, ResetDraws, StepDraws, batch_reset,
                  draw_reset, draw_step, env_auto_reset, env_state_from_dict,
                  env_state_to_dict, env_step)
from .networks import GaussianPolicy, VFunction, gaussian_logp


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    n_envs: int = 256
    rollout_len: int = 64
    n_minibatch: int = 8
    n_epochs: int = 4
    hidden: tuple = (256, 256, 256)
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    lr: float = 3e-4
    max_grad_norm: float = 0.5


@dataclasses.dataclass
class PPOState:
    pi: GaussianPolicy
    v: VFunction
    opt: torch.optim.Adam             # over pi's and v's parameters
    env_state: EnvState
    obs: torch.Tensor                 # (n_envs, obs_dim)
    generator: torch.Generator
    update_count: int = 0

    def params(self):
        return list(self.pi.parameters()) + list(self.v.parameters())

    def state_dict(self) -> dict:
        return dict(pi=self.pi.state_dict(), v=self.v.state_dict(),
                    opt=self.opt.state_dict(),
                    env_state=env_state_to_dict(self.env_state),
                    obs=self.obs, generator=self.generator.get_state(),
                    update_count=self.update_count)

    def load_state_dict(self, d):
        for k in ("pi", "v", "opt"):
            getattr(self, k).load_state_dict(d[k])
        self.env_state = env_state_from_dict(d["env_state"])
        self.obs = d["obs"]
        self.generator.set_state(d["generator"].cpu())
        self.update_count = int(d["update_count"])


@dataclasses.dataclass(frozen=True)
class PPODraws:
    """A train step's draws: per collected step t, act[t] (n_envs,
    act_dim) standard normals, env[t] and reset[t] the env step's and
    the auto-reset's draws; per epoch, perm[e] (rollout_len * n_envs,)
    int64 a permutation."""

    act: Sequence[torch.Tensor]
    env: Sequence[StepDraws]
    reset: Sequence[ResetDraws]
    perm: Sequence[torch.Tensor]


def ppo_init(cfg: PPOConfig, env_cfg: EnvConfig, base: Model, rf,
             generator: torch.Generator, obs_dim: int = 30,
             act_dim: int = 12) -> PPOState:
    es, obs = batch_reset(env_cfg, base, rf, cfg.n_envs, generator)
    kw = dict(dtype=base.dtype, device=base.device)
    pi = GaussianPolicy(obs_dim, act_dim, cfg.hidden, "tanh", False,
                        generator, **kw)
    v = VFunction(obs_dim, cfg.hidden, "tanh", generator, **kw)
    # optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8, eps_root 0
    opt = torch.optim.Adam(list(pi.parameters()) + list(v.parameters()),
                           lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    return PPOState(pi=pi, v=v, opt=opt, env_state=es, obs=obs,
                    generator=generator)


def _gae(rewards, values, last_value, dones, gamma, lam):
    """rewards, values, dones (T, B); last_value (B,). Returns
    (advantages, returns), (T, B)."""
    adv = torch.empty_like(values)
    gae = torch.zeros_like(last_value)
    next_v = last_value
    for t in range(values.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_v * nonterm - values[t]
        gae = delta + gamma * lam * nonterm * gae
        adv[t] = gae
        next_v = values[t]
    return adv, adv + values


def clip_by_global_norm_(grads, max_norm: float):
    """optax.clip_by_global_norm in place: g -> (g / norm) * max_norm
    when the global norm is at least max_norm; no host sync."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


def ppo_collect(cfg: PPOConfig, env_cfg: EnvConfig, base: Model,
                state: PPOState, draws: PPODraws):
    """Roll the state's envs out for cfg.rollout_len steps under the
    policy: (env state, obs, rollout), the rollout (obs, act, logp, v, r,
    done, trunc) each (T, B, ...) and the last obs's values (B,). Every
    env reads only its own row of the draws, so a shard of the envs
    collects with the same rows of the whole batch's draws."""
    traj = []
    es, obs = state.env_state, state.obs
    with torch.no_grad():
        for t in range(cfg.rollout_len):
            # the unclipped sample is stored with its logp (SB3); only
            # the copy sent to the env is clipped
            mean, log_std = state.pi(obs)
            a = mean + torch.exp(log_std) * draws.act[t]
            logp = gaussian_logp(mean, log_std, a)
            v = state.v(obs)
            es, obs2, r, term, trunc = env_step(
                env_cfg, base, es, torch.clamp(a, -1.0, 1.0), draws.env[t])
            es, obs2, done = env_auto_reset(env_cfg, base, es, obs2, r, term,
                                            trunc, draws.reset[t])
            traj.append((obs, a, logp, v, r, done.to(r.dtype), trunc))
            obs = obs2
        rollout = tuple(torch.stack(x) for x in zip(*traj))
        rollout += (state.v(obs),)
    return es, obs, rollout


def ppo_update(cfg: PPOConfig, state: PPOState, rollout, perm,
               part=None, reduce=None):
    """GAE, advantage normalization and the n_epochs x n_minibatch
    clipped-surrogate updates of the whole batch's rollout (as
    `ppo_collect` returns it); updates the networks and the optimizer in
    place. Returns the metrics, 0-d tensors.

    For a data-parallel step (parallel/distributed.py): `part(idx)`
    names the rows of minibatch `idx` whose loss this process takes, its
    loss weighted by their share of the minibatch, and `reduce(x)` sums
    a tensor over the processes in place (each gradient, and the
    losses). By default one process takes every row."""
    obs_t, act_t, logp_t, v_t, r_t, done_t, trunc_t, last_v = rollout
    with torch.no_grad():
        adv, ret = _gae(r_t, v_t, last_v, done_t, cfg.gamma, cfg.lam)
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    N = obs_t.shape[0] * obs_t.shape[1]
    batch = tuple(x.reshape((N,) + x.shape[2:])
                  for x in (obs_t, act_t, logp_t, adv, ret))
    half_log_2pie = 0.5 * math.log(2 * math.pi * math.e)
    params = state.params()
    losses = []
    for e in range(cfg.n_epochs):
        idxs = perm[e].reshape(cfg.n_minibatch, N // cfg.n_minibatch)
        for idx in idxs:
            rows = idx if part is None else part(idx)
            share = rows.numel() / idx.numel()
            obs_b, act_b, logp_old, adv_b, ret_b = (x[rows] for x in batch)
            mean, log_std = state.pi(obs_b)
            logp = gaussian_logp(mean, log_std, act_b)
            ratio = torch.exp(logp - logp_old)
            pg = -torch.mean(torch.minimum(
                ratio * adv_b,
                torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv_b))
            v_loss = torch.mean((state.v(obs_b) - ret_b) ** 2)
            ent = torch.mean(torch.sum(log_std + half_log_2pie, dim=-1))
            loss = (pg + cfg.vf_coef * v_loss - cfg.ent_coef * ent) * share
            state.opt.zero_grad(set_to_none=True)
            loss.backward()
            if reduce is not None:
                for p in params:
                    reduce(p.grad)
            clip_by_global_norm_([p.grad for p in params], cfg.max_grad_norm)
            state.opt.step()
            losses.append(loss.detach())
    losses = torch.stack(losses)
    if reduce is not None:
        reduce(losses)
    # success: the share of completed episodes that ended by truncation
    return dict(loss=losses.mean(), mean_reward=r_t.mean(),
                episode_done_rate=done_t.mean(),
                success_rate=trunc_t.to(r_t.dtype).sum()
                / torch.clamp(done_t.sum(), min=1.0))


def ppo_train_step_core(cfg: PPOConfig, env_cfg: EnvConfig, base: Model,
                        state: PPOState, draws: PPODraws):
    """Collect, then update (see the module docstring). Updates `state`
    in place; returns (state, metrics), metrics as 0-d tensors."""
    es, obs, rollout = ppo_collect(cfg, env_cfg, base, state, draws)
    metrics = ppo_update(cfg, state, rollout, draws.perm)
    state.env_state, state.obs = es, obs
    state.update_count += 1
    return state, metrics


def draw_train_step(cfg: PPOConfig, base: Model, state: PPOState
                    ) -> PPODraws:
    """A train step's draws from the state's generator, in the order the
    step reads them: per collected step its action normals, its env
    step's and its reset's draws; then each epoch's permutation."""
    g, n = state.generator, cfg.n_envs
    dev, dtype = state.obs.device, state.obs.dtype
    act, env, reset = [], [], []
    for _ in range(cfg.rollout_len):
        act.append(torch.randn((n, state.pi.heads[0].out_features),
                               generator=g, device=dev, dtype=dtype))
        env.append(draw_step(base, n, g))
        reset.append(draw_reset(base, n, g))
    perm = [torch.randperm(cfg.rollout_len * n, generator=g, device=dev)
            for _ in range(cfg.n_epochs)]
    return PPODraws(act=act, env=env, reset=reset, perm=perm)


def ppo_train_step(cfg: PPOConfig, env_cfg: EnvConfig, base: Model,
                   state: PPOState):
    """`ppo_train_step_core` with the draws from the state's generator."""
    return ppo_train_step_core(cfg, env_cfg, base, state,
                               draw_train_step(cfg, base, state))
