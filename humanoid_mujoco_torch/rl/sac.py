"""Soft actor-critic over the lockstep env batch, on one device.

Counterpart of humanoid_mujoco_tpu/rl/sac.py (the reference's SB3 SAC:
MlpPolicy 3×128, batch 4 × n_envs) with an on-device replay buffer. One
`sac_train_step` runs `steps_per_update` rounds of one env step for all
envs, one critic, one actor and one temperature update (Adam, the
optax.adam defaults), then the Polyak target update, as the JAX step
does; the success counters are windowed over the call.

The draws are kept apart from the arithmetic: `sac_train_step_core`
takes each round's draws (`SACDraws`); `sac_train_step` draws them from
the state's generator. The networks, optimizers and buffer are updated
in place.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterable, Optional

import torch

from ..physics.model import Model
from .env import (EnvConfig, EnvState, ResetDraws, StepDraws, batch_reset,
                  draw_reset, draw_step, env_auto_reset, env_state_from_dict,
                  env_state_to_dict, env_step)
from .networks import DoubleQ, GaussianPolicy, sample_squashed


@dataclasses.dataclass(frozen=True)
class SACConfig:
    n_envs: int = 256
    buffer_size: int = 262144
    batch_size: int = 1024
    hidden: tuple = (128, 128, 128)
    steps_per_update: int = 32
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    target_entropy: float = -12.0     # -act_dim (SB3 "auto")


class ReplayBuffer:
    """A ring of transitions on the device. The write pointer and the
    fill are host integers (they follow from the call count alone), so
    sampling needs no device sync."""

    def __init__(self, cap: int, obs_dim: int, act_dim: int, dtype, device):
        def z(*shape):
            return torch.zeros((cap,) + shape, dtype=dtype, device=device)
        self.obs, self.act, self.rew = z(obs_dim), z(act_dim), z()
        self.next_obs, self.done = z(obs_dim), z()
        self.ptr = 0
        self.size = 0

    FIELDS = ("obs", "act", "rew", "next_obs", "done")

    @property
    def cap(self) -> int:
        return self.obs.shape[0]

    def add_batch(self, *rows):
        """Write one transition per env (obs, act, rew, next_obs, done)
        at the pointer, wrapping around."""
        n, cap = rows[0].shape[0], self.cap
        assert n <= cap
        first = min(n, cap - self.ptr)
        for name, x in zip(self.FIELDS, rows):
            dst = getattr(self, name)
            dst[self.ptr:self.ptr + first] = x[:first]
            if first < n:
                dst[:n - first] = x[first:]
        self.ptr = (self.ptr + n) % cap
        self.size = min(self.size + n, cap)

    def sample(self, idx):
        return tuple(getattr(self, k)[idx] for k in self.FIELDS)

    def state_dict(self) -> dict:
        return {**{k: getattr(self, k) for k in self.FIELDS},
                "ptr": self.ptr, "size": self.size}

    def load_state_dict(self, d):
        for k in self.FIELDS:
            getattr(self, k).copy_(d[k])
        self.ptr, self.size = int(d["ptr"]), int(d["size"])


@dataclasses.dataclass
class SACState:
    pi: GaussianPolicy
    q: DoubleQ
    q_target: DoubleQ
    log_alpha: torch.Tensor            # () requires grad
    opt_pi: torch.optim.Adam
    opt_q: torch.optim.Adam
    opt_alpha: torch.optim.Adam
    buffer: ReplayBuffer
    env_state: EnvState
    obs: torch.Tensor                  # (n_envs, obs_dim)
    generator: torch.Generator
    step_count: int = 0
    # windowed episode counters: success rate = d(trunc) / d(done) over
    # one train step
    ep_done: Optional[torch.Tensor] = None
    ep_trunc: Optional[torch.Tensor] = None

    def state_dict(self) -> dict:
        """Everything a resume needs: parameters, optimizer moments, the
        replay buffer, the env batch, the generator and the counters."""
        return dict(
            pi=self.pi.state_dict(), q=self.q.state_dict(),
            q_target=self.q_target.state_dict(),
            log_alpha=self.log_alpha.detach().clone(),
            opt_pi=self.opt_pi.state_dict(), opt_q=self.opt_q.state_dict(),
            opt_alpha=self.opt_alpha.state_dict(),
            buffer=self.buffer.state_dict(),
            env_state=env_state_to_dict(self.env_state), obs=self.obs,
            generator=self.generator.get_state(),
            step_count=self.step_count, ep_done=self.ep_done,
            ep_trunc=self.ep_trunc)

    def load_state_dict(self, d):
        for k in ("pi", "q", "q_target", "opt_pi", "opt_q", "opt_alpha",
                  "buffer"):
            getattr(self, k).load_state_dict(d[k])
        with torch.no_grad():
            self.log_alpha.copy_(d["log_alpha"])
        self.env_state = env_state_from_dict(d["env_state"])
        self.obs = d["obs"]
        self.generator.set_state(d["generator"].cpu())
        self.step_count = int(d["step_count"])
        self.ep_done, self.ep_trunc = d["ep_done"], d["ep_trunc"]


@dataclasses.dataclass(frozen=True)
class SACDraws:
    """One round's draws: act (n_envs, act_dim), crit and pi
    (batch_size, act_dim) standard normals; idx (batch_size,) int64
    replay indices in [0, max(size, 1)); the env step's and the
    auto-reset's draws."""

    act: torch.Tensor
    env: StepDraws
    reset: ResetDraws
    idx: torch.Tensor
    crit: torch.Tensor
    pi: torch.Tensor


def _adam(params, lr):
    # optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8, eps_root 0
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def sac_init(cfg: SACConfig, env_cfg: EnvConfig, base: Model, rf,
             generator: torch.Generator, obs_dim: int = 30,
             act_dim: int = 12) -> SACState:
    """The env batch reset at rf, fresh networks (flax's init), Adam
    states, an empty buffer; all draws from `generator`."""
    es, obs = batch_reset(env_cfg, base, rf, cfg.n_envs, generator)
    kw = dict(dtype=base.dtype, device=base.device)
    pi = GaussianPolicy(obs_dim, act_dim, cfg.hidden, "tanh", True,
                        generator, **kw)
    q = DoubleQ(obs_dim, act_dim, cfg.hidden, generator, **kw)
    q_target = copy.deepcopy(q).requires_grad_(False)
    log_alpha = torch.zeros((), requires_grad=True, **kw)
    return SACState(
        pi=pi, q=q, q_target=q_target, log_alpha=log_alpha,
        opt_pi=_adam(pi.parameters(), cfg.lr),
        opt_q=_adam(q.parameters(), cfg.lr),
        opt_alpha=_adam([log_alpha], cfg.lr),
        buffer=ReplayBuffer(cfg.buffer_size, obs_dim, act_dim, **kw),
        env_state=es, obs=obs, generator=generator,
        ep_done=torch.zeros((), **kw), ep_trunc=torch.zeros((), **kw))


def _round(cfg: SACConfig, env_cfg: EnvConfig, base: Model, st: SACState,
           d: SACDraws):
    """One round: one env step for all envs, then one gradient update."""
    with torch.no_grad():
        mean, log_std = st.pi(st.obs)
        a, _ = sample_squashed(mean, log_std, d.act)
        es, obs2, r, term, trunc = env_step(env_cfg, base, st.env_state, a,
                                            d.env)
        es, obs2_reset, done = env_auto_reset(env_cfg, base, es, obs2, r,
                                              term, trunc, d.reset)
        # the bootstrap cut is terminal only: time-limit truncations
        # (the standup success among them) still bootstrap the Q target
        st.buffer.add_batch(st.obs, a, r, obs2, term.to(r.dtype))
        st.ep_done = st.ep_done + done.to(r.dtype).sum()
        st.ep_trunc = st.ep_trunc + trunc.to(r.dtype).sum()
        st.env_state, st.obs = es, obs2_reset

        ob, ab, rb, nob, db = st.buffer.sample(d.idx)
        alpha = torch.exp(st.log_alpha)
        mean2, ls2 = st.pi(nob)
        a2, logp2 = sample_squashed(mean2, ls2, d.crit)
        q1t, q2t = st.q_target(nob, a2)
        target = rb + cfg.gamma * (1 - db) * (torch.minimum(q1t, q2t)
                                              - alpha * logp2)

    q1, q2 = st.q(ob, ab)
    ql = torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)
    st.opt_q.zero_grad(set_to_none=True)
    ql.backward()
    st.opt_q.step()

    mean, ls = st.pi(ob)
    aa, logp = sample_squashed(mean, ls, d.pi)
    q1, q2 = st.q(ob, aa)
    pl = torch.mean(alpha * logp - torch.minimum(q1, q2))
    st.opt_pi.zero_grad(set_to_none=True)
    pl.backward(inputs=list(st.pi.parameters()))
    st.opt_pi.step()

    al = -torch.mean(torch.exp(st.log_alpha)
                     * (logp.detach() + cfg.target_entropy))
    st.opt_alpha.zero_grad(set_to_none=True)
    al.backward()
    st.opt_alpha.step()

    with torch.no_grad():
        tp = list(st.q_target.parameters())
        torch._foreach_mul_(tp, 1 - cfg.tau)
        torch._foreach_add_(tp, torch._foreach_mul(
            list(st.q.parameters()), cfg.tau))
    return r.mean(), ql.detach(), pl.detach(), alpha


def sac_train_step_core(cfg: SACConfig, env_cfg: EnvConfig, base: Model,
                        state: SACState, draws: Iterable[SACDraws]):
    """`steps_per_update` rounds, round k from draws[k] (an iterable,
    read one round at a time). Updates `state` in place; returns
    (state, metrics), metrics as 0-d tensors on the device."""
    d0, t0 = state.ep_done, state.ep_trunc
    rounds = [_round(cfg, env_cfg, base, state, d) for _, d in
              zip(range(cfg.steps_per_update), draws)]
    rews, qls, pls, alphas = (torch.stack(x) for x in zip(*rounds))
    state.step_count += cfg.steps_per_update * cfg.n_envs
    d_done = state.ep_done - d0
    d_trunc = state.ep_trunc - t0
    metrics = dict(q_loss=qls.mean(), pi_loss=pls.mean(), alpha=alphas[-1],
                   mean_reward=rews.mean(), episodes_done=d_done,
                   success_rate=d_trunc / torch.clamp(d_done, min=1.0))
    return state, metrics


def draw_round(cfg: SACConfig, base: Model, state: SACState) -> SACDraws:
    """One round's draws from the state's generator."""
    g, n, buf = state.generator, cfg.n_envs, state.buffer

    def normal(rows):
        return torch.randn((rows, buf.act.shape[1]), generator=g,
                           device=buf.act.device, dtype=buf.act.dtype)
    act = normal(n)
    env = draw_step(base, n, g)
    reset = draw_reset(base, n, g)
    # the buffer holds this round's transitions when it is sampled
    size = min(buf.size + n, buf.cap)
    idx = torch.randint(0, max(size, 1), (cfg.batch_size,), generator=g,
                        device=buf.act.device)
    return SACDraws(act=act, env=env, reset=reset, idx=idx,
                    crit=normal(cfg.batch_size), pi=normal(cfg.batch_size))


def sac_train_step(cfg: SACConfig, env_cfg: EnvConfig, base: Model,
                   state: SACState):
    """`sac_train_step_core` with each round's draws from the state's
    generator."""
    draws = (draw_round(cfg, base, state)
             for _ in range(cfg.steps_per_update))
    return sac_train_step_core(cfg, env_cfg, base, state, draws)
