"""Policy and value networks for SAC and PPO.

Counterpart of humanoid_mujoco_tpu/rl/networks.py (flax.linen), with the
reference's SB3 widths: SAC 3×128 (policy tanh, critics relu), PPO
3×256 (tanh). Layers are `nn.Linear`, initialized as flax's `Dense`:
kernels lecun_normal (a normal truncated at ±2 std over fan_in), biases
zero, each draw from the caller's `torch.Generator`.

Submodules mirror the flax tree, so `params_from_flax` maps a flax
parameter tree onto `state_dict()` names: `MLP_0` -> `mlp`, its
`Dense_i` -> `mlp.layers.i`, a module's own `Dense_i` -> `heads.i`,
`QFunction_i` -> `qs.i`, `kernel` (in, out) -> `weight` (out, in).
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
_LOG_2PI = math.log(2 * math.pi)


def lecun_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """flax's default Dense kernel init on a (out, in) weight: variance
    1 / fan_in, a normal truncated at ±2 standard deviations."""
    std = math.sqrt(1.0 / weight.shape[1]) / .87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def dense(n_in: int, n_out: int, generator=None, **kw) -> nn.Linear:
    lin = nn.Linear(n_in, n_out, **kw)
    lecun_normal_(lin.weight, generator)
    nn.init.zeros_(lin.bias)
    return lin


_ACT = dict(tanh=torch.tanh, relu=torch.relu)


class MLP(nn.Module):
    def __init__(self, n_in: int, features: Sequence[int],
                 activation: str = "tanh", generator=None, **kw):
        super().__init__()
        sizes = (n_in,) + tuple(features)
        self.layers = nn.ModuleList(
            dense(a, b, generator, **kw) for a, b in zip(sizes, sizes[1:]))
        self.act = _ACT[activation]

    def forward(self, x):
        for layer in self.layers:
            x = self.act(layer(x))
        return x


class GaussianPolicy(nn.Module):
    """Squashed-Gaussian actor (SAC: a state-dependent log std head) or
    diagonal-Gaussian actor (PPO: one global `log_std` parameter)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128, 128, 128),
                 activation: str = "tanh", state_dependent_std: bool = True,
                 generator=None, **kw):
        super().__init__()
        self.mlp = MLP(obs_dim, hidden, activation, generator, **kw)
        n = 2 if state_dependent_std else 1
        self.heads = nn.ModuleList(dense(hidden[-1], action_dim, generator,
                                         **kw) for _ in range(n))
        if not state_dependent_std:
            self.log_std = nn.Parameter(torch.zeros(action_dim, **kw))

    def forward(self, obs):
        h = self.mlp(obs)
        mean = self.heads[0](h)
        if len(self.heads) == 2:
            log_std = self.heads[1](h)
        else:
            log_std = self.log_std.expand_as(mean)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


class VFunction(nn.Module):
    def __init__(self, obs_dim: int, hidden: Sequence[int] = (256, 256, 256),
                 activation: str = "tanh", generator=None, **kw):
        super().__init__()
        self.mlp = MLP(obs_dim, hidden, activation, generator, **kw)
        self.heads = nn.ModuleList([dense(hidden[-1], 1, generator, **kw)])

    def forward(self, obs):
        return self.heads[0](self.mlp(obs))[..., 0]


class QFunction(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (128, 128, 128),
                 activation: str = "relu", generator=None, **kw):
        super().__init__()
        self.mlp = MLP(obs_dim + act_dim, hidden, activation, generator, **kw)
        self.heads = nn.ModuleList([dense(hidden[-1], 1, generator, **kw)])

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self.heads[0](self.mlp(x))[..., 0]


class DoubleQ(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (128, 128, 128), generator=None,
                 **kw):
        super().__init__()
        self.qs = nn.ModuleList(
            QFunction(obs_dim, act_dim, hidden, "relu", generator, **kw)
            for _ in range(2))

    def forward(self, obs, act):
        return self.qs[0](obs, act), self.qs[1](obs, act)


def sample_squashed(mean, log_std, eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """tanh-squashed Gaussian sample and its log-probability (SAC), from
    standard normals eps shaped like mean."""
    pre = mean + torch.exp(log_std) * eps
    act = torch.tanh(pre)
    logp = torch.sum(
        -0.5 * (eps ** 2 + 2 * log_std + _LOG_2PI)
        - torch.log(torch.clamp(1 - act ** 2, min=1e-6)), dim=-1)
    return act, logp


def gaussian_logp(mean, log_std, act) -> torch.Tensor:
    std = torch.exp(log_std)
    return torch.sum(
        -0.5 * (((act - mean) / std) ** 2 + 2 * log_std + _LOG_2PI), dim=-1)


def _torch_name(path, leaf: str) -> str:
    parts = []
    for i, p in enumerate(path):
        kind, _, idx = p.rpartition("_")
        if kind == "MLP":
            parts.append("mlp")
        elif kind == "QFunction":
            parts.append(f"qs.{idx}")
        elif kind == "Dense":
            inside_mlp = i > 0 and path[i - 1].startswith("MLP_")
            parts.append(f"{'layers' if inside_mlp else 'heads'}.{idx}")
        else:
            raise KeyError(f"unknown flax module {p!r}")
    parts.append({"kernel": "weight"}.get(leaf, leaf))
    return ".".join(parts)


def params_from_flax(tree) -> dict:
    """A flax parameter tree (`{"params": {...}}` or its inner mapping,
    leaves array-like) as a state dict of this module's networks, float
    tensors on the CPU: load it with `module.load_state_dict`, which
    casts to the module's dtype and device."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + [k])
            else:
                a = np.asarray(v)
                out[_torch_name(path, k)] = torch.tensor(
                    a.T.copy() if k == "kernel" else a)
    walk(tree, [])
    return out
