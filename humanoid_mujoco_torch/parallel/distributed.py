"""Multi-process initialization and the data-parallel PPO train step.

Counterpart of humanoid_mujoco_tpu/parallel/distributed.py. The
reference is single-host (SURVEY §2.4); multi-host scaling is this
framework's own: `init_distributed` brings up a torch.distributed
process group (NCCL on cards, gloo on the CPU), and
`dp_sharded_ppo_step` runs PPO's collect-and-update with the env batch
sharded over the ranks (pure data parallelism: the networks and the
optimizer are replicated).

The JAX step is one global computation, so its minibatches are
permutations of the GLOBAL batch; a per-rank PPO with averaged gradients
would permute each rank's shard instead and take another step. Here
every rank draws the whole batch's draws from the same generator state
(the env noise and each epoch's permutation, `rl/ppo.py`), collects its
env shard with its rows of them, and the ranks all_gather the rollout;
every rank then takes its part of every global minibatch, and the
gradients are summed with all_reduce. The step equals `ppo_train_step`
on the whole batch, up to the order of the sums.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils import tree_map
from .mesh import Mesh, make_mesh, shard_batch


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> Optional[Mesh]:
    """Bring up the default process group and return its Mesh; a no-op
    returning None without a coordinator. The arguments default to
    HMT_COORDINATOR (host:port of rank 0), HMT_NUM_PROCESSES and
    HMT_PROCESS_ID; under torchrun, where those are unset, its own
    rendezvous is used (`env://`: MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK). The backend is NCCL on cuda, gloo on the CPU. A group that is
    already up is taken as it is."""
    from .. import resolve_device
    dev = resolve_device(device)
    if dist.is_initialized():
        return make_mesh(dev)
    coordinator = coordinator or os.environ.get("HMT_COORDINATOR")
    if coordinator is not None:
        kw = dict(init_method=f"tcp://{coordinator}",
                  world_size=int(num_processes or os.environ.get(
                      "HMT_NUM_PROCESSES", "1")),
                  rank=int(os.environ.get("HMT_PROCESS_ID", "0")
                           if process_id is None else process_id))
    elif "MASTER_ADDR" in os.environ and "RANK" in os.environ:
        kw = dict(init_method="env://")
    else:
        return None   # single process
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)
    mesh = make_mesh(dev)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    return mesh


def shard_env_batch(mesh: Mesh, tree):
    """This rank's shard of every leaf's leading (env) axis."""
    return shard_batch(mesh, tree)


def gather_tensor(mesh: Mesh, x: torch.Tensor, dim: int = 0):
    """The ranks' x joined in rank order along the env axis `dim` (bool
    as uint8: not every backend gathers bool)."""
    y = mesh.all_gather(x.to(torch.uint8) if x.dtype == torch.bool else x)
    return torch.cat(tuple(y), dim=dim).to(x.dtype)


def gather_env_batch(mesh: Mesh, tree):
    """The inverse of `shard_env_batch`: every leaf's shards, gathered
    from the ranks and joined in rank order along the env axis."""
    return tree_map(lambda x: gather_tensor(mesh, x), tree)


def dp_sharded_ppo_step(mesh: Mesh, cfg, env_cfg, base_model, state,
                        draws=None):
    """PPO train step with the env batch sharded over the mesh's ranks.

    `state` is replicated except its env state and obs, which hold this
    rank's shard (`shard_env_batch`) of cfg.n_envs envs; its generator
    is in the same state on every rank. `draws` (the whole batch's
    `PPODraws`) replaces the draw from that generator. Updates `state`
    in place; returns (state, metrics), the metrics of the whole batch,
    equal on every rank."""
    from ..rl.ppo import draw_train_step, ppo_collect, ppo_update

    if draws is None:
        draws = draw_train_step(cfg, base_model, state)
    local = shard_batch(mesh, dataclasses.replace(draws, perm=()))
    local = dataclasses.replace(local, perm=draws.perm)
    es, obs, rollout = ppo_collect(cfg, env_cfg, base_model, state, local)
    # the whole batch's rollout: (T, B, ...) and the last values (B,)
    rollout = tuple(gather_tensor(mesh, x, 1) for x in rollout[:-1]) + (
        gather_tensor(mesh, rollout[-1]),)
    w, r = mesh.size, mesh.rank

    def part(idx):
        return torch.tensor_split(idx, w)[r]

    def reduce(x):
        dist.all_reduce(x, group=mesh.group)

    metrics = ppo_update(cfg, state, rollout, draws.perm, part=part,
                         reduce=reduce)
    state.env_state, state.obs = es, obs
    state.update_count += 1
    return state, metrics
