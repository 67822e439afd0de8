"""Multi-GPU scaling: candidate and env batches sharded over the ranks of
a torch.distributed process group.

Counterpart of humanoid_mujoco_tpu/parallel/mesh.py. The reference has
no distributed backend: its parallelism is a thread pool fanning <= 128
rollouts on one host (mjpc/threadpool.cc, sampling/planner.cc:342-380).
The JAX package makes the candidate batch a named mesh axis; here the
"mesh" is a process group, one rank a device (NCCL on cards, gloo on
the CPU), and the batch axis is split over the ranks: each rank rolls
out its shard in lockstep, and the winner is chosen from one all_gather
of the returns and of each rank's local best. The model is replicated
(it is tiny); data parallelism is this workload's only axis.

There is no global array: every rank holds the whole of what it must
agree on (the candidates, the parameters) and computes its shard of the
rest. So every rank draws the whole candidate set from the same
generator state, as the JAX plan draws its candidates whole before it
constrains their sharding, and keeps its slice.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..physics.model import Model, State
from ..planners.policy import SplinePolicy
from ..planners.sampling import (PlanInfo, SamplingConfig, candidate_returns,
                                 plan_nominal, sample_candidates)
from ..tasks.base import Task
from ..utils import tree_map


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group (None: the default group) and this rank's
    device."""

    group: Optional[object]
    device: torch.device

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    def shard(self, n: int) -> slice:
        """This rank's slice of a batch of n (n a multiple of the size)."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not divide over "
                             f"{self.size} ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's x, in rank order."""
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x.contiguous(), group=self.group)
        return torch.stack(out)


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of an initialized process group (`init_distributed`, or
    torch.distributed.init_process_group): on cuda, the card of this
    rank's local index (LOCAL_RANK, else the rank modulo the cards)."""
    from .. import resolve_device
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: call "
                           "parallel.distributed.init_distributed or "
                           "torch.distributed.init_process_group first")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank(group) % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
    return Mesh(group=group, device=dev)


def shard_batch(mesh: Mesh, tree):
    """This rank's shard of the leading (env or candidate) axis of every
    tensor leaf of `tree` (`utils.tree_map`)."""
    return tree_map(lambda x: x[mesh.shard(x.shape[0])], tree)


def sharded_sampling_plan(mesh: Mesh, m: Model, task: Task,
                          cfg: SamplingConfig, policy: SplinePolicy,
                          state: State,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None
                          ) -> Tuple[SplinePolicy, PlanInfo]:
    """Predictive-sampling iteration with the candidates sharded over the
    mesh's ranks.

    The math of planners.sampling.sampling_plan, with the same draws: the
    rank draws all nsample candidates (from `generator`, or `noise`), as
    every rank must from the same generator state, rolls out its
    nsample / size of them, and the winner comes from one all_gather of
    the returns and of each rank's local best (the argmin over the
    ranks' minima, then the rank's own: the lowest index on ties, as the
    unsharded argmin). Every rank returns the same policy and info,
    equal to the unsharded plan's bit for bit where the rollouts of a
    shard equal those of the whole batch."""
    nominal = plan_nominal(m, cfg, policy, state, "sharded_sampling_plan")
    cands = sample_candidates(m, cfg, nominal.values, generator, noise)
    local = cands[mesh.shard(cfg.nsample)]
    local_returns = candidate_returns(m, task, cfg, state, nominal.times,
                                      local)
    all_returns = mesh.all_gather(local_returns)            # (d, N/d)
    best_values = mesh.all_gather(local[torch.argmin(local_returns)])
    win_dev = torch.argmin(torch.amin(all_returns, dim=-1))
    returns = all_returns.reshape(-1)
    winner = torch.argmin(returns)
    info = PlanInfo(returns=returns, winner=winner,
                    best_return=returns[winner], nominal_return=returns[0],
                    improvement=returns[0] - returns[winner])
    return SplinePolicy(times=nominal.times,
                        values=best_values[win_dev]), info
