"""The multi-device dry run: one sharded plan and one data-parallel PPO
step over a process group, at tiny shapes.

Counterpart of `dryrun_multichip` in the JAX package's entry module
(__graft_entry__.py): there one process runs a jitted plan over an
n-device mesh; here `world_size` processes (one a card, or gloo on the
CPU) join a process group on localhost, and each runs a sharded
sampling plan of the cap humanoid (candidates on the rank axis, the
winner from all_gather) and a dp-sharded PPO step of the RL env, then
checks shapes and finiteness.

Run: python -m humanoid_mujoco_torch.parallel.dryrun [--world-size 4]
         [--device cpu]
"""

from __future__ import annotations

import argparse
import socket

import torch


def _rank(rank: int, world_size: int, init_method: str, device: str):
    import torch.distributed as dist

    from ..ops.spline import SplineOrder
    from ..physics import humanoid
    from ..physics.model import make_state
    from ..planners import SamplingConfig, init_policy
    from ..rl.env import EnvConfig, rl_humanoid_model
    from ..rl.ppo import PPOConfig, ppo_init
    from ..tasks import stand_task
    from .distributed import dp_sharded_ppo_step, shard_env_batch
    from .mesh import make_mesh, sharded_sampling_plan

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size)
    try:
        mesh = make_mesh(device)
        dev = mesh.device
        m = humanoid.build_humanoid(device=dev)
        cfg = SamplingConfig(nsample=2 * world_size, nknots=3, horizon=3,
                             order=SplineOrder.ZERO, solver_iters=2)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        pol, info = sharded_sampling_plan(
            mesh, m, stand_task(device=dev), cfg, init_policy(m, 3),
            make_state(m, qpos=humanoid.stand_qpos(m)), generator=gen)
        assert pol.values.shape == (cfg.nknots, m.nu), pol.values.shape
        assert info.returns.shape == (cfg.nsample,), info.returns.shape
        assert bool(torch.isfinite(info.returns).all()), info.returns

        base = rl_humanoid_model(device=dev)
        env_cfg = EnvConfig(standup=True)
        pcfg = PPOConfig(n_envs=2 * world_size, rollout_len=2,
                         n_minibatch=2, n_epochs=1, hidden=(32, 32))
        gen.manual_seed(1)
        st = ppo_init(pcfg, env_cfg, base, 0.1, gen)
        st.env_state = shard_env_batch(mesh, st.env_state)
        st.obs = shard_env_batch(mesh, st.obs)
        st, metrics = dp_sharded_ppo_step(mesh, pcfg, env_cfg, base, st)
        assert st.obs.shape[0] == pcfg.n_envs // world_size, st.obs.shape
        assert bool(torch.isfinite(metrics["loss"])), metrics
    finally:
        dist.destroy_process_group()


def dryrun_multichip(world_size: int, device=None) -> None:
    """Run the dry run in `world_size` spawned processes on `device`
    (cuda: one card a rank; cpu: gloo); raises if a rank fails."""
    import torch.multiprocessing as mp

    from .. import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < world_size:
        raise ValueError(f"{world_size} ranks need as many cards; this "
                         f"machine has {torch.cuda.device_count()}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(world_size, f"tcp://127.0.0.1:{port}",
                          dev.type), nprocs=world_size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world-size", type=int,
                    default=max(1, torch.cuda.device_count()))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dryrun_multichip(args.world_size, args.device)
    print("dryrun ok", flush=True)


if __name__ == "__main__":
    main()
