#!/usr/bin/env bash
# Multi-GPU launcher with auto-resume for the PyTorch port: the JAX
# package's tools/pod_run.sh with torchrun (the reference's SLURM script
# analog, slurm/script:1-37: long single-GPU jobs, auto-resubmit on
# preemption).
#
# One torchrun per host, one process per card. rl/train.py brings the
# process group up from torchrun's rendezvous
# (parallel/distributed.init_distributed) and runs PPO data-parallel:
# each rank steps its shard of the env batch, gradients are summed with
# all_reduce. Checkpoints are complete (parameters, optimizer, env batch,
# generator, curriculum; rank 0 writes them with the whole env batch),
# so a preempted run resumes exactly from the newest one: the loop below
# is the slurm `scontrol requeue` analog.
#
# Usage, on one host with N cards:
#   NPROC=N tools/pod_run_torch.sh runs/ppo_pod --envs 4096 [train args...]
# on every host of a multi-host job (host 0's address as the rendezvous):
#   NNODES=<hosts> NODE_RANK=<i> MASTER_ADDR=<host0> MASTER_PORT=29500 \
#       NPROC=<cards per host> tools/pod_run_torch.sh RUN_DIR [args...]
set -euo pipefail
cd "$(dirname "$0")/.."

RUN_DIR="${1:?usage: pod_run_torch.sh RUN_DIR [train args...]}"
shift || true
mkdir -p "$RUN_DIR"

while true; do
    CKPT=""
    # newest complete checkpoint, if any
    LATEST=$(ls -t "$RUN_DIR"/ckpt_*.pt 2>/dev/null | head -1 || true)
    [ -n "$LATEST" ] && CKPT="--ckpt $LATEST"
    echo "[pod_run_torch] starting (node=${NODE_RANK:-0}/${NNODES:-1}," \
         "procs=${NPROC:-1}) resume='${LATEST:-none}'"
    if torchrun --nnodes "${NNODES:-1}" --node-rank "${NODE_RANK:-0}" \
            --nproc-per-node "${NPROC:-1}" \
            --master-addr "${MASTER_ADDR:-127.0.0.1}" \
            --master-port "${MASTER_PORT:-29500}" \
            -m humanoid_mujoco_torch.rl.train --algo ppo \
            --out "$RUN_DIR" $CKPT "$@"; then
        echo "[pod_run_torch] training finished cleanly"
        break
    fi
    echo "[pod_run_torch] a worker exited nonzero: resubmitting in 10 s" \
         "(preemption or transient failure; slurm/script:28-37 analog)"
    sleep 10
done
