"""Where one step of a port rollout spends its time, on the GPU.

Runs a chip_smoke.py rollout for a few steps under torch.profiler and
prints, per step: the wall time (CUDA events), the device time and the
launches of every kernel name, the number of kernel launches, and the
device idle share (1 - device busy / wall), which is the launch and host
overhead of the eager loop. `--task` picks the rollout:

- "Humanoid Cap Stand" (default): `chip_smoke.headline`, the stand task
  under a zero-order spline (kernels B1 + B2);
- "Swimmer": `chip_smoke.swimmer_rollout`, Swimmer states under a linear
  spline of random controls (plain smooth stage + kernel B3).

    python tools/torch_profile.py [--task Swimmer] [--batch 1024] [--steps 20]

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--task", default="Humanoid Cap Stand",
                    choices=["Humanoid Cap Stand", "Swimmer"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import headline, swimmer_rollout
    from humanoid_mujoco_torch.tasks import task_model

    B, T = args.batch, args.steps
    m = task_model(args.task)
    if args.task == "Swimmer":
        rollout = swimmer_rollout(m, B, T)
    else:
        _, rollout = headline(m, B, T)

    def run():
        return rollout().total_return

    run()                                                # build + warm-up
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    run()
    b.record()
    torch.cuda.synchronize()
    wall_ms = a.elapsed_time(b) / T

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # device-side events only (kernels, copies, fills): the host-side op
    # that launched a kernel reports the same device time again
    rows = [(ev.key, ev.count, ev.self_device_time_total)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows) / 1e3 / T
    launches = sum(r[1] for r in rows) / T
    print(json.dumps({
        "task": args.task, "batch": B, "steps": T,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "kernel_launches_per_step": launches,
        "kernels": [{"name": k[:80], "launches_per_step": c / T,
                     "ms_per_step": us / 1e3 / T}
                    for k, c, us in rows]}, indent=1))
    if not rows:
        print("torch_profile: the profiler saw no device time")


if __name__ == "__main__":
    main()
