"""Kernel B1's time against the batch and the envs per block, on the GPU.

Launches the shipped kernel (csrc/smooth.cu) through its C entry, without
the wrapper's host work, on chip_smoke's stand states at B = 132 to 4096
with 8, 4, 2 and 1 envs (warps) per block, and prints the mean time per
launch over 50 launches (CUDA events, after 5 warm-up launches). Read
across a row it says what bounds the kernel: if B = 132 (17 blocks of 8
warps, or 132 blocks of one warp) takes as long as B = 1024 (8 warps on
each SM), the time is one warp's dependent chain, not the SM's issue
rate or the memory.

    python tools/smooth_scaling.py

Needs a CUDA device and nvcc; prints the card's name and power limit
first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    if not torch.cuda.is_available():
        sys.exit("smooth_scaling: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    import chip_smoke
    from humanoid_mujoco_torch import kernels
    from humanoid_mujoco_torch.physics import fused_smooth, humanoid
    m = humanoid.build_humanoid(device="cuda")
    fn = kernels.load("smooth").hm_smooth
    stream = torch.cuda.current_stream().cuda_stream
    d = fused_smooth.smooth_dims(m)
    for B in (132, 264, 528, 1024, 2048, 4096):
        qpos, qvel, ctrl = chip_smoke.states(m, B)
        ins, outs, meta, _ = fused_smooth._smooth_launch_args(
            m, qpos, qvel, ctrl, None)
        ptrs = [None if t is None or t.numel() == 0 else t.data_ptr()
                for t in ins + outs]
        for envs in (8, 4, 2, 1):
            smem = fused_smooth.smooth_smem_bytes(d, envs)

            def launch():
                if fn(*ptrs, meta.data_ptr(), B, envs, smem, stream):
                    raise RuntimeError("kernel B1 failed to launch")
            for _ in range(5):
                launch()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(50):
                launch()
            b.record()
            torch.cuda.synchronize()
            print(json.dumps({"batch": B, "envs_per_block": envs,
                              "blocks": -(-B // envs),
                              "ms": a.elapsed_time(b) / 50}), flush=True)


if __name__ == "__main__":
    main()
