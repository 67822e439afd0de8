"""Kernel B2's bare time a launch on the task models' settled states.

For each model: chip_smoke's `settled_states` (B = 1024, seed 21, 50
steps under its controls), B2's inputs on the model's step route
(chip_smoke.route_solve_inputs: B1's twin outputs on "smooth", the
plain smooth stage and `collide` on "contact", the top-k selection and
its per-env mask where the step keeps it), then `chip_smoke.kernel_ms`
of B2's C entry (20 launches queued behind a spin) `--reps` times; it
prints one JSON line per model with the times and the card's name and
power limit.

    python tools/b2_times.py [--root DIR] [--reps 3] [--models A,B,...]

`--root` runs the checkout at DIR instead of this one (its package, its
chip_smoke.py and its kernels, built under DIR/build/kernels): to
compare two trees on one card, run parent, change, change, parent in
one call. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

DEFAULT = ("Walker", "Quadruped Flat", "Quadruped Hill", "Humanoid Stand",
           "OP3", "Panda", "Bimanual Handover", "Allegro", "Shadow",
           "Bimanual Insert", "Bimanual Reorient", "Humanoid Interact",
           "Rubik")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--models", default=",".join(DEFAULT))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as C
    from humanoid_mujoco_torch import kernels
    from humanoid_mujoco_torch.physics import fused_solver
    from humanoid_mujoco_torch.physics.solver import limit_rows_static
    from humanoid_mujoco_torch.tasks import task_model
    if not torch.cuda.is_available():
        sys.exit("b2_times: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels.build(["solver"])
    for name in args.models.split(","):
        if name not in C.TASK_ROUTES:
            print(json.dumps({"root": root, "model": name,
                              "skipped": "not in this tree's tasks"}))
            continue
        m = task_model(name, device="cuda")
        main_states = C.settled_states(name, m, C.BENCH_BATCH, seed=21)
        solve_in = C.route_solve_inputs(C.TASK_ROUTES[name], m,
                                        *main_states)
        lim_tab = limit_rows_static(m)
        extra = ()
        if solve_in[8].ndim == 3:
            extra = (C.b2_kw(m, solve_in[8], lim_tab)["chain_max"],)
        launch = fused_solver._solver_launch_args(*solve_in, lim_tab, 8, 16,
                                                  *extra)
        ms = [C.bare_kernel_ms("solver", launch, "cuda")
              for _ in range(args.reps)]
        print(json.dumps({"root": root, "model": name, "gpu": smi,
                          "per_env_mask": solve_in[8].ndim == 3,
                          "nv": m.nv, "slots": solve_in[8].shape[-2],
                          "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
