"""Where kernels B1, B2 and B3 spend their time, phase by phase, on the GPU.

Builds an instrumented copy of humanoid_mujoco_torch/csrc/smooth.cu (B1),
csrc/solver.cu (B2) and csrc/euler.cu (B3) into build/solver_phases/
(the shipped kernels are not touched): before each phase marker below,
the warp reads clock64() and adds the cycles since the previous marker
to that phase's counter in registers; after the last marker lane 0
writes the counters to a per-env slot in global memory. It runs B1 on
chip_smoke's random stand states (chip_smoke.states), B2 once on the
stand rollout's states (chip_smoke.headline, 50 steps in) and once on
chip_smoke's stand states, and B3 on the Swimmer's rows
(chip_smoke.swimmer_states) and on the humanoid's 694 selection-free
rows (rows_from_raw of chip_smoke's stand states), at B = 1024, and
prints per phase the mean cycles per env and its share. B1's phases are
the stages of its program: staging, limit rows and actuators, the
kinematics, cdof and inertias, composite inertias and M, the velocity
and acceleration passes, the forces up the tree and qfrc_smooth,
collision, observables, and the block's barrier and output write. B2's
and B3's Newton phases are summed over the iterations; the residual pass
also carries the previous iteration's step update. The markers add a
__syncwarp, a clock read and an add each, so an instrumented kernel runs
a little slower than the shipped one (its time is printed beside).

    python tools/solver_phases.py [--batch 1024]

Needs a CUDA device and nvcc; prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# per kernel, (text in its source that starts a phase, name of the phase
# it ends)
B2_MARKS = (
    ("  // ---- lanes over slots: tangent frame", "load inputs"),
    ("  // ---- Cholesky of M (in H)", "frames and base rows"),
    ("  // ---- lanes over slots: Gram terms", "chol(M), a_smooth, L^-1"),
    ("  // line-search lanes:", "Gram terms, D, aref"),
    ("    // lanes over dofs: M (x - a_smooth)", "residuals, active set"),
    ("    // H = M + J", "gradient"),
    ("    __syncwarp();\n    chol<R>(H, nv, ld, INV);\n    float pu[R];",
     "Hessian"),
    ("    // ---- line search on the fixed grid ----", "chol(H), solve"),
    ("    // lanes over (edge, grid point)", "line search: J p"),
    ("    // piecewise-linear monotone dphi", "line search: grid"),
    ("  // ---- final forces", "line search: step (last)"),
    ("  // ---- implicit-damping Euler", "final forces"),
    ("  const float h = __ldg(a.dt);", "Euler"),
)
B3_MARKS = (
    ("  // ---- Cholesky of M (in H)", "load inputs"),
    ("  // ---- lanes over rows: diag(J", "chol(M), a_smooth, L^-1"),
    ("  // H's lower-triangle entries", "Gram: diag(J M^-1 J^T), D, aref"),
    ("    // lanes over dofs: M (x - a_smooth)", "residuals, active set"),
    ("    // H = M + J", "gradient"),
    ("    __syncwarp();\n    chol<R>(H, nv, ld, INV);\n    float pu[R];",
     "Hessian"),
    ("    // ---- line search on the fixed grid ----", "chol(H), solve"),
    ("    // lanes over (row, grid point)", "line search: J p"),
    ("    // piecewise-linear monotone dphi", "line search: grid"),
    ("  // ---- final forces", "line search: step (last)"),
    ("  // ---- implicit-damping Euler", "final forces"),
    ("  const float h = __ldg(a.dt);", "Euler"),
)
B1_MARKS = (
    ("    // ---- limit rows and actuator forces",
     "stage table, packs, inputs"),
    ("    // ---- forward kinematics and COMs", "limit rows, actuators"),
    ("    // ---- cdof, spatial inertias", "kinematics, COMs, anchor"),
    ("    // ---- composite inertias up the tree", "cdof, inertias"),
    ("    // ---- body velocities, cdof_dot", "composite inertias, M"),
    ("    // ---- body forces less the wrenches", "velocities, accelerations"),
    ("    // ---- collision: sphere centres", "forces up the tree, qfrc"),
    ("    // ---- observables:", "collision"),
    ("  }\n  __syncthreads();\n\n  // ---- the staged outputs", "observables"),
    ("}\n\n// ---- host side", "block barrier, output write"),
)
MARKS = {"smooth": B1_MARKS, "solver": B2_MARKS, "euler": B3_MARKS}
# where the clock starts: after the line that names the warp's env
START = {"smooth": "  const int e = e0 + wid;",
         "solver": "  if (e >= B) return;", "euler": "  if (e >= B) return;"}
PROBE = r'''
__device__ unsigned long long g_phase[4096 * 16];
#define PHASE(k) do { __syncwarp(); const long long t_ = clock64(); \
  ph_[k] += (unsigned)(t_ - t_last); t_last = t_; } while (0)
#define PHASE_FLUSH() do { if (lane == 0 && e < 4096) \
  for (int k_ = 0; k_ < 16; ++k_) g_phase[e * 16 + k_] += ph_[k_]; \
  } while (0)
'''
READ = r'''
extern "C" int hm_phase_read(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, 8 * 16 * (size_t)n);
}
extern "C" int hm_phase_zero() {
  static unsigned long long zero[4096 * 16];
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
'''


def instrumented_source(name: str) -> str:
    src = open(os.path.join(ROOT, "humanoid_mujoco_torch", "csrc",
                            f"{name}.cu")).read()
    marks = MARKS[name]
    for k, (mark, _) in enumerate(marks):
        if src.count(mark) != 1:
            raise RuntimeError(f"phase marker not found once: {mark!r}")
        flush = "  PHASE_FLUSH();\n" if k == len(marks) - 1 else ""
        src = src.replace(mark, f"  PHASE({k});\n" + flush + mark)
    start = START[name]
    if src.count(start) != 1:
        raise RuntimeError("kernel entry marker not found")
    src = src.replace(start, start + "\n  long long t_last = clock64();\n"
                      "  unsigned ph_[16] = {0};")
    src = src.replace('#include "common.cuh"', '#include "common.cuh"\n'
                      + PROBE)
    return src + READ


def build(name: str):
    from humanoid_mujoco_torch import kernels
    out = os.path.join(ROOT, "build", "solver_phases")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, f"{name}_phases.cu")
    with open(src, "w") as f:
        f.write(instrumented_source(name))
    lib = os.path.join(out, f"lib{name}_phases.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                    "-I", os.path.join(ROOT, "humanoid_mujoco_torch", "csrc"),
                    "-o", lib, src], check=True, capture_output=True)
    so = ctypes.CDLL(lib)
    fn_name, argtypes = kernels.SIGNATURES[name]
    fn = getattr(so, fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return so, fn


def solve_inputs(m, qpos, qvel, ctrl):
    from humanoid_mujoco_torch.physics import fused_smooth
    from humanoid_mujoco_torch.physics.solver import contact_dmask
    raw = fused_smooth.smooth_raw(m, qpos, qvel, ctrl)
    return (raw[0], raw[1], qvel, *raw[2:7], contact_dmask(m), *raw[7:14],
            m.dt * m.dof_damping, m.dt)


def b1_cases(B):
    """B1's C arguments on the smoke's stand states."""
    import chip_smoke
    from humanoid_mujoco_torch.physics import fused_smooth, humanoid
    m = humanoid.build_humanoid(device="cuda")
    qpos, qvel, ctrl = chip_smoke.states(m, B)
    ins, outs, meta, ints = fused_smooth._smooth_launch_args(
        m, qpos, qvel, ctrl, None)
    return {"smoke": (list(ins + outs) + [meta], list(ints))}


def b2_cases(B):
    """B2's C arguments on the rollout's and the smoke's states."""
    import chip_smoke
    from humanoid_mujoco_torch.physics import fused_solver, humanoid
    from humanoid_mujoco_torch.physics.solver import limit_rows_static
    m = humanoid.build_humanoid(device="cuda")
    lim_tab = limit_rows_static(m)
    _, rollout = chip_smoke.headline(m, B, 50)
    end = rollout().final_state
    cases = {"rollout": solve_inputs(m, end.qpos, end.qvel,
                                     torch.zeros(B, m.nu, device="cuda")),
             "smoke": solve_inputs(m, *chip_smoke.states(m, B))}
    out = {}
    for label, args in cases.items():
        ins, ints, outs = fused_solver._solver_launch_args(*args, lim_tab, 8,
                                                           16)
        out[label] = (list(ins + outs), list(ints))
    return out


def b3_cases(B):
    """B3's C arguments on the Swimmer's rows and on the humanoid's
    selection-free rows (its strides, a host int32 tensor, are the
    pointer after the outputs)."""
    import chip_smoke
    from humanoid_mujoco_torch.physics import fused_solver, humanoid
    from humanoid_mujoco_torch.physics.solver import (limit_rows_static,
                                                      rows_from_raw)
    from humanoid_mujoco_torch.tasks import task_model
    sw = task_model("Swimmer", device="cuda")
    swim = chip_smoke.swimmer_solve_inputs(sw, *chip_smoke.swimmer_states(
        sw, B))
    m = humanoid.build_humanoid(device="cuda")
    (M, qf, qv, cdof, rel, nrm, dist, mu3, dmask, kc, bc, dc, lpos, kl, bl,
     dl, hdamp, h) = solve_inputs(m, *chip_smoke.states(m, B))
    rows = rows_from_raw(cdof, dmask, rel, nrm, dist, mu3, kc, bc, dc,
                         limit_rows_static(m), lpos, kl, bl, dl)
    hum = (M, qf, qv, rows.J.contiguous(), rows.pos, rows.k, rows.b,
           rows.d, hdamp, h)
    out = {}
    for label, args in (("swimmer_rows", swim), ("humanoid_rows", hum)):
        ins, (strides, *ints), outs = fused_solver._euler_launch_args(
            *args, 8, 16)
        out[label] = (list(ins + outs) + [strides], ints)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    B = ap.parse_args().batch
    if not torch.cuda.is_available():
        sys.exit("solver_phases: needs a CUDA device")
    if B > 4096:
        sys.exit("solver_phases: at most 4096 envs")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    stream = torch.cuda.current_stream().cuda_stream
    for name, cases in (("smooth", b1_cases), ("solver", b2_cases),
                        ("euler", b3_cases)):
        so, fn = build(name)
        for label, (tensors, ints) in cases(B).items():
            ptrs = [None if t is None or t.numel() == 0 else t.data_ptr()
                    for t in tensors]
            if fn(*ptrs, *ints, stream) or so.hm_phase_zero():  # warm-up
                raise RuntimeError("instrumented launch failed")
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            if fn(*ptrs, *ints, stream):
                raise RuntimeError("instrumented launch failed")
            b.record()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (16 * B))()
            if so.hm_phase_read(buf, B):
                raise RuntimeError("reading the phase counters failed")
            cyc = np.frombuffer(buf, dtype=np.uint64).reshape(B, 16)
            marks = MARKS[name]
            mean = cyc[:, :len(marks)].astype(np.float64).mean(axis=0)
            total = float(mean.sum())
            print(json.dumps({
                "kernel": name, "states": label, "batch": B,
                "instrumented_ms": a.elapsed_time(b),
                "cycles_per_env": total,
                "phases": [{"phase": phase, "cycles": float(c),
                            "share": float(c) / total}
                           for (_, phase), c in zip(marks, mean)]},
                indent=1))


if __name__ == "__main__":
    main()
