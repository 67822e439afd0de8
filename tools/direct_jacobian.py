"""Two ways to take the direct optimizer's residual Jacobian, timed.

`direct_optimize` needs J, the Jacobian of the window's stacked residual
in the tangent of its T configurations and its parameters. Two ways to
take it by forward mode through the plain `forward(ift=True)` path:

- "dense" (`direct.optimizer.residual_jacobian`, the package's): one
  dual pass over (T - 2)·(T·nv + npar) rows, every knot under every unit
  tangent of the window and the parameters, as the JAX package's single
  `jacfwd`; a parameter's tangent rides in a per-row model leaf;
- "bands" (`band_jacobian` here, the alternative the dense pass is
  measured against): each interior knot's residuals depend on
  q_{t-1}, q_t, q_{t+1} and the parameters only, so one dual pass over
  (T - 2)·3·nv rows gives every configuration column (scattered into
  the window's columns), and one pass over T - 2 rows per parameter its
  column.

For the window lengths given (the chip_smoke cell's T 10 and
DirectService's default 16), in float64 on a stand window of the
port's float32 step with the joints perturbed, the denoise settings (no
parameter) and the mass fit's (mass_scale, force weight 1e-2): both Js
against each other, and the median ms of each over `--reps` rounds that
alternate the two (bands, dense, then dense, bands; CUDA events on the
card).

    python tools/direct_jacobian.py [--T 10 16] [--reps 4] [--device cpu]

Prints the card's name and power limit first (on the card), then one
JSON line per (T, case).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from humanoid_mujoco_torch.direct import optimizer as od  # noqa: E402
from humanoid_mujoco_torch.physics.tangent import state_add  # noqa: E402
from humanoid_mujoco_torch.planners.derivatives import _jacfwd  # noqa: E402


def band_jacobian(m, cfg, sensor, qpos_seq, y_seq, ctrl_seq, dt, theta):
    """(r, J) as `residual_jacobian` returns them, by knot bands."""
    T, nv = qpos_seq.shape[0], m.nv
    K, nloc = T - 2, 3 * nv
    npar = len(od._param_names(cfg))
    dtype, dev = qpos_seq.dtype, qpos_seq.device
    mm = od._apply_params(m, cfg, theta)
    args = od._window(qpos_seq, y_seq, ctrl_seq)

    def band(z):
        q = [state_add(mm, x.repeat_interleave(nloc, dim=0),
                       z[:, j * nv:(j + 1) * nv])
             for j, x in enumerate(args[:3])]
        return od._knot_residuals(mm, cfg, sensor, *q,
                                  *(x.repeat_interleave(nloc, dim=0)
                                    for x in args[3:]), dt)

    (r_y, Jy), (r_f, Jf) = _jacfwd(band, K, nloc, dtype, dev)
    # scatter each knot's band (K, nres, 3 nv) into the window's columns
    blocks = []
    idx = torch.arange(K, device=dev)
    for Jb in (Jy, Jf):
        full = Jb.new_zeros((K, Jb.shape[1], T, nv))
        for j in range(3):
            full[idx, :, idx + j] = Jb[..., j * nv:(j + 1) * nv]
        blocks.append(full.reshape(K * Jb.shape[1], T * nv))
    J = torch.cat(blocks)
    if npar:
        cols = []
        for p in range(npar):
            with fwAD.dual_level():
                th = fwAD.make_dual(theta, torch.eye(
                    npar, dtype=dtype, device=dev)[p])
                outs = od._knot_residuals(od._apply_params(m, cfg, th), cfg,
                                          sensor, *args, dt)
                col = []
                for o in outs:
                    primal, tangent = fwAD.unpack_dual(o)
                    col.append(torch.zeros_like(primal).reshape(-1)
                               if tangent is None else
                               tangent.reshape(-1).clone())
            cols.append(torch.cat(col))
        J = torch.cat([J, torch.stack(cols, dim=1)], dim=1)
    return torch.cat([r_y.reshape(-1), r_f.reshape(-1)]), J


def window(m, T, seed=0):
    """A T-knot stand window in m's dtype, from the port's float32 step on
    m's device (the kernels run float32 only), its joints moved by 0.03
    normals, its noise-free measurements and zero controls."""
    from humanoid_mujoco_torch.estimators.sensors import measure
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import step
    m32 = humanoid.build_humanoid(device=m.device)
    s = make_state(m32, qpos=humanoid.stand_qpos(m32))
    u = torch.zeros((1, m.nu), device=m.device)
    qs, vs = [s.qpos], [s.qvel]
    for _ in range(T - 1):
        s, _ = step(m32, s, u)
        qs.append(s.qpos)
        vs.append(s.qvel)
    qs, vs = torch.cat(qs).to(m.dtype), torch.cat(vs).to(m.dtype)
    ys = measure(m, qs, vs)
    noise = np.random.default_rng(seed).standard_normal((T, m.nu))
    qs[:, 7:] += 0.03 * torch.tensor(noise, dtype=m.dtype, device=m.device)
    return qs, ys, torch.zeros((T, m.nu), dtype=m.dtype, device=m.device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, nargs="+", default=[10, 16])
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from chip_smoke import Timer
    from humanoid_mujoco_torch import estimators as est
    from humanoid_mujoco_torch.physics import humanoid
    if args.device != "cpu":
        if not torch.cuda.is_available():
            sys.exit("direct_jacobian: needs a CUDA device (or --device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    m = humanoid.build_humanoid(dtype=torch.float64, device=args.device)
    sensor = est.default_sensor_model(m, dtype=torch.float64)
    timer = Timer(args.device)
    dt = float(m.dt)
    for T in args.T:
        qs, ys, us = window(m, T)
        for case, cfg in (("denoise", od.DirectConfig()),
                          ("mass_fit", od.DirectConfig(
                              estimate_params=("mass_scale", ),
                              force_weight=1e-2))):
            npar = len(od._param_names(cfg))
            theta = torch.full((npar, ), 0.05, dtype=m.dtype,
                               device=m.device)
            out = {"T": T, "case": case, "npar": npar,
                   "rows_bands": (T - 2) * 3 * m.nv,
                   "rows_dense": (T - 2) * (T * m.nv + npar)}
            fns = {"bands": band_jacobian, "dense": od.residual_jacobian}
            res, times = {}, {"bands": [], "dense": []}
            for name, fn in fns.items():
                res[name] = fn(m, cfg, sensor, qs, ys, us, dt, theta)
            for rep in range(args.reps):
                for name in (("bands", "dense") if rep % 2 == 0 else
                             ("dense", "bands")):
                    times[name].append(timer.once(
                        lambda fn=fns[name]: fn(m, cfg, sensor, qs, ys, us,
                                                dt, theta))[1])
            for name, ts in times.items():
                out[f"{name}_ms"] = float(np.median(ts))
                out[f"{name}_ms_all"] = ts
            (r_b, J_b), (r_d, J_d) = res["bands"], res["dense"]
            out["r_max_abs_diff"] = float((r_b - r_d).abs().max())
            out["J_max_rel_err"] = float((J_b - J_d).abs().max()
                                         / J_b.abs().max())
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
