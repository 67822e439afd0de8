"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py

It builds the two CUDA kernels of the humanoid step (csrc/smooth.cu and
csrc/solver.cu, with nvcc for sm_90a), holds each kernel and the whole
step against the plain PyTorch twins on the card, drives the port's main
path (the 1024 x 100 stand rollout and three 1024-sample predictive-
sampling plans through `rollout_spline` / `sampling_plan`), checks the
kernels' launch counters, and prints a `kernels` JSON line (time, launch
count, plain-twin time and roofline bound per kernel). The last line is
{"ok": true, "device": {...}}. Any failed check exits non-zero. Without
a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TOL = 5e-4            # kernel vs twin, max-abs error over max-abs value
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOP_S = 67e12    # H100 SXM fp32 peak outside the tensor cores
BENCH_BATCH, BENCH_HORIZON = 1024, 100
PLAN_SAMPLES, PLAN_HORIZON, PLAN_CALLS = 1024, 100, 3


def log(phase: str, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


class Timer:
    """Wall time of a region: CUDA events on the card, the host clock
    on the CPU (used only to rehearse this script)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def __call__(self, fn, reps: int):
        times = []
        for _ in range(reps):
            if self.cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                fn()
                times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))


def rel_err(ref: torch.Tensor, out: torch.Tensor, name: str = ""):
    """max |ref - out| / max |ref|; 1e9 `dist` sentinels compared by
    identity."""
    r = ref.detach().double().cpu().numpy()
    o = out.detach().double().cpu().numpy()
    assert r.shape == o.shape, (name, r.shape, o.shape)
    if name == "dist":
        sent = r > 1e8
        assert np.array_equal(sent, o > 1e8), "dist sentinels differ"
        r, o = r[~sent], o[~sent]
    if r.size == 0:
        return 0.0
    assert np.all(np.isfinite(o)), f"{name}: non-finite kernel output"
    return float(np.max(np.abs(r - o)) / (np.max(np.abs(r)) + 1e-9))


def states(m, B, seed=0):
    """Realistic stand states: stand_qpos + 0.03 N on the joints, qvel
    0.2 N, ctrl 0.3 N (numpy seed)."""
    from humanoid_mujoco_torch.physics import humanoid
    rng = np.random.default_rng(seed)
    qpos = np.tile(humanoid.stand_qpos(m).cpu().numpy(), (B, 1))
    qpos[:, 7:] += 0.03 * rng.standard_normal((B, 12))
    qvel = 0.2 * rng.standard_normal((B, m.nv))
    ctrl = 0.3 * rng.standard_normal((B, m.nu))
    return tuple(torch.tensor(x, dtype=m.dtype, device=m.device)
                 for x in (qpos, qvel, ctrl))


def smooth_cost(m, B, nlim, packs):
    """(bytes, flops) kernel B1 must move / do at batch B: each input
    read once (the shared parameter packs once), each output written
    once; flops counted from the kernel's loops over this structure."""
    s = m.struct
    K = m.ncon
    n_in = s.nq + s.nv + s.nu
    n_out = (s.nv * s.nv + s.nv + 6 * s.nv + 13 * K + 4 * nlim
             + 13 * s.nbody + 3 * len(s.site_names) + 6 + s.nu)
    chain = int(np.asarray(s.body_dof, dtype=np.int64).sum())
    flops = (s.nbody * (60 + 90 + 40 + 2 * 80 + 40)    # FK, inertia, RNEA
             + s.njnt * 60 + s.nv * (40 + 30)           # joints, cdof
             + s.nv * 40 + chain * 12                    # mass matrix
             + s.nsph * (5 * 16 + 40) + s.npair * 40     # collision
             + K * 30 + nlim * 25 + s.nu * 10)           # rows, actuators
    params = sum(p.numel() for p in packs)
    return 4 * (B * (n_in + n_out) + params), B * flops


def solve_trace(M, qf, qv, raw, dmask, lim_tab):
    """The twin's Newton solve on these inputs: (efc, x, f, trace), with
    trace each iteration's (r, J p), both (B, ne)."""
    from humanoid_mujoco_torch.ops import linalg
    from humanoid_mujoco_torch.physics.solver import (finish_efc,
                                                      newton_solve,
                                                      rows_from_raw)
    cdof, rel, nrm, dist, mu3, kc, bc, dc, lpos, kl, bl, dl = raw
    rows = rows_from_raw(cdof, dmask, rel, nrm, dist, mu3, kc, bc, dc,
                         lim_tab, lpos, kl, bl, dl)
    Mchol = linalg.chol_factor(M)
    efc = finish_efc(rows, qv, Mchol)
    trace = []
    x, f, _ = newton_solve(M, Mchol, qf, efc, trace=trace)
    return efc, x, f, trace


def solve_cost(m, B, dmask, lim_tab, f, trace):
    """(bytes, flops) kernel B2 must move / do on this run's data. Bytes:
    per-env inputs and outputs once each, the shared mask, damping and dt
    once. Flops (an FMA is two) of the algorithm, not of the kernel's
    loops: J built once; J x and J p at 12 flops per chain dof; M⁻¹ from
    the factor for diag(J M⁻¹ Jᵀ); the gradient and Hessian updates only
    for the slots and limit rows active in each iteration, and the
    16-point line search only for the edges that are active somewhere
    on its grid (r < 0 or r + 4 J p < 0), both read from the twin's
    iterations."""
    nv, K, nlim = m.nv, m.ncon, len(lim_tab)
    dmask = dmask.to(f.device)
    nz = (dmask != 0).sum(dim=1).double()             # (K,) chain dofs
    nzl = torch.tensor([float(sum(c != 0 for c in row)) for row in lim_tab],
                       dtype=torch.float64, device=f.device)
    chain = float(nz.sum())
    n_in = nv * nv + 8 * nv + 13 * K + 4 * nlim
    n_out = 3 * nv + K
    shared = K * nv + nv + 1
    setup = (nv ** 3 / 3 + 2 * nv * nv                # chol(M), a_smooth
             + 2 * nv ** 3 / 3                        # M⁻¹ from the factor
             + 30 * K + 42 * chain                    # frames, J, J qvel
             + float((12 * nz * nz + 22 * nz).sum())  # diag(J M⁻¹ Jᵀ)
             + 100 * K                                # D, aref per edge
             + float((2 * nzl * nzl + 2 * nzl + 10).sum()))
    per_it = (12 * chain + 30 * K + float((2 * nzl + 1).sum())  # J x - aref
              + 2 * nv * nv + nv                      # M (x - a_smooth)
              + nv ** 3 / 3 + 2 * nv * nv + nv        # chol(H), p
              + 12 * chain + 20 * K + float((2 * nzl).sum())    # J p
              + 2 * nv * nv + 6 * nv + 2 * 16)        # pMp, b0, dphi, x
    final = (12 * chain + 60 * K + float((2 * nzl + 3).sum())   # r, f
             + nv ** 3 / 3 + 2 * nv * nv + 3 * nv)    # Euler
    flops = B * (setup + len(trace) * per_it + final)
    for r, Jp in trace:
        act = (r[:, nlim:].reshape(B, 10, K) < 0).any(dim=1).double()
        flops += float((act * (36 * nz + 6 * nz * (nz + 1) + 50)).sum())
        flops += float(((r[:, :nlim] < 0).double()
                        * (2 * nzl + 2 * nzl * nzl)).sum())
        flops += float(((r < 0) | (r + 4.0 * Jp < 0)).sum()) * (1 + 16 * 5)
    loaded = (f[:, nlim:].reshape(B, 10, K).sum(dim=1) > 0).double()
    flops += float((loaded * (12 * nz + 15)).sum())   # Jᵀ f
    flops += float(((f[:, :nlim] > 0).double() * 2 * nzl).sum())
    return 4 * (B * (n_in + n_out) + shared), flops


def knife_edges(efc, x, nlim):
    """Envs with a limit row at its activation boundary at the solution
    (|r| within f32 rounding of 0), from the twin's internals."""
    r = (efc.J[:, :nlim] @ x[..., None])[..., 0] - efc.aref[:, :nlim]
    edge = r.abs() < 1e-6 * (1.0 + efc.aref[:, :nlim].abs())
    return int(edge.any(dim=1).sum())


def expect_error(exc, fn):
    """Fail unless fn() raises exc (a kernel wrapper refusing bad input)."""
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"expected {exc.__name__}")


def kernel_edges(m, device, B=300):
    """Both kernels at a batch that is not a multiple of the 128-thread
    block, B1 with per-body wrenches; on the card, the inputs the
    wrappers must refuse. Returns the max relative error per kernel."""
    from humanoid_mujoco_torch.physics import (fused_smooth, fused_solver,
                                               humanoid)
    from humanoid_mujoco_torch.physics.solver import (contact_dmask,
                                                      limit_rows_static)
    qpos, qvel, ctrl = states(m, B, seed=2)
    rng = np.random.default_rng(3)
    xfrc = torch.tensor(rng.standard_normal((B, m.struct.nbody, 6)),
                        dtype=m.dtype, device=m.device)
    ker = fused_smooth.smooth_raw(m, qpos, qvel, ctrl, xfrc)
    ref = fused_smooth.smooth_raw_reference(m, qpos, qvel, ctrl, xfrc)
    e1 = max(rel_err(r, o, n)
             for n, r, o in zip(fused_smooth.NAMES, ref, ker))
    lim_tab = limit_rows_static(m)
    args = (ref[0], ref[1], qvel, *ref[2:7], contact_dmask(m), *ref[7:14],
            m.dt * m.dof_damping, m.dt)
    e2 = max(rel_err(r, o) for r, o in zip(
        fused_solver.solve_step_raw_reference(*args, lim_tab=lim_tab),
        fused_solver.solve_step_raw(*args, lim_tab=lim_tab)))
    assert e1 <= TOL and e2 <= TOL, (e1, e2)
    if device != "cpu":
        expect_error(TypeError, lambda: fused_smooth.smooth_raw(
            m, qpos.double(), qvel.double(), ctrl.double()))
        expect_error(ValueError, lambda: fused_smooth.smooth_raw(
            m, qpos[:, :10], qvel, ctrl))
        big = humanoid.build_humanoid(device=device, hfield_shape=(64, 64))
        expect_error(NotImplementedError, lambda: fused_smooth.smooth_raw(
            big, qpos, qvel, ctrl))
        expect_error(TypeError, lambda: fused_solver.solve_step_raw(
            *[a.double() for a in args[:16]], *args[16:], lim_tab=lim_tab))
        expect_error(ValueError, lambda: fused_solver.solve_step_raw(
            *args[:3], args[3][:, :5], *args[4:], lim_tab=lim_tab))
    return {"batch": B, "smooth_xfrc_rel_err": e1, "solver_rel_err": e2}


def headline(m, B, horizon):
    """The bench.py workload: the stand task under a 3-knot zero-order
    spline policy from B perturbed stand states (numpy seed 1). Returns
    (task, rollout), rollout() running one `rollout_spline` of `horizon`
    steps."""
    from humanoid_mujoco_torch.ops.spline import SplineOrder
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.planners import init_policy
    from humanoid_mujoco_torch.rollout import rollout_spline
    from humanoid_mujoco_torch.tasks import stand_task

    task = stand_task(device=m.device)
    pol = init_policy(m, 3)
    rng = np.random.default_rng(1)
    qpos = humanoid.stand_qpos(m).expand(B, -1).clone()
    qpos[:, 7:] += torch.tensor(0.03 * rng.standard_normal((B, 12)),
                                dtype=m.dtype, device=m.device)
    s0 = make_state(m, qpos=qpos)
    values = pol.values.expand(B, -1, -1) + torch.tensor(
        0.02 * rng.standard_normal((B, 3, m.nu)), dtype=m.dtype,
        device=m.device)

    def rollout():
        return rollout_spline(m, task, s0, pol.times, values,
                              SplineOrder.ZERO, horizon)
    return task, rollout


def run(device="cuda", B=BENCH_BATCH, horizon=BENCH_HORIZON,
        nsample=PLAN_SAMPLES, plan_horizon=PLAN_HORIZON, gpu="cpu"):
    from humanoid_mujoco_torch.ops.spline import SplineOrder
    from humanoid_mujoco_torch.physics import (fused_smooth, fused_solver,
                                               humanoid)
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.solver import (contact_dmask,
                                                      limit_rows_static)
    from humanoid_mujoco_torch.physics.step import integrate_pos, step
    from humanoid_mujoco_torch.planners import (SamplingConfig,
                                                init_policy, sampling_plan)

    timer = Timer(device)
    m = humanoid.build_humanoid(device=device)
    qpos, qvel, ctrl = states(m, B)
    lim_tab = m.static("lim_tab", lambda: limit_rows_static(m))
    dmask = contact_dmask(m)
    h = m.dt
    hdamp = h * m.dof_damping

    # ---- 2. B1 kernel vs its twin ----
    ker = fused_smooth.smooth_raw(m, qpos, qvel, ctrl)
    ref = fused_smooth.smooth_raw_reference(m, qpos, qvel, ctrl)
    errs = {n: rel_err(r, o, n)
            for n, r, o in zip(fused_smooth.NAMES, ref, ker)}
    worst = max(errs, key=errs.get)
    log("smooth_vs_twin", batch=B, max_rel_err=errs[worst], worst=worst,
        tol=TOL, errs=errs)
    assert errs[worst] <= TOL, f"B1 {worst}: {errs[worst]:.3e} > {TOL}"

    # ---- 3. B2 kernel vs its twin, both fed the twin's B1 outputs ----
    (M, qfs, cdof, rel, nrm, dist, mu3, kc, bc, dc,
     lpos, kl, bl, dl) = ref[:14]
    solve_in = (M, qfs, qvel, cdof, rel, nrm, dist, mu3, dmask, kc, bc, dc,
                lpos, kl, bl, dl, hdamp, h)
    ker2 = fused_solver.solve_step_raw(*solve_in, lim_tab=lim_tab)
    ref2 = fused_solver.solve_step_raw_reference(*solve_in, lim_tab=lim_tab)
    names2 = ("qacc", "qvel_new", "fslot", "qfrc_constraint")
    errs2 = {n: rel_err(r, o, n) for n, r, o in zip(names2, ref2, ker2)}
    worst2 = max(errs2, key=errs2.get)
    efc, x_t, f_t, trace = solve_trace(
        M, qfs, qvel, (cdof, rel, nrm, dist, mu3, kc, bc, dc, lpos, kl, bl,
                       dl), dmask, lim_tab)
    knife = knife_edges(efc, x_t, len(lim_tab))
    log("solver_vs_twin", batch=B, max_rel_err=errs2[worst2], worst=worst2,
        tol=TOL, errs=errs2, knife_edge_states=knife)
    assert errs2[worst2] <= TOL, f"B2 {worst2}: {errs2[worst2]:.3e} > {TOL}"

    # ---- 4. whole step: kernels vs the twin composition ----
    s_k, info_k = step(m, make_state(m, qpos=qpos, qvel=qvel), ctrl)
    qacc_r, qv_r, cf_r, _ = ref2
    q_r = integrate_pos(m, qpos, qv_r, h)
    errs4 = {"qpos": rel_err(q_r, s_k.qpos), "qvel": rel_err(qv_r, s_k.qvel),
             "qacc": rel_err(qacc_r, info_k.qacc),
             "contact_force": rel_err(cf_r, info_k.contact_force)}
    worst4 = max(errs4, key=errs4.get)
    log("step_vs_twin", batch=B, max_rel_err=errs4[worst4], worst=worst4,
        tol=TOL, errs=errs4, diverged=int(info_k.diverged.sum()))
    assert errs4[worst4] <= TOL, f"step {worst4}: {errs4[worst4]:.3e}"
    assert not bool(info_k.diverged.any()), "step diverged"

    # ---- 4b. odd batch, wrenches, refused inputs ----
    log("kernel_edges", tol=TOL, **kernel_edges(m, device))

    # ---- 5. headline: the bench.py rollout (stand task, spline policy) ----
    task, rollout = headline(m, B, horizon)
    rollout()                                          # warm-up
    fused_smooth.LAUNCHES = fused_solver.LAUNCHES = 0
    res = rollout()
    if device != "cpu":
        torch.cuda.synchronize()
    launches = {"smooth": fused_smooth.LAUNCHES,
                "solver": fused_solver.LAUNCHES}
    fused_smooth.LAUNCHES = fused_solver.LAUNCHES = 0
    ms = timer(rollout, 3)
    timed = {"smooth": fused_smooth.LAUNCHES, "solver": fused_solver.LAUNCHES}
    returns = res.total_return
    log("rollout", gpu=gpu, batch=B, horizon=horizon, ms=ms,
        steps_per_s=B * horizon / (ms * 1e-3), launches=launches,
        mean_return=float(returns.mean()),
        diverged=int(res.diverged.sum()))
    if device != "cpu":
        assert launches == {"smooth": horizon, "solver": horizon}, launches
        assert timed == {"smooth": 3 * horizon, "solver": 3 * horizon}
    assert bool(torch.isfinite(returns).all()), "non-finite returns"
    assert not bool(res.diverged.any()), "rollout diverged"

    # ---- 6. predictive-sampling plans ----
    cfg = SamplingConfig(nsample=nsample, nknots=3, horizon=plan_horizon,
                         order=SplineOrder.ZERO)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    s0 = make_state(m, qpos=humanoid.stand_qpos(m))
    plan_pol = init_policy(m, 3)
    fused_smooth.LAUNCHES = fused_solver.LAUNCHES = 0
    for i in range(PLAN_CALLS):
        holder = {}

        def plan():
            holder["out"] = sampling_plan(m, task, cfg, plan_pol, s0,
                                          generator=gen)
        lat = timer(plan, 1)
        plan_pol, info = holder["out"]
        best, nominal = float(info.best_return), float(info.nominal_return)
        log("plan", gpu=gpu, call=i, nsample=nsample, horizon=plan_horizon,
            latency_ms=lat, best=best, nominal=nominal,
            winner=int(info.winner))
        assert best <= nominal, (best, nominal)
    plan_launches = {"smooth": fused_smooth.LAUNCHES,
                     "solver": fused_solver.LAUNCHES}
    log("plan_launches", **plan_launches)
    if device != "cpu":
        assert plan_launches == {"smooth": PLAN_CALLS * plan_horizon,
                                 "solver": PLAN_CALLS * plan_horizon}

    # ---- 7. kernel table ----
    n0, n1 = fused_smooth.LAUNCHES, fused_solver.LAUNCHES
    t_k1 = timer(lambda: fused_smooth.smooth_raw(m, qpos, qvel, ctrl), 20)
    t_r1 = timer(lambda: fused_smooth.smooth_raw_reference(
        m, qpos, qvel, ctrl), 5)
    t_k2 = timer(lambda: fused_solver.solve_step_raw(
        *solve_in, lim_tab=lim_tab), 20)
    t_r2 = timer(lambda: fused_solver.solve_step_raw_reference(
        *solve_in, lim_tab=lim_tab), 5)
    # timing launches are not main-path launches
    fused_smooth.LAUNCHES, fused_solver.LAUNCHES = n0, n1
    b1_bytes, b1_flops = smooth_cost(m, B, len(lim_tab),
                                     fused_smooth._pack_params(m))
    b2_bytes, b2_flops = solve_cost(m, B, dmask, lim_tab, f_t, trace)

    def row(name, src, replaces, n, err, t, tr, nbytes, flops):
        tb, tf = 1e3 * nbytes / HBM_BYTES_S, 1e3 * flops / FP32_FLOP_S
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": t, "plain_ms": tr, "bound_ms": max(tb, tf),
                "bound_by": "bytes" if tb >= tf else "operations",
                "library_ms": None, "bytes": nbytes, "flops": flops}

    max_abs1 = max(float((r - o).abs().max()) for n, r, o in
                   zip(fused_smooth.NAMES, ref, ker)
                   if r.numel() and n != "dist")
    max_abs2 = max(float((r - o).abs().max()) for r, o in zip(ref2, ker2))
    table = [
        row("smooth", "humanoid_mujoco_torch/csrc/smooth.cu",
            "humanoid_mujoco_tpu/physics/pallas_smooth.py:179",
            launches["smooth"], max_abs1, t_k1, t_r1, b1_bytes, b1_flops),
        row("solver", "humanoid_mujoco_torch/csrc/solver.cu",
            "humanoid_mujoco_tpu/physics/pallas_solver.py:629",
            launches["solver"], max_abs2, t_k2, t_r2, b2_bytes, b2_flops),
    ]
    return table


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from humanoid_mujoco_torch import kernels
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in kernels.BUILD_LOG.items()}
    log("environment", gpu=smi, torch=torch.__version__,
        cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    table = run("cuda", gpu=smi)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
