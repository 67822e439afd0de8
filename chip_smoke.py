"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py

It builds the three CUDA kernels (csrc/smooth.cu, csrc/solver.cu and
csrc/euler.cu, one nvcc each for sm_90a, started together) and drives
the port's three paths:

- the humanoid (kernels B1 + B2): each kernel and the whole step against
  the plain PyTorch twins on the card (B = 1024, an odd B = 300, B1 there
  with per-body wrenches, and B = 1); each kernel's bitwise repeat, the
  isolation of a NaN env (only its outputs turn non-finite, only it
  diverges, the others keep their bits) and its refusal of a model too
  large for a block's shared memory; the 1024 x 100 stand rollout and
  three 1024-sample predictive-sampling plans;
- the Swimmer (plain smooth stage + kernel B3): B3 against its twin on
  Swimmer states (B = 1024, an odd B = 300 and B = 1) and on a
  Rubik-sized synthetic solve (nv 36, 360 rows, B = 300), and against B2
  on the humanoid's 694 explicit rows; B3's bitwise repeat, the
  isolation of a NaN env and its refusal of nv > 64 and of a model too
  large for a block's shared memory; the whole step against the twin
  composition, three 1024-sample x 60-step plans and a 10 x 10 MPC loop
  toward a target with the task's transition on;
- the golden MuJoCo replay (after the Swimmer): both sequences of
  tests/fixtures/golden_mujoco.npz (250 steps each, recorded from real
  MuJoCo) through the humanoid's step at batch 1 in float32 against
  tests/test_parity.py's bounds, beside the CPU twin's replay; every
  step's B1 and B2 against the float64 twins on the same input state,
  exactly 500 launches of each; inverse_dynamics and point_jacobian on
  the replay's states against their float64 twins (`golden`);
- the RL slice (B1 with per-env parameter packs + B2): B1 on 4096 envs
  reset at randomization factor 1 against its twin on the same patched
  model, its bitwise repeat, a launch whose per-env leaves all equal the
  base model's against the shared-pack launch (bit for bit), a NaN env
  kept to itself, and B2 on those outputs against its twin
  (`rl_smooth_per_env`); 4096 envs stepped 10 times at randomization
  factor 0.5 (`rl_env`: env steps/s, B1 and B2 launches per env step,
  all kernel launches and the idle share from torch.profiler, one env
  step against the same step with the twins); `sac_train_step` at
  SACConfig() (2 calls), `ppo_train_step` at PPOConfig() (1 call), and
  rl.train's main for 2 iterations, resumed to 3 from its checkpoint,
  against an uninterrupted 3-iteration run, to the bit (`rl_train`);
- the serving slice (B1 + B2 under the Agent): for each of the sampling,
  MPPI, CEM and iLQG planners, an Agent at its defaults (64 samples,
  horizon 17, plan dt 0.02; iLQG's 8 line-search alphas) behind
  MPCServer (2 planner iterations) on 127.0.0.1, a client thread's 20
  JSON requests (4 for iLQG, cut for time; noisy
  stand-pose observations) and a malformed one:
  every reply 12 finite floats, the malformed one an error, position
  mode joint_pos + 0.3 torque; median and p90 latency, control rate, B1
  and B2 launches per request, device busy and idle share of one request
  (torch.profiler); one plan's 64 candidates through the kernels against
  the float64 twins, every (candidate, step) pair in lockstep and the
  returns of the well-conditioned ones (`serving_candidates`); the
  root-height search's time and its float32 pick against the float64
  twin's on every observation (`serving`); one iLQG iteration's rollout
  steps (batch 4 and 8) against the float64 twins, the card's float32
  linearization along its nominal against the float64 twin on the CPU,
  B1 and B2 on its own inputs at batch 4 and 8 against their twins,
  timed (`serving_ilqg`); 0.03 s of MPC in the randomized env with the
  default planner, iLQG (cut from 0.05 s for time; `mpc_in_env_ilqg`), and
  0.2 s with sampling
  (`mpc_in_env`); the deterministic policy of rl_train's checkpoint on
  16 episodes x 100 steps at randomization factors 0 and 1 (`evaluate`);
  the env steps of these MPC and evaluate runs (B1 with per-env packs
  and B2, at batch 1 and 16) recorded as they ran and held against the
  same steps through the float64 twins; an Agent on the Swimmer by
  registry id, one plan and one step through B3, each of its B3 launches
  (batch 64 and 1) held against B3's twin on the same inputs
  (`swimmer_agent`); the host wall time of each serving phase
  (`serving_walls`);
- the task slice (the task library's sphere-and-joint tier, each at its
  model's published size): B1 and B2 on Walker and Quadruped Flat
  states settled 50 steps, B2 behind the plain smooth stage on
  Quadruped Hill and B3 on Cartpole's rows, each against its twins at
  B = 1024, 300 and 1 (B2 and B3 against the float64 twins on all but
  0.5% of the envs), with its bitwise repeat and a NaN env kept to
  itself (`task_kernels`); the kernels one step of each task's model
  launches, none on Acrobot and Particle, whose float32 step is held to
  the CPU's float64 step (`task_routing`); a 1024 x 100 rollout of each
  model under its task, with launches and idle share from
  torch.profiler (`task_rollouts`); the JAX package's task tests'
  closed loops: the walker holding its height under sampling MPC, the
  A1 standing on the flat floor and on the hill, iLQG swinging the
  cartpole up, sampling MPC pumping the acrobot (`task_loops`); and an
  Agent of each task by name at its default planner, iLQG, one
  planner_step and one get_action (`task_agents`);
- the estimation slice (after the task slice, before serving): one
  update of the EKF, UKF and batch estimator on the humanoid and of the
  EKF and UKF on Cartpole, every `step` they take recorded (B1 + B2 at
  batch 1, 73 and 7; B3 at 1 and 9) and held against the float64 twins,
  their kernels against their twins on those inputs, B1's and B2's time
  at the UKF's batch of 73, the launches an update by the counters and
  the host syncs of an EKF update (`estimation_kernels`); the JAX
  estimator and direct tests' scenarios in float32 (the direct ones
  also in float64, which the kernel-free direct path takes), each with
  its threshold, ms a call, launches and idle share
  (`estimation_loops`); the JAX serving test's shoved robot through a
  ServingFilter, then 20 TCP requests to `MPCServer(filter="ekf")`
  with the sampling planner, 35 B1 + 35 B2 launches each
  (`serving_filter`);
- the planner slice (after the task slice, before estimation): robust,
  sample-gradient, gradient and iLQS at their defaults on the humanoid
  stand (plan model, float32), 2 plan calls each (median ms by CUDA
  events, B1, B2 and B3 launches a call by the counters, busy time and
  idle share of one call by torch.profiler) and a 10-tick closed loop
  beside the zero-control loop's stand cost; B1 and B2 on the robust
  plan's 17 batch-20 steps, each env with its own wrench slice read at
  its strides, against their twins, B1 also on a contiguous copy and at
  a batch stride of 0, equal to the bit, each timed by `kernel_ms`
  (`planners`); the JAX planner tests' scenarios and bounds, the
  pendulum's in float64 (`planner_scenarios`); the parallel Riccati pass
  against the sequential one in float64 on the humanoid's linearization
  at T = 17, 128 and 512 (`riccati`); rl/tune's study, 3 trials of 2 PPO
  iterations at 32 envs (`tune`); rl/videos' `record_episode` for 0.2 s
  and the viewer's scene and page from it (`videos`);
- the contact-rich family (the upstream humanoid as Humanoid Stand's
  and Track's models, OP3, Panda, PickAndPlace, FreeFingers, the
  Quadrotor and the Bimanual Handover, each on the step's "contact"
  route: the plain smooth stage, the capsule and box narrowphase,
  fixed-tendon limit rows, gravcomp and site actuators, then B2) runs
  inside the task slice's phases: B2 against its twins on settled
  states at B = 1024, 300 and 1 with its bitwise repeat, NaN env, bare
  time and bound, and one `step_rk4` against the CPU's float64
  step_rk4 (`task_kernels`); its launches a step (`task_routing`); a
  1024 x 100 rollout under its task, timed once (`task_rollouts`); the
  Quadrotor's hover, OP3 settling from its keyframe, Panda holding its
  pose under gravcomp and an iLQG Agent on Humanoid Stand
  (`task_loops`);
- the top-k tier (Allegro, Shadow, Bimanual Insert and Reorient,
  Humanoid Interact, Rubik: models whose step keeps its top-k contact
  selection, so that B2 takes the selected slots' per-env chain mask;
  Rubik at nv 36, B2's two matrix rows a lane) inside the task slice's
  phases: B2 with the per-env mask against its twins on settled states
  at B = 1024, 300 and 1, its bitwise repeat, NaN env, bare time and
  bound (`task_kernels`); one B2 a step (`task_routing`); a 1024 x 100
  rollout under each task (`task_rollouts`); the JAX tests' Allegro and
  Shadow keyframe grasps held 300 steps and Reorient's cross settling
  200 (`task_loops`); an iLQG Agent a task (`task_agents`); and, on the
  Handover's and the cap humanoid's settled states, B2 launched with the
  static mask broadcast per env equal to the static launch bit for bit,
  and its refusal of nv 70 and of a per-env chain area over a block
  (`b2_per_env_equals_static`);
- bench.py's handover8191x128 cell (after the planner slice, before
  estimation): the Handover's predictive-sampling plan at 8191 x 128 x
  4 linear knots with 1 solver iteration (2 timed plans: latency,
  rollout steps/s, launches, idle share); one more plan's candidates
  and tests/test_torch_contact.py's witness candidates rolled until all
  diverge, each one's divergence step; B2 at that one iteration on the
  first-step states of all 8191 candidates against its twins, with its
  bare time and bound; and a 1024-sample plan at 8 iterations whose
  candidates must all stay finite (`handover`);
- the host surface and multi-GPU (after serving): the AsyncAgent's plan
  thread under realtime_eval's 100 Hz control loop for 3 s with the
  sampling planner (128 candidates) and with iLQG, the robot proxy in a
  process of its own (control Hz, plans/s, get_action's p50 and p99;
  B1 and B2 launches exactly 17, or 34, a plan and every one from the
  plan thread, on its current stream), three (two) hand-driven plans
  whose published policy equals a synchronous Agent's to the bit, and
  an injected plan-thread failure re-raised by get_action and stop()
  (`async_agent`); 20 requests at 100 Hz to MPCServer(async_mode=True)
  (`server_async`); measure_async_rates (`realtime_eval`); a LiveSession
  served on 127.0.0.1 (page, snapshot, a weight slider reaching the plan
  thread, a push moving the root; `live`); StageTimers and a trace_to
  trace naming B1's and B2's kernels (`profiling`); and a one-rank NCCL
  group: the 1024 x 100 candidate-sharded plan and the dp-sharded PPO
  step at PPOConfig() each equal to its unsharded counterpart to the
  bit, timed (`multi_gpu`).

Each path is driven with the kernels' launch counters set to 0 just
before it and read just after. The `environment` line carries ptxas's
registers, stack and spill bytes per kernel function (B2's four
instantiations among them), B1's and
B2's occupancy on the humanoid and B3's on the Swimmer's rows, the
humanoid's rows and the nv-36 case (envs and shared bytes per block,
shared bytes per env, blocks per SM, registers and spills), and B1's
with per-env packs, and each new task model's (`task_occupancy`; B2's
per-env instantiation on the top-k tier). It
prints a `kernels` JSON line (time, launch
count, plain-twin time and roofline bound per kernel; B1's and B2's
rows also their RL and serving launches (iLQG's too) and their times
and bounds at batch 4 and 8, B1's its per-env time and bound at B =
4096; B3's row its Swimmer-agent launches; each kernel's row its
times, launches and bound on the task slice's models, its launches on
the estimation slice, and B1's and B2's time, plain time and bound at
the UKF's batch of 73; B1's and B2's launches on the planner slice and
their time, plain time and bound on its batch-20 wrench steps; B2's
launches in the Handover plan and its time, plain time and bound on
its 8191 first-step states at one iteration; B1's and B2's launches on
the golden replay and on the host and multi-GPU phases) and the
script's total seconds. The last line is {"ok": true, "device":
{...}}. Any failed check exits non-zero.
Without a CUDA device it exits non-zero and prints no result.
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
# the Swimmer: the JAX MPC test's configuration at the humanoid's sample
# count and the step's default 8 solver iterations
SWIM_HORIZON, SWIM_KNOTS, SWIM_PLAN_DT = 60, 6, 0.02
SWIM_CYCLES, SWIM_SIM_STEPS, SWIM_TARGET = 10, 10, (0.0, -0.5)


def log(phase: str, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


class Timer:
    """Wall time of a region: CUDA events on the card, the host clock
    on the CPU (used only to rehearse this script)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def __call__(self, fn, reps: int):
        """The median ms of `reps` fn() calls."""
        return float(np.median([self.once(fn)[1] for _ in range(reps)]))

    def once(self, fn):
        """(fn(), the ms it took)."""
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            return out, a.elapsed_time(b)
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)


def counters_zero():
    """Set the launch counters of B1, B2 and B3 to 0."""
    from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
    fused_smooth.LAUNCHES = fused_solver.LAUNCHES = 0
    fused_solver.EULER_LAUNCHES = 0


def counters():
    """The launch counters of B1 (smooth), B2 (solver) and B3 (euler)."""
    from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
    return {"smooth": fused_smooth.LAUNCHES, "solver": fused_solver.LAUNCHES,
            "euler": fused_solver.EULER_LAUNCHES}


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


def smooth_cost(m, B, nlim, packs, xfrc=False):
    """(bytes, flops) kernel B1 must move / do at batch B: each input
    read once (the shared parameter packs once; with `xfrc` the per-body
    wrenches too), each output written once; flops counted from the
    kernel's loops over this structure."""
    s = m.struct
    K = m.ncon
    n_in = s.nq + s.nv + s.nu + (6 * s.nbody if xfrc else 0)
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


def solve_trace(M, qf, qv, raw, dmask, lim_tab, niter=8):
    """The twin's Newton solve of `niter` iterations on these inputs:
    (efc, x, f, trace), with trace each iteration's (r, J p), both
    (B, ne)."""
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
    x, f, _ = newton_solve(M, Mchol, qf, efc, niter=niter, trace=trace)
    return efc, x, f, trace


def solve_cost(m, B, dmask, lim_tab, f, trace):
    """(bytes, flops) kernel B2 must move / do on this run's data. Bytes:
    per-env inputs and outputs once each (a per-env mask among them),
    the shared mask, damping and dt once. Flops (an FMA is two) of the
    algorithm, not of the kernel's loops: J built once; J x and J p at
    12 flops per chain dof; M⁻¹ from the factor for diag(J M⁻¹ Jᵀ); the
    gradient and Hessian updates only for the slots and limit rows
    active in each iteration, and the 16-point line search only for the
    edges that are active somewhere on its grid (r < 0 or r + 4 J p <
    0), both read from the twin's iterations. Each env's own chain dofs
    count: a static mask's, or the env's selected slots' under a per-env
    mask."""
    nv, nlim = m.nv, len(lim_tab)
    K = dmask.shape[-2]
    per_env = dmask.ndim == 3
    dmask = dmask.to(f.device)
    nz = (dmask != 0).sum(dim=-1).double().expand(B, K)   # chain dofs
    nzl = torch.tensor([float(sum(c != 0 for c in row)) for row in lim_tab],
                       dtype=torch.float64, device=f.device)
    chain = nz.sum(dim=1)                                  # (B,)
    n_in = nv * nv + 8 * nv + 13 * K + 4 * nlim + (K * nv if per_env else 0)
    n_out = 3 * nv + K
    shared = (0 if per_env else K * nv) + nv + 1
    setup = (nv ** 3 / 3 + 2 * nv * nv               # chol(M), a_smooth
             + 2 * nv ** 3 / 3                        # M⁻¹ from the factor
             + 30 * K + 42 * chain                    # frames, J, J qvel
             + (12 * nz * nz + 22 * nz).sum(dim=1)    # diag(J M⁻¹ Jᵀ)
             + 100 * K                                # D, aref per edge
             + float((2 * nzl * nzl + 2 * nzl + 10).sum()))
    per_it = (12 * chain + 30 * K + float((2 * nzl + 1).sum())  # J x - aref
              + 2 * nv * nv + nv                      # M (x - a_smooth)
              + nv ** 3 / 3 + 2 * nv * nv + nv        # chol(H), p
              + 12 * chain + 20 * K + float((2 * nzl).sum())    # J p
              + 2 * nv * nv + 6 * nv + 2 * 16)        # pMp, b0, dphi, x
    final = (12 * chain + 60 * K + float((2 * nzl + 3).sum())   # r, f
             + nv ** 3 / 3 + 2 * nv * nv + 3 * nv)    # Euler
    flops = float((setup + len(trace) * per_it + final).sum())
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


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card needs to move
    `nbytes` or to do `flops` fp32 operations, and which one sets it."""
    tb, tf = 1e3 * nbytes / HBM_BYTES_S, 1e3 * flops / FP32_FLOP_S
    return max(tb, tf), "bytes" if tb >= tf else "operations"


def solver_vs_twin(m, B, seed):
    """B2 against its twin at batch B on `states` (numpy seed), both fed
    the twin's B1 outputs. Returns the max relative error."""
    from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
    from humanoid_mujoco_torch.physics.solver import (contact_dmask,
                                                      limit_rows_static)
    qpos, qvel, ctrl = states(m, B, seed=seed)
    ref = fused_smooth.smooth_raw_reference(m, qpos, qvel, ctrl)
    lim_tab = limit_rows_static(m)
    args = (ref[0], ref[1], qvel, *ref[2:7], contact_dmask(m), *ref[7:14],
            m.dt * m.dof_damping, m.dt)
    return max(rel_err(r, o) for r, o in zip(
        fused_solver.solve_step_raw_reference(*args, lim_tab=lim_tab),
        fused_solver.solve_step_raw(*args, lim_tab=lim_tab)))


def isolation(m, solve, args, model_states, env=7):
    """A solve kernel (`solve(*args)`, B2 or B3) on the main states: two
    launches give the same bits; a NaN in one env's qvel (args[2]) makes
    that env's qacc and qvel_new non-finite, so that `step` flags it as
    diverged, and leaves every other env's outputs bitwise unchanged.
    `model_states(m, B)` gives the states for the step."""
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import step
    first = solve(*args)
    again = solve(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again)), \
        "the kernel differs between two launches on the same inputs"
    qv = args[2].clone()
    dof = min(3, qv.shape[1] - 1)
    qv[env, dof] = float("nan")
    poisoned = solve(*args[:2], qv, *args[3:])
    B = qv.shape[0]
    rest = torch.arange(B, device=qv.device) != env
    assert not bool(torch.isfinite(poisoned[0][env]).all()), "qacc finite"
    assert not bool(torch.isfinite(poisoned[1][env]).all()), \
        "qvel_new finite"
    assert all(torch.equal(a[rest], b[rest])
               for a, b in zip(first, poisoned)), \
        "a NaN env changed another env's outputs"
    qpos, qvel, ctrl = model_states(m, B)
    qvel[env, dof] = float("nan")
    _, info = step(m, make_state(m, qpos=qpos, qvel=qvel), ctrl)
    flagged = info.diverged.nonzero().flatten().tolist()
    assert flagged == [env], flagged
    return {"bitwise_repeat": True, "nan_env": env, "diverged": flagged,
            "others_bitwise_equal": True}


def smooth_vs_twin(m, B, seed, xfrc_seed=None):
    """B1 against its twin at batch B on `states` (numpy seed), with
    per-body wrenches from `xfrc_seed` when it is given. Returns the max
    relative error over the 22 outputs."""
    from humanoid_mujoco_torch.physics import fused_smooth
    qpos, qvel, ctrl = states(m, B, seed=seed)
    xfrc = None
    if xfrc_seed is not None:
        rng = np.random.default_rng(xfrc_seed)
        xfrc = torch.tensor(rng.standard_normal((B, m.struct.nbody, 6)),
                            dtype=m.dtype, device=m.device)
    ker = fused_smooth.smooth_raw(m, qpos, qvel, ctrl, xfrc)
    ref = fused_smooth.smooth_raw_reference(m, qpos, qvel, ctrl, xfrc)
    return max(rel_err(r, o, n)
               for n, r, o in zip(fused_smooth.NAMES, ref, ker))


def smooth_isolation(m, qpos, qvel, ctrl, env=7):
    """B1 on the main states: two launches give the same bits; a NaN in
    one env's qvel makes that env's qfrc_smooth non-finite and leaves
    every other env's 22 outputs bitwise unchanged."""
    from humanoid_mujoco_torch.physics import fused_smooth
    first = fused_smooth.smooth_raw(m, qpos, qvel, ctrl)
    again = fused_smooth.smooth_raw(m, qpos, qvel, ctrl)
    assert all(torch.equal(a, b) for a, b in zip(first, again)), \
        "B1 differs between two launches on the same inputs"
    qv = qvel.clone()
    qv[env, 3] = float("nan")
    poisoned = fused_smooth.smooth_raw(m, qpos, qv, ctrl)
    rest = torch.arange(qv.shape[0], device=qv.device) != env
    nonfinite = [n for n, p in zip(fused_smooth.NAMES, poisoned)
                 if not bool(torch.isfinite(p[env]).all())]
    assert "qfrc_smooth" in nonfinite, nonfinite
    assert all(torch.equal(a[rest], b[rest])
               for a, b in zip(first, poisoned)), \
        "a NaN env changed another env's B1 outputs"
    return {"bitwise_repeat": True, "nan_env": env,
            "nonfinite_outputs": nonfinite, "others_bitwise_equal": True}


def smooth_oversize_model(device, n=250):
    """A chain of `n` hinge bodies with one sphere on the floor: inside
    B1's family (fused_smooth.supported), but its M alone (n² floats)
    outgrows a block's shared memory."""
    from humanoid_mujoco_torch.physics.model import JointType, ModelBuilder
    b = ModelBuilder()
    body = -1
    for i in range(n):
        body = b.add_body(f"link{i}", body, pos=(0.0, 0.0, 0.01), mass=0.01,
                          inertia=(1e-4, 1e-4, 1e-4))
        b.add_joint(f"hinge{i}", body, JointType.HINGE, axis=(0, 1, 0))
    b.add_sphere(body, radius=0.02)
    return b.finalize(device=device)


def smooth_refuses_oversize(device):
    """`smooth_oversize_model` is refused with ValueError before any
    launch. Returns the bytes one env would need."""
    from humanoid_mujoco_torch.physics import fused_smooth
    m = smooth_oversize_model(device)
    B = 2
    z = torch.zeros((B, m.nv), dtype=torch.float32, device=device)
    qpos = torch.zeros((B, m.nq), dtype=torch.float32, device=device)
    n = fused_smooth.LAUNCHES
    try:
        fused_smooth.smooth_raw(m, qpos, z, z[:, :0])
    except ValueError as e:
        assert "bytes of shared memory" in str(e), e
    else:
        raise AssertionError("an oversize model was not refused by B1")
    assert fused_smooth.LAUNCHES == n
    return fused_smooth.smooth_smem_bytes(fused_smooth.smooth_dims(m))


def solver_refuses_oversize(m, device, slots=2000):
    """A model whose per-env working set exceeds a block's shared memory
    (`slots` contact slots over all dofs) is refused with ValueError
    before any launch. Returns the bytes it would need."""
    from humanoid_mujoco_torch.physics import fused_solver
    from humanoid_mujoco_torch.physics.solver import limit_rows_static
    nv, lim_tab = m.nv, limit_rows_static(m)
    nlim = len(lim_tab)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    args = (torch.eye(nv, device=device)[None], z(1, nv), z(1, nv),
            z(1, nv, 6), z(1, slots, 3), z(1, slots, 3), z(1, slots),
            z(1, slots, 3), torch.ones((slots, nv), device=device),
            z(1, slots), z(1, slots), z(1, slots), z(1, nlim), z(1, nlim),
            z(1, nlim), z(1, nlim), m.dt * m.dof_damping, m.dt)
    n = fused_solver.LAUNCHES
    try:
        fused_solver.solve_step_raw(*args, lim_tab=lim_tab)
    except ValueError as e:
        assert "bytes of shared memory" in str(e), e
    else:
        raise AssertionError("an oversize model was not refused")
    assert fused_solver.LAUNCHES == n
    return fused_solver.solver_smem_bytes(nv, slots, nlim, slots * nv)


def kernel_edges(m, device, solve_in, lim_tab, main_states, B=300):
    """Both kernels at a batch that is not a multiple of a block (B1's 8
    envs, B2's 4), B1 with per-body wrenches, and both at B = 1; on the
    main states, each kernel's bitwise repeat and the isolation of a NaN
    env; on the card, the models too large for a block and the inputs
    the wrappers must refuse. Returns the max relative error per kernel
    and the checks' results."""
    from humanoid_mujoco_torch.physics import (fused_smooth, fused_solver,
                                               humanoid)
    from humanoid_mujoco_torch.physics.solver import contact_dmask
    qpos, qvel, ctrl = states(m, B, seed=2)
    e1 = smooth_vs_twin(m, B, seed=2, xfrc_seed=3)
    e1_one = smooth_vs_twin(m, 1, seed=4)
    ref = fused_smooth.smooth_raw_reference(m, qpos, qvel, ctrl)
    args = (ref[0], ref[1], qvel, *ref[2:7], contact_dmask(m), *ref[7:14],
            m.dt * m.dof_damping, m.dt)
    e2 = max(rel_err(r, o) for r, o in zip(
        fused_solver.solve_step_raw_reference(*args, lim_tab=lim_tab),
        fused_solver.solve_step_raw(*args, lim_tab=lim_tab)))
    e2_one = solver_vs_twin(m, 1, seed=4)
    assert max(e1, e1_one, e2, e2_one) <= TOL, (e1, e1_one, e2, e2_one)
    out = {"batch": B, "smooth_xfrc_rel_err": e1,
           "smooth_rel_err_batch_1": e1_one, "solver_rel_err": e2,
           "solver_rel_err_batch_1": e2_one}
    if device != "cpu":
        out["smooth_isolation"] = smooth_isolation(m, *main_states)
        out["smooth_oversize_bytes_refused"] = smooth_refuses_oversize(
            device)
        out["solver_isolation"] = isolation(
            m, lambda *a: fused_solver.solve_step_raw(*a, lim_tab=lim_tab),
            solve_in, states)
        out["solver_oversize_bytes_refused"] = solver_refuses_oversize(
            m, device)
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
    return out


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


def swimmer_states(m, B, seed=0):
    """Swimmer states around make_state(swimmer_model()) (numpy seed):
    root offsets 0.3 N, hinges uniform in ±1.3 rad, and in every other
    env one hinge within 0.05 rad of (or past) its ±90° limit; qvel
    0.8 N, ctrl uniform in the ctrl range."""
    from humanoid_mujoco_torch.physics.model import make_state
    rng = np.random.default_rng(seed)
    qpos = np.tile(make_state(m).qpos.cpu().numpy(), (B, 1))
    qpos[:, :3] += 0.3 * rng.standard_normal((B, 3))
    qpos[:, 3:] = rng.uniform(-1.3, 1.3, (B, 5))
    near = np.arange(B) % 2 == 0
    joint = rng.integers(0, 5, B)
    edge = (np.pi / 2 + rng.uniform(-0.05, 0.02, B)) * rng.choice(
        [-1.0, 1.0], B)
    qpos[near, 3 + joint[near]] = edge[near]
    qvel = 0.8 * rng.standard_normal((B, m.nv))
    ctrl = rng.uniform(-1.0, 1.0, (B, m.nu))
    return tuple(torch.tensor(x, dtype=m.dtype, device=m.device)
                 for x in (qpos, qvel, ctrl))


def swimmer_solve_inputs(m, qpos, qvel, ctrl):
    """The B3 inputs of the Swimmer's step (plain smooth stage + limit
    rows): (M, qf, qv, J, pos, k, b, d, hdamp, dt)."""
    from humanoid_mujoco_torch.physics.engine import prepare_smooth
    from humanoid_mujoco_torch.physics.solver import make_rows
    _, _, M, qf = prepare_smooth(m, qpos, qvel, ctrl)
    rows = make_rows(m, qpos)
    return (M, qf, qvel, rows.J, rows.pos, rows.k, rows.b, rows.d,
            m.dt * m.dof_damping, m.dt)


def rows_trace(M, qf, qv, J, pos, k, b, d):
    """The twin's Newton solve on explicit rows: (efc, x, f, trace)."""
    from humanoid_mujoco_torch.ops import linalg
    from humanoid_mujoco_torch.physics.solver import (Rows, finish_efc,
                                                      newton_solve)
    Mchol = linalg.chol_factor(M)
    efc = finish_efc(Rows(J=J, pos=pos, k=k, b=b, d=d), qv, Mchol)
    trace = []
    x, f, _ = newton_solve(M, Mchol, qf, efc, trace=trace)
    return efc, x, f, trace


def rows_cost(J, f, trace):
    """(bytes, flops) kernel B3 must move / do on this run's data.
    Bytes: per-env inputs and outputs once each, damping and dt once.
    Flops (an FMA is two) of the algorithm on these rows, counting each
    row's nonzeros (nz): chol(M), a_smooth and M⁻¹ from the factor;
    diag(J M⁻¹ Jᵀ), J qvel, D and aref per row; per iteration J x, the
    gradient and Hessian updates of the rows active in it, M (x - a),
    chol(H) and p, J p, and the 16-point line search only for the rows
    active somewhere on its grid, read from the twin's iterations; the
    final forces, Jᵀ f of the loaded rows, and the Euler solve."""
    B, ne, nv = J.shape
    nz = (J != 0).sum(dim=-1).double()                # (B, ne)
    n_in = nv * nv + 2 * nv + ne * nv + 4 * ne
    n_out = 3 * nv + ne
    chol = nv ** 3 / 3
    flops = B * (chol + 2 * nv * nv + 2 * chol)       # chol, a_s, M⁻¹
    flops += float((2 * nz * nz + 2 * nz + 8).sum())  # diagA, J qv, D, aref
    dense = (2 * nv * nv + nv + chol + 2 * nv * nv + nv
             + 2 * nv * nv + 4 * nv + 32)             # Mx, H, p, pMp, x
    flops += len(trace) * B * dense
    for r, Jp in trace:
        act = (r < 0).double()
        flops += float((2 * nz + 1).sum() + (2 * nz).sum())       # J x, J p
        flops += float((act * (2 * nz + nz * (nz + 1))).sum())    # g, H
        flops += float(((r < 0) | (r + 4.0 * Jp < 0)).sum()) * (1 + 16 * 5)
    flops += float((2 * nz + 3).sum())                # final r, f
    flops += float(((f > 0).double() * 2 * nz).sum())  # Jᵀ f
    flops += B * (chol + 2 * nv * nv + 3 * nv)        # Euler
    return 4 * (B * (n_in + n_out) + nv + 1), flops


def rubik_rows(B, device, seed=7, nv=36, ne=360):
    """A synthetic explicit-row solve the size of the registry's largest
    B3 model (Rubik: nv 36, up to a few hundred rows), from a numpy seed:
    a random SPD M with eigenvalues in ~[0.02, 1.5], J with 8 nonzero
    dofs a row (all of them when nv < 8), a quarter of the rows violated
    (pos in [-5, 20] mm) with solref (0.02, 1) and d in [0.9, 0.95] at
    dt 0.002. Returns (M, qf, qv, J, pos, k, b, d, hdamp, dt) float32."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, nv, nv)) / np.sqrt(nv)
    M = 0.3 * A @ A.transpose(0, 2, 1) + 0.02 * np.eye(nv)
    J = np.zeros((B, ne, nv))
    nz = min(8, nv)
    for i in range(ne):
        dofs = rng.permuted(np.tile(np.arange(nv), (B, 1)), axis=1)[:, :nz]
        J[np.arange(B)[:, None], i, dofs] = rng.standard_normal((B, nz))
    pos = rng.uniform(-0.005, 0.02, (B, ne))
    d = rng.uniform(0.9, 0.95, (B, ne))
    dt, tc = 0.002, 0.02
    b = np.full((B, ne), 2.0 / (0.95 * tc))
    k = d / (0.95 ** 2 * tc ** 2)
    qf = rng.standard_normal((B, nv))
    qv = 0.5 * rng.standard_normal((B, nv))

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return (t(M), t(qf), t(qv), t(J), t(pos), t(k), t(b), t(d),
            t(np.full(nv, dt * 0.1)), dt)


def euler_refusals(device):
    """Models B3 does not take are refused with ValueError before any
    launch: nv 65 (above the kernel's 64) and nv 36 with 1400 rows (one
    env's working set above a block's shared memory). Returns the bytes
    the latter would need."""
    from humanoid_mujoco_torch.physics import fused_solver
    n = fused_solver.EULER_LAUNCHES
    for nv, ne, what in ((65, 4, "dofs"), (36, 1400, "bytes of shared")):
        args = rubik_rows(1, device, nv=nv, ne=ne)
        try:
            fused_solver.solve_constraints_euler(*args)
        except ValueError as e:
            assert what in str(e), e
        else:
            raise AssertionError(f"nv {nv}, {ne} rows was not refused")
    assert fused_solver.EULER_LAUNCHES == n
    return fused_solver.euler_smem_bytes(36, 1400)


def euler_edges(m, device, B=300):
    """B3 at a batch that is not a multiple of its 4-env block and at
    B = 1 on Swimmer states, and on a Rubik-sized synthetic solve (nv 36,
    360 rows, `rubik_rows`) at B = 300; on the card, its bitwise repeat,
    the isolation of a NaN env, the models it must refuse and the inputs
    its wrapper must refuse. Returns the max relative errors and the
    checks' results."""
    from humanoid_mujoco_torch.physics import fused_solver

    def vs_twin(args):
        ker = fused_solver.solve_constraints_euler(*args)
        ref = fused_solver.solve_constraints_euler_reference(*args)
        return max(rel_err(r, o) for r, o in zip(ref, ker))
    args = swimmer_solve_inputs(m, *swimmer_states(m, B, seed=5))
    err = vs_twin(args)
    err_one = vs_twin(swimmer_solve_inputs(m, *swimmer_states(m, 1, seed=8)))
    err_nv36 = vs_twin(rubik_rows(B, device))
    assert max(err, err_one, err_nv36) <= TOL, (err, err_one, err_nv36)
    out = {"batch": B, "euler_rel_err": err, "euler_rel_err_batch_1": err_one,
           "euler_rel_err_nv36_rows360": err_nv36}
    if device != "cpu":
        out["euler_isolation"] = isolation(
            m, fused_solver.solve_constraints_euler, args,
            lambda mm, n: swimmer_states(mm, n, seed=5))
        out["euler_oversize_bytes_refused"] = euler_refusals(device)
        expect_error(TypeError, lambda: fused_solver.solve_constraints_euler(
            *[a.double() for a in args[:8]], *args[8:]))
        expect_error(ValueError, lambda: fused_solver.solve_constraints_euler(
            *args[:3], args[3][:, :, :5], *args[4:]))
        expect_error(ValueError, lambda: fused_solver.solve_constraints_euler(
            *args[:4], args[4][:, :7], *args[5:]))
        expect_error(ValueError, lambda: fused_solver.solve_constraints_euler(
            *args[:4], args[4].cpu(), *args[5:]))
    return out


def swimmer_rollout(m, B, horizon):
    """A Swimmer rollout for tools/torch_profile.py: B states of
    `swimmer_states` (seed 6) under a linear 6-knot spline of random
    controls toward SWIM_TARGET. Returns rollout(), one
    `rollout_spline` of `horizon` steps."""
    from humanoid_mujoco_torch.ops.spline import SplineOrder
    from humanoid_mujoco_torch.physics.model import State
    from humanoid_mujoco_torch.rollout import rollout_spline
    from humanoid_mujoco_torch.tasks import swimmer_task
    task = swimmer_task(target=SWIM_TARGET, device=m.device)
    qpos, qvel, _ = swimmer_states(m, B, seed=6)
    s0 = State(qpos=qpos, qvel=qvel,
               time=torch.zeros(B, dtype=m.dtype, device=m.device))
    rng = np.random.default_rng(6)
    times = torch.linspace(0.0, horizon * float(m.dt), SWIM_KNOTS,
                           dtype=m.dtype, device=m.device)
    values = torch.tensor(rng.uniform(-1.0, 1.0, (B, SWIM_KNOTS, m.nu)),
                          dtype=m.dtype, device=m.device)

    def rollout():
        return rollout_spline(m, task, s0, times, values, SplineOrder.LINEAR,
                              horizon)
    return rollout


def run_swimmer(device="cuda", B=BENCH_BATCH, nsample=PLAN_SAMPLES,
                plan_horizon=SWIM_HORIZON, ncycle=SWIM_CYCLES,
                sim_steps=SWIM_SIM_STEPS, gpu="cpu", humanoid_b3=None):
    """The Swimmer's path: B3 vs its twin, the whole step, the plans and
    the MPC loop. Returns B3's row of the kernel table."""
    from humanoid_mujoco_torch import mpc
    from humanoid_mujoco_torch.ops.spline import SplineOrder
    from humanoid_mujoco_torch.physics import fused_solver
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import integrate_pos, step
    from humanoid_mujoco_torch.planners import (SamplingConfig,
                                                init_policy, sampling_plan)
    from humanoid_mujoco_torch.tasks import get_task, task_model

    timer = Timer(device)
    m = task_model("Swimmer", device=device)
    qpos, qvel, ctrl = swimmer_states(m, B)

    # ---- 8. B3 kernel vs its twin on Swimmer rows ----
    args = swimmer_solve_inputs(m, qpos, qvel, ctrl)
    ker = fused_solver.solve_constraints_euler(*args)
    ref = fused_solver.solve_constraints_euler_reference(*args)
    names = ("qacc", "qvel_new", "f", "qfrc_constraint")
    errs = {n: rel_err(r, o, n) for n, r, o in zip(names, ref, ker)}
    worst = max(errs, key=errs.get)
    efc, x_t, f_t, trace = rows_trace(*args[:8])
    knife = knife_edges(efc, x_t, args[3].shape[1])
    log("euler_vs_twin", batch=B, max_rel_err=errs[worst], worst=worst,
        tol=TOL, errs=errs, knife_edge_states=knife,
        active_rows=int((f_t > 0).sum()))
    assert errs[worst] <= TOL, f"B3 {worst}: {errs[worst]:.3e} > {TOL}"
    log("euler_edges", tol=TOL, **euler_edges(m, device))

    # ---- 9. the Swimmer's whole step: kernel vs the twin composition ----
    s_k, info_k = step(m, make_state(m, qpos=qpos, qvel=qvel), ctrl)
    q_r = integrate_pos(m, qpos, ref[1], m.dt)
    errs9 = {"qpos": rel_err(q_r, s_k.qpos), "qvel": rel_err(ref[1], s_k.qvel),
             "qacc": rel_err(ref[0], info_k.qacc)}
    worst9 = max(errs9, key=errs9.get)
    log("swimmer_step_vs_twin", batch=B, max_rel_err=errs9[worst9],
        worst=worst9, tol=TOL, errs=errs9,
        diverged=int(info_k.diverged.sum()))
    assert errs9[worst9] <= TOL, f"step {worst9}: {errs9[worst9]:.3e}"
    assert not bool(info_k.diverged.any()), "Swimmer step diverged"

    # ---- 10. Swimmer plans ----
    task = get_task("Swimmer", target=SWIM_TARGET, device=device)
    pm = mpc.make_plan_model(m, SWIM_PLAN_DT)
    cfg = SamplingConfig(nsample=nsample, nknots=SWIM_KNOTS,
                         horizon=plan_horizon, order=SplineOrder.LINEAR,
                         exploration=0.3, solver_iters=8)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    s0 = make_state(m)
    pol = init_policy(m, SWIM_KNOTS)
    counters_zero()
    for i in range(PLAN_CALLS):
        holder = {}

        def plan():
            holder["out"] = sampling_plan(pm, task, cfg, pol, s0,
                                          generator=gen)
        lat = timer(plan, 1)
        pol, info = holder["out"]
        best, nominal = float(info.best_return), float(info.nominal_return)
        log("swimmer_plan", gpu=gpu, call=i, nsample=nsample,
            horizon=plan_horizon, latency_ms=lat, best=best,
            nominal=nominal, winner=int(info.winner))
        assert best <= nominal, (best, nominal)
    plan_launches = counters()
    log("swimmer_plan_launches", **plan_launches)
    if device != "cpu":
        assert plan_launches == {"smooth": 0, "solver": 0,
                                 "euler": PLAN_CALLS * plan_horizon}

    # ---- 11. the Swimmer MPC loop with the task's transition ----
    def plan_fn(mm, tt, pp, ss, g):
        return sampling_plan(mm, tt, cfg, pp, ss, generator=g)
    target = torch.tensor(SWIM_TARGET, dtype=m.dtype, device=device)
    s_mpc = make_state(m)
    holder = {}

    def loop():
        holder["res"] = mpc.mpc_rollout(
            m, pm, task, plan_fn, init_policy(m, SWIM_KNOTS), s_mpc, gen,
            ncycle, sim_steps, mpc.spline_action_fn(SplineOrder.LINEAR),
            run_transition=True)
    counters_zero()
    loop_ms = timer(loop, 1)
    mpc_launches = counters()
    res = holder["res"]
    d0 = float(torch.linalg.vector_norm(s_mpc.qpos[0, :2] - target))
    heads = res.states[..., :2].reshape(-1, 2)
    dist = torch.linalg.vector_norm(
        torch.cat([heads, res.final_state.qpos[:, :2]]) - target, dim=-1)
    log("swimmer_mpc", gpu=gpu, cycles=ncycle, sim_steps=sim_steps,
        nsample=nsample, loop_ms=loop_ms, launches=mpc_launches,
        head_dist_start=d0, head_dist_end=float(dist[-1]),
        head_dist_per_cycle=dist[::sim_steps].tolist(),
        mean_cost=float(res.costs.mean()),
        plan_returns=res.plan_returns.tolist(),
        target_end=res.final_task.mocap_pos[0].tolist())
    assert bool(torch.isfinite(res.costs).all()), "non-finite MPC costs"
    assert float(dist[-1]) < d0, ("head did not close on the target",
                                  d0, float(dist[-1]))
    if device != "cpu":
        assert mpc_launches == {"smooth": 0, "solver": 0,
                                "euler": ncycle * plan_horizon
                                + ncycle * sim_steps}, mpc_launches

    # ---- 12. B3's row of the kernel table ----
    n3 = fused_solver.EULER_LAUNCHES
    t_k = timer(lambda: fused_solver.solve_constraints_euler(*args), 20)
    t_r = timer(lambda: fused_solver.solve_constraints_euler_reference(
        *args), 5)
    fused_solver.EULER_LAUNCHES = n3      # timing launches are not counted
    nbytes, flops = rows_cost(args[3], f_t, trace)
    bound_ms, bound_by = bound(nbytes, flops)
    row = {"name": "euler", "route": "cuda",
           "source": "humanoid_mujoco_torch/csrc/euler.cu",
           "replaces": "humanoid_mujoco_tpu/physics/pallas_solver.py:102",
           "launches": plan_launches["euler"] + mpc_launches["euler"],
           "max_abs_err": max(float((r - o).abs().max())
                              for r, o in zip(ref, ker)),
           "ms": t_k, "plain_ms": t_r, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None, "bytes": nbytes, "flops": flops,
           "launches_per_plan_step": plan_launches["euler"]
           / (PLAN_CALLS * plan_horizon),
           "launches_plans": plan_launches["euler"],
           "launches_mpc": mpc_launches["euler"]}
    if humanoid_b3:
        row.update(humanoid_b3)
    return row


def euler_vs_solver(m, solve_in, lim_tab, ker2, knife, timer):
    """B3 against B2 on the same solve: the humanoid's selection-free
    explicit rows (rows_from_raw) into B3, the raw data they come from
    into B2. Returns B3's numbers on these rows for the kernel table."""
    from humanoid_mujoco_torch.physics import fused_solver
    from humanoid_mujoco_torch.physics.solver import rows_from_raw
    (M, qfs, qvel, cdof, rel, nrm, dist, mu3, dmask, kc, bc, dc,
     lpos, kl, bl, dl, hdamp, h) = solve_in
    rows = rows_from_raw(cdof, dmask, rel, nrm, dist, mu3, kc, bc, dc,
                         lim_tab, lpos, kl, bl, dl)
    args = (M, qfs, qvel, rows.J.contiguous(), rows.pos, rows.k, rows.b,
            rows.d, hdamp, h)
    ker3 = fused_solver.solve_constraints_euler(*args)
    names = ("qacc", "qvel_new", "qfrc_constraint")
    errs = {n: rel_err(r, o, n) for n, r, o in
            zip(names, (ker2[0], ker2[1], ker2[3]),
                (ker3[0], ker3[1], ker3[3]))}
    worst = max(errs, key=errs.get)
    log("euler_vs_solver", batch=M.shape[0], rows=list(rows.J.shape[1:]),
        max_rel_err=errs[worst], worst=worst, tol=TOL, errs=errs,
        knife_edge_states=knife)
    assert errs[worst] <= TOL, f"B3 vs B2 {worst}: {errs[worst]:.3e}"
    n3 = fused_solver.EULER_LAUNCHES
    t_k = timer(lambda: fused_solver.solve_constraints_euler(*args), 5)
    t_r = timer(lambda: fused_solver.solve_constraints_euler_reference(
        *args), 3)
    fused_solver.EULER_LAUNCHES = n3
    _, _, f_t, trace = rows_trace(*args[:8])
    nbytes, flops = rows_cost(args[3], f_t, trace)
    bound_ms, bound_by = bound(nbytes, flops)
    return {"ms_humanoid_rows": t_k, "plain_ms_humanoid_rows": t_r,
            "bound_ms_humanoid_rows": bound_ms,
            "bound_by_humanoid_rows": bound_by,
            "bytes_humanoid_rows": nbytes, "flops_humanoid_rows": flops,
            "max_rel_err_vs_solver": errs[worst]}


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
    lim_tab = m.struct_static("lim_tab", lambda: limit_rows_static(m))
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

    # ---- 3b. B3 against B2 on the humanoid's 694 explicit rows ----
    b3_rows = euler_vs_solver(m, solve_in, lim_tab, ker2, knife, timer)

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

    # ---- 4b. odd batch, wrenches, B = 1, isolation, refusals ----
    log("kernel_edges", tol=TOL,
        **kernel_edges(m, device, solve_in, lim_tab, (qpos, qvel, ctrl)))

    # ---- 5. headline: the bench.py rollout (stand task, spline policy) ----
    task, rollout = headline(m, B, horizon)
    rollout()                                          # warm-up
    counters_zero()
    res = rollout()
    if device != "cpu":
        torch.cuda.synchronize()
    launches = counters()
    counters_zero()
    ms = timer(rollout, 3)
    timed = counters()
    returns = res.total_return
    log("rollout", gpu=gpu, batch=B, horizon=horizon, ms=ms,
        steps_per_s=B * horizon / (ms * 1e-3), launches=launches,
        mean_return=float(returns.mean()),
        diverged=int(res.diverged.sum()))
    if device != "cpu":
        assert launches == {"smooth": horizon, "solver": horizon,
                            "euler": 0}, launches
        assert timed == {"smooth": 3 * horizon, "solver": 3 * horizon,
                         "euler": 0}, timed
    assert bool(torch.isfinite(returns).all()), "non-finite returns"
    assert not bool(res.diverged.any()), "rollout diverged"

    # ---- 6. predictive-sampling plans ----
    cfg = SamplingConfig(nsample=nsample, nknots=3, horizon=plan_horizon,
                         order=SplineOrder.ZERO)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    s0 = make_state(m, qpos=humanoid.stand_qpos(m))
    plan_pol = init_policy(m, 3)
    counters_zero()
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
    plan_launches = counters()
    log("plan_launches", **plan_launches)
    if device != "cpu":
        assert plan_launches == {"smooth": PLAN_CALLS * plan_horizon,
                                 "solver": PLAN_CALLS * plan_horizon,
                                 "euler": 0}

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
        bound_ms, bound_by = bound(nbytes, flops)
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": t, "plain_ms": tr, "bound_ms": bound_ms,
                "bound_by": bound_by,
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
    return table, b3_rows


# the RL slice: the domain-randomized env batch, SAC and PPO
RL_BATCH, RL_STEPS, RL_RF = 4096, 10, 0.5
RL_TRAIN_ENVS = 256


class twins:
    """Within the block, `step` runs kernels B1's and B2's plain twins on
    the card (the wrappers' module attributes swapped for the twins), so
    the same env step can be held against the kernels' on one device."""

    def __enter__(self):
        from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
        self.saved = fused_smooth.smooth_raw, fused_solver.solve_step_raw
        fused_smooth.smooth_raw = fused_smooth.smooth_raw_reference
        fused_solver.solve_step_raw = fused_solver.solve_step_raw_reference

    def __exit__(self, *exc):
        from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
        fused_smooth.smooth_raw, fused_solver.solve_step_raw = self.saved


class record:
    """Within the block, the calls of the function `name` of the first
    module in `modules` (the others import the same function by name)
    are recorded with their arguments and results, every `every`-th one
    in `calls`, so that the main path's own calls can be held against
    the twins after it."""

    def __init__(self, modules, name, every=1):
        self.modules, self.name, self.every = modules, name, every
        self.calls, self.n = [], 0

    def __enter__(self):
        fn = self.saved = getattr(self.modules[0], self.name)

        def spy(*a, **kw):
            out = fn(*a, **kw)
            if self.n % self.every == 0:
                self.calls.append((a, kw, out))
            self.n += 1
            return out
        for mod in self.modules:
            assert getattr(mod, self.name) is fn, (mod, self.name)
            setattr(mod, self.name, spy)
        return self

    def __exit__(self, *exc):
        for mod in self.modules:
            setattr(mod, self.name, self.saved)


class timed:
    """Within the block, each call of the functions `names` of `module`
    adds its host wall time (ms, the device synchronized before and
    after) to `into[name]`: where one call of the caller spends its
    time."""

    def __init__(self, module, names, into):
        self.module, self.names, self.into = module, names, into

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            setattr(self.module, n, self._wrap(n, fn))

    def _wrap(self, name, fn):
        def spy(*a, **kw):
            sync = torch.cuda.synchronize if torch.cuda.is_available() \
                else (lambda: None)
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            self.into[name] = (self.into.get(name, 0.0)
                               + 1e3 * (time.perf_counter() - t0))
            return out
        return spy

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def env_outs(r):
    """(obs, reward, qpos, qvel) of an env step's result."""
    return (r[1], r[2], r[0].phys.qpos, r[0].phys.qvel)


def env_steps_vs_twins(calls, device):
    """Env steps recorded on a main path (`record` of rl/env.py's
    env_step: kernel B1 with per-env packs, then B2, at that path's
    batch) against the same steps (state, action and draws) through the
    float64 twins, the float32 twins' numbers beside them. Each env's
    largest error in obs, reward, qpos and qvel, each over the batch's
    largest value, within TOL on all but 0.5% of the (env, step) pairs
    (none at fewer than 200), as rl_env holds one step of
    4096 reset envs (a float32 rounding can flip an active set in a
    stiff solve; see rl_smooth_per_env). The paths step the RL model,
    rl_humanoid_model, whose float64 copy the twins step."""
    from humanoid_mujoco_torch.rl import env as E
    base64 = E.rl_humanoid_model(dtype=torch.float64, device=device)
    e_k, e_t = [], []
    for (cfg, base, es, act, d), kw, out in calls:
        assert not kw, kw
        with twins():
            t = E.env_step(cfg, base, es, act, d)
            t64 = E.env_step(cfg, base64, to_float64(es), act.double(),
                             to_float64(d))
        ref = env_outs(t64)
        e_k.append(per_env_err(env_outs(out), ref))
        e_t.append(per_env_err(env_outs(t), ref))
    e_k, e_t = torch.cat(e_k), torch.cat(e_t)
    out = {"steps": len(calls), "batch": calls[0][0][2].batch,
           "pairs": e_k.numel(), "tol": TOL,
           "pairs_over_tol_vs_float64": int((e_k > TOL).sum()),
           "twin_pairs_over_tol_vs_float64": int((e_t > TOL).sum()),
           "max_rel_err_vs_float64": float(e_k.max()),
           "median_rel_err_vs_float64": float(e_k.median()),
           "twin_max_rel_err_vs_float64": float(e_t.max())}
    assert out["pairs_over_tol_vs_float64"] <= e_k.numel() // 200, out
    return out


def rl_inputs(base, es, seed=11):
    """B1's inputs on RL states: the reset's qpos, qvel 0.2 N, ctrl 0.3 N
    (numpy seed) and one env-style push per env (a one-hot body row of
    5-15 N horizontally)."""
    B = es.batch
    rng = np.random.default_rng(seed)
    nb = base.struct.nbody
    xfrc = np.zeros((B, nb, 6))
    body = rng.integers(1, nb, B)
    ang = rng.uniform(0.0, 2 * np.pi, B)
    mag = rng.uniform(5.0, 15.0, B)
    xfrc[np.arange(B), body, 0] = mag * np.cos(ang)
    xfrc[np.arange(B), body, 1] = mag * np.sin(ang)

    def t(x):
        return torch.tensor(x, dtype=base.dtype, device=base.device)
    return (es.phys.qpos, t(0.2 * rng.standard_normal((B, base.nv))),
            t(0.3 * rng.standard_normal((B, base.nu))), t(xfrc))


def device_ms(fn, reps, name):
    """Device time per launch (ms) of the kernels whose name holds
    `name`, from torch.profiler over `reps` calls of fn after one more;
    None on the CPU."""
    if not torch.cuda.is_available():
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(ev.count, ev.self_device_time_total)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and name in ev.key]
    n = sum(c for c, _ in rows)
    assert n >= reps, f"the profiler saw {n} launches of {name}"
    return sum(t for _, t in rows) / 1e3 / n


def kernel_ms(launch, reps=20, spin_cycles=40_000_000):
    """Device time (ms) a launch of a bare kernel call (`launch()`, the
    kernel's C entry on arguments built once, so no wrapper copies):
    CUDA events around `reps` back-to-back launches queued behind a spin
    of the card (~20 ms), so that the host's launch cost falls inside
    the spin, not between the launches."""
    launch()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    a.record()
    for _ in range(reps):
        launch()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def profile_rows(fn):
    """(name, launches, device µs) of each CUDA kernel that one fn()
    call ran, from torch.profiler, the busiest first (`device_rows`)."""
    rows = device_rows(fn)
    assert rows, "the profiler saw no device time"
    return rows


def device_rows(fn):
    """`profile_rows` without its check: empty where the session
    recorded nothing. It traces the device only: the host-side events
    of a 40 k-launch plan would cost the trace's aggregation tens of
    seconds, and none is read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the first kernels of a session can go unrecorded (the leading
        # spin below never shows; on some runs a port kernel after it
        # went too): 50 ms of host time first, then a spin of the card
        # (~0.5 ms) on either side of fn, left out of the rows: fn's
        # first and last launches then lie well inside the trace
        time.sleep(0.05)
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
    rows = [(ev.key, ev.count, ev.self_device_time_total)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0
            and "spin_kernel" not in ev.key]
    return sorted(rows, key=lambda x: -x[2])


def profile_rows_complete(fn, want, sessions=1, attempts=5, fresh=None):
    """`profile_rows` of `sessions` fn() calls, each in a profiler
    session of its own (a 30 k-launch session has dropped launches) that
    saw `want` launches of the port's kernels; a session that dropped
    some or recorded nothing (CUPTI has done both, now and then, once
    three times in a row a second apart, after a 6 k-launch session) is
    run again 1, 2, 4 and 8 s later. Where every attempt missed (one B1
    launch missed in every retry of a process has ended whole runs, and
    never showed in a fresh process), `fresh()` runs the same sessions
    in a new process, under the same check. Returns (the rows merged by
    kernel, the sessions run)."""
    merged, runs = {}, 0
    for _ in range(sessions):
        for attempt in range(attempts):
            if attempt:
                time.sleep(2.0 ** (attempt - 1))
            runs += 1
            rows = device_rows(fn)
            seen = sum(x[1] for x in rows if any(
                n in x[0] for n in ("smooth_kernel", "solve_kernel",
                                    "euler_kernel")))
            if rows and seen == want:
                break
        else:
            missed = ("the profiler missed launches", seen, want, rows[:5])
            if fresh is None:
                raise AssertionError(missed)
            log("profiler_fresh_process", missed=str(missed)[:300])
            rows, fresh_runs = fresh()
            return rows, runs + fresh_runs
        for key, n, t in rows:
            c, d = merged.get(key, (0, 0.0))
            merged[key] = (c + n, d + t)
    return sorted(((k, c, d) for k, (c, d) in merged.items()),
                  key=lambda x: -x[2]), runs


def profile_busy_ms(fn):
    """Device busy time (ms) and CUDA kernel launches of one fn() call."""
    rows = profile_rows(fn)
    return sum(x[2] for x in rows) / 1e3, sum(x[1] for x in rows)


def per_env_err(outs, refs):
    """(B,) the largest |out - ref| of each env over a tuple of outputs,
    each over the largest |ref| of the batch + 1e-9 (as rel_err, so an
    all-zero output such as an idle row's force is held absolutely); NaN
    where an output is not finite."""
    errs = [(o.double() - r.double()).abs().reshape(o.shape[0], -1)
            .amax(dim=1) / (r.double().abs().max() + 1e-9)
            for o, r in zip(outs, refs) if r.numel()]
    return torch.stack(errs).amax(dim=0)


def to_float64(x):
    """A copy of an env state or draws (dataclasses of tensors) with its
    float tensors in float64."""
    import dataclasses
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: to_float64(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(to_float64(v) for v in x)
    return x.double() if x.is_floating_point() else x


def settle(base, es, gen, n=20):
    """The batch after n env steps under zero actions."""
    from humanoid_mujoco_torch.rl import env as E
    act = torch.zeros((es.batch, base.nu), dtype=base.dtype,
                      device=base.device)
    for _ in range(n):
        es = E.batch_step(E.EnvConfig(standup=True), base, es, act, gen)[0]
    return es


def b2_vs_twin(m, qpos, qvel, ctrl, xfrc):
    """B2 against its twin on kernel B1's outputs: the max relative
    error per output."""
    from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
    from humanoid_mujoco_torch.physics.solver import (contact_dmask,
                                                      limit_rows_static)
    ker = fused_smooth.smooth_raw(m, qpos, qvel, ctrl, xfrc)
    solve_in = (ker[0], ker[1], qvel, *ker[2:7], contact_dmask(m),
                *ker[7:14], m.dt * m.dof_damping, m.dt)
    lim_tab = limit_rows_static(m)
    names = ("qacc", "qvel_new", "fslot", "qfrc_constraint")
    return {n: rel_err(r, o, n) for n, r, o in zip(
        names, fused_solver.solve_step_raw_reference(*solve_in,
                                                     lim_tab=lim_tab),
        fused_solver.solve_step_raw(*solve_in, lim_tab=lim_tab))}


def rl_smooth_per_env(base, es, timer, device, gen):
    """B1 with per-env packs against its twin on the same patched model,
    its bitwise repeat, a launch with every per-env leaf equal to the
    base model's against the shared-pack launch (bit for bit), a NaN env
    kept to itself, and B2 on these B1 outputs against its twin. Returns
    the phase's numbers and B1's per-env numbers for the kernel table."""
    import dataclasses
    from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
    from humanoid_mujoco_torch.physics.solver import (contact_dmask,
                                                      limit_rows_static)
    m = es.patch.apply(base)
    qpos, qvel, ctrl, xfrc = rl_inputs(base, es)
    B = qpos.shape[0]
    ker = fused_smooth.smooth_raw(m, qpos, qvel, ctrl, xfrc)
    ref = fused_smooth.smooth_raw_reference(m, qpos, qvel, ctrl, xfrc)
    errs = {n: rel_err(r, o, n)
            for n, r, o in zip(fused_smooth.NAMES, ref, ker)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, f"per-env B1 {worst}: {errs[worst]:.3e}"
    out = {"batch": B, "max_rel_err": errs[worst], "worst": worst,
           "tol": TOL, "errs": errs}
    lim_tab = limit_rows_static(m)
    if device != "cpu":
        again = fused_smooth.smooth_raw(m, qpos, qvel, ctrl, xfrc)
        assert all(torch.equal(a, b) for a, b in zip(ker, again)), \
            "per-env B1 differs between two launches"
        same = dataclasses.replace(es.patch, **{
            f.name: getattr(base, f.name).expand(
                getattr(es.patch, f.name).shape).contiguous()
            for f in dataclasses.fields(es.patch)})
        k_env = fused_smooth.smooth_raw(same.apply(base), qpos, qvel, ctrl,
                                        xfrc)
        k_shared = fused_smooth.smooth_raw(base, qpos, qvel, ctrl, xfrc)
        assert all(torch.equal(a, b) for a, b in zip(k_env, k_shared)), \
            "per-env packs equal to the base differ from the shared packs"
        env = 7
        qv = qvel.clone()
        qv[env, 3] = float("nan")
        poisoned = fused_smooth.smooth_raw(m, qpos, qv, ctrl, xfrc)
        rest = torch.arange(B, device=qv.device) != env
        nonfinite = [n for n, p in zip(fused_smooth.NAMES, poisoned)
                     if not bool(torch.isfinite(p[env]).all())]
        assert "qfrc_smooth" in nonfinite, nonfinite
        assert all(torch.equal(a[rest], b[rest])
                   for a, b in zip(ker, poisoned)), \
            "a NaN env changed another env's per-env B1 outputs"
        out.update(bitwise_repeat=True, equal_leaves_bitwise_shared=True,
                   nan_env=env, nonfinite_outputs=nonfinite,
                   others_bitwise_equal=True)
    # B2 on these outputs. At reset the humanoid lies in deep contact on
    # a bumpy floor, and on a few envs per thousand the solve is so
    # stiff that float32 rounding flips an edge's active set within the
    # 8 Newton iterations: B2 and its twin in float32 then each miss the
    # float64 solve, on different envs. So here B2 is held to the
    # float64 twin on all but 0.5% of the envs (its float32 twin's count
    # beside it), and to its float32 twin on every env of the same
    # batch after 20 env steps (`settle`)
    solve_in = (ker[0], ker[1], qvel, *ker[2:7], contact_dmask(m),
                *ker[7:14], m.dt * m.dof_damping, m.dt)
    k2 = fused_solver.solve_step_raw(*solve_in, lim_tab=lim_tab)
    r2 = fused_solver.solve_step_raw_reference(*solve_in, lim_tab=lim_tab)
    r64 = fused_solver.solve_step_raw_reference(
        *[t.double() if torch.is_tensor(t) else t for t in solve_in],
        lim_tab=lim_tab)
    e_k, e_t = per_env_err(k2, r64), per_env_err(r2, r64)
    out.update(
        solver_envs_over_tol_vs_float64=int((e_k > TOL).sum()),
        twin_envs_over_tol_vs_float64=int((e_t > TOL).sum()),
        solver_envs_over_tol_vs_twin=int((per_env_err(k2, r2) > TOL).sum()),
        solver_median_err_vs_float64=float(e_k.median()),
        twin_median_err_vs_float64=float(e_t.median()),
        penetrating_slots_mean=float(
            (ker[5] < 0).sum(dim=1).double().mean()),
        penetrating_slots_max=int((ker[5] < 0).sum(dim=1).max()))
    assert out["solver_envs_over_tol_vs_float64"] <= B // 200, out
    settled = settle(base, es, gen)
    errs2 = b2_vs_twin(settled.patch.apply(base), settled.phys.qpos,
                       settled.phys.qvel, ctrl, None)
    out.update(solver_settled_max_rel_err=max(errs2.values()),
               solver_settled_errs=errs2)
    assert out["solver_settled_max_rel_err"] <= TOL, errs2
    n1 = fused_smooth.LAUNCHES

    def per_env():
        return fused_smooth.smooth_raw(m, qpos, qvel, ctrl, xfrc)

    def shared():
        return fused_smooth.smooth_raw(base, qpos, qvel, ctrl, xfrc)
    t_env, t_shared = timer(per_env, 20), timer(shared, 20)
    k_env = device_ms(per_env, 20, "smooth_kernel")
    k_shared = device_ms(shared, 20, "smooth_kernel")
    t_twin = timer(lambda: fused_smooth.smooth_raw_reference(
        m, qpos, qvel, ctrl, xfrc), 3)
    fused_smooth.LAUNCHES = n1          # timing launches are not counted
    packs = fused_smooth._pack_params(m)
    nbytes, flops = smooth_cost(m, B, len(lim_tab), packs)
    nbytes_shared, _ = smooth_cost(base, B, len(lim_tab),
                                   fused_smooth._pack_params(base))
    bound_ms, bound_by = bound(nbytes, flops)
    out.update(kernel_ms=k_env, kernel_ms_shared_packs=k_shared,
               wrapper_ms=t_env, wrapper_ms_shared_packs=t_shared,
               plain_ms=t_twin, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, bytes_shared_packs=nbytes_shared)
    row = {"per_env_batch": B, "per_env_ms": k_env,
           "per_env_shared_packs_ms": k_shared,
           "per_env_wrapper_ms": t_env, "per_env_plain_ms": t_twin,
           "per_env_bound_ms": bound_ms, "per_env_bound_by": bound_by,
           "per_env_bytes": nbytes,
           "per_env_max_abs_err": max(
               float((r - o).abs().max()) for n, r, o in
               zip(fused_smooth.NAMES, ref, ker) if r.numel()
               and n != "dist")}
    return out, row


def rl_env_phase(base, timer, device, gen, B, nsteps):
    """The rl_env4096 cell: B envs (standup), reset at RL_RF, zero
    actions, `nsteps` batch_steps. Launches of B1 and B2 per env step
    from their counters, all kernel launches, device busy time and idle
    share from torch.profiler; wall time from CUDA events, median of 3
    after a warm-up; one env step with the kernels against the same step
    (the same draws) with the twins."""
    from humanoid_mujoco_torch.rl import env as E
    cfg = E.EnvConfig(standup=True)
    es0, _ = E.batch_reset(cfg, base, RL_RF, B, gen)
    act = torch.zeros((B, base.nu), dtype=base.dtype, device=device)
    diverged = []
    step = E.step

    def spy(*a, **kw):
        out = step(*a, **kw)
        diverged.append(out[1].diverged)
        return out

    def run():
        es = es0
        for _ in range(nsteps):
            es, obs, r, term, trunc = E.batch_step(cfg, base, es, act, gen)
        return es, obs, r

    run()                                            # warm-up
    counters_zero()
    E.step = spy
    try:
        es, obs, r = run()
    finally:
        E.step = step
    if device != "cpu":
        torch.cuda.synchronize()
    launches = counters()
    n_div = int(torch.stack(diverged).sum())
    assert n_div == 0, f"{n_div} env steps diverged"
    assert bool(torch.isfinite(obs).all() & torch.isfinite(r).all())
    ms = timer(run, 3) / nsteps
    out = {"gpu_batch": B, "steps": nsteps, "rf": RL_RF, "ms_per_env_step": ms,
           "env_steps_per_s": B / (ms * 1e-3), "launches": launches,
           "smooth_per_env_step": launches["smooth"] / nsteps,
           "solver_per_env_step": launches["solver"] / nsteps,
           "diverged": n_div, "mean_reward_last": float(r.mean())}
    if device != "cpu":
        assert launches["smooth"] == launches["solver"] == nsteps, launches
        rows = profile_rows(run)
        busy = sum(x[2] for x in rows) / 1e3 / nsteps
        out.update(
            cuda_launches_per_env_step=sum(x[1] for x in rows) / nsteps,
            device_busy_ms_per_env_step=busy,
            idle_share=1.0 - busy / ms if busy else None,
            top_kernels=[{"name": k[:60], "per_step": c / nsteps,
                          "ms_per_step": us / 1e3 / nsteps}
                         for k, c, us in rows[:6]])
    counters_zero()
    # one env step, kernels against twins, on the same draws: from the
    # reset, against the float64 twins on all but 0.5% of the envs (the
    # float32 twins' count beside it; see rl_smooth_per_env), and after
    # 20 steps (`settle`) against the float32 twins on every env
    d = E.draw_step(base, B, gen)
    k = E.env_step(cfg, base, es0, act, d)
    with twins():
        t = E.env_step(cfg, base, es0, act, d)
        t64 = E.env_step(
            cfg, E.rl_humanoid_model(dtype=torch.float64, device=device),
            to_float64(es0), act.double(), to_float64(d))
    e_k = per_env_err(env_outs(k), env_outs(t64))
    e_t = per_env_err(env_outs(t), env_outs(t64))
    out.update(step_envs_over_tol_vs_float64=int((e_k > TOL).sum()),
               twin_step_envs_over_tol_vs_float64=int((e_t > TOL).sum()),
               step_median_err_vs_float64=float(e_k.median()))
    assert out["step_envs_over_tol_vs_float64"] <= B // 200, out
    settled = settle(base, es0, gen)
    d = E.draw_step(base, B, gen)
    k = E.env_step(cfg, base, settled, act, d)
    with twins():
        t = E.env_step(cfg, base, settled, act, d)
    errs = {n: rel_err(b, a) for n, a, b in
            zip(("obs", "reward", "qpos", "qvel"), env_outs(k),
                env_outs(t))}
    out["settled_step_vs_twin"] = errs
    out["settled_step_vs_twin_max"] = max(errs.values())
    assert out["settled_step_vs_twin_max"] <= TOL, errs
    counters_zero()
    return out, launches


def param_snapshot(*modules):
    return [p.detach().clone() for mod in modules for p in mod.parameters()]


def changed(before, modules):
    after = param_snapshot(*modules)
    return all(not torch.equal(a, b) for a, b in zip(before, after))


def rl_train_phase(base, timer, device, gen, sac_kw=None, ppo_kw=None,
                   train_envs=RL_TRAIN_ENVS):
    """sac_train_step at SACConfig() (2 calls) and ppo_train_step at
    PPOConfig() (1 call), each timed, losses finite and parameters
    changed; then rl.train's main for 2 iterations into a directory under
    build/, a resume from its checkpoint to 3, and an uninterrupted
    3-iteration run: the resumed parameters must equal the uninterrupted
    ones to the bit. The first run's checkpoint is kept as
    build/rl_train_ckpt.pt (out["ckpt"]) for the evaluate phase."""
    import shutil
    import tempfile
    from humanoid_mujoco_torch.rl import env as E
    from humanoid_mujoco_torch.rl import ppo, sac, train
    cfg = E.EnvConfig(standup=True)
    out = {}
    scfg = sac.SACConfig(**(sac_kw or {}))
    st = sac.sac_init(scfg, cfg, base, RL_RF, gen)
    for i in range(2):
        before = param_snapshot(st.pi, st.q)
        holder = {}

        def call():
            holder["m"] = sac.sac_train_step(scfg, cfg, base, st)[1]
        ms = timer(call, 1)
        met = {k: float(v) for k, v in holder["m"].items()}
        assert all(np.isfinite(v) for v in met.values()), met
        assert changed(before, (st.pi, st.q)), "SAC left a parameter as it was"
        out[f"sac_call{i}"] = {"ms": ms, **met}
    out["sac"] = {"n_envs": scfg.n_envs, "batch_size": scfg.batch_size,
                  "rounds": scfg.steps_per_update,
                  "buffer_size": scfg.buffer_size,
                  "ms_per_round": out["sac_call1"]["ms"]
                  / scfg.steps_per_update}
    pcfg = ppo.PPOConfig(**(ppo_kw or {}))
    pst = ppo.ppo_init(pcfg, cfg, base, RL_RF, gen)
    before = param_snapshot(pst.pi, pst.v)
    holder = {}

    def pcall():
        holder["m"] = ppo.ppo_train_step(pcfg, cfg, base, pst)[1]
    ms = timer(pcall, 1)
    met = {k: float(v) for k, v in holder["m"].items()}
    assert all(np.isfinite(v) for v in met.values()), met
    assert changed(before, (pst.pi, pst.v)), "PPO left a parameter as it was"
    out["ppo_call0"] = {"ms": ms, "n_envs": pcfg.n_envs,
                        "rollout_len": pcfg.rollout_len, **met}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="rl_train_", dir=root)
    try:
        spi = 32 * train_envs
        common = ["--algo", "sac", "--envs", str(train_envs),
                  "--eval-every", "1", "--device", device, "--seed", "5"]
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        t0 = time.perf_counter()
        _, ckpt = train.main(common + ["--out", a, "--steps", str(2 * spi)])
        resumed, _ = train.main(common + ["--out", a, "--steps",
                                          str(3 * spi), "--ckpt", ckpt])
        fresh, _ = train.main(common + ["--out", b, "--steps",
                                        str(3 * spi)])
        out["train_main_s"] = time.perf_counter() - t0
        # the evaluate phase reads this checkpoint (SAC, 2 iterations)
        out["ckpt"] = shutil.copy(ckpt, os.path.join(root,
                                                     "rl_train_ckpt.pt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in ("pi", "q", "q_target"):
        ra, fa = (getattr(x, name).state_dict() for x in (resumed, fresh))
        assert all(torch.equal(ra[k], fa[k]) for k in ra), \
            f"resumed {name} differs from the uninterrupted run"
    assert torch.equal(resumed.log_alpha, fresh.log_alpha)
    out["resume_bitwise_equal"] = True
    return out


def run_rl(device="cuda", gpu="cpu", B=RL_BATCH, nsteps=RL_STEPS,
           sac_kw=None, ppo_kw=None, train_envs=RL_TRAIN_ENVS):
    """The RL slice's phases (rl_smooth_per_env, rl_env, rl_train).
    Returns the per-env numbers for B1's row and the RL launches of B1
    and B2."""
    from humanoid_mujoco_torch.rl import env as E
    timer = Timer(device)
    base = E.rl_humanoid_model(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    es, _ = E.batch_reset(E.EnvConfig(standup=True), base, 1.0, B, gen)
    phase, row = rl_smooth_per_env(base, es, timer, device, gen)
    log("rl_smooth_per_env", gpu=gpu, **phase)
    env_out, env_launches = rl_env_phase(base, timer, device, gen, B, nsteps)
    log("rl_env", gpu=gpu, **env_out)
    counters_zero()
    train_out = rl_train_phase(base, timer, device, gen, sac_kw, ppo_kw,
                               train_envs)
    train_launches = counters()
    log("rl_train", gpu=gpu, launches=train_launches, **train_out)
    if device != "cpu":
        assert train_launches["smooth"] > 0 and train_launches["solver"] > 0
        assert train_launches["euler"] == env_launches["euler"] == 0
    row.update(launches_rl_env=env_launches["smooth"],
               launches_rl_train=train_launches["smooth"])
    return row, {"launches_rl_env": env_launches["solver"],
                 "launches_rl_train": train_launches["solver"]}, \
        train_out["ckpt"]


# the serving slice: the Agent behind the TCP server, MPC in the env,
# policy evaluation
SERVE_PLANNERS = ("sampling", "mppi", "cem", "ilqg")
SERVE_REQUESTS, SERVE_ITERS = 20, 2
# iLQG's requests (~1.7 s each on the H100) and its MPC in the env: cut
# from 20, then 8, and 0.05 s to stay inside the time limit
SERVE_ILQG_REQUESTS = 4
MPC_IN_ENV_SECONDS, MPC_IN_ENV_RF = 0.2, 0.1
# MPC in the env with the default planner, iLQG: a shorter run than
# sampling's (each tick is two iLQG iterations, ~10x a sampling tick)
MPC_IN_ENV_ILQG_SECONDS = 0.03
EVAL_RFS, EVAL_EPISODES, EVAL_STEPS = (0.0, 1.0), 16, 100
# every n-th env step of mpc_in_env and evaluate held against the twins
MPC_CHECK_EVERY, EVAL_CHECK_EVERY = 2, 10


def serve_observations(m, n, seed=3):
    """n robot observations near the stand pose (numpy seed): joint
    angles + 0.03 N, joint velocities 0.1 N, angular velocity 0.05 N, the
    stand quaternion + 0.01 N, normalized."""
    from humanoid_mujoco_torch.physics import humanoid
    q0 = humanoid.stand_qpos(m).double().cpu().numpy()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        quat = q0[3:7] + 0.01 * rng.standard_normal(4)
        out.append(dict(
            joint_pos=(q0[7:] + 0.03 * rng.standard_normal(12)).tolist(),
            joint_vel=(0.1 * rng.standard_normal(12)).tolist(),
            ang_vel=(0.05 * rng.standard_normal(3)).tolist(),
            quat=(quat / np.linalg.norm(quat)).tolist()))
    return out


def serve_client(port, requests, result, timeout=120.0, period=0.0):
    """One TCP connection to 127.0.0.1:port; each request (bytes) sent
    after the reply to the one before, and `period` s after the one
    before at the earliest (a robot's control period). Fills
    result["replies"] and result["ms"] (client-side latency of each)."""
    import socket
    dec = json.JSONDecoder()
    replies, ms, buf = [], [], ""
    start = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as c:
        for i, req in enumerate(requests):
            wait = start + i * period - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            t0 = time.perf_counter()
            c.sendall(req)
            while True:
                try:
                    v, end = dec.raw_decode(buf.lstrip())
                    buf = buf.lstrip()[end:]
                    break
                except json.JSONDecodeError:
                    data = c.recv(65536)
                    if not data:
                        raise ConnectionError("the server closed")
                    buf += data.decode()
            ms.append(1e3 * (time.perf_counter() - t0))
            replies.append(v)
    result.update(replies=replies, ms=ms)


def serve_one_planner(m, planner, obs, device, requests,
                      nsample, horizon):
    """The Agent (`planner`) behind MPCServer on 127.0.0.1: `requests`
    JSON requests from a client thread, then a malformed one; replies 12
    finite floats, the malformed one an error. Kernel launches per
    request from the counters (set to 0 just before the client starts);
    then, not counted: position mode against the torque it converts,
    one request profiled (device busy, idle share against the median
    latency), and for the sampling planner one planner_step's candidate
    returns through the kernels against the twins on the same noise."""
    import threading
    from humanoid_mujoco_torch.agent import Agent
    from humanoid_mujoco_torch.serving import MPCServer
    from humanoid_mujoco_torch.serving.server import (
        TORQUE_TO_POSITION_MULTIPLIER)
    from humanoid_mujoco_torch.tasks import stand_task
    agent = Agent(m, stand_task(device=device), planner=planner,
                  nsample=nsample, horizon=horizon)
    srv = MPCServer(agent, planner_iterations=SERVE_ITERS, port=0)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    assert srv.listening.wait(30.0), "the server did not bind"
    srv.compute_action(**obs[0])                     # warm-up
    reqs = [json.dumps(o).encode() for o in obs[:requests]]
    reqs.append(b'{"joint_pos": [1, 2]}')
    result = {}
    counters_zero()
    client = threading.Thread(target=serve_client,
                              args=(srv.port, reqs, result), daemon=True)
    client.start()
    client.join(timeout=600.0)
    if device != "cpu":
        torch.cuda.synchronize()
    launches = counters()
    srv.stop()
    server.join(timeout=30.0)
    assert not client.is_alive() and not server.is_alive(), \
        "the client or the server did not finish"
    replies, ms = result["replies"], result["ms"][:requests]
    for r in replies[:requests]:
        assert isinstance(r, list) and len(r) == 12 \
            and np.all(np.isfinite(r)), r
    assert set(replies[-1]) == {"error"}, replies[-1]
    out = {"planner": planner, "requests": requests,
           "nsample": getattr(agent.cfg, "nsample", None),
           "horizon": agent.cfg.horizon,
           "planner_iterations": SERVE_ITERS,
           "median_ms": float(np.median(ms)),
           "p90_ms": float(np.percentile(ms, 90)),
           "max_ms": float(np.max(ms)),
           "control_hz": 1e3 / float(np.median(ms)),
           "launches_per_request": {k: v / requests
                                    for k, v in launches.items()}}
    if device != "cpu":
        # a sampling planner rolls its candidates out once an iteration,
        # iLQG twice (the nominal search, then the line search)
        steps = (SERVE_ITERS * agent.cfg.horizon
                 * (2 if planner == "ilqg" else 1))
        assert launches == {"smooth": steps * requests,
                            "solver": steps * requests, "euler": 0}, \
            launches
    # position mode: joint_pos + 0.3 * the torque it converts
    seen = []
    get_action = agent.get_action

    def spy(*a, **kw):
        seen.append(get_action(*a, **kw))
        return seen[-1]
    agent.get_action, srv.position_mode = spy, True
    pos = srv.compute_action(**obs[0])
    agent.get_action, srv.position_mode = get_action, False
    want = (np.asarray(obs[0]["joint_pos"])
            + TORQUE_TO_POSITION_MULTIPLIER * seen[0])
    assert np.allclose(pos, want, rtol=0, atol=1e-6), (pos, want)
    out["position_mode_ok"] = True
    # where a request's time goes: one planner_step (CUDA events, median
    # of 3; the request runs SERVE_ITERS of them after the search)
    out["planner_step_ms"] = Timer(device)(agent.planner_step, 3)
    if device != "cpu":
        busy, n = profile_busy_ms(lambda: srv.compute_action(**obs[1]))
        out.update(device_busy_ms_per_request=busy,
                   cuda_launches_per_request=n,
                   idle_share=1.0 - busy / out["median_ms"])
    if planner == "sampling":
        t0 = time.perf_counter()
        out["candidates_vs_twins"] = candidates_vs_twins(agent, device)
        out["candidates_wall_s"] = time.perf_counter() - t0
    return out


def candidates_vs_twins(agent, device, perturbations=3):
    """One planner_step's candidates (the agent's nominal from its state,
    64 candidates from seeded noise) through the kernels against the
    float64 twins, on the card, the float32 twins' numbers beside them:

    - every step of every candidate, in lockstep along the kernels'
      trajectory: the kernel step against the float64 twins' step from
      the same state and control, within TOL on all but 0.5% of the
      (candidate, step) pairs, as the RL phases hold B2 on reset states;
      a pair over TOL is a knife-edge step (a float32 rounding flips a
      contact or limit row's active set, ROADMAP "Knife-edge limit
      rows");
    - the candidates' returns against the float64 twins' rollouts of
      the same candidates, within TOL for every candidate that has no
      knife-edge step and whose return is well conditioned: the float64
      return moves by at most TOL when the start state is perturbed at
      the size of one step's kernel-to-twin difference (qpos 1e-6, qvel
      1e-5; `perturbations` seeded draws). A rollout that passes that
      close to a contact or limit row's switch parts at the switch, in
      float32 or float64 alike; such candidates are counted and
      reported, not asserted on.

    Errors are over the batch's largest value of each output."""
    from humanoid_mujoco_torch.mpc import make_plan_model
    from humanoid_mujoco_torch.ops.spline import spline_sample
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.physics.model import State
    from humanoid_mujoco_torch.physics.step import step
    from humanoid_mujoco_torch.planners.sampling import (plan_nominal,
                                                         sample_candidates)
    from humanoid_mujoco_torch.rollout import MAX_RETURN
    from humanoid_mujoco_torch.rollout import rollout_spline
    from humanoid_mujoco_torch.tasks import stand_task
    pm, cfg, state = agent.plan_model, agent.cfg, agent.state
    N = cfg.nsample
    nominal = plan_nominal(pm, cfg, agent.pstate, state, "check")
    g = torch.Generator(device=device)
    g.manual_seed(5)
    cands = sample_candidates(pm, cfg, nominal.values, generator=g)
    s0 = State(qpos=state.qpos.expand(N, -1), qvel=state.qvel.expand(N, -1),
               time=state.time.expand(N))
    pm64 = make_plan_model(humanoid.build_humanoid(
        dtype=torch.float64, device=device), agent.plan_dt)
    task64 = stand_task(dtype=torch.float64, device=device)

    def returns(m, task, s, cast):
        return rollout_spline(m, task, s, cast(nominal.times), cast(cands),
                              cfg.order, cfg.horizon,
                              solver_iters=cfg.solver_iters
                              ).total_return.double()

    def same(x):
        return x
    ker = returns(pm, agent.task, s0, same)
    with twins():
        tw = returns(pm, agent.task, s0, same)
        s64 = to_float64(s0)
        t64 = returns(pm64, task64, s64, to_float64)
        moved = torch.zeros_like(t64)
        for _ in range(perturbations):
            sp = State(
                qpos=s64.qpos + 1e-6 * torch.randn(
                    s64.qpos.shape, generator=g, device=device,
                    dtype=torch.float64),
                qvel=s64.qvel + 1e-5 * torch.randn(
                    s64.qvel.shape, generator=g, device=device,
                    dtype=torch.float64),
                time=s64.time)
            moved = torch.maximum(
                moved, (returns(pm64, task64, sp, to_float64) - t64).abs())
    lo, hi = pm.act_ctrlrange[:, 0], pm.act_ctrlrange[:, 1]
    # (candidate, step) errors against the float64 twins' step
    pair_k = torch.zeros((N, cfg.horizon), dtype=torch.float64,
                         device=device)
    pair_32 = torch.zeros_like(pair_k)
    s = s0
    for i in range(cfg.horizon):
        ctrl = torch.clamp(spline_sample(nominal.times, cands, s.time,
                                         cfg.order), lo, hi)
        k = step(pm, s, ctrl, solver_iters=cfg.solver_iters)[0]
        with twins():
            t32 = step(pm, s, ctrl, solver_iters=cfg.solver_iters)[0]
            ref = step(pm64, to_float64(s), ctrl.double(),
                       solver_iters=cfg.solver_iters)[0]
        ref = (ref.qpos, ref.qvel)
        pair_k[:, i] = per_env_err((k.qpos, k.qvel), ref)
        pair_32[:, i] = per_env_err((t32.qpos, t32.qvel), ref)
        s = k
    knife_pairs = (pair_k > TOL).cpu().numpy()
    step_k = pair_k.amax(dim=1).cpu().numpy()
    step_32 = pair_32.amax(dim=1).cpu().numpy()

    def rel(x):
        return ((x - t64).abs() / t64.abs().max()).cpu().numpy()
    err, err_32 = rel(ker), rel(tw)
    moved = (moved / t64.abs().max()).cpu().numpy()
    knife_step = knife_pairs.any(axis=1)
    ill = moved > TOL
    held = ~(knife_step | ill)
    out = {"candidates": N, "steps": cfg.horizon, "tol": TOL,
           "pairs": N * cfg.horizon,
           "knife_edge_pairs": int(knife_pairs.sum()),
           "twin_float32_knife_edge_pairs": int((pair_32 > TOL).sum()),
           "step_max_rel_err_vs_float64": float(step_k[~knife_step].max()),
           "step_median_rel_err_vs_float64": float(np.median(step_k)),
           "twin_step_median_rel_err_vs_float64": float(np.median(step_32)),
           "knife_edge_step_candidates": np.flatnonzero(knife_step).tolist(),
           "twin_float32_knife_edge_step_candidates":
               np.flatnonzero(step_32 > TOL).tolist(),
           "ill_conditioned_candidates": np.flatnonzero(ill).tolist(),
           "held_candidates": int(held.sum()),
           "returns_max_rel_err_vs_float64": float(err[held].max()),
           "twin_returns_max_rel_err_vs_float64": float(err_32[held].max()),
           "returns_over_tol": np.flatnonzero(err > TOL).tolist(),
           "twin_returns_over_tol": np.flatnonzero(err_32 > TOL).tolist(),
           "max_return": float(t64.max())}
    log("serving_candidates", **out)
    assert out["knife_edge_pairs"] <= int(0.005 * N * cfg.horizon), out
    assert held.sum() >= N // 3, out
    assert err[held].max() <= TOL, out
    return out


def root_height_check(m, obs, device, timer):
    """The root-height search: its time (CUDA events, median of 5), its
    device busy time and launches (torch.profiler) and, on every
    observation, the float32 pick against the float64 twin's:
    the same index, a neighbour (candidates 2.5 mm apart) or farther,
    with the scores."""
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.serving import (find_ideal_root_height,
                                               root_height_scores)
    o = obs[0]
    ms = timer(lambda: find_ideal_root_height(m, o["joint_pos"],
                                              o["quat"]), 5)
    out = {"root_height_ms": ms}
    if device != "cpu":
        busy, n = profile_busy_ms(lambda: find_ideal_root_height(
            m, o["joint_pos"], o["quat"]))
        out.update(root_height_busy_ms=busy, root_height_cuda_launches=n)
    m64 = humanoid.build_humanoid(dtype=torch.float64, device=device)
    picks = {"same": 0, "neighbour": 0, "farther": 0}
    worst = None
    for o in obs:
        zs, s32 = root_height_scores(m, o["joint_pos"], o["quat"])
        _, s64 = root_height_scores(m64, o["joint_pos"], o["quat"])
        assert bool(torch.isfinite(s32).all()), "non-finite scores"
        i32, i64 = int(torch.argmin(s32)), int(torch.argmin(s64))
        d = abs(i32 - i64)
        picks["same" if d == 0 else "neighbour" if d == 1
              else "farther"] += 1
        if d and (worst is None or d > worst["index_gap"]):
            worst = {"index_gap": d, "i32": i32, "i64": i64,
                     "f64_score_at_i32": float(s64[i32]),
                     "f64_score_at_i64": float(s64[i64]),
                     "f32_score_at_i32": float(s32[i32]),
                     "f32_score_at_i64": float(s32[i64])}
    return {**out, "observations": len(obs), "f32_vs_f64_pick": picks,
            "largest_gap": worst}


def swimmer_agent(device):
    """Agent("Swimmer" by registry id, sampling): one planner_step and
    one step, through the plain smooth stage and B3, the transition
    through _light_info. Each B3 launch of that run (the plan's 17
    rollout steps at the Agent's 64 candidates, the step at batch 1) is
    then held against B3's float32 twin on the same inputs within TOL,
    the float64 twin's error beside it."""
    from humanoid_mujoco_torch.agent import Agent
    from humanoid_mujoco_torch.physics import fused_solver
    from humanoid_mujoco_torch.tasks import home_qpos, task_model
    m = task_model("Swimmer", device=device)
    a = Agent(m, "Swimmer", planner="sampling")
    a.set_state(qpos=home_qpos("Swimmer", m))
    counters_zero()
    with record([fused_solver], "solve_constraints_euler") as rec:
        best = a.planner_step()
        u = a.step()
    if device != "cpu":
        torch.cuda.synchronize()
    n = counters()
    assert np.isfinite(best) and np.all(np.isfinite(u))
    if device != "cpu":
        assert n == {"smooth": 0, "solver": 0,
                     "euler": a.cfg.horizon + 1}, n
    names = ("qacc", "qvel_new", "efc_force", "qfrc_constraint")
    worst, worst64 = {}, {}
    for args, kw, ker in rec.calls:
        ref = fused_solver.solve_constraints_euler_reference(*args, **kw)
        ref64 = fused_solver.solve_constraints_euler_reference(
            *[x.double() if torch.is_tensor(x) else x for x in args], **kw)
        for nm, r, r64, o in zip(names, ref, ref64, ker):
            if r.numel():
                worst[nm] = max(worst.get(nm, 0.0), rel_err(r, o, nm))
                worst64[nm] = max(worst64.get(nm, 0.0), rel_err(r64, o, nm))
    out = {"best_return": best, "launches": n,
           "b3_calls_vs_twin": len(rec.calls),
           "b3_batches": sorted({c[0][0].shape[0] for c in rec.calls}),
           "b3_max_rel_err_vs_twin": max(worst.values()),
           "b3_max_rel_err_vs_float64": max(worst64.values()),
           "tol": TOL, "b3_errs_vs_twin": worst}
    assert out["b3_max_rel_err_vs_twin"] <= TOL, out
    return out


def ilqg_rollouts_vs_twins(calls, pm, device):
    """The `step` calls of one iLQG iteration's rollouts (the nominal
    search at batch 4, the line search at batch 8, through B1 and B2)
    against the same steps through the float64 twins, the float32 twins'
    numbers beside them: each (rollout, step) pair's largest error in
    qpos and qvel over the batch's largest value, within TOL on all but
    0.5% of the pairs, as `candidates_vs_twins` holds a sampling plan's
    steps."""
    from humanoid_mujoco_torch.mpc import make_plan_model
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.physics.step import step
    pm64 = make_plan_model(humanoid.build_humanoid(
        dtype=torch.float64, device=device), float(pm.dt))
    e_k, e_t, batches = [], [], {}
    for (m, s, u), kw, out in calls:
        batches[s.batch] = batches.get(s.batch, 0) + 1
        with twins():
            t32 = step(m, s, u, **kw)[0]
            t64 = step(pm64, to_float64(s), u.double(), **kw)[0]
        ref = (t64.qpos, t64.qvel)
        e_k.append(per_env_err((out[0].qpos, out[0].qvel), ref))
        e_t.append(per_env_err((t32.qpos, t32.qvel), ref))
    e_k, e_t = torch.cat(e_k), torch.cat(e_t)
    out = {"steps_by_batch": batches, "pairs": e_k.numel(), "tol": TOL,
           "pairs_over_tol_vs_float64": int((e_k > TOL).sum()),
           "twin_pairs_over_tol_vs_float64": int((e_t > TOL).sum()),
           "max_rel_err_vs_float64": float(e_k.max()),
           "median_rel_err_vs_float64": float(e_k.median()),
           "twin_max_rel_err_vs_float64": float(e_t.max())}
    assert out["pairs_over_tol_vs_float64"] <= int(0.005 * e_k.numel()), out
    return out


def derivatives_vs_float64(agent, perturbations=2, seed=6):
    """The card's float32 `trajectory_derivatives` along the agent's
    nominal (a stand state's plan) against the float64 twin on the CPU
    (the same function, same nominal): for each knot, each leaf's (A, B,
    cx, cu, cxx, cxu, cuu) largest error over that knot's largest value,
    within TOL on every knot that is not knife-edge. A knife-edge knot is
    one whose float64 linearization itself moves by more than TOL when
    the nominal's states move by one float32 step's error (qpos 1e-6,
    qvel 1e-5, `perturbations` seeded draws): a contact or limit row at
    its switch there. Those are listed, not asserted on."""
    import dataclasses
    from humanoid_mujoco_torch.mpc import make_plan_model
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.planners.derivatives import (
        trajectory_derivatives)
    from humanoid_mujoco_torch.tasks import stand_task
    p = agent.pstate.policy
    t0 = time.perf_counter()
    d32 = trajectory_derivatives(agent.plan_model, agent.task, p.qpos_nom,
                                 p.qvel_nom, p.u_nom, p.times)
    if p.qpos_nom.is_cuda:
        torch.cuda.synchronize()
    card_ms = 1e3 * (time.perf_counter() - t0)
    pm64 = make_plan_model(humanoid.build_humanoid(
        dtype=torch.float64, device="cpu"), agent.plan_dt)
    task64 = stand_task(dtype=torch.float64, device="cpu")
    qp, qv, u, t = (x.double().cpu() for x in (p.qpos_nom, p.qvel_nom,
                                               p.u_nom, p.times))

    def derivs(qp, qv):
        d = trajectory_derivatives(pm64, task64, qp, qv, u, t)
        return {f.name: getattr(d, f.name) for f in dataclasses.fields(d)}

    def knot_err(a, ref):
        return {k: ((a[k].double().cpu() - r).abs().flatten(1).amax(1)
                    / (r.abs().flatten(1).amax(1) + 1e-12))
                for k, r in ref.items()}
    d64 = derivs(qp, qv)
    err = knot_err({f.name: getattr(d32, f.name)
                    for f in dataclasses.fields(d32)}, d64)
    g = torch.Generator().manual_seed(seed)
    moved = torch.zeros(u.shape[0], dtype=torch.float64)
    for _ in range(perturbations):
        dp = derivs(qp + 1e-6 * torch.randn(qp.shape, generator=g,
                                            dtype=torch.float64),
                    qv + 1e-5 * torch.randn(qv.shape, generator=g,
                                            dtype=torch.float64))
        moved = torch.maximum(moved, torch.stack(
            list(knot_err(dp, d64).values())).amax(dim=0))
    worst = torch.stack(list(err.values())).amax(dim=0)
    knife = moved > TOL
    held = ~knife
    out = {"knots": int(u.shape[0]), "tol": TOL,
           "card_float32_ms": card_ms,
           "max_rel_err_by_leaf": {k: float(v[held].max())
                                   for k, v in err.items()},
           "knot_max_rel_err": worst.tolist(),
           "knife_edge_knots": torch.nonzero(knife).flatten().tolist(),
           "knife_edge_knot_errs": worst[knife].tolist(),
           "float64_moved_by_perturbation": moved.tolist(),
           "held_knots": int(held.sum())}
    assert held.sum() >= u.shape[0] // 2, out
    assert float(worst[held].max()) <= TOL, out
    return out


def ilqg_checks(m, obs, device, timer, horizon=17):
    """One iLQG iteration of an Agent at its defaults (horizon 17, plan
    dt 0.02, 8 line-search alphas) from a served observation's state,
    after one iteration to give it gains: the wall time of its stages
    (the two batched rollouts, the linearization, the backward pass;
    `timed`), its rollout steps against the
    float64 twins (`ilqg_rollouts_vs_twins`); the linearization along
    the new nominal against the float64 twin (`derivatives_vs_float64`);
    B1 and B2 on that iteration's own inputs at batch 4 (the nominal
    search) and 8 (the line search): against their twins, each kernel's
    device time a launch (`kernel_ms`), its wrapper's
    time (CUDA events, median of 20) beside its twin's (median of 5) and
    its bound (`smooth_cost`, `solve_cost` on these inputs). Returns the
    log and the kernel rows' additions; the timing launches are taken
    off the counters."""
    from humanoid_mujoco_torch import kernels
    from humanoid_mujoco_torch.agent import Agent
    from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
    from humanoid_mujoco_torch.physics.solver import limit_rows_static
    from humanoid_mujoco_torch.planners import ilqg as P
    from humanoid_mujoco_torch.serving import set_robot_state
    from humanoid_mujoco_torch.tasks import stand_task
    agent = Agent(m, stand_task(device=device), horizon=horizon)
    o = obs[0]
    agent.state = set_robot_state(m, o["joint_pos"], o["joint_vel"],
                                  o["ang_vel"], o["quat"])
    agent.planner_step()
    n0, n1 = fused_smooth.LAUNCHES, fused_solver.LAUNCHES
    stages = {}
    with record([P], "step") as steps, \
            record([fused_smooth], "smooth_raw") as b1, \
            record([fused_solver], "solve_step_raw") as b2, \
            timed(P, ("_feedback_rollout", "trajectory_derivatives",
                      "backward_pass"), stages):
        t0 = time.perf_counter()
        best = agent.planner_step()
        stages["planner_step_ms"] = 1e3 * (time.perf_counter() - t0)
    out = {"best_return": best, "reg": float(agent._last_info.reg),
           "alpha": float(agent._last_info.alpha), "stage_ms": stages,
           "rollouts_vs_twins": ilqg_rollouts_vs_twins(
               steps.calls, agent.plan_model, device),
           "derivatives_vs_float64": derivatives_vs_float64(agent)}
    nlim = len(limit_rows_static(m))
    rows = ({}, {})
    for B in (4, 8):
        a1, kw1, ker1 = next(c for c in b1.calls if c[0][1].shape[0] == B)
        a2, kw2, ker2 = next(c for c in b2.calls if c[0][0].shape[0] == B)
        ref1 = fused_smooth.smooth_raw_reference(*a1, **kw1)
        ref2 = fused_solver.solve_step_raw_reference(*a2, **kw2)
        err1 = max(rel_err(r, k, n) for n, r, k in
                   zip(fused_smooth.NAMES, ref1, ker1))
        err2 = max(rel_err(r, k) for r, k in zip(ref2, ker2))
        assert err1 <= TOL and err2 <= TOL, (B, err1, err2)
        t1 = timer(lambda: fused_smooth.smooth_raw(*a1, **kw1), 20)
        tr1 = timer(lambda: fused_smooth.smooth_raw_reference(*a1, **kw1),
                    5)
        t2 = timer(lambda: fused_solver.solve_step_raw(*a2, **kw2), 20)
        tr2 = timer(lambda: fused_solver.solve_step_raw_reference(*a2,
                                                                  **kw2), 5)
        M, qf, qv = a2[:3]
        raw = a2[3:8] + a2[9:16]
        _, _, f, trace = solve_trace(M, qf, qv, raw, a2[8], kw2["lim_tab"])
        bb1 = bound(*smooth_cost(m, B, nlim, fused_smooth._pack_params(m)))
        bb2 = bound(*solve_cost(m, B, a2[8], kw2["lim_tab"], f, trace))
        k1 = k2 = None
        if device != "cpu":
            ins, outs, meta, ints = fused_smooth._smooth_launch_args(*a1)
            p1 = [None if t is None or t.numel() == 0 else t.data_ptr()
                  for t in ins + outs] + [meta.data_ptr(), *ints]
            k1 = kernel_ms(lambda: kernels.launch("smooth", *p1))
            ins, ints, outs = fused_solver._solver_launch_args(
                *a2, kw2["lim_tab"], kw2["niter"], 16)
            p2 = [t.data_ptr() for t in ins + outs] + list(ints)
            k2 = kernel_ms(lambda: kernels.launch("solver", *p2))
        for row, err, k, t, tr, (bms, by) in (
                (rows[0], err1, k1, t1, tr1, bb1),
                (rows[1], err2, k2, t2, tr2, bb2)):
            row.update({f"ms_batch{B}": k, f"wrapper_ms_batch{B}": t,
                        f"plain_ms_batch{B}": tr, f"bound_ms_batch{B}": bms,
                        f"bound_by_batch{B}": by,
                        f"max_rel_err_batch{B}": err})
    # timing launches are not main-path launches
    fused_smooth.LAUNCHES, fused_solver.LAUNCHES = n0, n1
    out["kernels_at_batch_4_and_8"] = {"smooth": rows[0], "solver": rows[1]}
    return out, rows


def run_serving(device="cuda", gpu="cpu", ckpt=None,
                planners=SERVE_PLANNERS, requests=SERVE_REQUESTS,
                nsample=64, horizon=17, mpc_seconds=MPC_IN_ENV_SECONDS,
                mpc_ilqg_seconds=MPC_IN_ENV_ILQG_SECONDS,
                eval_episodes=EVAL_EPISODES, eval_steps=EVAL_STEPS):
    """The serving slice's phases: `serving` (each planner behind the
    TCP server, the root-height search), `serving_ilqg` (`ilqg_checks`),
    `mpc_in_env_ilqg` (the default planner), `mpc_in_env` (sampling)
    and `evaluate` (on `ckpt`, rl_train's checkpoint, removed
    afterwards), each MPC and evaluate run with its env steps held
    against the twins (`env_steps_vs_twins`: every MPC_CHECK_EVERY-th
    step of mpc_in_env at batch 1, every EVAL_CHECK_EVERY-th of evaluate
    at its episodes' batch), and `swimmer_agent`; then
    `serving_walls`, the host wall time of each. Returns the launches
    of B1, B2 and B3 on these paths for the kernel table."""
    import shutil
    import tempfile
    from humanoid_mujoco_torch import mpc_in_env
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.rl import env as E
    from humanoid_mujoco_torch.rl import evaluate as V
    t_all = time.perf_counter()
    walls = {}
    timer = Timer(device)
    m = humanoid.build_humanoid(device=device)
    obs = serve_observations(m, requests)
    per = []
    for p in planners:
        t0 = time.perf_counter()
        n_req = min(requests, SERVE_ILQG_REQUESTS) if p == "ilqg" \
            else requests
        per.append(serve_one_planner(m, p, obs, device, n_req, nsample,
                                     horizon))
        walls[f"serving_{p}_s"] = time.perf_counter() - t0
        if "candidates_wall_s" in per[-1]:
            walls["serving_candidates_s"] = per[-1]["candidates_wall_s"]
    t0 = time.perf_counter()
    height = root_height_check(m, obs, device, timer)
    walls["root_height_s"] = time.perf_counter() - t0
    log("serving", gpu=gpu, planners=per, **height)
    t0 = time.perf_counter()
    ilqg, ilqg_rows = ilqg_checks(m, obs, device, timer, horizon)
    walls["serving_ilqg_checks_s"] = time.perf_counter() - t0
    log("serving_ilqg", gpu=gpu, **ilqg)

    counters_zero()
    t0 = time.perf_counter()
    with record([E], "env_step", MPC_CHECK_EVERY) as rec:
        out = mpc_in_env.run(seconds=mpc_ilqg_seconds,
                             randomization_factor=MPC_IN_ENV_RF,
                             device=device, verbose=False)
    wall = time.perf_counter() - t0
    mie_ilqg = counters()
    t0 = time.perf_counter()
    mie_check = env_steps_vs_twins(rec.calls, device)
    walls.update(mpc_in_env_ilqg_s=wall,
                 mpc_in_env_ilqg_check_s=time.perf_counter() - t0)
    log("mpc_in_env_ilqg", gpu=gpu, seconds=mpc_ilqg_seconds,
        rf=MPC_IN_ENV_RF, planner="ilqg", wall_s=wall, launches=mie_ilqg,
        env_steps_vs_twins=mie_check, **out)
    assert out["steps"] > 0 and np.isfinite(out["mean_reward"]), out
    assert rec.n == out["steps"], (rec.n, out)
    if device != "cpu":
        assert mie_ilqg["smooth"] > 0 and mie_ilqg["solver"] > 0, mie_ilqg

    counters_zero()
    t0 = time.perf_counter()
    with record([E], "env_step", MPC_CHECK_EVERY) as rec:
        out = mpc_in_env.run(seconds=mpc_seconds,
                             randomization_factor=MPC_IN_ENV_RF,
                             planner="sampling", device=device,
                             verbose=False)
    wall = time.perf_counter() - t0
    mie = counters()
    t0 = time.perf_counter()
    mie_check = env_steps_vs_twins(rec.calls, device)
    walls.update(mpc_in_env_s=wall,
                 mpc_in_env_check_s=time.perf_counter() - t0)
    log("mpc_in_env", gpu=gpu, seconds=mpc_seconds, rf=MPC_IN_ENV_RF,
        planner="sampling", wall_s=wall, launches=mie,
        env_steps_vs_twins=mie_check, **out)
    assert out["steps"] > 0 and np.isfinite(out["mean_reward"]), out
    assert rec.n == out["steps"], (rec.n, out)
    if device != "cpu":
        assert mie["smooth"] > 0 and mie["solver"] > 0, mie

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="evaluate_", dir=root)
    try:
        counters_zero()
        t0 = time.perf_counter()
        with record([E, V], "env_step", EVAL_CHECK_EVERY) as rec:
            rows = V.evaluate(ckpt, rand_factors=EVAL_RFS,
                              n_episodes=eval_episodes,
                              max_steps=eval_steps, out=tmp, device=device)
        wall = time.perf_counter() - t0
        ev = counters()
        written = sorted(os.listdir(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        os.remove(ckpt)
    t0 = time.perf_counter()
    ev_check = env_steps_vs_twins(rec.calls, device)
    walls.update(evaluate_s=wall, evaluate_check_s=time.perf_counter() - t0)
    log("evaluate", gpu=gpu, episodes=eval_episodes, max_steps=eval_steps,
        wall_s=wall, launches=ev, rows=rows, files=written,
        env_steps_vs_twins=ev_check)
    assert "eval.csv" in written, written
    assert all(np.all(np.isfinite(list(r.values()))) for r in rows), rows
    if device != "cpu":
        assert ev["smooth"] > 0 and ev["solver"] > 0, ev

    t0 = time.perf_counter()
    sw = swimmer_agent(device)
    walls["swimmer_agent_s"] = time.perf_counter() - t0
    log("swimmer_agent", gpu=gpu, **sw)
    log("serving_walls", **walls, total_s=time.perf_counter() - t_all)
    serve = per[0]["launches_per_request"]
    serve_ilqg = next(p for p in per if p["planner"] == "ilqg")[
        "launches_per_request"]
    return ({"launches_serving_per_request": serve["smooth"],
             "launches_ilqg_per_request": serve_ilqg["smooth"],
             "launches_mpc_in_env": mie["smooth"],
             "launches_mpc_in_env_ilqg": mie_ilqg["smooth"],
             "launches_evaluate": ev["smooth"], **ilqg_rows[0]},
            {"launches_serving_per_request": serve["solver"],
             "launches_ilqg_per_request": serve_ilqg["solver"],
             "launches_mpc_in_env": mie["solver"],
             "launches_mpc_in_env_ilqg": mie_ilqg["solver"],
             "launches_evaluate": ev["solver"], **ilqg_rows[1]},
            {"launches_swimmer_agent": sw["launches"]["euler"]})


# the task slice: the sphere-and-joint tier of the task library, each
# task's model at its published size, float32
TASK_NAMES = ("Acrobot", "Cartpole", "Humanoid Cap Walk", "Particle",
              "ParticleFixed", "Quadruped Flat", "Quadruped Hill", "Walker")
# the contact-rich family: capsules, boxes, fixed tendons, gravcomp and
# site actuators, every model on the step's "contact" route (the plain
# smooth stage, collide, then B2 over all slots)
CONTACT_MODELS = ("Humanoid Stand", "Humanoid Track", "OP3", "Panda",
                  "PickAndPlace", "FreeFingers", "Quadrotor",
                  "Bimanual Handover")
# the top-k tier: models whose step keeps its top-k contact selection
# (nv·(nlim + 10 ncon) over 16384), so that B2 solves the k smallest gaps
# with their per-env chain mask; Rubik at nv 36 (B2's two rows a lane)
TOPK_MODELS = ("Allegro", "Shadow", "Bimanual Insert", "Bimanual Reorient",
               "Humanoid Interact", "Rubik")
TASK_ROUTES = {"Humanoid Cap Walk": "smooth", "Walker": "smooth",
               "Quadruped Flat": "smooth", "Quadruped Hill": "contact",
               "Cartpole": "rows", "Acrobot": "free", "Particle": "free",
               "ParticleFixed": "free",
               **dict.fromkeys(CONTACT_MODELS + TOPK_MODELS, "contact")}
ROUTE_LAUNCHES = {"smooth": {"smooth": 1, "solver": 1, "euler": 0},
                  "contact": {"smooth": 0, "solver": 1, "euler": 0},
                  "rows": {"smooth": 0, "solver": 0, "euler": 1},
                  "free": {"smooth": 0, "solver": 0, "euler": 0}}
# the models the rollouts run (ParticleFixed shares Particle's model)
TASK_ROLLOUTS = ("Walker", "Quadruped Flat", "Quadruped Hill",
                 "Humanoid Cap Walk", "Cartpole", "Acrobot",
                 "Particle") + CONTACT_MODELS + TOPK_MODELS
# the models whose kernels are held against their twins
TASK_KERNELS = ("Walker", "Quadruped Flat", "Quadruped Hill",
                "Cartpole") + CONTACT_MODELS + TOPK_MODELS
TASK_SETTLE = 50
# the models on which B2's per-env launch of the broadcast static mask is
# held to the static launch, bit for bit
PER_ENV_CHECK = ("Bimanual Handover", "Humanoid Cap Walk")
TASK_BATCHES = (BENCH_BATCH, 300, 1)
# the family's rollouts are timed once, by their counted run (a
# 1024 x 100 rollout of ~3,000 launches a step takes 2-7 s); one
# step_rk4 of the settled states at this batch
CONTACT_RK4_BATCH = 64
# the closed loops of the JAX package's own task tests
# (tests/test_tasks_suite.py), at their settings; the one depth cut:
# Cartpole's iLQG swing-up runs 8 iterations, not 20 (the float32 port
# crosses 0.85 of the first return at the 7th, on the CPU and the card)
CARTPOLE_ILQG_ITERS = 8
# the family's loops: Panda's hold and iLQG on Humanoid Stand, cut
CONTACT_HOLD_STEPS, CONTACT_ILQG_TICKS = 150, 2
# the top-k tier's loops, at the JAX tests' lengths
HAND_HOLD_STEPS, REORIENT_SETTLE_STEPS = 300, 200
# cut for the time limit: the contact family's and the top-k
# tier's rollouts run 1024 x 50, not 100 (each a single counted run of
# 47-81 ms a step), and the task agents plan at horizon 8, not 17
CONTACT_ROLLOUT_HORIZON, TASK_AGENT_HORIZON = 50, 8


def task_states(name, m, B, seed=0):
    """B states of task `name` on m's device (numpy seed): the home
    keyframe plus noise (joints 0.03-0.05 N, or 0.3 N on the planar
    models' coordinates; qvel 0.1 N), controls uniform in the middle 40%
    of the range (the quadruped: the home servo targets + 0.05 N).
    Quadruped Hill's trunks stand at the keyframe height over the
    terrain at points around the hill (radius 0.5-2.5 m); Cartpole's
    carts spread over the rail and into its limits. The contact family:
    every hinge and slide + 0.03 N; controls the humanoid's 0.1 N, OP3's
    keyframe servo targets + 0.05 N, the bimanual models' home targets +
    0.02 N, the Quadrotor's hover thrust + 0.5 N with half the craft
    standing on the floor, the others in the middle 40%; the top-k tier
    as the family."""
    from humanoid_mujoco_torch.physics.model import JointType
    from humanoid_mujoco_torch.tasks import aloha, home_qpos
    from humanoid_mujoco_torch.tasks.quadruped import home_ctrl
    from humanoid_mujoco_torch.tasks.quadruped_hill import hill_height_np
    rng = np.random.default_rng(seed)
    nq, nv, nu = m.nq, m.nv, m.nu
    qpos = np.tile(home_qpos(name, m).double().cpu().numpy(), (B, 1))
    qvel = 0.1 * rng.standard_normal((B, nv))
    lo, hi = m.act_ctrlrange.double().cpu().numpy().T
    ctrl = rng.uniform(lo + 0.3 * (hi - lo), hi - 0.3 * (hi - lo), (B, nu))
    if name in CONTACT_MODELS + TOPK_MODELS:
        s = m.struct
        for j in range(s.njnt):
            if s.jnt_type[j] in (JointType.HINGE, JointType.SLIDE):
                qpos[:, s.jnt_qadr[j]] += 0.03 * rng.standard_normal(B)
        if name.startswith("Humanoid"):
            ctrl = 0.1 * rng.standard_normal((B, nu))
        elif name == "OP3":
            ctrl = qpos[:1, 7:] + 0.05 * rng.standard_normal((B, nu))
        elif name.startswith("Bimanual"):
            ctrl = aloha.home_ctrl(m).double().cpu().numpy() \
                + 0.02 * rng.standard_normal((B, nu))
        elif name == "Quadrotor":
            ctrl = 1.325 * 9.81 / 4 + 0.5 * rng.standard_normal((B, 4))
            qpos[: B // 2, 2] = 0.019
        ctrl = np.clip(ctrl, lo, hi)
    elif name.startswith("Quadruped"):
        qpos[:, 7:] += 0.03 * rng.standard_normal((B, 12))
        ctrl = home_ctrl(m).double().cpu().numpy() \
            + 0.05 * rng.standard_normal((B, 12))
        if name == "Quadruped Hill":
            th = rng.uniform(0.0, 2 * np.pi, B)
            r = rng.uniform(0.5, 2.5, B)
            qpos[:, 0], qpos[:, 1] = r * np.cos(th), r * np.sin(th)
            qpos[:, 2] = hill_height_np(qpos[:, 0], qpos[:, 1]) + 0.27
    elif name == "Humanoid Cap Walk":
        qpos[:, 7:] += 0.03 * rng.standard_normal((B, 12))
        ctrl = 0.3 * rng.standard_normal((B, nu))
    elif name == "Walker":
        qpos[:, 1:] += 0.05 * rng.standard_normal((B, nq - 1))
    elif name == "Cartpole":
        qpos[:, 0] = rng.uniform(-1.85, 1.85, B)
        qpos[:, 1] = rng.uniform(-np.pi, np.pi, B)
        qvel = 0.5 * rng.standard_normal((B, nv))
    else:
        qpos += 0.3 * rng.standard_normal((B, nq))
    return tuple(torch.tensor(x, dtype=m.dtype, device=m.device)
                 for x in (qpos, qvel, ctrl))


def settled_states(name, m, B, seed=0, n=TASK_SETTLE):
    """`task_states` after n steps under their controls, so that feet
    carry load."""
    from humanoid_mujoco_torch.physics.model import State
    from humanoid_mujoco_torch.physics.step import step
    qpos, qvel, ctrl = task_states(name, m, B, seed)
    s = State(qpos=qpos, qvel=qvel,
              time=torch.zeros(B, dtype=m.dtype, device=m.device))
    for _ in range(n):
        s, info = step(m, s, ctrl)
    assert not bool(info.diverged.any()), f"{name}: settling diverged"
    return s.qpos, s.qvel, ctrl


def contact_solve_inputs(m, qpos, qvel, ctrl):
    """Kernel B2's inputs of the "contact" route (the plain smooth stage,
    collision, the top-k selection where the step keeps it, the raw
    contact and limit data): the 18 arguments of solve_step_raw before
    lim_tab, the mask per env (B, k, nv) after a selection."""
    from humanoid_mujoco_torch.physics.collision import (collide,
                                                         select_contacts)
    from humanoid_mujoco_torch.physics.engine import prepare_smooth
    from humanoid_mujoco_torch.physics.solver import (contact_raw,
                                                      limit_rows_data)
    from humanoid_mujoco_torch.physics.step import keeps_selection
    kin, _, M, qf = prepare_smooth(m, qpos, qvel, ctrl)
    c, sel = collide(m, kin.xpos, kin.xmat), None
    if keeps_selection(m):
        c, sel = select_contacts(c, m.struct.max_contacts)
    dmask, rel, mu3, kc, bc, dc = contact_raw(m, kin, c, sel)
    lpos, kl, bl, dl = limit_rows_data(m, qpos)
    return (M, qf, qvel, kin.cdof, rel, c.normal, c.dist, mu3, dmask, kc,
            bc, dc, lpos, kl, bl, dl, m.dt * m.dof_damping, m.dt)


def route_solve_inputs(way, m, qpos, qvel, ctrl):
    """The solve kernel's inputs on `way`, the model's step route: B2's
    18 arguments before lim_tab from B1's float32 twin ("smooth") or
    from `contact_solve_inputs` ("contact"), B3's 10 from
    `swimmer_solve_inputs` ("rows")."""
    from humanoid_mujoco_torch.physics import fused_smooth
    from humanoid_mujoco_torch.physics.solver import contact_dmask
    if way == "contact":
        return contact_solve_inputs(m, qpos, qvel, ctrl)
    if way == "rows":
        return swimmer_solve_inputs(m, qpos, qvel, ctrl)
    ref = fused_smooth.smooth_raw_reference(m, qpos, qvel, ctrl)
    return (ref[0], ref[1], qvel, *ref[2:7], contact_dmask(m), *ref[7:14],
            m.dt * m.dof_damping, m.dt)


def b2_kw(m, dmask, lim_tab):
    """Kernel B2's keywords for this model and mask: lim_tab, and with a
    per-env mask the chain area the step sizes (the model's k longest
    slot chains, `fused_solver.chain_bound`)."""
    from humanoid_mujoco_torch.physics import fused_solver
    from humanoid_mujoco_torch.physics.solver import contact_dmask
    kw = {"lim_tab": lim_tab}
    if dmask.ndim == 3:
        kw["chain_max"] = fused_solver.chain_bound(contact_dmask(m),
                                                   dmask.shape[1])
    return kw


def against_twins(solve, twin, args, kw, names):
    """A solve kernel (B2 or B3) against its float32 and float64 twins
    on the same inputs: the max relative error per output against the
    float32 twin, and per env against the float64 twin (`per_env_err`),
    whose envs over TOL or not finite may be at most 0.5% of the batch
    (a rounding that flips an active set; the float32 twin's count
    beside it)."""
    ker = solve(*args, **kw)
    r32 = twin(*args, **kw)
    r64 = twin(*[a.double() if torch.is_tensor(a) else a for a in args],
               **kw)
    B = args[0].shape[0]
    e_k, e_t = per_env_err(ker, r64), per_env_err(r32, r64)
    out = {"batch": B,
           "errs_vs_twin": {n: rel_err(r, o, n)
                            for n, r, o in zip(names, r32, ker)},
           "envs_over_tol_vs_float64": int((~(e_k <= TOL)).sum()),
           "twin_envs_over_tol_vs_float64": int((~(e_t <= TOL)).sum()),
           "max_err_vs_float64_held": float(e_k.sort().values[
               B - 1 - B // 200]),
           "max_abs_err": max(float((r - o).abs().max())
                              for r, o in zip(r32, ker) if r.numel())}
    out["max_rel_err_vs_twin"] = max(out["errs_vs_twin"].values())
    assert out["envs_over_tol_vs_float64"] <= B // 200, out
    return ker, out


def bare_kernel_ms(name, launch_args, device):
    """`kernel_ms` of kernel `name`'s C entry on the arguments its
    wrapper builds (`launch_args`, from fused_smooth._smooth_launch_args
    or fused_solver._solver_launch_args / _euler_launch_args); None on
    the CPU."""
    from humanoid_mujoco_torch import kernels
    if device == "cpu":
        return None
    if name == "smooth":
        ins, outs, meta, ints = launch_args
        ptrs = [None if t is None or t.numel() == 0 else t.data_ptr()
                for t in ins + outs] + [meta.data_ptr(), *ints]
    elif name == "solver":
        ins, ints, outs = launch_args
        ptrs = [t.data_ptr() for t in ins + outs] + list(ints)
    else:
        ins, (strides, *ints), outs = launch_args
        ptrs = [t.data_ptr() for t in ins + outs + (strides,)] + ints
    return kernel_ms(lambda: kernels.launch(name, *ptrs))


def b2_row(m, solve_in, lim_tab, device, timer, max_abs_err, niter=8):
    """Kernel B2's numbers for the kernel table on `solve_in` (the 18
    arguments of solve_step_raw before lim_tab) at `niter` Newton
    iterations: its device time a launch (`bare_kernel_ms`), the
    wrapper's and the twin's time, the bound from the twin's iterations
    on these inputs (`solve_cost`), and the envs with a limit row at its
    activation boundary (`knife_edges`)."""
    from humanoid_mujoco_torch.physics import fused_solver
    B = solve_in[0].shape[0]
    kw = {**b2_kw(m, solve_in[8], lim_tab), "niter": niter}
    efc, x, f_t, trace = solve_trace(
        solve_in[0], solve_in[1], solve_in[2],
        solve_in[3:8] + solve_in[9:16], solve_in[8], lim_tab, niter)
    nbytes, flops = solve_cost(m, B, solve_in[8], lim_tab, f_t, trace)
    bound_ms, bound_by = bound(nbytes, flops)
    return {
        "ms": bare_kernel_ms("solver", fused_solver._solver_launch_args(
            *solve_in, lim_tab, niter, 16, kw.get("chain_max")), device),
        "wrapper_ms": timer(
            lambda: fused_solver.solve_step_raw(*solve_in, **kw), 20),
        "plain_ms": timer(
            lambda: fused_solver.solve_step_raw_reference(*solve_in, **kw),
            3),
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
        "max_abs_err": max_abs_err,
        "knife_edge_envs": knife_edges(efc, x, len(lim_tab))}


def task_kernel_checks(name, m, device, timer, batches=TASK_BATCHES):
    """The kernels of this model's route against their twins on settled
    states at B = 1024, 300 and 1 (B1 within TOL of its float32 twin, B2
    and B3 `against_twins`); at B = 1024 on the card each kernel's
    bitwise repeat and the isolation of a NaN env, its device time a
    launch (`bare_kernel_ms`), the wrapper's and the twin's time and the
    bound.
    Returns (the phase's numbers, per kernel the table's numbers)."""
    from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
    from humanoid_mujoco_torch.physics.solver import limit_rows_static
    way = TASK_ROUTES[name]
    lim_tab = limit_rows_static(m)
    out, rows = {}, {}
    b2_names = ("qacc", "qvel_new", "fslot", "qfrc_constraint")
    b3_names = ("qacc", "qvel_new", "efc_force", "qfrc_constraint")
    main = settled_states(name, m, batches[0], seed=21)
    for B in batches:
        qpos, qvel, ctrl = (x[:B].contiguous() for x in main)
        res = {}
        if way == "smooth":
            ker = fused_smooth.smooth_raw(m, qpos, qvel, ctrl)
            ref = fused_smooth.smooth_raw_reference(m, qpos, qvel, ctrl)
            errs = {n: rel_err(r, o, n)
                    for n, r, o in zip(fused_smooth.NAMES, ref, ker)}
            res["smooth_max_rel_err"] = max(errs.values())
            res["smooth_worst"] = max(errs, key=errs.get)
            res["smooth_max_abs_err"] = max(
                float((r - o).abs().max()) for n, r, o in
                zip(fused_smooth.NAMES, ref, ker)
                if r.numel() and n != "dist")
            assert res["smooth_max_rel_err"] <= TOL, (name, B, errs)
        solve_in = route_solve_inputs(way, m, qpos, qvel, ctrl)
        if way in ("smooth", "contact"):
            _, res["solver"] = against_twins(
                fused_solver.solve_step_raw,
                fused_solver.solve_step_raw_reference, solve_in,
                b2_kw(m, solve_in[8], lim_tab), b2_names)
            res["loaded_slots_mean"] = float(
                (solve_in[6] < 0).sum(dim=1).double().mean())
        if way == "rows":
            _, res["euler"] = against_twins(
                fused_solver.solve_constraints_euler,
                fused_solver.solve_constraints_euler_reference, solve_in,
                {}, b3_names)
            res["active_limit_rows_mean"] = float(
                (solve_in[4] < 0).sum(dim=1).double().mean())
        out[f"batch_{B}"] = res
    qpos, qvel, ctrl = main
    B = qpos.shape[0]
    solve_in = route_solve_inputs(way, m, qpos, qvel, ctrl)

    if name in CONTACT_MODELS:
        out["rk4"] = rk4_vs_float64(
            name, m, *(x[:CONTACT_RK4_BATCH] for x in main))

    def model_states(mm, n):
        return tuple(x[:n].clone() for x in main)
    if device != "cpu" and way == "smooth":
        out["smooth_isolation"] = smooth_isolation(m, qpos, qvel, ctrl)
    if device != "cpu" and way in ("smooth", "contact"):
        kw = b2_kw(m, solve_in[8], lim_tab)
        out["solver_isolation"] = isolation(
            m, lambda *a: fused_solver.solve_step_raw(*a, **kw),
            solve_in, model_states)
    if device != "cpu" and way == "rows":
        out["euler_isolation"] = isolation(
            m, fused_solver.solve_constraints_euler, solve_in, model_states)
    # the table's numbers at B = 1024; timing launches are not counted
    n = counters()
    if way == "smooth":
        packs = fused_smooth._pack_params(m)
        nbytes, flops = smooth_cost(m, B, len(lim_tab), packs)
        bound_ms, bound_by = bound(nbytes, flops)

        def b1():
            return fused_smooth.smooth_raw(m, qpos, qvel, ctrl)
        rows["smooth"] = {
            "ms": bare_kernel_ms("smooth", fused_smooth._smooth_launch_args(
                m, qpos, qvel, ctrl, None), device),
            "wrapper_ms": timer(b1, 20),
            "plain_ms": timer(lambda: fused_smooth.smooth_raw_reference(
                m, qpos, qvel, ctrl), 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "max_abs_err": out[f"batch_{B}"]["smooth_max_abs_err"]}
    if way in ("smooth", "contact"):
        rows["solver"] = b2_row(m, solve_in, lim_tab, device, timer,
                                out[f"batch_{B}"]["solver"]["max_abs_err"])
    if way == "rows":
        _, _, f_t, trace = rows_trace(*solve_in[:8])
        nbytes, flops = rows_cost(solve_in[3], f_t, trace)
        bound_ms, bound_by = bound(nbytes, flops)

        def b3():
            return fused_solver.solve_constraints_euler(*solve_in)
        rows["euler"] = {
            "ms": bare_kernel_ms("euler", fused_solver._euler_launch_args(
                *solve_in, 8, 16), device),
            "wrapper_ms": timer(b3, 20),
            "plain_ms": timer(
                lambda: fused_solver.solve_constraints_euler_reference(
                    *solve_in), 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "max_abs_err": out[f"batch_{B}"]["euler"]["max_abs_err"]}
    fused_smooth.LAUNCHES, fused_solver.LAUNCHES = n["smooth"], n["solver"]
    fused_solver.EULER_LAUNCHES = n["euler"]
    return out, rows


def b2_per_env_equals_static(m, solve_in, lim_tab, device):
    """Kernel B2 on a model's selection-free inputs `solve_in` launched
    with its static mask broadcast per env (contact_dmask(m)[None]
    .expand(B, K, nv), the chain area of all K slots) gives the static
    launch's bits (asserted on the card); both timed bare."""
    from humanoid_mujoco_torch.physics import fused_solver
    dm = solve_in[8]
    B, (K, nv) = solve_in[0].shape[0], dm.shape
    per_env = solve_in[:8] + (dm[None].expand(B, K, nv),) + solve_in[9:]
    kw = b2_kw(m, per_env[8], lim_tab)
    a = fused_solver.solve_step_raw(*solve_in, lim_tab=lim_tab)
    b = fused_solver.solve_step_raw(*per_env, **kw)
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    out = {"batch": B, "slots": K, "chain_max": kw["chain_max"],
           "bitwise_equal": equal,
           "static_ms": bare_kernel_ms("solver",
                                       fused_solver._solver_launch_args(
                                           *solve_in, lim_tab, 8, 16),
                                       device),
           "per_env_ms": bare_kernel_ms("solver",
                                        fused_solver._solver_launch_args(
                                            *per_env, lim_tab, 8, 16,
                                            kw["chain_max"]), device)}
    if device != "cpu":
        assert equal, out
    return out


def b2_topk_refusals(device):
    """Kernel B2 refuses, with ValueError before any launch (the launch
    counter unchanged), a per-env mask at nv 70 (over its cap of 64
    dofs) and a per-env mask whose chain area outgrows a block's shared
    memory (2,000 slots over every dof of a 6-dof model)."""
    from humanoid_mujoco_torch.physics import fused_solver

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def args(nv, K):
        return (torch.eye(nv, device=device)[None], z(1, nv), z(1, nv),
                z(1, nv, 6), z(1, K, 3), z(1, K, 3), z(1, K), z(1, K, 3),
                torch.ones((1, K, nv), device=device), z(1, K), z(1, K),
                z(1, K), z(1, 0), z(1, 0), z(1, 0), z(1, 0), z(nv), 0.01)
    n = fused_solver.LAUNCHES
    out = {}
    for key, (nv, K), why in (("nv70", (70, 16), "at most 64 dofs"),
                              ("slots2000", (6, 2000),
                               "bytes of shared memory")):
        try:
            fused_solver.solve_step_raw(*args(nv, K))
        except ValueError as e:
            assert why in str(e), e
            out[key] = str(e)
        else:
            raise AssertionError(f"B2 launched an oversize model ({key})")
    assert fused_solver.LAUNCHES == n
    return out


def task_routing(name, device):
    """One step of task `name`'s model at batch 64 on `task_states`: the
    kernels it launched, from the counters (ROUTE_LAUNCHES of its route).
    On the solver-free route the card's float32 step is also held to the
    CPU's float64 step on the same inputs."""
    from humanoid_mujoco_torch.physics.model import State
    from humanoid_mujoco_torch.physics.step import route, step
    from humanoid_mujoco_torch.tasks import task_model
    m = task_model(name, device=device)
    qpos, qvel, ctrl = task_states(name, m, 64, seed=5)
    s = State(qpos=qpos, qvel=qvel,
              time=torch.zeros(64, dtype=m.dtype, device=m.device))
    counters_zero()
    s2, info = step(m, s, ctrl)
    if device != "cpu":
        torch.cuda.synchronize()
    n = counters()
    out = {"route": route(m), "launches": n}
    assert route(m) == TASK_ROUTES[name], (name, route(m))
    if device != "cpu":
        assert n == ROUTE_LAUNCHES[TASK_ROUTES[name]], (name, n)
    if TASK_ROUTES[name] == "free":
        m64 = task_model(name, dtype=torch.float64, device="cpu")
        s64 = State(*(x.double().cpu() for x in (qpos, qvel, s.time)))
        r2, rinfo = step(m64, s64, ctrl.double().cpu())
        errs = {"qpos": rel_err(r2.qpos, s2.qpos),
                "qvel": rel_err(r2.qvel, s2.qvel),
                "qacc": rel_err(rinfo.qacc, info.qacc)}
        out["errs_vs_cpu_float64"] = errs
        assert max(errs.values()) <= TOL, (name, errs)
    return out


def task_rollout(name, m, B, horizon, seed=6):
    """Task `name`'s rollout for the cells: B `task_states` under a
    3-knot zero-order spline of their controls + 0.02 N of the range
    (numpy seed), the task's residual and cost each step. Returns
    rollout(), one `rollout_spline` of `horizon` steps."""
    from humanoid_mujoco_torch.ops.spline import SplineOrder
    from humanoid_mujoco_torch.physics.model import State
    from humanoid_mujoco_torch.rollout import rollout_spline
    from humanoid_mujoco_torch.tasks import get_task
    task = get_task(name, device=m.device)
    if name == "Humanoid Cap Walk":
        task = task.set_mode("Walk")
    qpos, qvel, ctrl = task_states(name, m, B, seed)
    s0 = State(qpos=qpos, qvel=qvel,
               time=torch.zeros(B, dtype=m.dtype, device=m.device))
    rng = np.random.default_rng(seed)
    lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
    values = torch.clamp(ctrl[:, None] + 0.02 * (hi - lo) * torch.tensor(
        rng.standard_normal((B, 3, m.nu)), dtype=m.dtype, device=m.device),
        lo, hi)
    times = torch.linspace(0.0, horizon * float(m.dt), 3, dtype=m.dtype,
                           device=m.device)

    def rollout():
        return rollout_spline(m, task, s0, times, values, SplineOrder.ZERO,
                              horizon)
    return rollout


def short_profile(name, B, short, sessions, want):
    """Task `name`'s `short`-step rollout at batch B profiled in
    `sessions` sessions (`profile_rows_complete`), on the card."""
    from humanoid_mujoco_torch.tasks import task_model
    few = task_rollout(name, task_model(name, device="cuda"), B, short)
    few()
    return profile_rows_complete(few, want, sessions)


def fresh_short_profile(name, B, short, sessions, want):
    """`short_profile` in a new process (`--short-profile`): its rows
    and sessions, from the JSON line it prints last."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--short-profile",
         json.dumps([name, B, short, sessions, want])],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    rows, runs = json.loads(out.stdout.strip().splitlines()[-1])
    return [tuple(r) for r in rows], runs


def task_rollouts(device, timer, B, horizon, profile="Walker",
                  short=2, sessions=1):
    """The 1024 x 100 rollout of each model under its task: ms (CUDA
    events, one run after the counted run; the contact family's
    counted run), steps/s, kernel launches
    per step (counters), and for `profile` the device busy time, all
    launches and the idle share of one rollout (torch.profiler). For
    every model also `sessions` `short`-step rollouts of the same batch
    under the profiler, each in its own session
    (`profile_rows_complete`): CUDA launches and device busy time a
    step, the idle share against the full rollout's time a step, and the
    three busiest kernels."""
    from humanoid_mujoco_torch.tasks import task_model
    out, launches = {}, {}
    for name in TASK_ROLLOUTS:
        m = task_model(name, device=device)
        family = name in CONTACT_MODELS + TOPK_MODELS
        h = min(horizon, CONTACT_ROLLOUT_HORIZON) if family else horizon
        rollout = task_rollout(name, m, B, h)
        counters_zero()
        res, ms = timer.once(rollout)     # counted, and the warm-up
        n = counters()
        if not family:
            ms = timer(rollout, 1)
        launches[name] = n
        r = {"batch": B, "horizon": h, "ms": ms,
             "steps_per_s": B * h / (ms * 1e-3),
             "launches": n,
             "launches_per_step": {k: v / h for k, v in n.items()},
             "mean_return": float(res.total_return.mean()),
             "diverged": int(res.diverged.sum())}
        if device != "cpu":
            if name == profile:
                busy, all_launches = profile_busy_ms(rollout)
                r.update(device_busy_ms=busy, cuda_launches=all_launches,
                         cuda_launches_per_step=all_launches / h,
                         idle_share=1.0 - busy / ms)
            few = task_rollout(name, m, B, short)
            few()
            want = short * sum(ROUTE_LAUNCHES[TASK_ROUTES[name]].values())
            rows, runs = profile_rows_complete(
                few, want, sessions, fresh=lambda: fresh_short_profile(
                    name, B, short, sessions, want))
            steps = short * sessions
            busy = sum(x[2] for x in rows) / 1e3
            r["short"] = {
                "horizon": steps, "profiler_sessions": runs,
                "busy_ms_per_step": busy / steps,
                "cuda_launches_per_step": sum(x[1] for x in rows) / steps,
                "idle_share": 1.0 - busy / steps / (ms / h),
                "top": [(k[:60], c, t / 1e3) for k, c, t in rows[:3]]}
        out[name] = r
        assert bool(torch.isfinite(res.total_return).all()), name
        assert not bool(res.diverged.any()), (name, r)
        if device != "cpu":
            want = ROUTE_LAUNCHES[TASK_ROUTES[name]]
            assert n == {k: v * h for k, v in want.items()}, (name, n)
    return out, launches


def walker_holds_height(device, seeds=range(8)):
    """tests/test_tasks_suite.py:358-381 on the port: sampling MPC (32
    samples, 3 zero-order knots, horizon 20 at plan dt 0.02, 4 solver
    iterations, exploration 0.1) on the walker at dt 0.005, 30 cycles x 4
    sim steps, once per generator seed. Every run keeps the torso above
    1.0 m; the upright bound (|rooty| < 0.5) holds on at least 7 of 8
    runs, the JAX test's own rate over PRNG keys 0-7 (its key 7 ends at
    rooty -0.58 on the CPU)."""
    from humanoid_mujoco_torch import mpc
    from humanoid_mujoco_torch.ops.spline import SplineOrder
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.planners import (SamplingConfig, init_policy,
                                                sampling_plan)
    from humanoid_mujoco_torch.tasks.walker2d import (walker_model,
                                                      walker_stand_qpos,
                                                      walker_task)
    m = walker_model(dt=0.005, device=device)
    task = walker_task(device=device)
    cfg = SamplingConfig(nsample=32, nknots=3, horizon=20,
                         order=SplineOrder.ZERO, solver_iters=4,
                         exploration=0.1)
    heights, pitches, costs = [], [], []
    for seed in seeds:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        res = mpc.mpc_rollout(
            m, mpc.make_plan_model(m, 0.02), task,
            lambda mm, tt, pp, ss, g: sampling_plan(mm, tt, cfg, pp, ss,
                                                    generator=g),
            init_policy(m, cfg.nknots),
            make_state(m, qpos=walker_stand_qpos(m)), gen, 30, 4,
            mpc.spline_action_fn(cfg.order), sim_solver_iters=4)
        assert bool(torch.isfinite(res.costs).all()), seed
        heights.append(1.3 + float(res.final_state.qpos[0, 0]))
        pitches.append(float(res.final_state.qpos[0, 2]))
        costs.append(float(res.costs.mean()))
    upright = sum(abs(p) < 0.5 for p in pitches)
    out = {"seeds": list(seeds), "final_heights": heights,
           "final_pitches": pitches, "mean_costs": costs,
           "upright_runs": upright}
    assert min(heights) > 1.0 and upright >= 7 * len(pitches) // 8, out
    return out


def quadruped_settles(device, hill):
    """tests/test_tasks_suite.py:153-197 on the port: the A1 under its
    home servo targets, 300 steps on the flat floor (the normal force
    sums to its weight within 5%, the trunk within 0.05 m of 0.27) or
    400 on the hill, dropped at (1.6, 0) 0.30 m over the terrain (it
    stands 0.26 m over the terrain, within 0.06)."""
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import step
    from humanoid_mujoco_torch.tasks import quadruped_hill as QH
    from humanoid_mujoco_torch.tasks.quadruped import (home_ctrl,
                                                       quadruped_home_qpos,
                                                       quadruped_model)
    m = (QH.quadruped_hill_model(device=device) if hill
         else quadruped_model(device=device))
    q = quadruped_home_qpos(m)
    if hill:
        q[0], q[2] = 1.6, float(QH.hill_height_np(1.6, 0.0)) + 0.30
    s = make_state(m, qpos=q)
    u = home_ctrl(m)[None]
    diverged = False
    for _ in range(400 if hill else 300):
        s, info = step(m, s, u)
        diverged |= bool(info.diverged.any())
    x, y, z = (float(v) for v in s.qpos[0, :3])
    if hill:
        terrain = float(QH.hill_height_np(x, y))
        out = {"steps": 400, "height_over_terrain": z - terrain}
        assert not diverged and abs(z - terrain - 0.26) < 0.06, out
        return out
    weight = 9.81 * float(m.body_mass.sum())
    fn = float(info.contact_force.sum())
    out = {"steps": 300, "normal_force": fn, "weight": weight,
           "trunk_z": z}
    assert not diverged and abs(fn - weight) <= 0.05 * weight \
        and abs(z - 0.27) < 0.05, out
    return out


def cartpole_swingup(device, iters=CARTPOLE_ILQG_ITERS):
    """tests/test_tasks_suite.py:85-113 on the port: iLQG (horizon 80 at
    plan dt 0.02, 2 solver iterations) from the pole 0.25 rad off
    hanging; the best return falls below 0.85 of the first."""
    from humanoid_mujoco_torch.mpc import make_plan_model
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.planners import ilqg
    from humanoid_mujoco_torch.tasks import get_task, home_qpos, task_model
    m = task_model("Cartpole", device=device)
    q = home_qpos("Cartpole", m)
    q[1] = np.pi - 0.25
    s0 = make_state(m, qpos=q)
    pm = make_plan_model(m, 0.02)
    cfg = ilqg.ILQGConfig(horizon=80, solver_iters=2, deriv_solver_iters=2)
    task = get_task("Cartpole", device=device)
    ps = ilqg.ilqg_init(pm, cfg, s0)
    returns = []
    for _ in range(iters):
        ps, info = ilqg.ilqg_plan(pm, task, cfg, ps, s0)
        returns.append(float(info.best_return))
    out = {"iterations": iters, "first": returns[0], "last": returns[-1],
           "ratio": returns[-1] / returns[0]}
    assert np.isfinite(returns[-1]) and out["ratio"] < 0.85, out
    return out


def acrobot_pumps(device):
    """tests/test_tasks_suite.py:127-150 on the port: sampling MPC (48
    samples, 6 linear knots, horizon 40 at plan dt 0.05, 2 solver
    iterations, exploration 0.6), 40 cycles x 5 sim steps from hanging;
    the tip ends above 1.0 m (it starts at 0, the shoulder is at 2)."""
    from humanoid_mujoco_torch import mpc
    from humanoid_mujoco_torch.ops.spline import SplineOrder
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import forward
    from humanoid_mujoco_torch.planners import (SamplingConfig, init_policy,
                                                sampling_plan)
    from humanoid_mujoco_torch.tasks import get_task, home_qpos, task_model
    m = task_model("Acrobot", device=device)
    task = get_task("Acrobot", device=device)
    cfg = SamplingConfig(nsample=48, nknots=6, horizon=40,
                         order=SplineOrder.LINEAR, solver_iters=2,
                         exploration=0.6)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    res = mpc.mpc_rollout(
        m, mpc.make_plan_model(m, 0.05), task,
        lambda mm, tt, pp, ss, g: sampling_plan(mm, tt, cfg, pp, ss,
                                                generator=g),
        init_policy(m, cfg.nknots),
        make_state(m, qpos=home_qpos("Acrobot", m)), gen, 40, 5,
        mpc.spline_action_fn(cfg.order), sim_solver_iters=2)
    info = forward(m, res.final_state, torch.zeros((1, m.nu), dtype=m.dtype,
                                                   device=m.device))[3]
    tip = float(info.site_xpos[0, m.struct.site_id("tip"), 2])
    out = {"tip_z": tip, "mean_cost": float(res.costs.mean())}
    assert bool(torch.isfinite(res.costs).all()) and tip > 1.0, out
    return out


def task_agents(device):
    """`Agent(task_model(name), name)` for each task of the first tier
    and the top-k tier at its default planner (iLQG, horizon
    TASK_AGENT_HORIZON, cut from 17 for time): one
    planner_step and one get_action from
    the home keyframe (Quadruped Hill's on the slope at the first
    waypoint; Humanoid Cap Walk in mode "Walk"), with the kernels each
    launched."""
    from humanoid_mujoco_torch.agent import Agent
    from humanoid_mujoco_torch.tasks import home_qpos, task_model
    from humanoid_mujoco_torch.tasks.quadruped_hill import hill_height_np
    out, launches = {}, {}
    for name in TASK_NAMES + TOPK_MODELS:
        m = task_model(name, device=device)
        a = Agent(m, name, horizon=TASK_AGENT_HORIZON)
        if name == "Humanoid Cap Walk":
            a.set_mode("Walk")
        q = home_qpos(name, m)
        if name == "Quadruped Hill":
            q[0], q[2] = 1.6, float(hill_height_np(1.6, 0.0)) + 0.27
        a.set_state(qpos=q)
        counters_zero()
        t0 = time.perf_counter()
        best = a.planner_step()
        u = a.get_action()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counters()
        launches[name] = n
        out[name] = {"planner": a.planner, "mode": a.get_mode(),
                     "best_return": best, "wall_s": wall, "launches": n}
        assert a.planner == "ilqg" and np.isfinite(best) \
            and u.shape == (m.nu,) and np.all(np.isfinite(u)), (name, out)
        if device != "cpu":
            want = ROUTE_LAUNCHES[TASK_ROUTES[name]]
            # the nominal search's and the line search's rollouts
            assert n == {k: v * 2 * a.cfg.horizon
                         for k, v in want.items()}, (name, n)
    return out, launches


def task_occupancy():
    """Each task model's kernel occupancy at the block shapes the
    wrappers launch (TASK_KERNELS): B1 and B2 on Walker and Quadruped
    Flat, B2 on Quadruped Hill and the contact family, B3 on Cartpole's
    rows."""
    from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
    from humanoid_mujoco_torch.physics.solver import (contact_dmask,
                                                      limit_rows_static)
    from humanoid_mujoco_torch.physics.step import keeps_selection
    from humanoid_mujoco_torch.tasks import task_model
    out = {}
    for name in TASK_KERNELS:
        m = task_model(name, device="cuda")
        nlim = len(limit_rows_static(m))
        occ = {}
        if TASK_ROUTES[name] == "smooth":
            occ["smooth"] = fused_smooth.smooth_occupancy(m)
        if m.ncon and keeps_selection(m):
            k = m.struct.max_contacts
            occ["solver_per_env"] = fused_solver.solver_occupancy(
                m.nv, k, nlim, fused_solver.chain_bound(contact_dmask(m), k),
                per_env=True)
        elif m.ncon:
            occ["solver"] = fused_solver.solver_occupancy(
                m.nv, m.ncon, nlim,
                len(fused_solver.chain_layout(contact_dmask(m))[1]))
        else:
            occ["euler"] = fused_solver.euler_occupancy(m.nv, nlim)
        out[name] = occ
    return out


def run_tasks(device="cuda", gpu="cpu", B=BENCH_BATCH,
              horizon=BENCH_HORIZON, batches=TASK_BATCHES):
    """The task slices' phases, the contact family's models among
    them: `task_kernels` (each model's kernels against their twins,
    `task_kernel_checks`), `task_routing`, `task_rollouts`, `task_loops`
    (the JAX task tests' closed loops and the family's), `task_agents`,
    `task_walls`, and `b2_per_env_equals_static` (B2's per-env launch
    of a broadcast static mask against the static launch, and its
    refusals). Returns each kernel's numbers on these models for the
    kernel table."""
    from humanoid_mujoco_torch.physics.solver import limit_rows_static
    from humanoid_mujoco_torch.tasks import task_model
    timer = Timer(device)
    walls, t_all = {}, time.perf_counter()
    rows = {"smooth": {}, "solver": {}, "euler": {}}
    t0 = time.perf_counter()
    for name in TASK_KERNELS:
        m = task_model(name, device=device)
        res, krows = task_kernel_checks(name, m, device, timer, batches)
        log("task_kernels", gpu=gpu, model=name, tol=TOL, **res)
        for k, r in krows.items():
            rows[k][name] = r
    walls["task_kernels_s"] = time.perf_counter() - t0
    t0, per_env = time.perf_counter(), {}
    for name in PER_ENV_CHECK:
        m = task_model(name, device=device)
        main = settled_states(name, m, B, seed=21)
        per_env[name] = b2_per_env_equals_static(
            m, route_solve_inputs(TASK_ROUTES[name], m, *main),
            limit_rows_static(m), device)
    if device != "cpu":
        per_env["refusals"] = b2_topk_refusals(device)
    log("b2_per_env_equals_static", gpu=gpu, **per_env)
    walls["b2_per_env_equals_static_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("task_routing", **{n: task_routing(n, device)
                           for n in TASK_NAMES + CONTACT_MODELS
                           + TOPK_MODELS})
    walls["task_routing_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ro, ro_launches = task_rollouts(device, timer, B, horizon)
    log("task_rollouts", gpu=gpu, **ro)
    walls["task_rollouts_s"] = time.perf_counter() - t0
    loops, totals = {}, {n: dict(ro_launches[n]) for n in ro_launches}
    for key, name, fn in (
            ("walker_holds_height", "Walker",
             lambda: walker_holds_height(device)),
            ("quadruped_flat_settles", "Quadruped Flat",
             lambda: quadruped_settles(device, hill=False)),
            ("quadruped_hill_settles", "Quadruped Hill",
             lambda: quadruped_settles(device, hill=True)),
            ("cartpole_ilqg_swingup", "Cartpole",
             lambda: cartpole_swingup(device)),
            ("acrobot_pumps", "Acrobot", lambda: acrobot_pumps(device)),
            ("quadrotor_hover", "Quadrotor",
             lambda: quadrotor_hovers(device)),
            ("op3_settles", "OP3", lambda: op3_settles(device)),
            ("panda_gravcomp_hold", "Panda", lambda: panda_holds(device)),
            ("humanoid_stand_ilqg", "Humanoid Stand",
             lambda: humanoid_stand_ilqg(device)),
            ("allegro_holds_grasp", "Allegro",
             lambda: hand_holds(device, "Allegro")),
            ("shadow_holds_grasp", "Shadow",
             lambda: hand_holds(device, "Shadow")),
            ("reorient_cross_settles", "Bimanual Reorient",
             lambda: reorient_settles(device))):
        counters_zero()
        t0 = time.perf_counter()
        loops[key] = fn()
        if device != "cpu":
            torch.cuda.synchronize()
        walls[f"{key}_s"] = time.perf_counter() - t0
        loops[key]["launches"] = counters()
        for k, v in loops[key]["launches"].items():
            totals[name][k] += v
        if device != "cpu":
            want = ROUTE_LAUNCHES[TASK_ROUTES[name]]
            assert all(bool(n) == bool(want[k]) for k, n in
                       loops[key]["launches"].items()), (key, loops[key])
    log("task_loops", gpu=gpu, **loops)
    t0 = time.perf_counter()
    ag, ag_launches = task_agents(device)
    log("task_agents", gpu=gpu, **ag)
    walls["task_agents_s"] = time.perf_counter() - t0
    log("task_walls", **walls, total_s=time.perf_counter() - t_all)
    # the table's launch counts: each model's rollout, loop and Agent
    for name, n in ag_launches.items():
        if name in totals:
            for k, v in n.items():
                totals[name][k] += v
    for k in rows:
        for name, r in rows[k].items():
            r["launches"] = totals[name][k]
    return rows


# the estimation slice: the EKF, UKF and batch estimator (their steps
# through B1 + B2 on the humanoid, B3 on Cartpole), the direct
# optimizer (plain by design), the serving filter and
# MPCServer(filter="ekf"), float32 on the card
EST_EKF_UPDATES, EST_COV_UPDATES = 30, 10
EST_UKF_UPDATES, EST_BATCH_UPDATES = 20, 12
EST_DIRECT_T = 10
SERVE_FILTER_UPDATES, SERVE_FILTER_SHOVE = 60, 0.4


def est_truth(m, n, seed, noise=0.01, qpos0=None, qvel0=None, ctrl=0.0,
              mass=1.0):
    """The tests' truth on m's device: n steps of the port's step from
    the stand pose (or qpos0, qvel0) under a constant control, with a
    model `mass` times heavier; (qpos (n+1, nq), qvel (n+1, nv), noisy
    measurements (n+1, ny), numpy seed) as float64 numpy."""
    from humanoid_mujoco_torch.estimators.sensors import measure
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import step
    mt = m if mass == 1.0 else m.replace(body_mass=m.body_mass * mass)
    q = humanoid.stand_qpos(m) if qpos0 is None else qpos0
    s = make_state(mt, qpos=q, qvel=qvel0)
    u = torch.full((1, m.nu), ctrl, dtype=m.dtype, device=m.device)
    qs, vs = [s.qpos], [s.qvel]
    for _ in range(n):
        s, _ = step(mt, s, u)
        qs.append(s.qpos)
        vs.append(s.qvel)
    qs, vs = torch.cat(qs), torch.cat(vs)
    ys = measure(m, qs, vs).double().cpu().numpy()
    ys = ys + noise * np.random.default_rng(seed).standard_normal(ys.shape)
    return (qs.double().cpu().numpy(), vs.double().cpu().numpy(), ys)


def est_wrong_start(m, off):
    """The stand pose with every joint moved by `off` into its range
    (tests/test_torch_estimation.py's `wrong_start`; -off on the three
    arm joints whose upper limit is 0)."""
    from humanoid_mujoco_torch.physics import humanoid
    q = humanoid.stand_qpos(m).double().cpu().numpy().copy()
    hi = m.jnt_range[1:, 1].double().cpu().numpy()
    q[7:] += np.where(hi >= off, off, -off)
    return q


def host_syncs(fn):
    """(count, sites) of the host syncs one fn() call makes on the card,
    by torch.cuda's sync debug mode (one warning a synchronizing call,
    attributed to the calling line); (None, []) on the CPU."""
    if not torch.cuda.is_available():
        return None, []
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    hits = [x for x in w if "synchroniz" in str(x.message)]
    return len(hits), sorted({f"{os.path.basename(x.filename)}:{x.lineno}"
                              for x in hits})


def est_update_stats(fn, device, timer, reps=3, profile=True):
    """Median ms of one call (CUDA events), and with `profile` on the
    card its device busy ms, CUDA launches and idle share
    (torch.profiler)."""
    out = {"median_ms": timer(fn, reps)}
    if profile and device != "cpu":
        busy, n = profile_busy_ms(fn)
        out.update(device_busy_ms=busy, cuda_launches=n,
                   idle_share=1.0 - busy / out["median_ms"])
    return out


def est_steps_vs_float64(calls, m64, way, solver_iters):
    """Each `step` an estimator took on the card (recorded with its
    arguments) against the same step through the float64 twins on the
    CPU (qpos, qvel, qacc within TOL); then its kernels on those inputs:
    B1 against its float32 twin within TOL, B2 (or B3 on a "rows" model)
    against its twins (`against_twins`: the float64 twin within TOL on
    all but 0.5% of the batch, the float32 twin's error reported), as
    the task phases hold them."""
    from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
    from humanoid_mujoco_torch.physics.model import State
    from humanoid_mujoco_torch.physics.solver import limit_rows_static
    from humanoid_mujoco_torch.physics.step import step
    out = []
    for a, kw, (s2, info) in calls:
        m, st, ctrl = a[:3]
        iters = kw.get("solver_iters", 8)
        assert iters == solver_iters, (iters, solver_iters)
        st64 = State(*(x.double().cpu() for x in (st.qpos, st.qvel,
                                                  st.time)))
        r2, rinfo = step(m64, st64, ctrl.double().cpu(), solver_iters=iters)
        res = {"batch": st.qpos.shape[0],
               "step_errs_vs_float64": {
                   n: rel_err(r, o, n) for n, r, o in (
                       ("qpos", r2.qpos, s2.qpos), ("qvel", r2.qvel, s2.qvel),
                       ("qacc", rinfo.qacc, info.qacc))}}
        assert max(res["step_errs_vs_float64"].values()) <= TOL, res
        solve_in = route_solve_inputs(way, m, st.qpos, st.qvel, ctrl)
        if way == "smooth":
            ker = fused_smooth.smooth_raw(m, st.qpos, st.qvel, ctrl)
            ref = fused_smooth.smooth_raw_reference(m, st.qpos, st.qvel,
                                                    ctrl)
            res["smooth_max_rel_err"] = max(
                rel_err(r, o, n) for n, r, o in zip(fused_smooth.NAMES,
                                                    ref, ker))
            assert res["smooth_max_rel_err"] <= TOL, res
            _, res["solver"] = against_twins(
                fused_solver.solve_step_raw,
                fused_solver.solve_step_raw_reference, solve_in,
                {"lim_tab": limit_rows_static(m), "niter": iters},
                ("qacc", "qvel_new", "fslot", "qfrc_constraint"))
        else:
            _, res["euler"] = against_twins(
                fused_solver.solve_constraints_euler,
                fused_solver.solve_constraints_euler_reference, solve_in,
                {"niter": iters},
                ("qacc", "qvel_new", "efc_force", "qfrc_constraint"))
        out.append(res)
    return out


def estimation_kernels(device, timer):
    """One update of each estimator, its `step` calls recorded and held
    against the float64 twins (`est_steps_vs_float64`): the EKF's
    predict (batch 1), the UKF's sigma points (batch 2·36 + 1 = 73), the
    batch estimator's shift-in (1) and window knots (W - 1 = 7) on the
    humanoid (B1 + B2); the EKF's and UKF's on Cartpole (B3, the generic
    (qpos, qvel) measurement). B1, B2 and B3 launches an update by the
    counters; the host syncs of one EKF update. Returns (the phase's
    numbers, per kernel its launches and its time at the UKF's batch)."""
    from humanoid_mujoco_torch import estimators as est
    from humanoid_mujoco_torch.estimators import batch as ebatch
    from humanoid_mujoco_torch.estimators import kalman as ekalman
    from humanoid_mujoco_torch.estimators import unscented as eukf
    from humanoid_mujoco_torch.physics import (fused_smooth, fused_solver,
                                               humanoid)
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.solver import limit_rows_static
    from humanoid_mujoco_torch.tasks import home_qpos, task_model
    mods = (ekalman, eukf, ebatch)
    out, launches = {}, {"smooth": 0, "solver": 0, "euler": 0}
    rows = {}
    for name in ("humanoid", "Cartpole"):
        if name == "humanoid":
            m = humanoid.build_humanoid(device=device)
            m64 = humanoid.build_humanoid(dtype=torch.float64, device="cpu")
            start = est_wrong_start(m, 0.05)
            y = est_truth(m, 1, seed=30)[2][1]
            kinds = ("ekf", "ukf", "batch")
            way = "smooth"
        else:
            m = task_model(name, device=device)
            m64 = task_model(name, dtype=torch.float64, device="cpu")
            start = home_qpos(name, m).double().cpu().numpy().copy()
            start[1] += 0.3
            y = np.concatenate([start + [0.02, -0.05], [0.1, -0.2]])
            kinds = ("ekf", "ukf")
            way = "rows"
        sensor = est.default_sensor_model(m)
        s0 = make_state(m, qpos=start)
        u = torch.zeros((1, m.nu), dtype=m.dtype, device=m.device)
        yt = torch.tensor(y[None], dtype=m.dtype, device=m.device)
        for kind in kinds:
            if kind == "ekf":
                cfg = est.EKFConfig()
                f0 = est.ekf_init(m, cfg, s0)
                upd = est.ekf_update
            elif kind == "ukf":
                cfg = est.UKFConfig()
                f0 = est.ukf_init(m, cfg, s0)
                upd = est.ukf_update
            else:
                cfg = est.BatchConfig()
                f0 = est.batch_init(m, cfg, s0)
                upd = est.batch_update

            def update():
                return upd(m, cfg, sensor, f0, u, yt)
            update()                                    # warm-up
            counters_zero()
            with record(mods, "step") as rec:
                f1, extra = update()
            if device != "cpu":
                torch.cuda.synchronize()
            n = counters()
            key = f"{name.lower()}_{kind}"
            leaves = [f1.qpos_win, f1.qvel_win] if kind == "batch" else [
                f1.state.qpos, f1.state.qvel, f1.cov]
            assert all(bool(torch.isfinite(x).all()) for x in leaves), key
            res = {"launches_per_update": n,
                   "steps": est_steps_vs_float64(rec.calls, m64, way,
                                                 cfg.solver_iters)}
            if device != "cpu":
                nsteps = 1 + (cfg.gn_iters if kind == "batch" else 0)
                want = ({"smooth": nsteps, "solver": nsteps, "euler": 0}
                        if way == "smooth" else
                        {"smooth": 0, "solver": 0, "euler": nsteps})
                assert n == want, (key, n, want)
            for k in launches:
                launches[k] += n[k]
            if key == "humanoid_ekf":
                (res["host_syncs_per_update"],
                 res["host_sync_sites"]) = host_syncs(update)
            if key == "humanoid_ukf" and device != "cpu":
                # B1 and B2 at the UKF's batch of 73 sigma points
                (a, kw, _), = rec.calls
                st, ctrl = a[1], a[2]
                qpos, qvel = st.qpos, st.qvel
                packs = fused_smooth._pack_params(m)
                lim_tab = limit_rows_static(m)
                B = qpos.shape[0]
                nb, fl = smooth_cost(m, B, len(lim_tab), packs)
                bms, bby = bound(nb, fl)
                rows["smooth"] = {
                    "ms_ukf73": bare_kernel_ms(
                        "smooth", fused_smooth._smooth_launch_args(
                            m, qpos, qvel, ctrl, None), device),
                    "plain_ms_ukf73": timer(
                        lambda: fused_smooth.smooth_raw_reference(
                            m, qpos, qvel, ctrl), 3),
                    "bound_ms_ukf73": bms, "bound_by_ukf73": bby}
                solve_in = route_solve_inputs("smooth", m, qpos, qvel, ctrl)
                raw = solve_in[3:8] + solve_in[9:16]
                _, _, f_t, trace = solve_trace(solve_in[0], solve_in[1],
                                               qvel, raw, solve_in[8],
                                               lim_tab)
                nb, fl = solve_cost(m, B, solve_in[8], lim_tab, f_t, trace)
                bms, bby = bound(nb, fl)
                rows["solver"] = {
                    "ms_ukf73": bare_kernel_ms(
                        "solver", fused_solver._solver_launch_args(
                            *solve_in, lim_tab, cfg.solver_iters, 16),
                        device),
                    "plain_ms_ukf73": timer(
                        lambda: fused_solver.solve_step_raw_reference(
                            *solve_in, lim_tab=lim_tab,
                            niter=cfg.solver_iters), 3),
                    "bound_ms_ukf73": bms, "bound_by_ukf73": bby}
                counters_zero()
            out[key] = res
    return out, launches, rows


def estimation_loops(device, timer):
    """tests/test_estimators.py's and tests/test_direct.py's scenarios in
    the model's dtype (float32 on the card), numpy draws, each with its
    threshold, its median ms a call, launches by the counters, and on
    the card its device busy time and idle share (torch.profiler):
    - EKF from `est_wrong_start(0.1)`: error < 0.3 err0 after 30
      updates, a finite covariance; from the JAX test's own start (every
      joint +0.1, three arm joints past their limits) the error ratio is
      reported, not held (tests/test_torch_estimation.py); the
      covariance after 10 updates from the truth: eigenvalues in
      (-1e-9, 1) in float64 on the CPU twins, in float32 here the
      bound's float32 analog (the smallest eigenvalue above -1e-6 of the
      largest);
    - UKF from `est_wrong_start(0.08)`: error < 0.5 err0 after 20
      updates; from the JAX test's start (every joint +0.08) the outcome
      is reported, not held: in float32 its second update leaves the
      covariance indefinite (P - K S Kᵀ after a predict whose sigma
      points spread at the violated limits) and the filter NaNs, as the
      JAX UKF does in float32 on the CPU from that start through its
      step's selection-free kernel branch (through its CPU step's top-32
      selection it does not: tests/test_torch_estimation.py's
      `ukf_float32_witness`), where the float64 CPU twin meets the
      bound;
    - the batch estimator (window 4, one iteration): error < 0.05 after
      12 updates;
    - direct: the denoised window (T 10, 3 iterations: the cost falls,
      the error below 0.7 of its start); the mass scale 1.15 ± 0.05
      from an actuated flight (6 iterations, force weight 1e-2); both
      held in float64 on the card, reported in float32, where the
      Gauss-Newton matrix (condition ~1e12 at the regularization 1e-4)
      leaves no step that lowers the cost.
    Every truth trajectory is built before the counters are set to 0;
    on the card each case's launches equal, kernel by kernel, the sum of
    its estimator calls' own (an EKF or UKF update 1 B1 + 1 B2, a batch
    update 1 + gn_iters, a direct fit none)."""
    from humanoid_mujoco_torch import estimators as est
    from humanoid_mujoco_torch.direct import DirectConfig, direct_optimize
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.physics.model import make_state
    m = humanoid.build_humanoid(device=device)
    dtype, dev = m.dtype, m.device
    sensor = est.default_sensor_model(m)
    u = torch.zeros((1, m.nu), dtype=dtype, device=dev)
    T = EST_DIRECT_T
    q0 = humanoid.stand_qpos(m).double().cpu().numpy()
    q0[2] = 1.0
    truth = {"ekf": est_truth(m, EST_EKF_UPDATES, seed=40),
             "ekf_cov": est_truth(m, EST_COV_UPDATES, seed=41),
             "ukf": est_truth(m, EST_UKF_UPDATES, seed=42),
             "batch": est_truth(m, EST_BATCH_UPDATES, seed=43, noise=0.005),
             "denoise": est_truth(m, T - 1, seed=0, noise=0.0),
             "flight": est_truth(m, T - 1, seed=0, noise=0.0, qpos0=q0,
                                 ctrl=0.4, mass=1.15)}
    out, expected = {}, {}

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    def counted(update, nsteps):
        """`update`, each call adding the B1 + B2 launches of its
        `nsteps` steps to `expected`."""
        def call(*a):
            for k in ("smooth", "solver"):
                expected[k] += nsteps
            return update(*a)
        return call

    def run(upd, f, ys, n):
        for y in ys[1:n + 1]:
            f, extra = upd(f, u, t(y)[None])
        return f, extra

    def loop(key, fn):
        expected.update(smooth=0, solver=0, euler=0)
        counters_zero()
        t0 = time.perf_counter()
        res = fn()
        if device != "cpu":
            torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
        res["launches"] = counters()
        if device != "cpu":
            assert res["launches"] == expected, (key, res["launches"],
                                                 expected)
        out[key] = res

    def ekf_case():
        qs, _, ys = truth["ekf"]
        cfg = est.EKFConfig()
        upd = counted(lambda f, uu, y: est.ekf_update(m, cfg, sensor, f, uu,
                                                      y), 1)
        res = {}
        for label, off, sign in (("in_range_start", 0.1, None),
                                 ("jax_test_start", 0.1, 1.0)):
            if sign is None:
                bad = est_wrong_start(m, off)
            else:
                bad = qs[0].copy()
                bad[7:] += off
            f, _ = run(upd, est.ekf_init(m, cfg, make_state(m, qpos=bad)),
                       ys, EST_EKF_UPDATES)
            err0 = np.linalg.norm(bad[7:] - qs[1, 7:])
            err = np.linalg.norm(f.state.qpos[0, 7:].double().cpu().numpy()
                                 - qs[EST_EKF_UPDATES, 7:])
            res[label] = {"err0": err0, "err": err, "ratio": err / err0,
                          "cov_finite": bool(torch.isfinite(f.cov).all())}
            assert res[label]["cov_finite"], res
        assert res["in_range_start"]["ratio"] < 0.3, res
        qs, _, ys = truth["ekf_cov"]
        f, _ = run(upd, est.ekf_init(m, cfg, make_state(m, qpos=qs[0])),
                   ys, EST_COV_UPDATES)
        w = np.linalg.eigvalsh(f.cov[0].double().cpu().numpy())
        res["cov_eig_min"], res["cov_eig_max"] = float(w.min()), float(
            w.max())
        assert w.max() < 1.0 and w.min() > -1e-6 * w.max(), res
        f1 = est.ekf_init(m, cfg, make_state(m, qpos=qs[0]))
        res.update(est_update_stats(lambda: upd(f1, u, t(ys[1])[None]),
                                    device, timer))
        return res

    def ukf_case():
        qs, _, ys = truth["ukf"]
        cfg = est.UKFConfig()
        upd = counted(lambda f, uu, y: est.ukf_update(m, cfg, sensor, f, uu,
                                                      y), 1)
        res = {}
        for label in ("in_range_start", "jax_test_start"):
            if label == "in_range_start":
                bad = est_wrong_start(m, 0.08)
            else:
                bad = qs[0].copy()
                bad[7:] += 0.08
            f0 = est.ukf_init(m, cfg, make_state(m, qpos=bad))
            f, _ = run(upd, f0, ys, EST_UKF_UPDATES)
            err0 = np.linalg.norm(bad[7:] - qs[1, 7:])
            err = np.linalg.norm(f.state.qpos[0, 7:].double().cpu().numpy()
                                 - qs[EST_UKF_UPDATES, 7:])
            res[label] = {"err0": err0, "err": err, "ratio": err / err0,
                          "finite": bool(torch.isfinite(f.cov).all())}
        assert res["in_range_start"]["ratio"] < 0.5, res
        f0 = est.ukf_init(m, cfg, make_state(m, qpos=est_wrong_start(m,
                                                                     0.08)))
        res.update(est_update_stats(lambda: upd(f0, u, t(ys[1])[None]),
                                    device, timer))
        return res

    def batch_case():
        qs, _, ys = truth["batch"]
        cfg = est.BatchConfig(window=4, gn_iters=1)
        upd = counted(lambda b, uu, y: est.batch_update(m, cfg, sensor, b,
                                                        uu, y),
                      1 + cfg.gn_iters)
        b0 = est.batch_init(m, cfg, make_state(m, qpos=qs[0]))
        _, e = run(upd, b0, ys, EST_BATCH_UPDATES)
        err = np.linalg.norm(e.qpos[0, 7:].double().cpu().numpy()
                             - qs[EST_BATCH_UPDATES, 7:])
        res = {"err": err, "finite": bool(torch.isfinite(e.qpos).all())}
        assert err < 0.05 and res["finite"], res
        res.update(est_update_stats(lambda: upd(b0, u, t(ys[1])[None]),
                                    device, timer))
        # the default window (8, 2 iterations), the table's batch case,
        # timed only (its profile doubles the phase)
        cfg8 = est.BatchConfig()
        upd8 = counted(lambda b, uu, y: est.batch_update(m, cfg8, sensor, b,
                                                         uu, y),
                       1 + cfg8.gn_iters)
        b8 = est.batch_init(m, cfg8, make_state(m, qpos=qs[0]))
        res["window8_gn2"] = est_update_stats(
            lambda: upd8(b8, u, t(ys[1])[None]), device, timer, reps=2,
            profile=False)
        return res

    def direct_case():
        """Both direct cases on float32 trajectories of the card's step,
        optimized in float32 (reported) and in float64 on the same card
        (held: the direct path runs no kernel, so it takes any dtype)."""
        dt = float(m.dt)
        m64 = humanoid.build_humanoid(dtype=torch.float64, device=device)
        sensor64 = est.default_sensor_model(m64, dtype=torch.float64)
        qs, _, ys = truth["denoise"]
        noisy = qs.copy()
        noisy[:, 7:] += 0.03 * np.random.default_rng(44).standard_normal(
            (T, 12))
        qf, _, yf = truth["flight"]
        res = {}
        for label, mm, sen in (("float32", m, sensor),
                               ("float64", m64, sensor64)):
            def tt(x):
                return torch.tensor(np.asarray(x), dtype=mm.dtype,
                                    device=dev)
            zeros = torch.zeros((T, mm.nu), dtype=mm.dtype, device=dev)
            cfg = DirectConfig(gn_iters=3)

            def denoise():
                return direct_optimize(mm, cfg, sen, tt(noisy), tt(ys),
                                       zeros, dt)
            denoise()                                   # warm-up
            r, ms = timer.once(denoise)
            before = np.abs(noisy[1:-1, 7:] - qs[1:-1, 7:]).mean()
            after = np.abs(r.qpos[1:-1, 7:].double().cpu().numpy()
                           - qs[1:-1, 7:]).mean()
            d = {"cost_initial": float(r.cost_initial),
                 "cost": float(r.cost), "err_before": before,
                 "err_after": after, "ratio": after / before,
                 "cost_falls": float(r.cost) < float(r.cost_initial),
                 "ms": ms}
            if label == "float64" and device != "cpu":
                # one Gauss-Newton iteration profiled (the three of the
                # call ~42 k launches take ~50 s under the profiler)
                cfg1 = DirectConfig(gn_iters=1)

                def one():
                    return direct_optimize(mm, cfg1, sen, tt(noisy), tt(ys),
                                           zeros, dt)
                _, ms1 = timer.once(one)
                busy, n = profile_busy_ms(one)
                d["one_iteration"] = {"ms": ms1, "device_busy_ms": busy,
                                      "cuda_launches": n,
                                      "idle_share": 1.0 - busy / ms1}
            cfg6 = DirectConfig(gn_iters=6, estimate_params=("mass_scale", ),
                                contact_forces=True, force_weight=1e-2)
            r, ms = timer.once(lambda: direct_optimize(
                mm, cfg6, sen, tt(qf), tt(yf), zeros + 0.4, dt))
            w = {"cost_initial": float(r.cost_initial),
                 "cost": float(r.cost), "mass_scale": float(r.mass_scale),
                 "cost_falls": float(r.cost) < float(r.cost_initial),
                 "ms": ms}
            res[label] = {"denoise": d, "mass_scale": w}
        d, w = res["float64"]["denoise"], res["float64"]["mass_scale"]
        assert d["cost_falls"] and d["ratio"] < 0.7, res
        assert w["cost_falls"] and abs(w["mass_scale"] - 1.15) < 0.05, res
        return res

    loop("ekf", ekf_case)
    loop("ukf", ukf_case)
    loop("batch", batch_case)
    loop("direct", direct_case)
    return out


def serving_filter(device, timer, requests=SERVE_REQUESTS):
    """tests/test_serving.py's shoved robot: a stand pushed at 0.4 m/s
    along x, stepped by the port at zero control, its reports folded
    into a ServingFilter; after SERVE_FILTER_UPDATES the root's x
    velocity within 0.05 of the truth and the velocity error under 0.6
    of the zero-velocity rebuild's. Then the Agent with the sampling
    planner at its defaults behind MPCServer(filter="ekf"), `requests`
    TCP requests of the shoved robot's reports after a first one that
    initializes the filter: every reply 12 finite floats; median and
    p90 latency; launches a request (the plan's and one EKF predict)."""
    import threading
    from humanoid_mujoco_torch.agent import Agent
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import step
    from humanoid_mujoco_torch.serving import MPCServer, ServingFilter
    from humanoid_mujoco_torch.tasks import stand_task
    m = humanoid.build_humanoid(device=device)
    v0 = torch.zeros(m.nv)
    v0[0] = SERVE_FILTER_SHOVE
    s = make_state(m, qpos=humanoid.stand_qpos(m), qvel=v0)
    u = torch.zeros((1, m.nu), dtype=m.dtype, device=m.device)
    # the shoved robot's reports, stepped before the counters are zeroed
    reports, truth = [], []
    for _ in range(SERVE_FILTER_UPDATES):
        q, v = s.qpos[0].cpu().numpy(), s.qvel[0].cpu().numpy()
        reports.append(dict(joint_pos=q[7:].tolist(),
                            joint_vel=v[6:].tolist(),
                            ang_vel=v[3:6].tolist(), quat=q[3:7].tolist()))
        truth.append(v[:3].astype(np.float64))
        s, _ = step(m, s, u)
    f = ServingFilter(m)
    counters_zero()
    t0 = time.perf_counter()
    for rep in reports:
        est_s = f.update(**rep, last_ctrl=np.zeros(12))
    est_v = est_s.qvel[0, :3].double().cpu().numpy()
    wall = time.perf_counter() - t0
    truth_v = truth[-1]
    out = {"updates": SERVE_FILTER_UPDATES, "wall_s": wall,
           "launches": counters(), "est_root_v": est_v.tolist(),
           "truth_root_v": truth_v.tolist(),
           "vx_err": float(abs(est_v[0] - truth_v[0])),
           "v_err_ratio_vs_zero": float(np.linalg.norm(est_v - truth_v)
                                        / np.linalg.norm(truth_v))}
    assert np.all(np.isfinite(est_v)), out
    assert out["vx_err"] < 0.05, out
    assert out["v_err_ratio_vs_zero"] < 0.6, out
    if device != "cpu":
        # the first report initializes the filter (no step), every later
        # one runs one EKF predict
        n = SERVE_FILTER_UPDATES - 1
        assert out["launches"] == {"smooth": n, "solver": n, "euler": 0}, \
            out["launches"]
    # MPCServer(filter="ekf") over TCP
    agent = Agent(m, stand_task(device=device), planner="sampling")
    srv = MPCServer(agent, planner_iterations=SERVE_ITERS, port=0,
                    filter="ekf")
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    assert srv.listening.wait(30.0), "the server did not bind"
    srv.compute_action(**reports[0])         # initializes the filter
    assert srv._filter is not None and srv._filter.ekf is not None
    reqs = [json.dumps(r).encode() for r in reports[1:requests + 1]]
    result = {}
    counters_zero()
    client = threading.Thread(target=serve_client,
                              args=(srv.port, reqs, result), daemon=True)
    client.start()
    client.join(timeout=600.0)
    if device != "cpu":
        torch.cuda.synchronize()
    launches = counters()
    srv.stop()
    server.join(timeout=30.0)
    assert not client.is_alive() and not server.is_alive(), \
        "the client or the server did not finish"
    replies, ms = result["replies"], result["ms"]
    assert len(replies) == requests, len(replies)
    for r in replies:
        assert isinstance(r, list) and len(r) == 12 \
            and np.all(np.isfinite(r)), r
    out["server"] = {
        "planner": "sampling", "requests": requests,
        "nsample": agent.cfg.nsample, "horizon": agent.cfg.horizon,
        "planner_iterations": SERVE_ITERS,
        "median_ms": float(np.median(ms)),
        "p90_ms": float(np.percentile(ms, 90)),
        "max_ms": float(np.max(ms)),
        "control_hz": 1e3 / float(np.median(ms)),
        "launches_per_request": {k: v / requests
                                 for k, v in launches.items()},
        "filter_time_s": float(srv._filter.state.time[0])}
    if device != "cpu":
        steps = SERVE_ITERS * agent.cfg.horizon + 1
        assert launches == {"smooth": steps * requests,
                            "solver": steps * requests, "euler": 0}, \
            launches
    out["launches_total"] = {k: out["launches"][k] + launches[k]
                             for k in launches}
    return out


def run_estimation(device="cuda", gpu="cpu"):
    """The estimation slice's phases: `estimation_kernels`,
    `estimation_loops`, `serving_filter`, `estimation_walls`. Returns
    each kernel's launches on the slice and B1's and B2's numbers at the
    UKF's batch of 73, for the kernel table."""
    timer = Timer(device)
    walls, t_all = {}, time.perf_counter()
    launches = {"smooth": 0, "solver": 0, "euler": 0}
    t0 = time.perf_counter()
    res, n, rows = estimation_kernels(device, timer)
    log("estimation_kernels", gpu=gpu, tol=TOL, **res)
    walls["estimation_kernels_s"] = time.perf_counter() - t0
    for k in launches:
        launches[k] += n[k]
    t0 = time.perf_counter()
    res = estimation_loops(device, timer)
    log("estimation_loops", gpu=gpu, **res)
    walls["estimation_loops_s"] = time.perf_counter() - t0
    for r in res.values():
        for k in launches:
            launches[k] += r["launches"][k]
    t0 = time.perf_counter()
    res = serving_filter(device, timer)
    log("serving_filter", gpu=gpu, **res)
    walls["serving_filter_s"] = time.perf_counter() - t0
    for k in launches:
        launches[k] += res["launches_total"][k]
    log("estimation_walls", **walls, total_s=time.perf_counter() - t_all)
    for k in launches:
        rows.setdefault(k, {})["launches_estimation"] = launches[k]
    return rows


# the planner slice: the rest of the planner library on the humanoid
# stand (plan model, float32, each planner at its JAX config defaults),
# the JAX planner tests' scenarios, the parallel Riccati pass and the RL
# tools
PLANNER_CALLS, PLANNER_TICKS, PLANNER_SIM_STEPS = 2, 10, 10
RICCATI_T = (17, 128, 512)
RICCATI_TOL = 1e-10
TUNE_TRIALS, TUNE_ITERS, TUNE_ENVS = 3, 2, 32
VIDEO_SECONDS = 0.2


def planner_suite(device):
    """(plan model, stand task, stand state, {name: (plan(generator) ->
    (policy, info), closed-loop plan_fn, initial policy, spline
    order)}): robust, sample-gradient, gradient and iLQS at their
    defaults, each plan from the stand state and the initial policy (the
    sample-gradient and iLQS states carried across a closed loop's
    ticks)."""
    import dataclasses
    from humanoid_mujoco_torch.mpc import make_plan_model
    from humanoid_mujoco_torch.ops.spline import SplineOrder
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.planners import (
        GradientConfig, ILQSConfig, RobustConfig, SampleGradientConfig,
        gradient_plan, ilqs_init, ilqs_plan, init_policy, robust_plan,
        sample_gradient_init, sample_gradient_plan)
    from humanoid_mujoco_torch.tasks import stand_task
    m = humanoid.build_humanoid(device=device)
    pm = make_plan_model(m, 0.02)
    task = stand_task(device=device)
    s0 = make_state(m, qpos=humanoid.stand_qpos(m))
    rc, sc, gc, ic = (RobustConfig(), SampleGradientConfig(),
                      GradientConfig(), ILQSConfig())
    p3, p5 = init_policy(m, 3), init_policy(m, gc.nknots)

    def sg_fn():
        box = {"gs": sample_gradient_init(pm, sc)}

        def fn(pm_, task_, pol, s, g):
            pol, box["gs"], info = sample_gradient_plan(
                pm_, task_, sc, pol, box["gs"], s, g)
            return pol, info
        return fn

    def ilqs_fn():
        box = {}

        def fn(pm_, task_, pol, s, g):
            ps = box.get("ps") or ilqs_init(pm_, ic, s, pol)
            ps = dataclasses.replace(ps, spline=pol)
            box["ps"], info = ilqs_plan(pm_, task_, ic, ps, s, g)
            return box["ps"].spline, info
        return fn

    def robust_fn(pm_, task_, pol, s, g):
        return robust_plan(pm_, task_, rc, pol, s, g)

    def gradient_fn(pm_, task_, pol, s, g):
        return gradient_plan(pm_, task_, gc, pol, s)

    suite = {"robust": (robust_fn, lambda: robust_fn, p3, SplineOrder.ZERO),
             "sample_gradient": (sg_fn(), sg_fn, p3, SplineOrder.ZERO),
             "gradient": (gradient_fn, lambda: gradient_fn, p5,
                          gc.order),
             "ilqs": (ilqs_fn(), ilqs_fn, p3, SplineOrder.ZERO)}
    return m, pm, task, s0, suite


def stand_loop(m, pm, task, s0, plan_fn, policy, order, device, seed=0):
    """PLANNER_TICKS plan -> act cycles (PLANNER_SIM_STEPS sim steps
    each) on the stand; the stand task's mean cost a sim step."""
    from humanoid_mujoco_torch import mpc
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    res = mpc.mpc_rollout(m, pm, task, plan_fn, policy, s0, g,
                          PLANNER_TICKS, PLANNER_SIM_STEPS,
                          mpc.spline_action_fn(order))
    return float(res.costs.mean()), float(res.final_state.qpos[0, 2])


def zero_plan(pm, task, policy, state, generator):
    """A plan_fn that keeps the policy (the zero-control loop)."""
    import types
    return policy, types.SimpleNamespace(best_return=torch.zeros(
        (), dtype=pm.dtype, device=pm.device))


def b1_env_errs(ker, ref):
    """Per-env errors of kernel B1's outputs against its twin's (each
    output's largest |ker - ref| over its largest |ref|), with far-slot
    `dist` sentinels (> 1e8) compared by identity: an env whose
    sentinels differ (a float32 rounding at the broadphase margin) gets
    an infinite error. Returns (errs (B,), sentinel-flip envs (B,))."""
    from humanoid_mujoco_torch.physics import fused_smooth
    errs, flip = [], None
    for n, r, o in zip(fused_smooth.NAMES, ref, ker):
        r, o = r.double(), o.double()
        if n == "dist":
            sr, so = r > 1e8, o > 1e8
            flip = (sr != so).flatten(1).any(dim=1)
            r = torch.where(sr, torch.zeros_like(r), r)
            o = torch.where(so, torch.zeros_like(o), o)
        if r.numel():
            errs.append((o - r).abs().flatten(1).amax(dim=1)
                        / (r.abs().max() + 1e-9))
    e = torch.stack(errs).amax(dim=0)
    return torch.where(flip, torch.full_like(e, float("inf")), e), flip


def b2_knife_envs(args, kw, rel=1e-6, seed=9):
    """Envs whose float64 B2 twin moves by more than TOL when the
    per-env float inputs are scaled by 1 + `rel` noise: a contact or
    limit row at its switch, where float32 rounding alone flips the
    active set."""
    from humanoid_mujoco_torch.physics import fused_solver
    twin = fused_solver.solve_step_raw_reference
    a64 = [a.double() if torch.is_tensor(a) and a.is_floating_point()
           else a for a in args]
    g = torch.Generator(device=args[0].device).manual_seed(seed)
    B = args[0].shape[0]
    pert = [a * (1 + rel * torch.randn(a.shape, generator=g, device=a.device,
                                       dtype=a.dtype))
            if i not in (8, 16, 17) and torch.is_tensor(a)
            and a.is_floating_point() and a.ndim and a.shape[0] == B else a
            for i, a in enumerate(a64)]
    return per_env_err(twin(*pert, **kw), twin(*a64, **kw)) > TOL


def planner_kernels(m, rec1, rec2, device, timer):
    """Kernels B1 and B2 on the robust planner's wrench-perturbed
    rollouts (batch K·R = 20, each env with its own wrench slice
    xfrc_seq[:, t], a strided view read in place): every recorded launch
    against its twin on the same inputs, per env within TOL, knife-edge
    envs (B1: a far-slot sentinel flipped; B2: `b2_knife_envs`) listed,
    not asserted on; then on the first step's inputs B1 relaunched on
    the strided slice, on a contiguous copy, on one env's wrenches at a
    batch stride of 0 (and its contiguous copy) and on the strided slice
    again: equal to the bit pairwise (the launch meta cached per stride
    tuple, `fused_smooth._smooth_meta`) and within TOL of the twin; each
    kernel's `kernel_ms`, wrapper and plain time and bound at batch 20.
    These launches are taken off the counters."""
    from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
    from humanoid_mujoco_torch.physics.solver import limit_rows_static
    n0, n1 = fused_smooth.LAUNCHES, fused_solver.LAUNCHES
    calls1 = [c for c in rec1.calls if c[0][1].shape[0] == 20]
    calls2 = [c for c in rec2.calls if c[0][0].shape[0] == 20]
    assert len(calls1) == len(calls2) == 17, (len(calls1), len(calls2))
    e1, f1, e2, k2 = [], [], [], []
    for (a1, kw1, ker1), (a2, kw2, ker2) in zip(calls1, calls2):
        xfrc = a1[4]
        assert xfrc is not None and not xfrc.is_contiguous(), xfrc.stride()
        e, flip = b1_env_errs(ker1, fused_smooth.smooth_raw_reference(*a1))
        e1.append(e)
        f1.append(flip)
        ref2 = fused_solver.solve_step_raw_reference(*a2, **kw2)
        e2.append(per_env_err(ker2, ref2))
        # the knife-edge test only where an env is over TOL
        k2.append(b2_knife_envs(a2, kw2) if bool((e2[-1] > TOL).any())
                  else torch.zeros_like(e2[-1], dtype=torch.bool))
    e1, f1, e2, k2 = (torch.stack(x) for x in (e1, f1, e2, k2))
    out = {"steps": len(calls1), "batch": 20, "tol": TOL,
           "xfrc_stride": list(calls1[0][0][4].stride()),
           "b1_max_rel_err": float(e1[~f1].max()),
           "b1_sentinel_flips": int(f1.sum()),
           "b2_max_rel_err_held": float(e2[~k2].max()),
           "b2_knife_edge_env_steps": int(k2.sum()),
           "b2_knife_edge_errs": e2[k2].tolist()}
    assert out["b1_max_rel_err"] <= TOL, out
    assert out["b2_max_rel_err_held"] <= TOL, out
    # the strides: strided, contiguous, batch stride 0, strided again
    (mm, qpos, qvel, ctrl, xfrc), _, first = calls1[0]
    x0 = xfrc[3:4].expand(20, -1, -1)
    assert x0.stride()[0] == 0
    runs = [fused_smooth.smooth_raw(mm, qpos, qvel, ctrl, x)
            for x in (xfrc, xfrc.contiguous(), x0, x0.contiguous(), xfrc)]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    out["strided_repeat_bitwise"] = same(runs[0], first) and same(runs[4],
                                                                  first)
    out["contiguous_equals_strided"] = same(runs[1], runs[0])
    out["stride0_equals_contiguous"] = same(runs[2], runs[3])
    e0, flip0 = b1_env_errs(runs[2], fused_smooth.smooth_raw_reference(
        mm, qpos, qvel, ctrl, x0))
    out["stride0_max_rel_err"] = float(e0[~flip0].max())
    assert all(out[k] for k in ("strided_repeat_bitwise",
                                "contiguous_equals_strided",
                                "stride0_equals_contiguous")), out
    assert out["stride0_max_rel_err"] <= TOL, out
    # times at batch 20
    a1, kw1, _ = calls1[0]
    a2, kw2, _ = calls2[0]
    nlim = len(limit_rows_static(m))
    rows = ({}, {})
    M, qf, qv = a2[:3]
    raw = a2[3:8] + a2[9:16]
    _, _, f, trace = solve_trace(M, qf, qv, raw, a2[8], kw2["lim_tab"])
    bb1 = bound(*smooth_cost(m, 20, nlim, fused_smooth._pack_params(m),
                             xfrc=True))
    bb2 = bound(*solve_cost(m, 20, a2[8], kw2["lim_tab"], f, trace))
    k1 = bare_kernel_ms("smooth", fused_smooth._smooth_launch_args(*a1),
                        device)
    k2 = bare_kernel_ms("solver", fused_solver._solver_launch_args(
        *a2, kw2["lim_tab"], kw2["niter"], 16), device)
    for row, k, fn, tw, (bms, by), err in (
            (rows[0], k1, lambda: fused_smooth.smooth_raw(*a1),
             lambda: fused_smooth.smooth_raw_reference(*a1), bb1,
             out["b1_max_rel_err"]),
            (rows[1], k2, lambda: fused_solver.solve_step_raw(*a2, **kw2),
             lambda: fused_solver.solve_step_raw_reference(*a2, **kw2), bb2,
             out["b2_max_rel_err_held"])):
        row.update(ms_batch20_wrenches=k, wrapper_ms_batch20=timer(fn, 20),
                   plain_ms_batch20=timer(tw, 5), bound_ms_batch20=bms,
                   bound_by_batch20=by, max_rel_err_batch20=err)
    out["kernel_ms"] = {"smooth": rows[0], "solver": rows[1]}
    fused_smooth.LAUNCHES, fused_solver.LAUNCHES = n0, n1
    return out, rows


def pendulum_model(device, dtype=torch.float64, dt=0.05):
    """The JAX planner tests' pendulum (tests/test_ilqg.py): one damped
    hinge, a ±10 motor, no floor."""
    from humanoid_mujoco_torch.physics.model import (ActuatorType,
                                                     JointType, ModelBuilder)
    b = ModelBuilder(dt=dt)
    b.has_floor = False
    body = b.add_body("pend", -1, mass=1.0, ipos=(0, 0, -0.5),
                      inertia=(0.05, 0.05, 0.001))
    jnt = b.add_joint("hinge", body, JointType.HINGE, axis=(0, 1, 0),
                      damping=0.1)
    b.add_actuator(jnt, ActuatorType.MOTOR, gear=1.0, ctrlrange=(-10, 10),
                   forcerange=(-10, 10))
    return b.finalize(dtype=dtype, device=device)


def pendulum_task(device, dtype=torch.float64):
    """Drive the hinge to π (upright) with small control."""
    from humanoid_mujoco_torch.ops.norms import NormType
    from humanoid_mujoco_torch.tasks.base import TermSpec, make_task

    def residual(m, task, state, info, ctrl):
        return torch.cat([state.qpos[:, :1] - task.params[0],
                          state.qvel[:, :1], ctrl], dim=-1)
    terms = (TermSpec("angle", 1, NormType.QUADRATIC),
             TermSpec("vel", 1, NormType.QUADRATIC),
             TermSpec("ctrl", 1, NormType.QUADRATIC))
    return make_task("pend-swing", terms, residual, (10.0, 0.1, 0.01),
                     params=(np.pi,), param_names=("target",), dtype=dtype,
                     device=device)


def planner_scenarios(device, pm, task, s0):
    """tests/test_planners_extra.py:73-139 on the card, with its bounds:
    the gradient planner on the float64 pendulum (10 iterations, below
    0.7 of the first nominal), iLQS (the second iteration below 0.75 of
    the first nominal), sample-gradient (3 iterations: a nonzero
    estimate, improvement >= -1e-6) and robust on the humanoid (the JAX
    test's float32 model: a finite return)."""
    from humanoid_mujoco_torch.ops.spline import SplineOrder
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.planners import (
        GradientConfig, ILQGConfig, ILQSConfig, RobustConfig,
        SampleGradientConfig, SamplingConfig, gradient_plan, ilqs_init,
        ilqs_plan, init_policy, robust_plan, sample_gradient_init,
        sample_gradient_plan)
    F64 = torch.float64
    m, ptask = pendulum_model(device), pendulum_task(device)
    ps0 = make_state(m)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    out = {}
    t0 = time.perf_counter()
    cfg = GradientConfig(nknots=5, horizon=25, n_linesearch=10,
                         order=SplineOrder.LINEAR)
    pol = init_policy(m, 5, dtype=F64)
    for i in range(10):
        pol, info = gradient_plan(m, ptask, cfg, pol, ps0)
        if i == 0:
            nominal0 = float(info.nominal_return)
    out["gradient"] = {"nominal0": nominal0,
                       "best": float(info.best_return),
                       "improvement": float(info.improvement),
                       "s": time.perf_counter() - t0}
    assert out["gradient"]["best"] < 0.7 * nominal0, out
    assert out["gradient"]["improvement"] >= -1e-6, out
    t0 = time.perf_counter()
    cfg = ILQSConfig(
        sampling=SamplingConfig(nsample=6, nknots=3, horizon=10,
                                solver_iters=3),
        ilqg=ILQGConfig(horizon=10, n_linesearch=4, solver_iters=3,
                        deriv_solver_iters=2))
    ps = ilqs_init(m, cfg, ps0, init_policy(m, 3, dtype=F64))
    ps, info = ilqs_plan(m, ptask, cfg, ps, ps0, g)
    ps, info2 = ilqs_plan(m, ptask, cfg, ps, ps0, g)
    out["ilqs"] = {"nominal0": float(info.nominal_return),
                   "best1": float(info.best_return),
                   "best2": float(info2.best_return),
                   "s": time.perf_counter() - t0}
    assert np.isfinite(out["ilqs"]["best1"]), out
    assert out["ilqs"]["best2"] < 0.75 * out["ilqs"]["nominal0"], out
    t0 = time.perf_counter()
    cfg = SampleGradientConfig(sampling=SamplingConfig(
        nsample=16, nknots=3, horizon=10, solver_iters=3, exploration=0.1))
    pol, gs = init_policy(m, 3, dtype=F64), sample_gradient_init(m, cfg)
    for _ in range(3):
        pol, gs, info = sample_gradient_plan(m, ptask, cfg, pol, gs, ps0, g)
    out["sample_gradient"] = {"grad_abs_sum": float(gs.grad.abs().sum()),
                              "improvement": float(info.improvement),
                              "s": time.perf_counter() - t0}
    assert out["sample_gradient"]["grad_abs_sum"] > 0.0, out
    assert out["sample_gradient"]["improvement"] >= -1e-6, out
    t0 = time.perf_counter()
    cfg = RobustConfig(sampling=SamplingConfig(nsample=6, nknots=3,
                                               horizon=4, solver_iters=3),
                       n_best=2, repetitions=2)
    pol2, info = robust_plan(pm, task, cfg, init_policy(pm, 3), s0, g)
    out["robust"] = {"best": float(info.best_return),
                     "s": time.perf_counter() - t0}
    assert pol2.values.shape == (3, pm.nu), pol2.values.shape
    assert np.isfinite(out["robust"]["best"]), out
    return out


def riccati_checks(device, timer):
    """The parallel Riccati pass against the sequential one in float64
    on the humanoid's own linearization at the stand (plan dt 0.02, a
    17-step zero-control nominal through the float64 twins,
    `trajectory_derivatives`; nx 36, nu 12), its knots tiled to T = 17,
    128 and 512, with the stand task's cost expansions and the last
    knot's as the terminal cost: K, k, P and p within RICCATI_TOL (max
    error over max value), each pass's median ms of 3 (CUDA events)."""
    from humanoid_mujoco_torch.mpc import make_plan_model
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import step
    from humanoid_mujoco_torch.planners.derivatives import (
        trajectory_derivatives)
    from humanoid_mujoco_torch.planners.parallel_riccati import (
        parallel_riccati, sequential_riccati)
    from humanoid_mujoco_torch.tasks import stand_task
    F64 = torch.float64
    pm = make_plan_model(humanoid.build_humanoid(dtype=F64, device=device),
                         0.02)
    s = make_state(pm, qpos=humanoid.stand_qpos(pm))
    u = torch.zeros((17, pm.nu), dtype=F64, device=device)
    qp, qv, tt = [s.qpos[0]], [s.qvel[0]], [s.time[0]]
    with twins():
        for t in range(17):
            s, _ = step(pm, s, u[t:t + 1])
            qp.append(s.qpos[0])
            qv.append(s.qvel[0])
            tt.append(s.time[0])
    d = trajectory_derivatives(pm, stand_task(dtype=F64, device=device),
                               torch.stack(qp), torch.stack(qv), u,
                               torch.stack(tt))
    out = {"nx": d.A.shape[1], "nu": d.B.shape[2], "tol": RICCATI_TOL}
    for T in RICCATI_T:
        idx = torch.arange(T, device=device) % 17
        args = [d.A[idx], d.B[idx],
                torch.zeros((T, d.A.shape[1]), dtype=F64, device=device),
                d.cxx[idx], d.cxu[idx], d.cuu[idx], d.cx[idx], d.cu[idx],
                d.cxx[-1], d.cx[-1]]
        par, seq = parallel_riccati(*args), sequential_riccati(*args)
        errs = {n: float((a[:T] - b).abs().max() / b.abs().max())
                for n, a, b in zip(("K", "k", "P", "p"), par, seq)}
        out[f"T{T}"] = {
            "max_rel_err": errs, "P_max": float(seq[2].abs().max()),
            "parallel_ms": timer(lambda: parallel_riccati(*args), 3),
            "sequential_ms": timer(lambda: sequential_riccati(*args), 3)}
        assert max(errs.values()) <= RICCATI_TOL, (T, errs)
    return out


class LoggedPruner:
    """A pruner that records each decision (trial, step, value, prune)
    of the one it wraps."""

    def __init__(self, inner):
        self.inner, self.decisions = inner, []

    def should_prune(self, step, value, completed_curves):
        d = self.inner.should_prune(step, value, completed_curves)
        self.decisions.append({"step": step, "value": value,
                               "completed": len(completed_curves),
                               "prune": bool(d)})
        return d


def tune_phase(device):
    """rl/tune's study, TPE with the median pruner, over TUNE_TRIALS
    trials of the port's PPO objective at TUNE_ITERS iterations and
    TUNE_ENVS envs (the JAX default is 16 trials x 12 iterations: the
    depth is cut to fit the time limit), its trials logged under build/:
    every trial ends, every pruning decision and the best parameters
    are reported."""
    from humanoid_mujoco_torch.rl import tune
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "tune.jsonl")
    if os.path.exists(path):
        os.remove(path)
    pruner = LoggedPruner(tune.MedianPruner())
    study = tune.Study(sampler=tune.TPESampler(seed=0), pruner=pruner,
                       log_path=path)
    t0 = time.perf_counter()
    best = study.optimize(tune.make_objective(
        iters=TUNE_ITERS, n_envs=TUNE_ENVS, device=device), TUNE_TRIALS,
        verbose=False)
    wall = time.perf_counter() - t0
    with open(path) as f:
        logged = [json.loads(ln) for ln in f]
    assert logged == study.trials and len(logged) == TUNE_TRIALS, logged
    assert all(t["state"] in ("COMPLETE", "PRUNED") for t in logged)
    assert np.isfinite(best["value"]), best
    return {"trials": logged, "pruning_decisions": pruner.decisions,
            "best": best, "wall_s": wall,
            "cut": f"{TUNE_TRIALS} trials x {TUNE_ITERS} iterations "
                   "(JAX default 16 x 12)"}


def video_phase(device):
    """rl/videos' record_episode for VIDEO_SECONDS with the zero policy
    on the card, then the viewer's trajectory_scene (stride 10) and
    export_html under build/. render_frame and render_trajectory need
    cv2, which this machine lacks: they are checked on the CPU only."""
    from humanoid_mujoco_torch.rl.videos import record_episode
    from humanoid_mujoco_torch.viz.viewer import export_html, trajectory_scene
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    em, traj = record_episode(None, seconds=VIDEO_SECONDS, device=device)
    rec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = trajectory_scene(em, traj, dt=0.002, stride=10)
    path = export_html(scene, os.path.join(root, "planners_viewer.html"))
    scene_s = time.perf_counter() - t0
    frames = np.asarray(scene["frames"])
    with open(path) as f:
        html = f.read()
    out = {"steps": int(traj.shape[0] - 1), "record_s": rec_s,
           "scene_s": scene_s, "frames": int(frames.shape[0]),
           "spheres": int(frames.shape[1]), "html_bytes": len(html),
           "root_z_first_last": [float(traj[0, 2]), float(traj[-1, 2])]}
    assert np.all(np.isfinite(traj)) and np.all(np.isfinite(frames)), out
    assert out["steps"] == int(VIDEO_SECONDS * 500), out
    assert html.startswith("<!DOCTYPE html>") and "const S = {" in html
    return out


def run_planners(device="cuda", gpu="cpu", calls=PLANNER_CALLS):
    """The planner slice's phase `planners`: for robust, sample-gradient,
    gradient and iLQS at their defaults on the humanoid stand, `calls`
    plan calls (median ms by CUDA events; B1, B2, B3 launches a call by
    the counters; device busy ms, CUDA launches and idle share of one
    call by torch.profiler), B1 and B2 on the robust plan's batch-20
    wrench-perturbed steps against their twins (`planner_kernels`), and
    a PLANNER_TICKS-tick closed loop with each beside the zero-control
    loop (reported, not gated); the JAX tests' scenarios
    (`planner_scenarios`); `riccati_checks`; `tune_phase`;
    `video_phase`. Returns the kernel rows' additions."""
    from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
    t_all = time.perf_counter()
    timer = Timer(device)
    m, pm, task, s0, suite = planner_suite(device)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    plans, launches = {}, {"smooth": 0, "solver": 0, "euler": 0}
    rec_out = None
    walls = {}
    for name, (plan_fn, make_fn, pol0, order) in suite.items():
        t_plan = time.perf_counter()
        plan_fn(pm, task, pol0, s0, g)                     # warm-up
        counters_zero()
        ms = []
        for _ in range(calls):
            if name == "robust" and rec_out is None:
                with record([fused_smooth], "smooth_raw") as rec1, \
                        record([fused_solver], "solve_step_raw") as rec2:
                    (_, info), t = timer.once(
                        lambda: plan_fn(pm, task, pol0, s0, g))
                rec_out = (rec1, rec2)
            else:
                (_, info), t = timer.once(
                    lambda: plan_fn(pm, task, pol0, s0, g))
            ms.append(t)
        n = counters()
        for k in launches:
            launches[k] += n[k]
        r = {"median_ms": float(np.median(ms)), "ms": ms,
             "launches_per_call": {**{k: v / calls for k, v in n.items()},
                                   "total": sum(n.values()) / calls},
             "best_return": float(info.best_return)}
        if device != "cpu":
            t0 = time.perf_counter()
            busy, nl = profile_busy_ms(lambda: plan_fn(pm, task, pol0, s0,
                                                       g))
            r["profile_wall_s"] = time.perf_counter() - t0
            r.update(device_busy_ms=busy, cuda_launches=nl,
                     idle_share=1.0 - busy / r["median_ms"])
        n0 = counters()
        t0 = time.perf_counter()
        cost, z = stand_loop(m, pm, task, s0, make_fn(), pol0, order, device)
        r["loop"] = {"mean_stand_cost": cost, "final_root_z": z,
                     "wall_s": time.perf_counter() - t0}
        n1 = counters()
        for k in launches:
            launches[k] += n1[k] - n0[k]
        plans[name] = r
        walls[f"{name}_s"] = time.perf_counter() - t_plan
    cost, z = stand_loop(m, pm, task, s0, zero_plan, suite["robust"][2],
                         suite["robust"][3], device)
    plans["zero_control_loop"] = {"mean_stand_cost": cost,
                                  "final_root_z": z}
    if device != "cpu":
        for name, r in plans.items():
            if name in suite:
                per = r["launches_per_call"]
                assert per["smooth"] > 0 and per["solver"] > 0, (name, per)
                assert per["euler"] == 0, (name, per)
    t0 = time.perf_counter()
    kern, rows = planner_kernels(m, *rec_out, device, timer)
    walls["planner_kernels_s"] = time.perf_counter() - t0
    log("planners", gpu=gpu, calls=calls, ticks=PLANNER_TICKS,
        sim_steps_per_tick=PLANNER_SIM_STEPS, plans=plans,
        kernels_robust_batch20=kern)
    t0 = time.perf_counter()
    n0 = counters()
    scen = planner_scenarios(device, pm, task, s0)
    walls["planner_scenarios_s"] = scen["wall_s"] = time.perf_counter() - t0
    log("planner_scenarios", gpu=gpu, **scen)
    t0 = time.perf_counter()
    ric = riccati_checks(device, timer)
    walls["riccati_s"] = time.perf_counter() - t0
    log("riccati", gpu=gpu, wall_s=walls["riccati_s"], **ric)
    tn = tune_phase(device)
    walls["tune_s"] = tn["wall_s"]
    log("tune", gpu=gpu, **tn)
    print("tune best params: " + json.dumps(tn["best"]["params"]),
          flush=True)
    vid = video_phase(device)
    log("videos", gpu=gpu, **vid)
    n1 = counters()
    for k in launches:
        launches[k] += n1[k] - n0[k]
    walls["videos_s"] = vid["record_s"] + vid["scene_s"]
    log("planners_walls", **walls, total_s=time.perf_counter() - t_all,
        launches=launches)
    rows[0]["launches_planners"] = launches["smooth"]
    rows[1]["launches_planners"] = launches["solver"]
    return rows, {"launches_planners": launches["euler"]}


# bench.py's handover8191x128 cell: predictive sampling at its settings
# (one solver iteration, under which every 128-step candidate of the
# Handover diverges by step ~30, in the JAX kernel branch as in the
# port: tests/test_torch_contact.py's witness); then a 1024-sample plan
# at the step's default 8 iterations, whose candidates must stay finite
HANDOVER_N, HANDOVER_H, HANDOVER_K = 8191, 128, 4
HANDOVER_CALLS, HANDOVER_CHECK_N = 2, 1024
# the profiled plans: 4 sessions of a 4-step plan of the same width
HANDOVER_PROFILE_H, HANDOVER_PROFILE_SESSIONS = 4, 4
# the divergence witness (tests/test_torch_contact.py, `witness_inputs`:
# numpy seed 12, 6 candidates of the cell, candidate 0 the nominal); the
# first diverged step of each in the JAX kernel branch's float64 rollout
# at 1 solver iteration, which that test holds the port's float64 step
# to; the card's float32 steps must lie within WITNESS_SLACK of them
WITNESS_SEED, WITNESS_N, WITNESS_SLACK = 12, 6, 2
WITNESS_JAX_STEPS = (30, 27, 27, 28, 27, 28)


def rk4_vs_float64(name, m, qpos, qvel, ctrl):
    """One `step_rk4` (plain PyTorch on `forward`, with its top-k slot
    selection) of these states against the CPU's float64 step_rk4 on the
    same inputs (`per_env_err`). An env over TOL is ill-conditioned where
    the float64 result itself moves over TOL when the state moves by
    1e-7 N in the tangent space (float32's rounding of the inputs: a slot
    at the top-k cut, an active set at its boundary) or when its solves
    run 30 Newton iterations instead of 8 (a solve the 8 iterations leave
    unconverged, where float32 and float64 iterate apart): reported, not
    held; the others over TOL may be at most 0.5% of the batch."""
    from humanoid_mujoco_torch.physics.model import State
    from humanoid_mujoco_torch.physics.step import step_rk4
    from humanoid_mujoco_torch.physics.tangent import state_add
    from humanoid_mujoco_torch.tasks import task_model
    B = qpos.shape[0]
    t = torch.zeros(B, dtype=m.dtype, device=m.device)
    s2, _ = step_rk4(m, State(qpos, qvel, t), ctrl)
    m64 = task_model(name, dtype=torch.float64, device="cpu")
    q64, v64, t64, u64 = (x.double().cpu() for x in (qpos, qvel, t, ctrl))
    r2, _ = step_rk4(m64, State(q64, v64, t64), u64)

    def err(a, b):
        return per_env_err((a.qpos.cpu(), a.qvel.cpu()), (b.qpos, b.qvel))
    e = err(s2, r2)
    over = ~(e <= TOL)
    edge = unconverged = torch.zeros_like(over)
    if bool(over.any()):
        g = torch.Generator().manual_seed(3)
        dx = 1e-7 * torch.randn((B, 2 * m.nv), generator=g,
                                dtype=torch.float64)
        r3, _ = step_rk4(m64, State(state_add(m64, q64, dx[:, :m.nv]),
                                    v64 + dx[:, m.nv:], t64), u64)
        edge = ~(err(r3, r2) <= TOL)
        r4, _ = step_rk4(m64, State(q64, v64, t64), u64, solver_iters=30)
        unconverged = ~(err(r4, r2) <= TOL)
    ill = edge | unconverged
    out = {"batch": B, "envs_over_tol": int(over.sum()),
           "knife_edge_envs": int((over & edge).sum()),
           "unconverged_envs": int((over & unconverged).sum()),
           "max_err": float(e.max()), "median_err": float(e.median()),
           "max_err_well_conditioned": float(e[~ill].max())}
    assert int((over & ~ill).sum()) <= B // 200, (name, out)
    return out


def witness_noise(nu):
    """The divergence witness's standard-normal knots (WITNESS_N,
    HANDOVER_K, nu), numpy seed WITNESS_SEED; candidate 0 is the
    nominal (sample_candidates zeroes its noise)."""
    rng = np.random.default_rng(WITNESS_SEED)
    return rng.standard_normal((WITNESS_N, HANDOVER_K, nu))


def divergence_steps(m, cfg, nominal, cands, s0, keep_step=1):
    """Each candidate's first diverged step (-1 for none) in a rollout
    of `cands` (N, K, nu) from s0 through `step` at cfg.solver_iters,
    stopped once every candidate has diverged (or at cfg.horizon); and
    the states and controls of step `keep_step` (the plan's rollout, as
    `rollout_spline` runs it)."""
    from humanoid_mujoco_torch.ops.spline import spline_sample
    from humanoid_mujoco_torch.physics.model import State
    from humanoid_mujoco_torch.physics.step import step
    N = cands.shape[0]
    lo, hi = m.act_ctrlrange[:, 0], m.act_ctrlrange[:, 1]
    s = State(qpos=s0.qpos.expand(N, -1).contiguous(),
              qvel=s0.qvel.expand(N, -1).contiguous(),
              time=s0.time.expand(N).contiguous())
    first = torch.full((N,), -1, dtype=torch.long, device=m.device)
    kept = None
    for t in range(cfg.horizon):
        u = torch.clamp(spline_sample(nominal.times, cands, s.time,
                                      cfg.order), lo, hi)
        if t == keep_step:
            kept = (s.qpos, s.qvel, u)
        s, info = step(m, s, u, solver_iters=cfg.solver_iters)
        first = torch.where((first < 0) & info.diverged,
                            torch.full_like(first, t), first)
        if t >= keep_step and bool((first >= 0).all()):
            break
    return first, t + 1, kept


def handover_plan(device, timer, nsample=HANDOVER_N, horizon=HANDOVER_H,
                  calls=HANDOVER_CALLS, profile_horizon=HANDOVER_PROFILE_H,
                  check_nsample=HANDOVER_CHECK_N):
    """bench.py's handover8191x128 cell on the port: `sampling_plan` on
    the Bimanual Handover at nsample 8191 x horizon 128, 4 linear knots,
    1 solver iteration, from `aloha_home_qpos` with the policy at
    `home_ctrl` on every knot. `calls` timed plans (CUDA events), the
    first counted: median latency and rollout steps/s; launches a plan
    by the counters (B2 only, one a step); CUDA launches, busy ms a step
    and the idle share from HANDOVER_PROFILE_SESSIONS torch.profiler
    sessions of a `profile_horizon`-step plan of the same width. Then
    one more plan's candidates with the witness's (`witness_noise`)
    rolled until every one has diverged (`divergence_steps`): each
    candidate's divergence step (the witness's beside the JAX kernel
    branch's, WITNESS_JAX_STEPS), and B2 at the plan's one Newton
    iteration on the plan's first-step states against its twins
    (`against_twins`, `b2_row`; its launches not counted). Last, one
    plan of `check_nsample` candidates at 8 solver iterations: every
    return finite and under MAX_RETURN. Returns (numbers, B2's row)."""
    import dataclasses
    from humanoid_mujoco_torch.ops.spline import SplineOrder
    from humanoid_mujoco_torch.physics import fused_solver
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.solver import limit_rows_static
    from humanoid_mujoco_torch.planners import (SamplingConfig, init_policy,
                                                sampling_plan)
    from humanoid_mujoco_torch.planners.sampling import (plan_nominal,
                                                         sample_candidates)
    from humanoid_mujoco_torch.rollout import MAX_RETURN
    from humanoid_mujoco_torch.tasks.aloha import (aloha_home_qpos,
                                                   aloha_model,
                                                   handover_task, home_ctrl)
    m = aloha_model(device=device)
    task = handover_task(device=device)
    cfg = SamplingConfig(nsample=nsample, nknots=HANDOVER_K,
                         horizon=horizon, order=SplineOrder.LINEAR,
                         solver_iters=1)
    s0 = make_state(m, qpos=aloha_home_qpos(m))
    pol = init_policy(m, HANDOVER_K)
    pol = dataclasses.replace(pol, values=home_ctrl(m)[None].expand(
        HANDOVER_K, -1).clone())
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def plan(c=cfg):
        return sampling_plan(m, task, c, pol, s0, generator=gen)
    counters_zero()
    (_, info), t = timer.once(plan)
    n = counters()
    lat = [t] + [timer.once(plan)[1] for _ in range(calls - 1)]
    med = float(np.median(lat))
    out = {"nsample": nsample, "horizon": horizon, "knots": HANDOVER_K,
           "order": "linear", "solver_iters": cfg.solver_iters,
           "latency_ms": lat, "median_latency_ms": med,
           "rollout_steps_per_s": nsample * horizon / (med * 1e-3),
           "launches_per_plan": n,
           "best_return": float(info.best_return),
           "nominal_return": float(info.nominal_return),
           "improvement": float(info.improvement),
           "returns_finite": bool(torch.isfinite(info.returns).all()),
           "diverged_candidates": int((info.returns >= MAX_RETURN).sum())}
    assert out["returns_finite"] and out["improvement"] >= 0.0, out
    if device != "cpu":
        assert n == {"smooth": 0, "solver": horizon, "euler": 0}, n
        pcfg = dataclasses.replace(cfg, horizon=profile_horizon)
        prows, runs = profile_rows_complete(
            lambda: plan(pcfg), profile_horizon, HANDOVER_PROFILE_SESSIONS)
        busy = sum(x[2] for x in prows) / 1e3
        k = profile_horizon * HANDOVER_PROFILE_SESSIONS
        out["profile"] = {
            "horizon": k, "profiler_sessions": runs,
            "busy_ms_per_step": busy / k,
            "cuda_launches_per_step": sum(x[1] for x in prows) / k,
            "idle_share": 1.0 - busy / k / (med / horizon),
            "top": [(x[0][:60], x[1], x[2] / 1e3) for x in prows[:3]]}
    # one plan's candidates and the witness's, rolled until all diverge
    nominal = plan_nominal(m, cfg, pol, s0, "handover")
    wcfg = dataclasses.replace(cfg, nsample=WITNESS_N)
    cands = torch.cat([
        sample_candidates(m, cfg, nominal.values, gen),
        sample_candidates(m, wcfg, nominal.values,
                          noise=witness_noise(m.nu))])
    first, rolled, (q1, v1, u1) = divergence_steps(m, cfg, nominal, cands,
                                                   s0)
    hit = first[:nsample][first[:nsample] >= 0]
    out["divergence"] = {
        "steps_rolled": rolled, "candidates_diverged": int(hit.numel()),
        "per_step_counts": {i: int(c) for i, c in enumerate(
            torch.bincount(hit, minlength=rolled).tolist()) if c},
        "witness_steps": first[nsample:].tolist(),
        "witness_steps_jax_float64": WITNESS_JAX_STEPS}
    if horizon >= max(WITNESS_JAX_STEPS) + WITNESS_SLACK:
        assert all(abs(a - b) <= WITNESS_SLACK for a, b in zip(
            first[nsample:].tolist(), WITNESS_JAX_STEPS)), out["divergence"]
    # B2 at the plan's iterations on its first-step states
    n0 = counters()
    lim_tab = limit_rows_static(m)
    args = contact_solve_inputs(m, q1[:nsample], v1[:nsample],
                                u1[:nsample])
    _, out["b2_first_step"] = against_twins(
        fused_solver.solve_step_raw, fused_solver.solve_step_raw_reference,
        args, {"lim_tab": lim_tab, "niter": cfg.solver_iters},
        ("qacc", "qvel_new", "fslot", "qfrc_constraint"))
    row = b2_row(m, args, lim_tab, device, timer,
                 out["b2_first_step"]["max_abs_err"],
                 niter=cfg.solver_iters)
    row["batch"] = nsample
    out["b2_first_step"].update(niter=cfg.solver_iters, **row)
    fused_solver.LAUNCHES = n0["solver"]
    ccfg = dataclasses.replace(cfg, nsample=check_nsample, solver_iters=8)
    (_, cinfo), c_ms = timer.once(lambda: plan(ccfg))
    out["converged_check"] = {
        "nsample": check_nsample, "solver_iters": 8, "ms": c_ms,
        "best_return": float(cinfo.best_return),
        "nominal_return": float(cinfo.nominal_return),
        "diverged_candidates": int((cinfo.returns >= MAX_RETURN).sum())}
    assert out["converged_check"]["diverged_candidates"] == 0 \
        and float(cinfo.best_return) <= float(cinfo.nominal_return), out
    return out, row


def quadrotor_hovers(device):
    """tests/test_quadrotor.py:34-44 on the port: the Quadrotor at the
    hover thrust for 200 steps holds its position and velocity within
    1e-5."""
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import step
    from humanoid_mujoco_torch.tasks import home_qpos, task_model
    from humanoid_mujoco_torch.tasks.quadrotor import hover_ctrl
    m = task_model("Quadrotor", device=device)
    s = make_state(m, qpos=home_qpos("Quadrotor", m))
    u = torch.full((1, 4), hover_ctrl(m), dtype=m.dtype, device=m.device)
    div = False
    for _ in range(200):
        s, info = step(m, s, u)
        div |= bool(info.diverged.any())
    pos_err = float((s.qpos[0, :3] - torch.tensor(
        [0.0, 0.0, 0.3], device=m.device)).abs().max())
    out = {"steps": 200, "max_pos_err": pos_err,
           "max_qvel": float(s.qvel.abs().max()), "threshold": 1e-5}
    assert not div and pos_err < 1e-5 and out["max_qvel"] < 1e-5, out
    return out


def op3_settles(device):
    """tests/test_tasks_suite.py:385-413 on the port: OP3 settles 300
    steps from its home keyframe under its servo targets, the height
    residual under 0.02 and the normal force its weight within 5%."""
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import forward, step
    from humanoid_mujoco_torch.tasks import get_task, task_model
    from humanoid_mujoco_torch.tasks.op3 import op3_home_qpos
    m = task_model("OP3", device=device)
    task = get_task("OP3", device=device)
    s = make_state(m, qpos=op3_home_qpos(m))
    c = op3_home_qpos(m)[7:][None]
    zero = torch.zeros((1, m.nu), dtype=m.dtype, device=m.device)
    _, _, _, info = forward(m, s, zero)
    h_err = float(task.residual(m, s, info, zero)[0, 0])
    div = False
    for _ in range(300):
        s, info = step(m, s, c)
        div |= bool(info.diverged.any())
    weight = 9.81 * float(m.body_mass.sum())
    fn = float(info.contact_force.sum())
    out = {"steps": 300, "height_residual": h_err, "normal_force": fn,
           "weight": weight,
           "thresholds": {"height_residual": 0.02, "force_rel": 0.05}}
    assert not div and abs(h_err) < 0.02 \
        and abs(fn - weight) <= 0.05 * weight, out
    return out


def panda_holds(device):
    """Panda holds its home pose CONTACT_HOLD_STEPS steps under gravcomp
    and the home controls: the arm's joints drift under 0.05 rad."""
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import step
    from humanoid_mujoco_torch.tasks import panda, task_model
    m = task_model("Panda", device=device)
    q0 = panda.panda_home_qpos(m)
    s = make_state(m, qpos=q0)
    u = panda.home_ctrl(m)[None]
    div = False
    for _ in range(CONTACT_HOLD_STEPS):
        s, info = step(m, s, u)
        div |= bool(info.diverged.any())
    drift = float((s.qpos[0, :7] - q0[:7]).abs().max())
    out = {"steps": CONTACT_HOLD_STEPS, "max_arm_joint_drift": drift,
           "max_arm_qvel": float(s.qvel[0, :7].abs().max())}
    assert not div and drift < 0.05, out
    return out


def hand_holds(device, name):
    """tests/test_tasks_suite.py:506-540 on the port: the Allegro or
    Shadow hand under its keyframe servo targets for 300 steps from its
    home keyframe (a finite residual there): no step diverges, the cube
    stays at or above the hand (its height over its half size less 1
    mm) and within 0.15 m of its start in xy."""
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import forward, step
    from humanoid_mujoco_torch.tasks import get_task, hands, task_model
    hand = name.lower()
    m = task_model(name, device=device)
    task = get_task(name, device=device)
    key = hands._KEY_HAND[hand]
    s = make_state(m, qpos=hands._home_qpos(hand, m))
    zero = torch.zeros((1, m.nu), dtype=m.dtype, device=m.device)
    _, _, _, info = forward(m, s, zero)
    res = task.residual(m, s, info, zero)
    u = torch.tensor(key, dtype=m.dtype, device=m.device)[None]
    div = False
    for _ in range(HAND_HOLD_STEPS):
        s, info = step(m, s, u)
        div |= bool(info.diverged.any())
    n = len(key)
    cube = s.qpos[0, n:n + 3].double().cpu().numpy()
    start = np.asarray(hands._CUBE[hand]["pos"][:2])
    half = hands._CUBE[hand]["half"]
    out = {"steps": HAND_HOLD_STEPS, "cube_z": float(cube[2]),
           "cube_xy_drift": float(np.linalg.norm(cube[:2] - start)),
           "thresholds": {"cube_z_min": half - 1e-3, "xy_drift": 0.15},
           "residual_finite": bool(torch.isfinite(res).all())}
    assert not div and out["residual_finite"] \
        and cube[2] > half - 1e-3 and out["cube_xy_drift"] < 0.15, out
    return out


def reorient_settles(device):
    """tests/test_tasks_suite.py:427-455 on the port: Bimanual Reorient
    at its home keyframe under the home controls: both grasp scores of
    the residual are 1 (not grasping), then 200 steps, none diverged,
    the cross rests on the table (its height in (0.01, 0.05))."""
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import forward, step
    from humanoid_mujoco_torch.tasks import aloha, get_task, task_model
    name = "Bimanual Reorient"
    m = task_model(name, device=device)
    task = get_task(name, device=device)
    s = make_state(m, qpos=aloha.reorient_home_qpos(m))
    c = aloha.home_ctrl(m)[None]
    _, _, _, info = forward(m, s, c)
    res = task.residual(m, s, info, c)[0]
    div = False
    for _ in range(REORIENT_SETTLE_STEPS):
        s, info = step(m, s, c)
        div |= bool(info.diverged.any())
    z = float(s.qpos[0, 18])
    out = {"steps": REORIENT_SETTLE_STEPS, "nres": int(res.numel()),
           "grasp_scores": [float(x) for x in res[6:8]], "cross_z": z,
           "thresholds": {"cross_z": (0.01, 0.05)}}
    assert res.numel() == 26 and bool(torch.all(
        (res[6:8] - 1.0).abs() < 1e-6)) and not div and 0.01 < z < 0.05, out
    return out


def humanoid_stand_ilqg(device):
    """An iLQG Agent on Humanoid Stand: CONTACT_ILQG_TICKS ticks of
    planner_step and step from the stand keyframe, the stand cost beside
    the zero-control loop's (reported)."""
    from humanoid_mujoco_torch.agent import Agent
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import forward, step
    from humanoid_mujoco_torch.tasks import get_task, home_qpos, task_model
    from humanoid_mujoco_torch.tasks.base import cost_value
    name = "Humanoid Stand"
    m = task_model(name, device=device)
    task = get_task(name, device=device)
    q0 = home_qpos(name, m)
    a = Agent(m, name)
    a.set_state(qpos=q0)
    costs = []
    for _ in range(CONTACT_ILQG_TICKS):
        best = a.planner_step()
        a.step()
        costs.append(sum(a.get_cost_term_values().values()))
    s = make_state(m, qpos=q0)
    zero = torch.zeros((1, m.nu), dtype=m.dtype, device=m.device)
    for _ in range(CONTACT_ILQG_TICKS):
        s, _ = step(m, s, zero)
    _, _, _, info = forward(m, s, zero)
    out = {"ticks": CONTACT_ILQG_TICKS, "planner": a.planner,
           "best_return": best, "stand_costs": costs,
           "zero_control_cost": float(cost_value(task, task.residual(
               m, s, info, zero))[0]),
           "root_z": float(a.get_state()["qpos"][2])}
    assert np.isfinite(best) and np.all(np.isfinite(costs)), out
    return out


def run_handover(device="cuda", gpu="cpu", **kw):
    """The `handover` phase (`handover_plan`). Returns B2's numbers for
    the kernel table: the plan's launches and B2 at batch 8191."""
    timer = Timer(device)
    t0 = time.perf_counter()
    counters_zero()
    ho, row = handover_plan(device, timer, **kw)
    launches = counters()["solver"]
    log("handover", gpu=gpu, tol=TOL, wall_s=time.perf_counter() - t0,
        **ho)
    table = {"launches_handover": launches}
    table.update({f"{k}_handover_8191": v for k, v in row.items()
                  if k in ("ms", "wrapper_ms", "plain_ms", "bound_ms",
                           "bound_by", "flops", "max_abs_err")})
    return table


# the host surface and multi-GPU slice: the async plan thread, the
# async server, realtime eval, the live viewer, profiling, and the
# torch.distributed sharded plan and dp PPO step
ASYNC_SECONDS, ASYNC_HZ, ASYNC_NSAMPLE = 3.0, 100.0, 128
ASYNC_HAND_ITERS = {"sampling": 3, "ilqg": 1}
LIVE_SECONDS = 2.0
ASYNC_SERVE_PERIOD = 0.01    # the async requests' 100 Hz control period


class launch_log:
    """Within the block, each AsyncAgent.start first calls
    `on_start(agent)`, and from the first start on each launch of B1, B2
    or B3 (`kernels.launch`) records (kernel, launching thread, the CUDA
    stream it went on)."""

    def __init__(self, on_start=None):
        self.calls, self.agents, self.on_start = [], [], on_start

    def __enter__(self):
        import threading
        from humanoid_mujoco_torch import kernels
        from humanoid_mujoco_torch.native import async_agent
        self.saved = kernels.launch, async_agent.AsyncAgent.start
        launch, start = self.saved

        def spy(name, *a):
            if self.agents:
                self.calls.append((name, threading.get_ident(),
                                   torch.cuda.current_stream().cuda_stream))
            return launch(name, *a)

        def starting(agent):
            self.agents.append(agent)
            if self.on_start is not None:
                self.on_start(agent)
            return start(agent)
        kernels.launch = spy
        async_agent.AsyncAgent.start = starting
        return self

    def __exit__(self, *exc):
        from humanoid_mujoco_torch import kernels
        from humanoid_mujoco_torch.native import async_agent
        kernels.launch, async_agent.AsyncAgent.start = self.saved

    def plan_thread_only(self, device):
        """Every launch came from the one plan thread, none from the
        control side, on the plan thread's current stream (the device's
        default stream). Returns (threads, streams) for the log."""
        import threading
        threads = {t for _, t, _ in self.calls}
        streams = {s for _, _, s in self.calls}
        if device != "cpu":
            (aa,) = self.agents
            assert threads and threading.get_ident() not in threads, \
                "a kernel was launched on the control thread"
            assert len(threads) == 1, threads
            assert streams == {aa.plan_stream.cuda_stream} == {
                torch.cuda.default_stream().cuda_stream}, streams
        return len(threads), len(streams)


def async_run(device, planner, seconds, per_plan):
    """realtime_eval.run with `planner` for `seconds` at ASYNC_HZ (sampling
    at ASYNC_NSAMPLE): its rates and get_action's latency, the launches
    of B1 and B2 from AsyncAgent.start to the joined plan thread's last
    plan, held to plan iterations x `per_plan`, every one from the plan
    thread on its stream."""
    from humanoid_mujoco_torch.serving import realtime_eval
    with launch_log(on_start=lambda a: counters_zero()) as rec:
        out = realtime_eval.run(seconds=seconds, control_hz=ASYNC_HZ,
                                planner=planner, nsample=ASYNC_NSAMPLE,
                                horizon=17, verbose=False, device=device)
    launches = counters()
    threads, streams = rec.plan_thread_only(device)
    n = out["plan_iterations"]
    assert n > 0, out
    if device != "cpu":
        assert launches == {"smooth": n * per_plan, "solver": n * per_plan,
                            "euler": 0}, (launches, n, per_plan)
    return dict(planner=planner, seconds=seconds, control_hz=ASYNC_HZ,
                launches=launches, launches_per_plan=per_plan,
                launching_threads=threads, launch_streams=streams, **out)


def async_hand_driven(device, planner, iters, nsample=ASYNC_NSAMPLE,
                      seed=11):
    """`iters` hand-driven `_plan_once` calls of an AsyncAgent (its loop
    not started), each after a fresh state and with seeded candidate
    noise, against a synchronous Agent given the same states and noise:
    the published policy equal to the bit, get_action (on the CPU) within
    1e-5 of the Agent's on its device (relative to max(1, |u|))."""
    import pickle
    from humanoid_mujoco_torch.agent import Agent
    from humanoid_mujoco_torch.native.async_agent import AsyncAgent
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.tasks import stand_task
    m = humanoid.build_humanoid(device=device)
    a1, a2 = (Agent(m, stand_task(device=device), planner=planner,
                    nsample=nsample) for _ in range(2))
    aa = AsyncAgent(a1)
    rng = np.random.default_rng(seed)
    q0 = humanoid.stand_qpos(m).double().cpu().numpy()
    worst = 0.0
    for i in range(iters):
        q = q0.copy()
        q[7:] += 0.02 * rng.standard_normal(m.nq - 7)
        v = 0.1 * rng.standard_normal(m.nv)
        t = 0.02 * i
        noise = None
        if planner != "ilqg":
            noise = torch.tensor(rng.standard_normal(
                (nsample, a1.cfg.nknots, m.nu)), dtype=m.dtype,
                device=device)
        aa.set_state(q, v, t)
        aa._plan_once(noise=noise)
        a2.set_state(qpos=q, qvel=v, time=t)
        a2.planner_step(noise=noise)
        pub = pickle.loads(aa.policy_buf.read())
        ref = a2.pstate
        leaves = ([(pub.times, ref.times), (pub.values, ref.values)]
                  if planner != "ilqg" else
                  [(getattr(pub.policy, k), getattr(ref.policy, k))
                   for k in ("times", "qpos_nom", "qvel_nom", "u_nom", "K",
                             "k_scale")] + [(pub.reg, ref.reg)])
        for x, y in leaves:
            assert torch.equal(x, y.cpu()), (planner, i, "policy differs")
        u1 = aa.get_action(q, v, t)
        u2 = a2.get_action(time=t)
        worst = max(worst, float(np.max(np.abs(u1 - u2)))
                    / max(1.0, float(np.max(np.abs(u2)))))
    assert worst <= 1e-5, (planner, worst)
    return dict(planner=planner, iterations=iters, policy_bitwise=True,
                get_action_max_abs_err=worst)


def async_failure(device):
    """An exception raised on the plan thread stops the loop and is
    re-raised by get_action and by stop()."""
    from humanoid_mujoco_torch.agent import Agent
    from humanoid_mujoco_torch.native.async_agent import AsyncAgent
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.tasks import stand_task
    m = humanoid.build_humanoid(device=device)
    aa = AsyncAgent(Agent(m, stand_task(device=device), planner="sampling",
                          nsample=16, horizon=5))

    def boom(agent):
        raise ValueError("injected plan-thread failure")
    aa.start()
    aa.submit(boom)
    deadline = time.time() + 60.0
    while aa.loop.error is None and time.time() < deadline:
        time.sleep(0.01)
    q = humanoid.stand_qpos(m).double().cpu().numpy()
    raised = {}
    for name, fn in (("get_action", lambda: aa.get_action(
            q, np.zeros(m.nv), 0.0)), ("stop", aa.stop)):
        try:
            fn()
        except RuntimeError as e:
            assert isinstance(e.__cause__, ValueError), e.__cause__
            raised[name] = str(e.__cause__)
    assert set(raised) == {"get_action", "stop"}, raised
    return raised


def server_async(device, requests=SERVE_REQUESTS):
    """MPCServer(async_mode=True) with the sampling agent at the serving
    phase's settings: `requests` JSON requests at a 100 Hz period, each
    reply 12 finite floats from the latest published policy; the plan
    loop ran at least once; B1 and B2 launched only by it, 17 each a
    plan."""
    import threading
    from humanoid_mujoco_torch.agent import Agent
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.serving import MPCServer
    from humanoid_mujoco_torch.tasks import stand_task
    m = humanoid.build_humanoid(device=device)
    agent = Agent(m, stand_task(device=device), planner="sampling",
                  nsample=64, horizon=17)
    srv = MPCServer(agent, port=0, async_mode=True)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    assert srv.listening.wait(30.0), "the server did not bind"
    obs = serve_observations(m, requests)
    reqs = [json.dumps(o).encode() for o in obs]
    result = {}
    with launch_log(on_start=lambda a: counters_zero()) as rec:
        client = threading.Thread(
            target=serve_client, args=(srv.port, reqs, result),
            kwargs=dict(period=ASYNC_SERVE_PERIOD), daemon=True)
        client.start()
        client.join(timeout=300.0)
        (aa,) = rec.agents
        srv.stop()       # joins the plan thread; re-raises its failure
        server.join(timeout=30.0)
    launches = counters()
    assert not client.is_alive() and not server.is_alive()
    iters = aa.loop.iterations
    threads, streams = rec.plan_thread_only(device)
    for r in result["replies"]:
        assert isinstance(r, list) and len(r) == 12 \
            and np.all(np.isfinite(r)), r
    assert iters > 0, iters
    if device != "cpu":
        assert launches == {"smooth": 17 * iters, "solver": 17 * iters,
                            "euler": 0}, (launches, iters)
    ms = result["ms"]
    return dict(requests=requests, period_s=ASYNC_SERVE_PERIOD,
                median_ms=float(np.median(ms)),
                p90_ms=float(np.percentile(ms, 90)),
                max_ms=float(np.max(ms)), first_ms=float(ms[0]),
                plan_iterations=iters, launches=launches,
                launching_threads=threads, launch_streams=streams)


def live_session(device, seconds=LIVE_SECONDS):
    """A LiveSession on the cap humanoid served on 127.0.0.1 for about
    `seconds`: the page and the snapshot route answer, the snapshot
    advances, a set_weight reaches the plan thread's agent, and a push
    of the page's +X button moves the root along +x by 5 mm within
    0.06 s of sim after a physics tick applied it."""
    import urllib.request
    from humanoid_mujoco_torch.viz.live import LiveSession, serve_live
    session = LiveSession(task_name="Humanoid Cap Stand",
                          planner="sampling", nsample=64, horizon=17,
                          control_hz=50.0, realtime=True, device=device)
    counters_zero()
    session.start()
    srv = serve_live(session, port=0, block=False)
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.read()

    def post(path, payload):
        req = urllib.request.Request(base + path, method="POST",
                                     data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    try:
        status, page = get("/")
        assert status == 200 and b"const META =" in page, status
        t0 = time.time()
        s1 = json.loads(get("/state.json")[1])
        while s1["t"] == 0.0 and time.time() - t0 < 60:   # the first tick
            time.sleep(0.05)
            s1 = json.loads(get("/state.json")[1])
        time.sleep(seconds / 2)
        s2 = json.loads(get("/state.json")[1])
        assert s2["t"] > s1["t"] and len(s2["spheres"]) == len(
            session.meta["radii"]), (s1, s2)
        assert post("/set_weight", {"name": "Height", "value": 7.5}) == 200
        while (session.agent.get_cost_weights()["Height"] != 7.5
               and time.time() - t0 < 60):
            time.sleep(0.02)
        weight = session.agent.get_cost_weights()["Height"]
        # the push lasts _PUSH_SECONDS of wall time: post it again until
        # a physics tick has applied it, then let 0.06 s of sim pass
        x0 = float(session._state["qpos"][0])
        pushes = 0
        s3 = json.loads(get("/state.json")[1])
        while not s3.get("push_active") and time.time() - t0 < 120:
            assert post("/perturb", {"force": [30.0, 0.0, 0.0]}) == 200
            pushes += 1
            time.sleep(0.1)
            s3 = json.loads(get("/state.json")[1])
        t_push = s3["t"]
        while s3["t"] < t_push + 0.06 and time.time() - t0 < 120:
            time.sleep(0.05)
            s3 = json.loads(get("/state.json")[1])
        x1 = float(session._state["qpos"][0])
    finally:
        srv.shutdown()
        session.stop()      # re-raises a failure of either loop
    launches = counters()
    assert weight == 7.5, weight
    assert x1 - x0 > 5e-3, (x0, x1, pushes, s3)
    if device != "cpu":
        assert launches["smooth"] > 0 and launches["solver"] > 0, launches
        assert launches["smooth"] % 17 == 0, launches
    return dict(snapshot_t=[s1["t"], s2["t"], s3["t"]],
                control_hz=s3["control_hz"], plans_per_s=s3["plans_per_s"],
                weight_applied=weight, pushes_posted=pushes,
                root_dx_after_push=x1 - x0,
                launches=launches, wall_s=time.time() - t0)


def profiling_checks(device):
    """StageTimers around three sampling plans with block=True, and a
    torch.profiler trace (trace_to) of one whose file names B1's and
    B2's kernels."""
    import tempfile
    from humanoid_mujoco_torch.agent import Agent
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.tasks import stand_task
    from humanoid_mujoco_torch.utils import StageTimers, trace_to
    m = humanoid.build_humanoid(device=device)
    agent = Agent(m, stand_task(device=device), planner="sampling")
    agent.set_state(qpos=humanoid.stand_qpos(m))
    agent.planner_step()
    timers = StageTimers()
    for _ in range(3):
        with timers.section("planner_step", block=True,
                            result=agent.pstate):
            agent.planner_step()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    logdir = tempfile.mkdtemp(prefix="trace_", dir=root)
    with trace_to(logdir):
        if device != "cpu":
            # the first kernels of a session can go unrecorded
            time.sleep(0.05)
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
        agent.planner_step()
    path = os.path.join(logdir, "trace.json")
    text = open(path).read()
    size = os.path.getsize(path)
    import shutil
    shutil.rmtree(logdir, ignore_errors=True)
    names = {k: k in text for k in ("smooth_kernel", "solve_kernel")}
    if device != "cpu":
        assert all(names.values()), names
    return dict(stage_timers=timers.summary(), trace_bytes=size,
                trace_names=names)


def run_host(device="cuda", gpu="cpu", seconds=ASYNC_SECONDS,
             requests=SERVE_REQUESTS, live_seconds=LIVE_SECONDS,
             hand_iters=ASYNC_HAND_ITERS):
    """The host surface's phases: `async_agent` (the plan thread with the
    sampling planner and iLQG under realtime_eval's control loop, the
    hand-driven policy against a synchronous Agent, an injected
    plan-thread failure), `server_async`, `realtime_eval`
    (measure_async_rates), `live` and `profiling`. Returns B1's and B2's
    launches on these paths for the kernel table."""
    from humanoid_mujoco_torch.serving import realtime_eval
    t_all = time.perf_counter()
    walls = {}
    t0 = time.perf_counter()
    runs = [async_run(device, "sampling", seconds, 17),
            async_run(device, "ilqg", seconds, 34)]
    hand = [async_hand_driven(device, p, n) for p, n in hand_iters.items()]
    failure = async_failure(device)
    walls["async_agent_s"] = time.perf_counter() - t0
    log("async_agent", gpu=gpu, runs=runs, hand_driven=hand,
        failure_reraised=failure, switch_interval_s=sys.getswitchinterval())
    t0 = time.perf_counter()
    sa = server_async(device, requests)
    walls["server_async_s"] = time.perf_counter() - t0
    log("server_async", gpu=gpu, **sa)
    t0 = time.perf_counter()
    counters_zero()
    rates = realtime_eval.measure_async_rates(device=device)
    rt_launches = counters()
    walls["realtime_eval_s"] = time.perf_counter() - t0
    log("realtime_eval", gpu=gpu, launches=rt_launches, **rates)
    assert set(rates) == {"async_control_hz", "async_plans_per_s",
                          "async_action_latency_ms",
                          "async_action_latency_p99_ms"}, rates
    assert rates["async_plans_per_s"] > 0, rates
    t0 = time.perf_counter()
    live = live_session(device, live_seconds)
    walls["live_s"] = time.perf_counter() - t0
    log("live", gpu=gpu, **live)
    t0 = time.perf_counter()
    prof = profiling_checks(device)
    walls["profiling_s"] = time.perf_counter() - t0
    log("profiling", gpu=gpu, **prof)
    log("host_walls", **walls, total_s=time.perf_counter() - t_all)
    return tuple({"launches_async_sampling": runs[0]["launches"][k],
                  "launches_async_ilqg": runs[1]["launches"][k],
                  "launches_server_async": sa["launches"][k],
                  "launches_realtime_eval": rt_launches[k],
                  "launches_live": live["launches"][k]}
                 for k in ("smooth", "solver"))


def run_multi(device="cuda", gpu="cpu", nsample=PLAN_SAMPLES,
              horizon=PLAN_HORIZON, ppo_kw=None):
    """The `multi_gpu` phase: a one-rank process group (NCCL on the
    card, gloo on the CPU) on 127.0.0.1 through init_distributed; the
    candidate-sharded sampling plan of the cap humanoid at nsample x
    horizon against sampling_plan on the same noise, and the dp-sharded
    PPO step at PPOConfig's defaults against ppo_train_step from the
    same initial state, both to the bit; each timed, its launches
    counted; then the group destroyed. (One card: the two-rank math is
    held on the CPU, tests/test_torch_parallel.py.)"""
    import socket
    import torch.distributed as dist
    from humanoid_mujoco_torch.ops.spline import SplineOrder
    from humanoid_mujoco_torch.parallel import sharded_sampling_plan
    from humanoid_mujoco_torch.parallel.distributed import (
        dp_sharded_ppo_step, init_distributed, shard_env_batch)
    from humanoid_mujoco_torch.physics import humanoid
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.planners import (SamplingConfig, init_policy,
                                                sampling_plan)
    from humanoid_mujoco_torch.rl import env as E
    from humanoid_mujoco_torch.rl import ppo as P
    from humanoid_mujoco_torch.tasks import stand_task
    timer = Timer(device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mesh = init_distributed(f"127.0.0.1:{port}", 1, 0, device=device)
    try:
        backend, world = dist.get_backend(), mesh.size
        m = humanoid.build_humanoid(device=device)
        task = stand_task(device=device)
        cfg = SamplingConfig(nsample=nsample, nknots=3, horizon=horizon,
                             order=SplineOrder.ZERO)
        s0 = make_state(m, qpos=humanoid.stand_qpos(m))
        pol = init_policy(m, 3)
        noise = torch.tensor(np.random.default_rng(12).standard_normal(
            (nsample, 3, m.nu)), dtype=m.dtype, device=device)
        out = {}

        def sharded():
            out["sharded"] = sharded_sampling_plan(mesh, m, task, cfg, pol,
                                                   s0, noise=noise)

        def plain():
            out["plain"] = sampling_plan(m, task, cfg, pol, s0, noise=noise)
        plain()      # warm-up: the model's packs and tables,
        sharded()    # and the communicator of the first all_gather
        counters_zero()
        sharded_ms = [timer.once(sharded)[1] for _ in range(2)]
        plan_launches = counters()
        plain_ms = [timer.once(plain)[1] for _ in range(2)]
        (p1, i1), (p2, i2) = out["sharded"], out["plain"]
        assert torch.equal(i1.returns, i2.returns), "returns differ"
        assert torch.equal(p1.values, p2.values) and int(i1.winner) == int(
            i2.winner), "winner differs"

        kw = ppo_kw or {}
        pcfg = P.PPOConfig(**kw)
        base = E.rl_humanoid_model(device=device)
        env_cfg = E.EnvConfig()
        states = []
        for _ in range(2):
            gen = torch.Generator(device=device)
            gen.manual_seed(5)
            states.append(P.ppo_init(pcfg, env_cfg, base, 0.5, gen))
        st_dp, st = states
        st_dp.env_state = shard_env_batch(mesh, st_dp.env_state)
        st_dp.obs = shard_env_batch(mesh, st_dp.obs)
        counters_zero()
        (st_dp, met_dp), dp_ms = timer.once(
            lambda: dp_sharded_ppo_step(mesh, pcfg, env_cfg, base, st_dp))
        ppo_launches = counters()
        (st, met), ppo_ms = timer.once(
            lambda: P.ppo_train_step(pcfg, env_cfg, base, st))
        for a, b in zip(st_dp.params(), st.params()):
            assert torch.equal(a, b), "dp PPO parameters differ"
        for k in met:
            assert torch.equal(met_dp[k], met[k]), (k, met_dp[k], met[k])
        assert torch.equal(st_dp.obs, st.obs), "dp PPO obs differ"
        if device != "cpu":
            assert plan_launches == {"smooth": 2 * horizon,
                                     "solver": 2 * horizon, "euler": 0}, \
                plan_launches
            assert ppo_launches == {"smooth": pcfg.rollout_len,
                                    "solver": pcfg.rollout_len,
                                    "euler": 0}, ppo_launches
    finally:
        dist.destroy_process_group()
    res = dict(backend=backend, world_size=world, nsample=nsample,
               horizon=horizon, sharded_plan_ms=sharded_ms,
               plain_plan_ms=plain_ms, plan_bitwise=True,
               plan_launches=plan_launches,
               ppo=dict(n_envs=pcfg.n_envs, rollout_len=pcfg.rollout_len,
                        n_minibatch=pcfg.n_minibatch,
                        n_epochs=pcfg.n_epochs, hidden=pcfg.hidden),
               dp_ppo_ms=dp_ms, ppo_ms=ppo_ms, ppo_bitwise=True,
               ppo_loss=float(met["loss"]), ppo_launches=ppo_launches)
    log("multi_gpu", gpu=gpu, **res)
    return tuple({"launches_multi_sharded_plan": plan_launches[k],
                  "launches_multi_dp_ppo": ppo_launches[k]}
                 for k in ("smooth", "solver"))


# the golden MuJoCo replay: tests/fixtures/golden_mujoco.npz, two
# 250-step trajectories of the cap humanoid recorded from real MuJoCo
GOLDEN_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "fixtures", "golden_mujoco.npz")
GOLDEN_SEQS = ("zero", "sine")


def golden_bounds(g, name, qs):
    """tests/test_parity.py's bounds against MuJoCo on a replay `qs`
    (T, nq) of sequence `name`, asserted; returns the errors. Zero
    control: root height < 0.03, hinges < 0.10, the last height no more
    than 0.05 under MuJoCo's; sine control: the first 25 steps < 0.25,
    step 124's height within 0.08."""
    ref = g[f"{name}_qpos"]
    err = np.abs(qs - ref)
    if name == "zero":
        out = {"root_height": float(err[:, 2].max()),
               "hinges": float(err[:, 7:].max()),
               "last_height_drop": float(ref[-1][2] - qs[-1][2])}
        assert out["root_height"] < 0.03, out
        assert out["hinges"] < 0.10, out
        assert qs[-1][2] > ref[-1][2] - 0.05, out
    else:
        out = {"first_25": float(err[:25].max()),
               "height_124": float(abs(qs[124][2] - ref[124][2]))}
        assert out["first_25"] < 0.25, out
        assert out["height_124"] < 0.08, out
    out["max_abs_err"] = float(err.max())
    return out


def golden_replay(m, g, name):
    """qpos (250, nq) of the port's `step` at batch 1 from the fixture's
    qpos0 under its control sequence `name`, on m's device and dtype."""
    from humanoid_mujoco_torch.physics.model import make_state
    from humanoid_mujoco_torch.physics.step import step
    s = make_state(m, qpos=torch.as_tensor(g["qpos0"], dtype=m.dtype,
                                           device=m.device))
    ctrl = torch.as_tensor(g[f"{name}_ctrl"], dtype=m.dtype, device=m.device)
    qs = []
    for k in range(ctrl.shape[0]):
        s, _ = step(m, s, ctrl[k:k + 1])
        qs.append(s.qpos[0])
    return torch.stack(qs).double().cpu().numpy()


def golden_kernels_vs_float64(c1, c2, m64):
    """Each recorded B1 and B2 launch of the replay against its float64
    twin on the same input state (B1: the float32 state; B2: B1's
    float32 outputs), within TOL; steps over TOL (B1: a far-slot
    sentinel flipped) may be at most 0.5% of the steps, and B2's are
    listed with whether they are knife edges (`b2_knife_envs`)."""
    from humanoid_mujoco_torch.physics import fused_smooth, fused_solver
    e1, flips = [], 0
    for (m, qpos, qvel, ctrl, *rest), kw, out in c1:
        assert not rest or rest[0] is None, "the replay applies no wrench"
        ref = fused_smooth.smooth_raw_reference(m64, qpos.double(),
                                                qvel.double(),
                                                ctrl.double(), **kw)
        e, flip = b1_env_errs(out, ref)
        e1.append(float(e[0]))
        flips += int(flip.sum())
    e2, over = [], []
    for i, (args, kw, out) in enumerate(c2):
        a64 = [a.double() if torch.is_tensor(a) and a.is_floating_point()
               else a for a in args]
        ref = fused_solver.solve_step_raw_reference(*a64, **kw)
        e2.append(float(per_env_err(out, ref)[0]))
        if not e2[-1] <= TOL:
            over.append({"step": i, "err": e2[-1],
                         "knife_edge": bool(b2_knife_envs(args, kw)[0])})
    e1, e2 = np.array(e1), np.array(e2)
    out = {"steps": len(c1), "tol": TOL,
           "b1_max_rel_err": float(e1[np.isfinite(e1)].max()),
           "b1_median_rel_err": float(np.median(e1)),
           "b1_steps_over_tol": int((~(e1 <= TOL)).sum()),
           "b1_sentinel_flips": flips,
           "b2_max_rel_err": float(e2.max()),
           "b2_median_rel_err": float(np.median(e2)),
           "b2_steps_over_tol": len(over), "b2_over_tol": over}
    for k in ("b1_steps_over_tol", "b2_steps_over_tol"):
        assert out[k] <= int(0.005 * len(c1)), out
    return out


def golden_functions(m, m64, qs, g, seed=13):
    """engine.inverse_dynamics and engine.point_jacobian on the card's
    replay states (every 10th, qvel from the recording, numpy-seeded
    accelerations; five points around four bodies) against their float64
    twins on the same inputs, within TOL."""
    from humanoid_mujoco_torch.physics import engine
    rng = np.random.default_rng(seed)
    qpos = np.concatenate([qs[n][::10] for n in GOLDEN_SEQS])
    qvel = np.concatenate([g[f"{n}_qvel"][::10] for n in GOLDEN_SEQS])
    qacc = rng.standard_normal(qvel.shape)
    out = {"states": len(qpos)}
    args = [torch.as_tensor(x) for x in (qpos, qvel, qacc)]
    tau = engine.inverse_dynamics(m, *(a.to(m.device, m.dtype)
                                       for a in args))
    tau64 = engine.inverse_dynamics(m64, *(a.to(m64.device, m64.dtype)
                                           for a in args))
    out["inverse_dynamics_rel_err"] = rel_err(tau64, tau)
    kin = engine.fwd_position(m, args[0].to(m.device, m.dtype))
    kin64 = engine.fwd_position(m64, args[0].to(m64.device, m64.dtype))
    errs = []
    for body in (1, 3, 7, 12):
        pts = kin64.xpos[:, body, None] + 0.2 * torch.as_tensor(
            rng.standard_normal((len(qpos), 5, 3)), device=m64.device)
        errs.append(rel_err(engine.point_jacobian(m64, kin64, body, pts),
                            engine.point_jacobian(m, kin, body,
                                                  pts.to(m.dtype))))
    out["point_jacobian_rel_err"] = max(errs)
    assert out["inverse_dynamics_rel_err"] <= TOL, out
    assert out["point_jacobian_rel_err"] <= TOL, out
    return out


def run_golden(device="cuda", gpu="cpu"):
    """The `golden` phase: both golden MuJoCo sequences replayed through
    the port's humanoid step at batch 1 in float32 (B1 + B2 on the card)
    against tests/test_parity.py's bounds, every step's B1 and B2 launch
    against the float64 twins (`golden_kernels_vs_float64`), exactly 250
    B1 and 250 B2 launches a sequence, the largest error against MuJoCo
    beside the CPU twin's replay, and inverse_dynamics and point_jacobian
    on the replay's states (`golden_functions`). Returns B1's and B2's
    launches for the kernel table."""
    from humanoid_mujoco_torch.physics import (fused_smooth, fused_solver,
                                               humanoid)
    t0 = time.perf_counter()
    with np.load(GOLDEN_FIXTURE) as f:
        g = {k: f[k] for k in f.files}
    assert [str(a) for a in g["act_names"]] == list(
        humanoid.ACTUATED_JOINT_ORDER)
    m = humanoid.build_humanoid(device=device)
    m64 = humanoid.build_humanoid(dtype=torch.float64, device=device)
    cpu = humanoid.build_humanoid(device="cpu")
    qs, out = {}, {}
    counters_zero()
    with record((fused_smooth,), "smooth_raw") as r1, \
            record((fused_solver,), "solve_step_raw") as r2:
        for name in GOLDEN_SEQS:
            qs[name] = golden_replay(m, g, name)
    launches = counters()
    replay_s = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        n = sum(len(g[f"{k}_ctrl"]) for k in GOLDEN_SEQS)
        assert launches["smooth"] == n and launches["solver"] == n, launches
    for name in GOLDEN_SEQS:
        q_cpu = golden_replay(cpu, g, name)
        out[name] = {"card": golden_bounds(g, name, qs[name]),
                     "cpu_twin": golden_bounds(g, name, q_cpu),
                     "card_vs_cpu_twin_max_abs": float(
                         np.abs(qs[name] - q_cpu).max()),
                     "card_vs_cpu_twin_first25_max_abs": float(
                         np.abs(qs[name] - q_cpu)[:25].max())}
    kernels = golden_kernels_vs_float64(r1.calls, r2.calls, m64)
    funcs = golden_functions(m, m64, qs, g)
    log("golden", gpu=gpu, launches=launches, replay_s=replay_s,
        wall_s=time.perf_counter() - t0, kernels_vs_float64=kernels,
        functions=funcs, **out)
    return ({"launches_golden": launches["smooth"]},
            {"launches_golden": launches["solver"]})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # no TF32 in the derivative path's products and the Riccati recursion
    assert torch.get_float32_matmul_precision() == "highest"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from humanoid_mujoco_torch import kernels
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    # per function (B2's four instantiations: R = 1 or 2, static or
    # per-env mask): its name, registers, stack and spill bytes
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Function properties" in ln]
             for k, v in kernels.BUILD_LOG.items()}
    from humanoid_mujoco_torch.physics import (fused_smooth, fused_solver,
                                               humanoid)
    from humanoid_mujoco_torch.physics.solver import (contact_dmask,
                                                      limit_rows_static)
    from humanoid_mujoco_torch.tasks import task_model
    hm = humanoid.build_humanoid(device="cuda")
    smooth_occ = fused_smooth.smooth_occupancy(hm)
    nlim = len(limit_rows_static(hm))
    occupancy = fused_solver.solver_occupancy(
        hm.nv, hm.ncon, nlim,
        len(fused_solver.chain_layout(contact_dmask(hm))[1]))
    sw = task_model("Swimmer", device="cuda")
    euler_occ = {f"nv{nv}_rows{ne}": fused_solver.euler_occupancy(nv, ne)
                 for nv, ne in ((sw.nv, len(limit_rows_static(sw))),
                                (hm.nv, nlim + 10 * hm.ncon), (36, 360))}
    from humanoid_mujoco_torch.rl import env as rl_env
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rl_base = rl_env.rl_humanoid_model(device="cuda")
    es8, _ = rl_env.batch_reset(rl_env.EnvConfig(), rl_base, 1.0, 8, gen)
    smooth_occ_env = fused_smooth.smooth_occupancy(es8.patch.apply(rl_base))
    task_occ = task_occupancy()
    log("environment", gpu=smi, torch=torch.__version__,
        cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas,
        smooth_occupancy=smooth_occ,
        smooth_occupancy_per_env_packs=smooth_occ_env,
        solver_occupancy=occupancy,
        euler_occupancy=euler_occ, task_occupancy=task_occ,
        float32_matmul_precision=torch.get_float32_matmul_precision(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    table, b3_rows = run("cuda", gpu=smi)
    table.append(run_swimmer("cuda", gpu=smi, humanoid_b3=b3_rows))
    b1_golden, b2_golden = run_golden("cuda", gpu=smi)
    table[0].update(b1_golden)
    table[1].update(b2_golden)
    b1_rl, b2_rl, ckpt = run_rl("cuda", gpu=smi)
    table[0].update(b1_rl)
    table[1].update(b2_rl)
    # the task and estimation slices before serving: torch.profiler
    # drops launches after the serving phase's 75 k-launch iLQG trace
    task_rows = run_tasks("cuda", gpu=smi)
    for row, k in zip(table, ("smooth", "solver", "euler")):
        for name, r in task_rows[k].items():
            slug = name.lower().replace(" ", "_")
            row.update({f"{key}_{slug}": v for key, v in r.items()})
    (b1_pl, b2_pl), b3_pl = run_planners("cuda", gpu=smi)
    table[0].update(b1_pl)
    table[1].update(b2_pl)
    table[2].update(b3_pl)
    table[1].update(run_handover("cuda", gpu=smi))
    est_rows = run_estimation("cuda", gpu=smi)
    for row, k in zip(table, ("smooth", "solver", "euler")):
        row.update(est_rows[k])
    b1_sv, b2_sv, b3_sv = run_serving("cuda", gpu=smi, ckpt=ckpt)
    table[0].update(b1_sv)
    table[1].update(b2_sv)
    table[2].update(b3_sv)
    for rows in (run_host("cuda", gpu=smi), run_multi("cuda", gpu=smi)):
        table[0].update(rows[0])
        table[1].update(rows[1])
    log("total", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--short-profile"]:
        print(json.dumps(short_profile(*json.loads(sys.argv[2]))))
    else:
        main()
