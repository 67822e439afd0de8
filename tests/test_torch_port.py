"""The PyTorch port's CPU parity suite, as one collected test.

The checks live in the other tests/test_torch_*.py modules: math and
ops, the model, the twins of the three CUDA kernels, the step, rollouts
and the sampling planner, the Swimmer's constraint stage, step, rollout,
transition and MPC loop, the RL env (per-env parameters), SAC and PPO,
the serving slice (forward, the root-height search, MPPI, CEM, the
Agent, the TCP server, policy evaluation, MPC in the env), the iLQG
slice, the task library's sphere-and-joint tier (models, tasks,
residuals, transitions, the four routes of the step, plans), the
estimation slice (sensors, EKF, UKF, the batch estimator, the direct
optimizer and its service, the serving filter), the rest of the planner
library (robust, sample-gradient, gradient, iLQS, parallel Riccati,
wrench-perturbed rollouts) and the RL tools (tune, plot, videos with
the renderer and the viewer), the contact-rich model family (capsule
and box narrowphase, fixed tendons, gravcomp, site actuators, RK4, the
upstream humanoid, OP3, Panda, PickAndPlace, FreeFingers, the Quadrotor
and the bimanual Handover), the top-k contact tier (Allegro, Shadow,
Bimanual Insert and Reorient, Humanoid Interact, Rubik: kernel B2's
twin with a per-env chain mask), the host surface (the native runtime,
AsyncAgent, the async server, realtime eval, the live viewer,
profiling, the gRPC servers) and the multi-GPU paths (the sharded plan
and the dp PPO step on two gloo ranks), each against the JAX package on
the same numpy-seeded inputs, and the port's import isolation. This test runs them all. The kernels themselves are checked
on the card by chip_smoke.py.

One item on purpose: the tier-1 command runs pytest-xdist with
`--dist load` against a time limit, xdist sizes its chunks from the
number of collected items, and more than one added item moves the
seed's 500-3000 s tests onto other workers (ROADMAP.md, "Keep the count
of collected test items small").

The four slow JAX references (the Swimmer's jitted step, rollout and
MPC loop, about 100 s; the jitted sampling plan, about 40 s; kernel B3's
program in interpret mode, about 30 s; the eager kernel-path step, about
22 s) are built in four more threads while the other checks run: XLA
compiles outside the GIL, and JAX keeps `disable_jit` per thread. All
are cached, so the checks that read them reuse the result. The RL
slice's three (the env's reset and steps with B1's per-env reference,
one SAC and one PPO train step), the serving slice's four (physics,
planners, agent, evaluate), the iLQG slice's two (the derivative
path, the plan), the task slice's four (the quadruped's step, the
hill's step, the quadruped's plan, the rest) and the estimation slice's
five (the filters with the serving filter, the EKF's variants, the
batch estimator, the direct residuals with ParticleFixed's optimize,
the direct service), the planner slice's two (the humanoid's wrench
rollout, robust and gradient plans; the pendulum planners, Riccati,
the renderer and the viewer) and the contact family's four (the four
plain-step models and the Handover's plan; the upstream humanoid; OP3
and the humanoid's derivatives; the Handover with its divergence
witness and derivatives) and the top-k tier's one (its six models'
steps, probes and residuals) are built in twenty-five processes: each is a
jit trace of a step, Python that holds the GIL, so threads would run
them one after another. The RL env's process also runs the JAX
`record_episode` the videos check reads. A twenty-sixth runs the
estimation slice's checks that need no JAX reference (the JAX tests'
scenarios on the port, about a minute), and a freed worker its checks
against the references, while this process runs the iLQG, task and
planner-slice checks. The host checks need no JAX reference (their
gRPC servers and robot proxies are processes of their own); the
multi-GPU checks, on the RL slice's PPO reference, run two gloo ranks
in two more processes (rank 0 compiles the JAX sharded plan), then the
dry run's two. Both run at the end, once the reference processes have
exited, so that their memory does not add to the peak.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import torch

import test_torch_constraints
import test_torch_contact
import test_torch_estimation
import test_torch_fused_smooth
import test_torch_host
import test_torch_ilqg
import test_torch_import
import test_torch_math
import test_torch_model
import test_torch_parallel
import test_torch_planners
import test_torch_rl
import test_torch_rollout
import test_torch_serving
import test_torch_step
import test_torch_swimmer
import test_torch_tasks
import test_torch_topk

torch.set_num_threads(1)


def test_port_matches_jax():
    names = ("env", "sac", "ppo")
    serving_names = test_torch_serving.NAMES
    ilqg_names = test_torch_ilqg.NAMES
    task_names = test_torch_tasks.NAMES
    est_names = test_torch_estimation.NAMES
    planner_names = test_torch_planners.NAMES
    contact_names = test_torch_contact.NAMES
    with ProcessPoolExecutor(
            max_workers=len(names) + len(serving_names) + len(ilqg_names)
            + len(task_names) + len(est_names) + len(planner_names)
            + len(contact_names) + 2,
            mp_context=multiprocessing.get_context("spawn")) as procs, \
            ThreadPoolExecutor(max_workers=4) as pool:
        planners = [procs.submit(test_torch_planners.reference, n)
                    for n in planner_names]
        contact = [procs.submit(test_torch_contact.reference, n)
                   for n in contact_names]
        topk = procs.submit(test_torch_topk.reference)
        ilqg = [procs.submit(test_torch_ilqg.reference, n)
                for n in ilqg_names]
        estimation = [procs.submit(test_torch_estimation.reference, n)
                      for n in est_names]
        est_local = procs.submit(test_torch_estimation.run_local_checks)
        tasks = [procs.submit(test_torch_tasks.reference, n)
                 for n in task_names]
        serving = [procs.submit(test_torch_serving.reference, n)
                   for n in serving_names]
        rl = [procs.submit(test_torch_rl.reference, n) for n in names]
        swimmer = pool.submit(test_torch_swimmer.jax_swimmer)
        plan = pool.submit(test_torch_rollout.jax_plan)
        b3 = pool.submit(test_torch_constraints.jax_b3_interpret)
        composition = pool.submit(test_torch_step.jax_composition)
        for module in (test_torch_math, test_torch_model, test_torch_import,
                       test_torch_fused_smooth):
            module.run_checks()
        test_torch_rl.run_local_checks()
        composition.result()
        test_torch_step.run_checks()
        b3.result()
        test_torch_constraints.run_checks()
        plan.result()
        test_torch_rollout.run_checks()
        rl_refs = {n: f.result() for n, f in zip(names, rl)}
        test_torch_rl.run_reference_checks(rl_refs)
        test_torch_serving.run_local_checks()
        test_torch_serving.run_reference_checks(
            {n: f.result() for n, f in zip(serving_names, serving)})
        # while the iLQG references finish
        test_torch_planners.run_local_checks()
        est_checks = procs.submit(
            test_torch_estimation.run_reference_checks,
            {n: f.result() for n, f in zip(est_names, estimation)})
        test_torch_ilqg.run_checks(
            {n: f.result() for n, f in zip(ilqg_names, ilqg)})
        test_torch_tasks.run_local_checks()
        test_torch_tasks.run_reference_checks(
            {n: f.result() for n, f in zip(task_names, tasks)})
        test_torch_planners.run_reference_checks(
            {n: f.result() for n, f in zip(planner_names, planners)},
            rl_refs["env"])
        test_torch_contact.run_local_checks()
        test_torch_contact.run_reference_checks(
            {n: f.result() for n, f in zip(contact_names, contact)})
        test_torch_topk.run_local_checks()
        test_torch_topk.run_reference_checks(topk.result())
        est_local.result()
        est_checks.result()
        swimmer.result()
    # after the reference processes have exited (their memory with them):
    # two gloo ranks from a thread while this process runs the rest
    with ThreadPoolExecutor(max_workers=1) as late:
        parallel = late.submit(test_torch_parallel.run_checks,
                               rl_refs["ppo"])
        test_torch_host.run_checks()
        test_torch_swimmer.run_checks()
        parallel.result()
