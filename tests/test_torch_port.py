"""The PyTorch port's CPU parity suite, as one collected test.

The checks live in the tests/test_torch_*.py modules: math and ops, the
model, the twins of the three CUDA kernels, the step, rollouts and the
sampling planner, the Swimmer's constraint stage, step, rollout,
transition and MPC loop, the RL env (per-env parameters), SAC and PPO,
the serving slice (forward, the root-height search, MPPI, CEM, the
Agent, the TCP server, policy evaluation, MPC in the env), the iLQG
slice, the task library's sphere-and-joint tier, the estimation slice
(sensors, EKF, UKF, the batch estimator, the direct optimizer and its
service, the serving filter), the rest of the planner library and the
RL tools, the contact-rich model family, the top-k contact tier, the
host surface (the native runtime, AsyncAgent, the async server,
realtime eval, the live viewer, profiling, the gRPC servers), the
multi-GPU paths (the sharded plan and the dp PPO step on two gloo
ranks), the golden MuJoCo replay with the engine's and the solver's
last public functions, each against the JAX package on the same
numpy-seeded inputs, and the port's import isolation. This test runs
them all. The kernels themselves are checked on the card by
chip_smoke.py.

One item on purpose: the tier-1 command runs pytest-xdist with `--dist
load` against a time limit, xdist sizes its chunks from the number of
collected items, and more than one added item moves the seed's
500-3000 s tests onto other workers (ROADMAP.md, "Keep the count of
collected test items small"). Collected first (moved to a directory
whose name sorts first), its builds took the CPU the other workers'
tests need and the tier-1 count fell from 195 to 121 (ROADMAP.md, item
0), so it keeps its place by name.

The JAX references are built in at most POOL processes at once, a fresh
one each, the longest builds first (JOBS), through
tests/test_torch_refs.py's `build`: each process runs the JAX package's
Cholesky factor and solve as loops, held to the unrolled forms at 1e-13
on its models' mass matrices before the build and on a sample of the
matrices the build factored after it. The estimation slice's checks
that need no JAX reference (the JAX tests' scenarios on the port) and,
once its references are in, its checks against them run in that pool
too. Four
small references (the Swimmer's jitted step, rollout and MPC loop; the
jitted sampling plan; kernel B3's program in interpret mode; the eager
kernel-path step) are built in threads of this process: XLA compiles
outside the GIL, and JAX keeps `disable_jit` per thread. Meanwhile this
process runs the checks that need no reference (the host surface's
among them: its gRPC servers and robot proxies are processes of their
own), then each module's checks against its references, the modules in
about the order their last references come in; the multi-GPU checks, on
the RL slice's PPO reference, run two gloo ranks in two more processes,
then the dry run's two, from a thread.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import torch

import test_torch_constraints
import test_torch_contact
import test_torch_estimation
import test_torch_fused_smooth
import test_torch_golden
import test_torch_host
import test_torch_ilqg
import test_torch_import
import test_torch_math
import test_torch_model
import test_torch_parallel
import test_torch_planners
import test_torch_refs as refs
import test_torch_rl
import test_torch_rollout
import test_torch_serving
import test_torch_step
import test_torch_swimmer
import test_torch_tasks
import test_torch_topk

torch.set_num_threads(1)

# reference builds at once: a build's XLA compiles keep about two threads
# busy, so four fill an 8-core host (more would only queue for cores)
POOL = 4
# every reference build (module, name), the longest first (their seconds
# with POOL 4 on 8 cores, CHANGES.md)
JOBS = (
    ("test_torch_topk", None),
    ("test_torch_ilqg", "derivs"),
    ("test_torch_estimation", "filters"),
    ("test_torch_planners", "humanoid"),
    ("test_torch_ilqg", "plan"),
    ("test_torch_contact", "light"),
    ("test_torch_estimation", "batch"),
    ("test_torch_contact", "aloha"),
    ("test_torch_estimation", "residuals"),
    ("test_torch_estimation", "ekf_variants"),
    ("test_torch_contact", "op3"),
    ("test_torch_planners", "light"),
    ("test_torch_rl", "env"),
    ("test_torch_estimation", "direct_service"),
    ("test_torch_contact", "humanoid"),
    ("test_torch_serving", "physics"),
    ("test_torch_rl", "sac"),
    ("test_torch_golden", "golden"),
    ("test_torch_rl", "ppo"),
    ("test_torch_serving", "agent"),
    ("test_torch_serving", "evaluate"),
    ("test_torch_tasks", "light"),
    ("test_torch_serving", "planners"),
    ("test_torch_tasks", "quadruped_plan"),
    ("test_torch_tasks", "quadruped_step"),
    ("test_torch_tasks", "hill_step"),
)


def _names(module):
    return [n for m, n in JOBS if m == module]


def test_port_matches_jax():
    for module in (test_torch_contact, test_torch_estimation,
                   test_torch_golden, test_torch_ilqg, test_torch_planners,
                   test_torch_serving, test_torch_tasks):
        assert sorted(_names(module.__name__)) == sorted(module.NAMES)
    assert _names("test_torch_rl") == ["env", "sac", "ppo"]
    assert _names("test_torch_topk") == [None]
    # a fresh process for each job: XLA reads its flags once, at the
    # backend's start, and a finished build's memory goes with it
    with ProcessPoolExecutor(
            max_workers=POOL, max_tasks_per_child=1,
            mp_context=multiprocessing.get_context("spawn")) as procs, \
            ThreadPoolExecutor(max_workers=4) as pool:
        est_local = procs.submit(test_torch_estimation.run_local_checks)
        futs = {job: procs.submit(refs.build, *job) for job in JOBS}

        def refs_of(module):
            return {n: futs[(module, n)].result() for n in _names(module)}
        threads = {name: pool.submit(fn) for name, fn in (
            ("swimmer", test_torch_swimmer.jax_swimmer),
            ("plan", test_torch_rollout.jax_plan),
            ("b3", test_torch_constraints.jax_b3_interpret),
            ("composition", test_torch_step.jax_composition))}
        for module in (test_torch_math, test_torch_model, test_torch_import,
                       test_torch_fused_smooth):
            module.run_checks()
        for module in (test_torch_rl, test_torch_serving,
                       test_torch_planners, test_torch_tasks,
                       test_torch_contact, test_torch_topk,
                       test_torch_golden):
            module.run_local_checks()
        for name, module in (("composition", test_torch_step),
                             ("b3", test_torch_constraints),
                             ("plan", test_torch_rollout),
                             ("swimmer", test_torch_swimmer)):
            threads[name].result()
            module.run_checks()
        # no JAX reference: its gRPC servers and robot proxies are
        # processes of their own
        test_torch_host.run_checks()
        test_torch_topk.run_reference_checks(
            futs[("test_torch_topk", None)].result())
        test_torch_ilqg.run_checks(refs_of("test_torch_ilqg"))
        test_torch_planners.run_reference_checks(
            refs_of("test_torch_planners"),
            futs[("test_torch_rl", "env")].result())
        est_checks = procs.submit(test_torch_estimation.run_reference_checks,
                                  refs_of("test_torch_estimation"))
        test_torch_contact.run_reference_checks(refs_of("test_torch_contact"))
        test_torch_golden.run_reference_checks(
            futs[("test_torch_golden", "golden")].result())
        rl_refs = refs_of("test_torch_rl")
        test_torch_rl.run_reference_checks(rl_refs)
        # two gloo ranks, then the dry run's two, from a thread
        parallel = pool.submit(test_torch_parallel.run_checks, rl_refs["ppo"])
        test_torch_serving.run_reference_checks(refs_of("test_torch_serving"))
        test_torch_tasks.run_reference_checks(refs_of("test_torch_tasks"))
        est_local.result()
        est_checks.result()
        parallel.result()
