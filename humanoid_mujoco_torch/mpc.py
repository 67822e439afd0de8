"""Closed-loop model-predictive control: plan -> act cycles.

Counterpart of humanoid_mujoco_tpu/mpc.py (the reference Agent's plan
loop, synchronous as in testspeed.cc): each cycle runs one planner
iteration on the planning model (coarse timestep, the reference's
agent_timestep) and then advances the simulation model (fine timestep)
under the updated policy. The simulation runs one state (batch 1)
through the same `step`, and so through the same kernels, as the
planner's rollouts: plan and sim share one solver.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .physics.model import Model, State
from .physics.step import step
from .planners.ilqg import ilqg_action
from .planners.policy import SplinePolicy, policy_action
from .tasks.base import Task, cost_value

# plan_fn: (plan_model, task, policy, state, generator) -> (policy, info)
PlanFn = Callable


@dataclasses.dataclass(frozen=True)
class MPCResult:
    final_state: State
    final_policy: SplinePolicy
    states: torch.Tensor        # (ncycle, steps_per_plan, nq) qpos trace
    ctrls: torch.Tensor         # (ncycle, steps_per_plan, nu)
    costs: torch.Tensor         # (ncycle, steps_per_plan) sim step costs
    plan_returns: torch.Tensor  # (ncycle,) best return of each plan
    final_task: Optional[Task] = None  # with run_transition: the task
    #   after the run (goals moved, mode advanced)


def spline_action_fn(order: int):
    """action_fn for spline policies: the policy at the state's time."""
    def fn(m, policy, s):
        return policy_action(m, policy, s.time, order)
    return fn


def ilqg_action_fn(m, policy, s):
    """action_fn for iLQG feedback policies: closes the K(t) loop at the
    sim rate, like the reference's physics thread (app.cc:90-93)."""
    return ilqg_action(m, policy, s.qpos, s.qvel, s.time)


def mpc_rollout(sim_model: Model, plan_model: Model, task: Task,
                plan_fn: PlanFn, policy, state: State,
                generator: Optional[torch.Generator], ncycle: int,
                steps_per_plan: int, action_fn, sim_solver_iters: int = 8,
                run_transition: bool = False) -> MPCResult:
    """Run `ncycle` plan -> act cycles from one state (batch 1).

    `plan_fn(plan_model, task, policy, state, generator)` returns the
    new policy and a plan info with `best_return`; `action_fn(m, policy,
    state)` gives the control at the sim rate. With `run_transition` the
    task's transition runs after every sim step, and the next plan sees
    the moved goal.
    """
    if state.batch != 1:
        raise ValueError("mpc_rollout runs one state (batch 1)")
    qpos, ctrls, costs, best = [], [], [], []
    for _ in range(ncycle):
        policy, info = plan_fn(plan_model, task, policy, state, generator)
        best.append(info.best_return)
        for _ in range(steps_per_plan):
            ctrl = action_fn(sim_model, policy, state)
            s_new, step_info = step(sim_model, state, ctrl,
                                    solver_iters=sim_solver_iters)
            res = task.residual(sim_model, state, step_info, ctrl)
            qpos.append(state.qpos[0])
            ctrls.append(ctrl[0])
            costs.append(cost_value(task, res)[0])
            if run_transition:
                task = task.transition(sim_model, s_new, step_info)
            state = s_new

    def grid(xs):
        x = torch.stack(xs)
        return x.reshape((ncycle, steps_per_plan) + x.shape[1:])

    return MPCResult(final_state=state, final_policy=policy,
                     states=grid(qpos), ctrls=grid(ctrls),
                     costs=grid(costs), plan_returns=torch.stack(best),
                     final_task=task if run_transition else None)


def make_plan_model(m: Model, plan_dt: float) -> Model:
    """Planning model: the sim model at the agent timestep."""
    return m.replace(dt=torch.as_tensor(plan_dt, dtype=m.dtype,
                                        device=m.device))
