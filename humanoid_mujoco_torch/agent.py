"""Agent: the in-process MPC object of the reference's Agent service.

Counterpart of humanoid_mujoco_tpu/agent.py (the mjpc::Agent and gRPC
Agent service verbs, grpc/agent.proto:19-60). The API map:

  Init               -> Agent(model, task, planner=...)
  SetState           -> set_state(qpos=..., qvel=..., time=...)
  GetState           -> get_state()
  PlannerStep        -> planner_step()
  GetAction          -> get_action(time=None, averaging_duration=0)
  Step               -> step() (the policy's action + one sim step)
  Reset              -> reset()
  SetTaskParameters  -> set_task_parameter(name, value)
  SetCostWeights     -> set_cost_weights({name: w})
  GetResiduals       -> get_residuals()
  GetCostValuesAndWeights -> get_cost_term_values()
  GetBestTrajectory  -> best_trajectory()
  SetMode/GetMode    -> set_mode(mode) / get_mode()
  SetMocap           -> set_mocap(name, pos, quat)
  SetAnything        -> set_anything(model=..., state=..., task=...)

The state is held as a batch of one on the model's device. Plans roll
their candidates out through `step`, and `get_action(averaging_
duration>0)` and `step()` run the batch-1 sim through the same `step`
and the same solver iterations, so plan and sim share the kernels (B1
and B2 on the card) and their arithmetic. Randomness comes from one
`torch.Generator` seeded from `seed`; `planner_step(noise=...)` takes
the candidates' standard normals instead.

Planners: "ilqg" (the default, as in the JAX package), "sampling",
"cem" and "mppi". iLQG's rollouts (its nominal search at batch 4 and
line search at batch 8) run through `step`, and so through B1 and B2
on the card; its derivatives run through the plain `step(ift=True)`
(planners/derivatives.py). Its policy is a feedback policy, so its
action reads the state; `get_action(nominal_action=True)` drops the
feedback term.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .mpc import make_plan_model
from .physics.model import Model, State, make_state
from .physics.step import forward, step
from .planners import (CEMConfig, ILQGConfig, MPPIConfig, SamplingConfig,
                       cem_init, cem_plan, ilqg_action, ilqg_init, ilqg_plan,
                       init_policy, mppi_plan, policy_action, sampling_plan)
from .planners.derivatives import _light_info
from .tasks.base import cost_terms

PLANNERS = ("sampling", "ilqg", "cem", "mppi")


class Agent:
    """Synchronous in-process agent on the model's device."""

    def __init__(self, model: Model, task, planner: str = "ilqg",
                 plan_dt: float = 0.02, horizon: int = 17,
                 nsample: int = 64, seed: int = 0):
        if planner not in PLANNERS:
            raise ValueError(f"unknown planner {planner!r}; "
                             f"options: {PLANNERS}")
        if isinstance(task, str):
            # Init by task id (grpc Init task_id, agent.proto:21)
            from .tasks.registry import get_task
            task = get_task(task, dtype=model.dtype, device=model.device)
        self.model = model
        self.plan_dt = plan_dt
        self.plan_model = make_plan_model(model, plan_dt)
        self.task = task
        self.planner = planner
        self.state = make_state(model)
        self.generator = torch.Generator(device=model.device)
        self.generator.manual_seed(seed)
        self._last_info = None
        if planner == "ilqg":
            self.cfg = ILQGConfig(horizon=horizon)
        else:
            config = {"sampling": SamplingConfig, "cem": CEMConfig,
                      "mppi": MPPIConfig}[planner]
            self.cfg = config(nsample=nsample, horizon=horizon)
        self._reset_planner()

    def _reset_planner(self):
        """The planner state at its initial value: iLQG's zero policy
        anchored at the state, or the nominal spline (and CEM's std)."""
        if self.planner == "ilqg":
            self.pstate = ilqg_init(self.plan_model, self.cfg, self.state)
            return
        self.pstate = init_policy(self.model, self.cfg.nknots)
        if self.planner == "cem":
            self.cem_state = cem_init(self.model, self.cfg)

    # ---- state ----
    def _batch1(self, x, n):
        return torch.as_tensor(x, dtype=self.model.dtype,
                               device=self.model.device).reshape(1, n)

    def set_state(self, qpos=None, qvel=None, time=None):
        """SetState, then the task transition (the reference runs it on
        every state publish)."""
        s = self.state
        if qpos is not None:
            s = s.replace(qpos=self._batch1(qpos, self.model.nq))
        if qvel is not None:
            s = s.replace(qvel=self._batch1(qvel, self.model.nv))
        if time is not None:
            s = s.replace(time=self._batch1(time, 1)[0])
        self.state = s
        self._transition()

    def get_state(self):
        return dict(qpos=self.state.qpos[0].cpu().numpy(),
                    qvel=self.state.qvel[0].cpu().numpy(),
                    time=float(self.state.time[0]))

    def reset(self):
        self.state = make_state(self.model)
        self._reset_planner()

    def _transition(self):
        if self.task.transition_fn is not None:
            self.task = self.task.transition(
                self.model, self.state, _light_info(self.model, self.state))

    # ---- planning ----
    def planner_step(self, noise: Optional[torch.Tensor] = None) -> float:
        """One planner iteration against the current state
        (Agent::PlanIteration). `noise` (nsample, nknots, nu) standard
        normal replaces the draw from the agent's generator (iLQG draws
        nothing)."""
        kw = dict(generator=self.generator, noise=noise)
        if self.planner == "ilqg":
            self.pstate, info = ilqg_plan(self.plan_model, self.task,
                                          self.cfg, self.pstate, self.state)
        elif self.planner == "cem":
            self.pstate, self.cem_state, info = cem_plan(
                self.plan_model, self.task, self.cfg, self.pstate,
                self.cem_state, self.state, **kw)
        else:
            plan = sampling_plan if self.planner == "sampling" else mppi_plan
            self.pstate, info = plan(self.plan_model, self.task, self.cfg,
                                     self.pstate, self.state, **kw)
        self._last_info = info
        return float(info.best_return)

    def _policy_action(self, s: State, t, nominal: bool = False
                       ) -> torch.Tensor:
        """The policy's action (1, nu) at state s and times t (1,);
        `nominal` drops iLQG's feedback term (its k_scale set to 0)."""
        if self.planner == "ilqg":
            pol = self.pstate.policy
            if nominal:
                pol = pol.replace(k_scale=torch.zeros_like(pol.k_scale))
            return ilqg_action(self.model, pol, s.qpos, s.qvel, t)
        return policy_action(self.model, self.pstate, t, self.cfg.order)

    def _sim_step(self, s: State, u: torch.Tensor):
        return step(self.model, s, u, solver_iters=self.cfg.solver_iters)

    def get_action(self, time=None, averaging_duration: float = 0.0,
                   nominal_action: bool = False) -> np.ndarray:
        """The policy's action (nu,) at `time` (default: the state's).
        With `averaging_duration` > 0, the mean action over that long a
        sim rollout from the state (grpc_agent_util.cc:166-197).
        `nominal_action` skips iLQG's feedback term K·dx (the proto's
        nominal_action flag); the sampling planners have none."""
        t = self.state.time if time is None else self._batch1(time, 1)[0]
        if averaging_duration > 0:
            n = max(1, int(round(float(averaging_duration)
                                 / float(self.model.dt))))
            s, acts = self.state, []
            for _ in range(n):
                u = self._policy_action(s, t, nominal_action)
                acts.append(u[0])
                s, _ = self._sim_step(s, u)
                t = s.time
            return torch.stack(acts).mean(dim=0).cpu().numpy()
        return self._policy_action(self.state, t,
                                   nominal_action)[0].cpu().numpy()

    def step(self) -> np.ndarray:
        """The policy's action, then one sim step and the task
        transition (the Step RPC); returns the action (nu,)."""
        u = self._policy_action(self.state, self.state.time)
        self.state, _ = self._sim_step(self.state, u)
        self._transition()
        return u[0].cpu().numpy()

    # ---- task configuration ----
    def set_task_parameter(self, name: str, value: float):
        self.task = self.task.set_param(name, value)

    def set_cost_weights(self, weights: Dict[str, float]):
        for k, v in weights.items():
            self.task = self.task.set_weight(k, v)

    def get_cost_weights(self):
        return {t.name: float(self.task.weights[i])
                for i, t in enumerate(self.task.terms)}

    def set_mode(self, mode):
        self.task = self.task.set_mode(mode)

    def get_mode(self) -> str:
        return self.task.mode_names[int(self.task.mode)]

    def set_mocap(self, name: str, pos=None, quat=None):
        self.task = self.task.set_mocap(name, pos=pos, quat=quat)

    def get_mocap(self):
        return {n: dict(pos=self.task.mocap_pos[i].cpu().numpy(),
                        quat=self.task.mocap_quat[i].cpu().numpy())
                for i, n in enumerate(self.task.mocap_names)}

    def set_anything(self, model: Optional[Dict] = None,
                     state: Optional[Dict] = None,
                     task: Optional[Dict] = None):
        """SetAnything: task fields (parameters, cost weights, mode,
        risk), state fields and model leaves by name. A model edit
        derives a new Model (`dataclasses.replace`, whose cache starts
        empty) and a new plan model, keeping the sim state, planner
        state and generator; no leaf is edited in place, since a kernel
        may already have seen the model."""
        if task:
            for k, v in task.items():
                if k in self.task.param_names:
                    self.set_task_parameter(k, v)
                elif k in [t.name for t in self.task.terms]:
                    self.set_cost_weights({k: v})
                elif k == "mode":
                    self.set_mode(v)
                elif k == "risk":
                    self.task = dataclasses.replace(
                        self.task, risk=torch.as_tensor(
                            v, dtype=self.task.risk.dtype,
                            device=self.task.risk.device))
                else:
                    raise KeyError(f"unknown task field {k!r}")
        if state:
            self.set_state(**state)
        if model:
            updates = {}
            for k, v in model.items():
                ref = getattr(self.model, k)   # unknown name: AttributeError
                updates[k] = torch.as_tensor(
                    v, dtype=ref.dtype, device=ref.device).reshape(ref.shape)
            self.model = dataclasses.replace(self.model, **updates)
            self.plan_model = make_plan_model(self.model, self.plan_dt)

    # ---- introspection ----
    def get_residuals(self) -> np.ndarray:
        u0 = torch.zeros((1, self.model.nu), dtype=self.model.dtype,
                         device=self.model.device)
        info = forward(self.model, self.state, u0)[3]
        u = self._policy_action(self.state, self.state.time)
        return self.task.residual(self.model, self.state, info,
                                  u)[0].cpu().numpy()

    def get_cost_term_values(self):
        r = torch.as_tensor(self.get_residuals(), device=self.model.device)
        terms = cost_terms(self.task, r)
        return {t.name: float(terms[i])
                for i, t in enumerate(self.task.terms)}

    def best_trajectory(self):
        if self.planner == "ilqg":
            p = self.pstate.policy
            return dict(times=p.times.cpu().numpy(),
                        qpos=p.qpos_nom.cpu().numpy(),
                        qvel=p.qvel_nom.cpu().numpy(),
                        actions=p.u_nom.cpu().numpy())
        return dict(times=self.pstate.times.cpu().numpy(),
                    knots=self.pstate.values.cpu().numpy())
