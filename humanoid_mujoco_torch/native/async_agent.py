"""Asynchronous agent: the reference's physics-thread / plan-thread
architecture (mjpc/agent.cc:318-329, app.cc:90-93, 493-496) on the
native runtime.

Counterpart of humanoid_mujoco_tpu/native/async_agent.py. A native
thread (NativeAgentLoop) runs the planner continuously against the
freshest state snapshot (NativeStateStore, float64) on the agent's
device, the card unless the agent was built on the CPU; the control
side queries actions at any rate from the most recently published
policy (NativePolicyBuffer).

Thread-safety contract: the PLAN thread is the only owner of the
`Agent`'s mutable fields (state, planner state, generator). The CONTROL
side never touches them: it unpickles the published policy, a CPU copy
of the planner state, into its own copy and evaluates the action on
`control_device` (the CPU by default) against a copy of the model's
leaves made once at construction, so it never touches a CUDA tensor
and launches no kernel. State flows control -> plan only through the
state store, policy plan -> control only through the policy buffer, and
agent mutations (weight sliders, task parameters) are queued with
`submit()` and applied by the plan thread before its next iteration.

A plan-thread exception stops the loop and is re-raised on the control
side, by `get_action`, `plan_iterations` and `stop()`: a dead plan loop
never serves a stale policy quietly.
"""

from __future__ import annotations

import pickle
import queue

import numpy as np
import torch

from ..agent import Agent
from ..utils import tree_map
from . import NativeAgentLoop, NativePolicyBuffer, NativeStateStore


def tree_to(x, device):
    """`x` (a tensor, or a dataclass of them: a Model, a planner state)
    with every tensor on `device`."""
    return tree_map(lambda t: t.to(device), x)


class AsyncAgent:
    def __init__(self, agent: Agent, control_device="cpu"):
        """`control_device`: where the control-side action runs. Planning
        stays on the agent's device; the action lookup is tiny math
        (spline evaluation or u + K dx), so it runs on the host against
        a CPU copy of the model: the reference's deployment shape, where
        the physics thread only evaluates ActionFromPolicy locally
        (app.cc:90-93) while the plan thread owns the heavy compute."""
        self.agent = agent
        m = agent.model
        self.control_device = torch.device(control_device)
        self.state_store = NativeStateStore(m.nq, m.nv)
        self.policy_buf = NativePolicyBuffer()
        self.loop = NativeAgentLoop()
        s = agent.get_state()
        self.state_store.set(s["qpos"], s["qvel"], s["time"])
        # control-side copies, owned by the control thread only
        self._ctl_model = tree_to(m, self.control_device)
        self._ctl_pstate = tree_to(agent.pstate, self.control_device)
        self._ctl_version = -1
        self._cmds: queue.Queue = queue.Queue()
        # the stream the plan thread launches on (set by its first call)
        self.plan_stream = None
        self._publish_policy()

    # ---- plan thread side (sole owner of self.agent's mutables) ----
    def _publish_policy(self):
        self.policy_buf.publish(
            pickle.dumps(tree_to(self.agent.pstate, "cpu")))

    def _plan_once(self, noise=None) -> bool:
        """One plan iteration against the stored state, then publish.
        `noise` is the planner's candidate normals (`Agent.planner_step`),
        for a hand-driven call."""
        dev = self.agent.model.device
        if self.plan_stream is None and dev.type == "cuda":
            # a native thread starts on the current device 0
            torch.cuda.set_device(dev)
            self.plan_stream = torch.cuda.current_stream(dev)
        while True:   # drain queued agent mutations (GUI verbs)
            try:
                fn = self._cmds.get_nowait()
            except queue.Empty:
                break
            fn(self.agent)
        qp, qv, t = self.state_store.get()
        self.agent.set_state(qpos=qp, qvel=qv, time=t)
        self.agent.planner_step(noise=noise)
        self._publish_policy()
        return False  # keep looping

    def start(self):
        """Start the background plan loop (plan thread analog)."""
        self.loop.start(self._plan_once)

    def stop(self):
        """Stop the loop after the iteration in flight; re-raise the
        exception that ended it, if any."""
        self.loop.stop()

    def _check(self):
        if self.loop.error is not None:
            raise RuntimeError("the plan thread failed") from self.loop.error

    # ---- control thread side (never mutates self.agent) ----
    def submit(self, fn):
        """Queue an agent mutation (e.g. lambda a:
        a.set_cost_weights({...})) for the plan thread to apply before
        its next iteration."""
        self._cmds.put(fn)

    def set_state(self, qpos, qvel, time: float):
        """Publish a fresh state snapshot (physics thread analog)."""
        self.state_store.set(np.asarray(qpos), np.asarray(qvel),
                             float(time))

    def get_action(self, qpos, qvel, time: float) -> np.ndarray:
        """The freshest published policy's action (nu,) at this state and
        time, evaluated on the control device (ActionFromPolicy under
        the policy's shared lock, app.cc:90-93)."""
        self._check()
        version = self.policy_buf.version
        if version != self._ctl_version:
            self._ctl_pstate = tree_to(
                pickle.loads(self.policy_buf.read()), self.control_device)
            self._ctl_version = version
        m, a = self._ctl_model, self.agent
        kw = dict(dtype=m.dtype, device=self.control_device)
        t = torch.tensor([float(time)], **kw)
        with torch.inference_mode():
            if a.planner == "ilqg":
                from ..planners import ilqg_action
                u = ilqg_action(
                    m, self._ctl_pstate.policy,
                    torch.as_tensor(np.asarray(qpos), **kw).reshape(1, m.nq),
                    torch.as_tensor(np.asarray(qvel), **kw).reshape(1, m.nv),
                    t)
            else:
                from ..planners import policy_action
                u = policy_action(m, self._ctl_pstate, t, a.cfg.order)
        return u[0].cpu().numpy()

    @property
    def plan_iterations(self) -> int:
        self._check()
        return self.loop.iterations
