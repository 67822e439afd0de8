"""Agent gRPC server: the `agent_server` binary analog.

Counterpart of humanoid_mujoco_tpu/serving/grpc_server.py. The
reference builds a headless gRPC server wrapping one Agent
(mjpc/grpc/agent_service.{h,cc}, binary at grpc/CMakeLists.txt:189);
Python bindings spawn it as a subprocess and speak protobuf over a
localhost channel (python/mujoco_mpc/agent.py:81-123). Same shape here:
`AgentServicer` wraps the in-process port Agent (agent.py), registered
through grpc generic method handlers (the messages come from protoc
--python_out, see grpc/gen.sh). The service name is the JAX package's,
so either package's client talks to either server (grpc/__init__.py).
Needs grpcio and protobuf.

Run: python -m humanoid_mujoco_torch.serving.grpc_server \\
        --task "Humanoid Cap Stand" --planner ilqg --port 50051 \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
from concurrent import futures

import grpc
import numpy as np

from ..agent import Agent
from ..grpc import agent_pb2 as pb

SERVICE = "humanoid_mujoco_tpu.Agent"

# RPC name -> (request type, response type); mirrors agent.proto
RPCS = {
    "Init": (pb.InitRequest, pb.Empty),
    "GetState": (pb.Empty, pb.State),
    "SetState": (pb.State, pb.Empty),
    "PlannerStep": (pb.PlannerStepRequest, pb.PlannerStepResponse),
    "GetAction": (pb.GetActionRequest, pb.Action),
    "Step": (pb.Empty, pb.Action),
    "Reset": (pb.Empty, pb.Empty),
    "SetTaskParameters": (pb.TaskParameters, pb.Empty),
    "SetCostWeights": (pb.CostWeights, pb.Empty),
    "GetCostValuesAndWeights": (pb.Empty, pb.CostValues),
    "GetResiduals": (pb.Empty, pb.Residuals),
    "SetMode": (pb.Mode, pb.Empty),
    "GetMode": (pb.Empty, pb.Mode),
    "SetMocap": (pb.Mocap, pb.Empty),
    "GetBestTrajectory": (pb.Empty, pb.Trajectory),
    "SetAnything": (pb.Anything, pb.Empty),
}


def generic_handlers(service: str, servicer, rpcs):
    """grpc generic method handlers of `servicer`'s verbs named in
    `rpcs` (name -> (request type, response type))."""
    return grpc.method_handlers_generic_handler(service, {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req_t.FromString,
            response_serializer=lambda m: m.SerializeToString())
        for name, (req_t, _resp_t) in rpcs.items()})


class AgentServicer:
    """Wraps one Agent, like AgentService (grpc/agent_service.h:36).
    `Init` builds its Agent's model on `device`."""

    def __init__(self, agent: Agent | None = None, device=None):
        self.agent = agent
        self.device = device

    def _require(self, context):
        if self.agent is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "call Init first")
        return self.agent

    # ---- verbs ----
    def Init(self, req, context):
        kw = {}
        if req.horizon:
            kw["horizon"] = req.horizon
        if req.nsample:
            kw["nsample"] = req.nsample
        if req.plan_dt:
            kw["plan_dt"] = req.plan_dt
        from ..tasks.registry import task_model
        self.agent = Agent(task_model(req.task_id, device=self.device),
                           req.task_id, planner=req.planner or "ilqg", **kw)
        return pb.Empty()

    def GetState(self, req, context):
        s = self._require(context).get_state()
        return pb.State(qpos=s["qpos"].tolist(),
                        qvel=s["qvel"].tolist(), time=s["time"])

    def SetState(self, req, context):
        a = self._require(context)
        a.set_state(
            qpos=np.asarray(req.qpos) if req.qpos else None,
            qvel=np.asarray(req.qvel) if req.qvel else None,
            # NaN marks "leave unchanged" (proto3 has no presence for
            # scalar doubles; time=0.0 must remain settable)
            time=None if np.isnan(req.time) else req.time)
        return pb.Empty()

    def PlannerStep(self, req, context):
        a = self._require(context)
        ret = 0.0
        for _ in range(max(1, req.iterations)):
            ret = a.planner_step()
        return pb.PlannerStepResponse(best_return=ret)

    def GetAction(self, req, context):
        a = self._require(context)
        u = a.get_action(
            time=req.time if req.time >= 0 else None,
            averaging_duration=req.averaging_duration,
            nominal_action=req.nominal_action)
        return pb.Action(action=np.asarray(u).tolist())

    def Step(self, req, context):
        u = self._require(context).step()
        return pb.Action(action=np.asarray(u).tolist())

    def Reset(self, req, context):
        self._require(context).reset()
        return pb.Empty()

    def SetTaskParameters(self, req, context):
        a = self._require(context)
        for k, v in req.parameters.items():
            a.set_task_parameter(k, v)
        return pb.Empty()

    def SetCostWeights(self, req, context):
        self._require(context).set_cost_weights(dict(req.weights))
        return pb.Empty()

    def GetCostValuesAndWeights(self, req, context):
        a = self._require(context)
        return pb.CostValues(values=a.get_cost_term_values(),
                             weights=a.get_cost_weights())

    def GetResiduals(self, req, context):
        r = self._require(context).get_residuals()
        return pb.Residuals(residuals=np.asarray(r).tolist())

    def SetMode(self, req, context):
        self._require(context).set_mode(req.mode)
        return pb.Empty()

    def GetMode(self, req, context):
        return pb.Mode(mode=self._require(context).get_mode())

    def SetMocap(self, req, context):
        self._require(context).set_mocap(
            req.name,
            pos=list(req.pos) if req.pos else None,
            quat=list(req.quat) if req.quat else None)
        return pb.Empty()

    def GetBestTrajectory(self, req, context):
        a = self._require(context)
        tr = a.best_trajectory()
        if "qpos" in tr:
            qpos = np.asarray(tr["qpos"])
            qvel = np.asarray(tr["qvel"])
            acts = np.asarray(tr["actions"])
            return pb.Trajectory(
                horizon=acts.shape[0], nq=qpos.shape[1],
                nv=qvel.shape[1], nu=acts.shape[1],
                times=np.asarray(tr["times"]).tolist(),
                qpos=qpos.ravel().tolist(),
                qvel=qvel.ravel().tolist(),
                actions=acts.ravel().tolist())
        knots = np.asarray(tr["knots"])
        return pb.Trajectory(horizon=knots.shape[0], nu=knots.shape[1],
                             times=np.asarray(tr["times"]).tolist(),
                             actions=knots.ravel().tolist())

    def SetAnything(self, req, context):
        a = self._require(context)
        try:
            a.set_anything(
                model={e.field: list(e.value) for e in req.model} or None,
                state={e.field: (list(e.value) if len(e.value) > 1
                                 else e.value[0])
                       for e in req.state} or None,
                task={e.field: e.value[0] for e in req.task} or None)
        except (KeyError, AttributeError) as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return pb.Empty()


def make_server(agent: Agent | None = None, port: int = 0,
                host: str = "127.0.0.1", device=None):
    """Build + bind (not started). Returns (server, bound_port)."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((generic_handlers(
        SERVICE, AgentServicer(agent, device), RPCS),))
    bound = server.add_insecure_port(f"{host}:{port}")
    return server, bound


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="Humanoid Cap Stand")
    ap.add_argument("--planner", default="ilqg")
    ap.add_argument("--port", type=int, default=50051)
    ap.add_argument("--horizon", type=int, default=0)
    ap.add_argument("--nsample", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..tasks.registry import task_model
    kw = {}
    if args.horizon:
        kw["horizon"] = args.horizon
    if args.nsample:
        kw["nsample"] = args.nsample
    agent = Agent(task_model(args.task, device=args.device), args.task,
                  planner=args.planner, **kw)
    server, port = make_server(agent, args.port, device=args.device)
    server.start()
    print(f"agent gRPC server on :{port}", flush=True)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
