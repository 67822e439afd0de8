"""Filter + Direct gRPC servers: the `filter_server` / `direct_server`
binary analogs.

Counterpart of humanoid_mujoco_tpu/serving/estimation_servers.py. The
reference ships four server binaries; beyond agent_server and
ui_agent_server it wires the estimators and the direct optimizer onto
the wire (mjpc/grpc/filter_service.{h,cc}, direct_service.{h,cc};
binaries at grpc/CMakeLists.txt:281,312). Same shape here: thin
servicers over the port's in-process FilterService
(serving/filtering.py) and DirectService (direct/service.py),
registered through grpc generic method handlers like grpc_server.py,
under the JAX package's service names. `Init` builds the model on the
server's device; the direct optimizer's model is float64 unless told
otherwise, since its float32 Gauss-Newton step lowers no cost (PERF.md).
Needs grpcio and protobuf.

Run:  python -m humanoid_mujoco_torch.serving.estimation_servers \\
          --service filter --task "Humanoid Cap Stand" --port 50052
      python -m humanoid_mujoco_torch.serving.estimation_servers \\
          --service direct --task ParticleFixed --port 50053 [--device cpu]
"""

from __future__ import annotations

import argparse
from concurrent import futures

import grpc
import numpy as np
import torch

from ..grpc import direct_pb2 as dpb
from ..grpc import filter_pb2 as fpb
from .grpc_server import generic_handlers

FILTER_SERVICE = "humanoid_mujoco_tpu.filter.StateEstimation"
DIRECT_SERVICE = "humanoid_mujoco_tpu.direct.Direct"

FILTER_RPCS = {
    "Init": (fpb.InitRequest, fpb.Empty),
    "Reset": (fpb.Empty, fpb.Empty),
    "Update": (fpb.UpdateRequest, fpb.UpdateResponse),
    "State": (fpb.Empty, fpb.StateResponse),
    "Covariance": (fpb.Empty, fpb.CovarianceResponse),
    "Noise": (fpb.Empty, fpb.NoiseResponse),
}

DIRECT_RPCS = {
    "Init": (dpb.InitRequest, dpb.Empty),
    "Data": (dpb.DataRequest, dpb.Empty),
    "Settings": (dpb.SettingsRequest, dpb.SettingsResponse),
    "Optimize": (dpb.Empty, dpb.OptimizeResponse),
    "Cost": (dpb.Empty, dpb.CostResponse),
    "Status": (dpb.Empty, dpb.StatusResponse),
    "Reset": (dpb.Empty, dpb.Empty),
}

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _model(task_id, device, dtype):
    from ..tasks.registry import task_model
    return task_model(task_id, device=device, dtype=dtype)


class FilterServicer:
    """Wraps one FilterService (filter_service.h analog); `Init` builds
    its model on `device` in `dtype`."""

    def __init__(self, service=None, device=None, dtype=torch.float32):
        self.service = service
        self.device, self.dtype = device, dtype

    def _require(self, context):
        if self.service is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "call Init first")
        return self.service

    def Init(self, req, context):
        from .filtering import FilterService
        self.service = FilterService(
            _model(req.task_id, self.device, self.dtype))
        if req.qpos:
            self.service.init(
                np.asarray(req.qpos),
                np.asarray(req.qvel) if req.qvel else None)
        return fpb.Empty()

    def Reset(self, req, context):
        self._require(context).reset()
        return fpb.Empty()

    def Update(self, req, context):
        f = self._require(context)
        try:
            innov = f.update(np.asarray(req.ctrl),
                             np.asarray(req.sensor))
        except RuntimeError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        return fpb.UpdateResponse(innovation=innov)

    def State(self, req, context):
        s = self._require(context).state()
        if s is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "filter not initialized")
        return fpb.StateResponse(qpos=s["qpos"].tolist(),
                                 qvel=s["qvel"].tolist())

    def Covariance(self, req, context):
        c = self._require(context).covariance()
        if c is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "filter not initialized")
        return fpb.CovarianceResponse(dimension=c.shape[0],
                                      covariance=c.ravel().tolist())

    def Noise(self, req, context):
        return fpb.NoiseResponse(
            sensor=self._require(context).noise().tolist())


class DirectServicer:
    """Wraps one DirectService (direct_service.h analog); `Init` builds
    its model on `device` in `dtype`."""

    def __init__(self, service=None, device=None, dtype=torch.float64):
        self.service = service
        self.device, self.dtype = device, dtype

    def _require(self, context):
        if self.service is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "call Init first")
        return self.service

    def Init(self, req, context):
        from ..direct.service import DirectService
        self.service = DirectService(
            _model(req.task_id, self.device, self.dtype),
            configuration_length=req.configuration_length or 16,
            dt=req.dt or None)
        return dpb.Empty()

    def Data(self, req, context):
        d = self._require(context)
        try:
            d.set_data(np.asarray(req.qpos),
                       np.asarray(req.sensor) if req.sensor else None,
                       np.asarray(req.ctrl) if req.ctrl else None)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return dpb.Empty()

    def Settings(self, req, context):
        d = self._require(context)
        d.set_settings(gn_iters=req.gn_iters,
                       estimate_mass=req.estimate_mass or None,
                       force_weight=req.force_weight,
                       regularization=req.regularization,
                       estimate_params=tuple(req.estimate_params))
        return dpb.SettingsResponse(**{
            k: (list(v) if k == "estimate_params" else v)
            for k, v in d.settings().items()})

    def Optimize(self, req, context):
        d = self._require(context)
        try:
            r = d.optimize()
        except RuntimeError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        return dpb.OptimizeResponse(
            cost_initial=float(r.cost_initial),
            cost_final=float(r.cost),
            mass_scale=float(r.mass_scale),
            parameters=np.asarray(r.params.cpu()).tolist(),
            qpos=np.asarray(r.qpos.cpu()).ravel().tolist(),
            qvel=np.asarray(r.qvel.cpu()).ravel().tolist())

    def Cost(self, req, context):
        d = self._require(context)
        try:
            return dpb.CostResponse(total=d.cost())
        except RuntimeError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))

    def Status(self, req, context):
        # the port's `improved` key is not on the wire
        st = self._require(context).status()
        return dpb.StatusResponse(gn_iters=st["gn_iters"], cost=st["cost"],
                                  optimized=st["optimized"])

    def Reset(self, req, context):
        self._require(context).reset()
        return dpb.Empty()


def _server(service_name, servicer, rpcs, port, host):
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers(
        (generic_handlers(service_name, servicer, rpcs),))
    bound = server.add_insecure_port(f"{host}:{port}")
    return server, bound


def make_filter_server(service=None, port: int = 0,
                       host: str = "127.0.0.1", device=None,
                       dtype=torch.float32):
    """Build + bind (not started). Returns (server, bound_port)."""
    return _server(FILTER_SERVICE, FilterServicer(service, device, dtype),
                   FILTER_RPCS, port, host)


def make_direct_server(service=None, port: int = 0,
                       host: str = "127.0.0.1", device=None,
                       dtype=torch.float64):
    return _server(DIRECT_SERVICE, DirectServicer(service, device, dtype),
                   DIRECT_RPCS, port, host)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--service", choices=("filter", "direct"),
                    required=True)
    ap.add_argument("--task", default="")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--configuration-length", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default=None,
                    help="the model's (filter: float32, direct: float64)")
    args = ap.parse_args(argv)

    filt = args.service == "filter"
    dtype = DTYPES[args.dtype or ("float32" if filt else "float64")]
    service = None
    if args.task:
        m = _model(args.task, args.device, dtype)
        if filt:
            from .filtering import FilterService
            service = FilterService(m)
        else:
            from ..direct.service import DirectService
            service = DirectService(
                m, configuration_length=args.configuration_length)
    make = make_filter_server if filt else make_direct_server
    server, port = make(service, args.port, device=args.device, dtype=dtype)
    server.start()
    print(f"{args.service} gRPC server on :{port}", flush=True)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
