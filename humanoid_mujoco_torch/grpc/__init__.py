"""gRPC wire protocol of the Agent, filter and direct services (the
mjpc/grpc analog).

`agent.proto`, `filter.proto` and `direct.proto` define the verb
surfaces (reference agent.proto:19-60); `*_pb2.py` is protoc gencode
(regenerate with gen.sh). These files are byte-for-byte copies of the
JAX package's, on purpose: both register `agent.proto` and the others
under one file name in protobuf's default pool, which accepts a second
identical file and refuses a different one, so the two packages load
in one process. The proto package and the service names stay
`humanoid_mujoco_tpu.*`: they are names on the wire, not imports, and
keeping them lets a client of either package talk to a server of the
other. The servers and clients live in serving/grpc_server.py,
serving/grpc_client.py, serving/estimation_servers.py and
serving/grpc_estimation.py; they need grpcio and protobuf, which
nothing else in the package imports.
"""

from . import agent_pb2

__all__ = ["agent_pb2"]
