#!/bin/sh
# regenerate protobuf gencode (protoc --python_out; service stubs are
# hand-rolled via grpc generic handlers, no grpcio-tools needed)
cd "$(dirname "$0")"
protoc --python_out=. agent.proto filter.proto direct.proto
