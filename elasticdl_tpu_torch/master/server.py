"""The master's socket transport: its servicer's methods over HTTP/1.1
(common/http_rpc.py), where the JAX master serves gRPC.

`POST /elasticdl_tpu.Master/<method>` with the request serialized in
protobuf's wire format (proto/messages.py), the response back; HTTP 200
for every call whose handler returns, 400 for a body that does not
parse, 404 for another path, 500 when the handler raises, 503 once the
server is stopping.  Workers call it through `proto.service.MasterStub`.
`stop(grace)` drains: no new request is read, those in flight finish.
"""

from __future__ import annotations

from elasticdl_tpu_torch.common.http_rpc import HttpRpcServer, routes_for
from elasticdl_tpu_torch.proto.service import (
    MASTER_METHOD_TYPES,
    SERVICE_NAME,
)

# the JAX master's gRPC thread pool
MASTER_RPC_WORKERS = 64


class MasterServer(HttpRpcServer):
    def __init__(self, servicer, workers: int = MASTER_RPC_WORKERS,
                 host: str = "0.0.0.0"):
        super().__init__(
            routes_for(SERVICE_NAME, servicer,
                       {name: types[0] for name, types in
                        MASTER_METHOD_TYPES.items()}),
            workers=workers, host=host, name="master-http")
