"""In-process client of the master servicer (the port's copy of
`InProcessMasterClient` in the JAX package's proto/service.py).

Each method calls the servicer directly, with no socket and no
serialization: the Local runner's master and workers share a process.
The gRPC stubs, the fault points and the retry policy wait for the gRPC
slice of the port.
"""

from __future__ import annotations

MASTER_METHODS = (
    "get_task",
    "report_task_result",
    "report_evaluation_metrics",
    "report_version",
)


class InProcessMasterClient:
    """Calls a MasterServicer directly: `client.get_task(request)` is
    `servicer.get_task(request, None)`.  Exceptions propagate to the
    caller unchanged."""

    def __init__(self, servicer):
        for name in MASTER_METHODS:
            setattr(self, name, self._bind(getattr(servicer, name)))

    @staticmethod
    def _bind(method):
        def call(request, timeout=None):
            return method(request, None)

        return call
