"""Self-address discovery for worker pods (the port of the JAX package's
common/net_utils.py).

Rank 0's address is where a cluster group's torch.distributed store
listens, so a worker needs the address other hosts can dial it on, not
`localhost`.  Resolution order: an explicit environment variable (the
pod IP from the downward API) > the source address the kernel picks to
reach the master (a UDP connect sends nothing, so no listener is needed)
> a hostname lookup.
"""

from __future__ import annotations

import os
import socket

from elasticdl_tpu_torch.common.constants import WorkerEnv


def get_reachable_address(master_addr: str = "") -> str:
    explicit = os.environ.get(WorkerEnv.WORKER_ADDR) or os.environ.get(
        "POD_IP")
    if explicit:
        return explicit
    host = (master_addr or "").rsplit(":", 1)[0] or "8.8.8.8"
    try:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            sock.connect((host, 9))
            return sock.getsockname()[0]
        finally:
            sock.close()
    except OSError:
        pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"
