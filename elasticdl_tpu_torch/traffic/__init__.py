"""Replayable open-loop traffic for the serving control loop (the port
of the JAX package's elasticdl_tpu/traffic): `generator.py` turns a seed
and a profile into a request schedule and drives the fleet router with
it."""

from elasticdl_tpu_torch.traffic.generator import (  # noqa: F401
    REQUEST_SHAPES,
    TRAFFIC_PROFILES,
    TrafficConfig,
    TrafficGenerator,
    router_request_fn,
)
