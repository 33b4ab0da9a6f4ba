"""The online loop: stream -> train -> checkpoint -> rolling hot-reload
behind a router (the port of the JAX package's elasticdl_tpu/online)."""

from elasticdl_tpu_torch.online.pipeline import (  # noqa: F401
    OnlineConfig,
    OnlinePipeline,
)
