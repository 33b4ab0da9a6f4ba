"""Job-image tooling: `elasticdl zoo init|build|push` (the port of the
JAX package's client/image_builder.py).

`init` writes a Dockerfile that carries the model zoo into an image with
the port installed; `build` and `push` run the docker CLI.  Without the
CLI they log how to do it elsewhere and return 1; the Dockerfile is
written all the same, so an image can be built on another machine.
"""

from __future__ import annotations

import os
import shutil
import subprocess

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

# The build context is the model zoo's parent directory, so the COPY
# source is the zoo's basename relative to it (an absolute COPY source
# is refused).  The framework itself is pip-installed into the image.
_DOCKERFILE = """\
FROM {base_image}
RUN pip install --no-cache-dir torch \\
    numpy elasticdl-tpu
COPY {zoo_basename} /app/model_zoo
WORKDIR /app
ENV PYTHONPATH=/app
ENTRYPOINT ["python", "-m", "elasticdl_tpu_torch.master.main"]
"""


def init_zoo(model_zoo: str, base_image: str = "python:3.12") -> int:
    """Write `model_zoo/Dockerfile`; returns 0."""
    os.makedirs(model_zoo, exist_ok=True)
    path = os.path.join(model_zoo, "Dockerfile")
    zoo_basename = os.path.basename(os.path.abspath(model_zoo))
    with open(path, "w") as f:
        f.write(_DOCKERFILE.format(base_image=base_image,
                                   zoo_basename=zoo_basename))
    logger.info("Wrote %s", path)
    return 0


def build_image(model_zoo: str, image: str) -> int:
    """`docker build` of the zoo's Dockerfile (written first when absent)
    as `image`; the CLI's exit code, or 1 without the CLI."""
    dockerfile = os.path.join(model_zoo, "Dockerfile")
    if not os.path.exists(dockerfile):
        init_zoo(model_zoo)
    context = os.path.dirname(os.path.abspath(model_zoo)) or "."
    if shutil.which("docker") is None:
        logger.error(
            "docker CLI not found; Dockerfile is at %s — build it on a "
            "machine with docker (`docker build -f %s -t %s %s`)",
            dockerfile, dockerfile, image, context)
        return 1
    return subprocess.call(
        ["docker", "build", "-f", dockerfile, "-t", image, context])


def push_image(image: str) -> int:
    """`docker push image`; the CLI's exit code, or 1 without the CLI."""
    if shutil.which("docker") is None:
        logger.error("docker CLI not found; cannot push %s", image)
        return 1
    return subprocess.call(["docker", "push", image])
