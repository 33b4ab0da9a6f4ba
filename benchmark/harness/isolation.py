"""What the run must not have loaded: JAX and the JAX package, compared
by whole top-level module names (the port's package name begins with
the JAX package's, and is allowed)."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "elasticdl_tpu")


def forbidden_modules(modules=None):
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))
