"""Flash attention backward's share of its roofline: the least time of
its calls in the traced slice (benchmark/costs/flash_bwd.py) over the
device time of all its launches (the prep, dK/dV and dQ kernels, or the
CUDA-core variant's three)."""

from benchmark.harness.stats import roofline


def read(rec):
    return roofline(rec, "flash_bwd",
                    ("flash_bwd", "dkdv_core", "dq_core", "delta_kernel"))
