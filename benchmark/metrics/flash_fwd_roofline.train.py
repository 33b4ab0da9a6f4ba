"""Flash attention forward's share of its roofline in training: the
least time of its calls in the traced slice (benchmark/costs/
flash_fwd.py) over the device time of its kernels."""

from benchmark.harness.stats import roofline


def read(rec):
    return roofline(rec, "flash_fwd", ("flash_fwd",))
