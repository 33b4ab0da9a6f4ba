"""Flash attention forward's share of its roofline in serving: the
least time of the forwards served inside the traced slice (benchmark/costs/
flash_fwd.py) over the device time of its kernels."""

from benchmark.harness.stats import roofline


def read(rec):
    return roofline(rec, "flash_fwd", ("flash_fwd",))
