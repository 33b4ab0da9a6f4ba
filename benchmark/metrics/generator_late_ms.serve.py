"""95th percentile of how late the load generator sent a request after
its due time."""

from benchmark.harness.stats import percentile_ms


def read(rec):
    return percentile_ms(rec.late_s, 95)
