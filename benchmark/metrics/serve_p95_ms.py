"""95th percentile of every request's latency, due time to answer."""

from benchmark.harness.stats import percentile_ms


def read(rec):
    return percentile_ms(rec.latency_s, 95)
