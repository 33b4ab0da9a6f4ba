"""95th percentile of the batcher's queue wait, per answered request
(the batcher's `queue_wait` phase)."""

from benchmark.harness.stats import percentile_ms


def read(rec):
    return percentile_ms(rec.queue_wait_s, 95)
