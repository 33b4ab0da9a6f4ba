"""95th percentile, over the requests answered in the traced slice, of
the part of each one's queue wait in which the batcher's dispatch
thread was holding the batch for the oldest request's deadline (the
program's `queue` span's `held_ns`)."""

from benchmark.harness.program_spans import queue_phase_s
from benchmark.harness.stats import percentile_ms


def read(rec):
    return percentile_ms(queue_phase_s(rec, "held_ns"), 95)
