"""Percent of the traced slice in which the device ran nothing while
the batcher's dispatch thread held queued rows for the oldest request's
deadline (the program's `dispatch.held` spans)."""

from benchmark.harness.program_spans import idle_within


def read(rec):
    return idle_within(rec, lambda name: name == "dispatch.held")
