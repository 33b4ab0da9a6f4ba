"""Percent of the traced slice in which the device ran nothing while
the trainer staged a batch (the program's `train.stage` spans)."""

from benchmark.harness.program_spans import idle_within


def read(rec):
    return idle_within(rec, lambda name: name == "train.stage")
