"""Percent of the traced slice in which the device ran nothing while
the trainer's call was in a host leg of its graph: the check (the key
and the fingerprint), the load into the static inputs, the replay's
launch until it returns, or the finish (the program's `train.check`,
`train.load`, `train.replay` and `train.finish` spans)."""

from benchmark.harness.program_spans import idle_within

LEGS = {"train.check", "train.load", "train.replay", "train.finish"}


def read(rec):
    return idle_within(rec, lambda name: name in LEGS)
