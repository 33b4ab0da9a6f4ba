"""Percent of the traced slice in which the device ran nothing while
the batcher's dispatch thread did host work: cutting, assembling and
answering batches (`dispatch.form`) or the engine's host legs (`pad`,
`copy_in`, the replay's launch `serve.replay.b<bucket>`, `unpack`, or an
eager forward's `compute`)."""

from benchmark.harness.program_spans import idle_within

LEGS = {"dispatch.form", "pad", "copy_in", "unpack", "compute"}


def read(rec):
    return idle_within(rec, lambda name: name in LEGS
                       or name.startswith("serve.replay."))
