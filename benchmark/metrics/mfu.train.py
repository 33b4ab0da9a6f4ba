"""The whole training step's share of the card's bf16 peak: the model's
operations per example (benchmark/costs, no recompute) times the
examples of the traced slice over its host seconds."""

from benchmark.costs import peaks


def read(rec):
    if not rec.slice_examples or not rec.slice_s:
        return None
    flops = rec.counts["flops_per_example"] * rec.slice_examples
    return 100.0 * flops / rec.slice_s / peaks.FLOPS["bf16"]
