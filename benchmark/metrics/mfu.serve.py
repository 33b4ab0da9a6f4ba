"""The served forwards' share of the card's bf16 peak while the device
was busy: the model's operations for the rows served in the traced
slice (the requests' rows, not the padding) over the device's busy
seconds there."""

from benchmark.costs import peaks


def read(rec):
    prof = rec.profile
    rows = rec.counts.get("slice_rows")
    if prof is None or not rows or prof.busy_s() <= 0:
        return None
    flops = rec.counts["flops_per_row"] * rows
    return 100.0 * flops / prof.busy_s() / peaks.FLOPS["bf16"]
