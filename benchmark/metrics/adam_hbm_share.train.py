"""The optimizer's share of the HBM bandwidth: a dense Adam step's
least bytes (benchmark/costs/adam.py: 7 x 4 bytes a parameter) over the
optimizer's device seconds a step times the peak bandwidth.  The
seconds are those of the kernels inside the optimizer's own
`Optimizer.step` range in one call run eagerly after the window (the
same kernels the captured graphs replay)."""

from benchmark.costs import adam, peaks


def read(rec):
    seconds = rec.counts.get("optimizer_s_per_step")
    if not seconds:
        return None
    _, nbytes = adam.cost(int(rec.counts["params"]))
    return 100.0 * nbytes / (seconds * peaks.HBM_BYTES_PER_S)
