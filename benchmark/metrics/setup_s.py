"""Seconds from the process's start to the window's: loading, the
kernels' build where the checkout has none, weights, inputs, graphs'
capture and the first steps."""


def read(rec):
    return rec.setup_s or None
