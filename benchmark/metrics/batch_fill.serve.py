"""Mean share of a bucket's rows that requests filled, over the
window's batches (the batcher's own `BatcherMetrics`)."""


def read(rec):
    if not rec.batcher.get("batches"):
        return None
    return 100.0 * rec.batcher["fill"]
