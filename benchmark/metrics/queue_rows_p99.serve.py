"""99th percentile, over the admissions in the traced slice, of the
rows queued at the admission as a percent of the queue's bound (the
program's `admit` spans: `queued` of `bound`, shed requests too)."""

import numpy as np

from benchmark.harness.program_spans import slice_spans


def read(rec):
    found = slice_spans(rec) or []
    shares = [100.0 * a["queued"] / a["bound"]
              for name, _, _, _, _, _, a in found
              if name == "admit" and a.get("bound")]
    if not shares:
        return None
    return float(np.percentile(np.asarray(shares, np.float64), 99))
