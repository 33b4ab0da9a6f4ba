"""The embedding scatter-add's share of its roofline: the least time of
its calls in the traced slice (benchmark/costs/scatter_add.py at each
call's shapes and touched rows, f32 adds) over the device time of all
its launches: the wrapper's stable sort and segment search, and the
kernels of csrc/scatter_add.cu."""

from benchmark.costs import peaks, scatter_add

_NAMES = ("scatter_add_segments", "scatter_add_long", "permute_rows",
          "radixsort", "searchsorted")


def _is_scatter(name: str) -> bool:
    low = name.lower()
    return any(s in low for s in _NAMES)


def read(rec):
    calls = rec.kernel_calls.get("scatter_add")
    if rec.profile is None or not calls:
        return None
    seconds, launches = rec.profile.op_seconds(_is_scatter)
    if not launches:
        return None
    least = sum(peaks.least_seconds(*scatter_add.cost(**kw), "f32")
                for kw in calls)
    return 100.0 * least / seconds
