"""The readers of the program's own spans on a synthetic traced slice:
the spans placed on the profile's clock by the slice's offset, the
device's idle time inside them, the queue's parts and rows, and None
where the program recorded no span."""

import pytest

from benchmark.harness import program_spans, spec
from benchmark.harness.record import Record
from benchmark.harness.trace import Profile
from elasticdl_tpu_torch.common import profiler

# the profile's clock runs 1 000 000 ns ahead of the host's
OFFSET = 1_000_000
NS = 1e-9


@pytest.fixture
def spans():
    profiler.SPANS.clear()
    yield profiler.SPANS
    profiler.SPANS.clear()


def _rec(device_ops=((10, 30), (60, 70))):
    """A slice from host 100 ns to 200 ns (profile 1_000_100..1_000_200),
    with device operations at the given host-relative times."""
    prof = Profile(
        device_ops=[("k", OFFSET + 100 + s, OFFSET + 100 + e)
                    for s, e in device_ops],
        start_ns=OFFSET + 100, end_ns=OFFSET + 200,
        host_start=100 * NS, host_end=200 * NS)
    return Record(cell=None, seed=0, seconds=1.0, trace=True, device="cpu",
                  profile=prof)


def _add(spans, name, start, end, **kw):
    """A span at host-relative times (ns after the slice's start)."""
    return spans.add(name, (100 + start) * NS, (100 + end) * NS, **kw)


def _read(metric, rec):
    return spec.load_code(spec.BENCH_DIR, "metrics", metric).read(rec)


def test_spans_are_placed_by_the_offset_and_clipped(spans):
    _add(spans, "dispatch.held", -50, 20)
    _add(spans, "dispatch.form", 20, 40)
    _add(spans, "dispatch.empty", 120, 150)     # after the slice
    found = program_spans.slice_spans(_rec())
    assert [(n, s, e) for n, s, e, *_ in found] == [
        ("dispatch.held", OFFSET + 100, OFFSET + 120),
        ("dispatch.form", OFFSET + 120, OFFSET + 140)]


def test_idle_is_attributed_to_the_spans_open_over_it(spans):
    # device busy 10..30 and 60..70 of the 100-ns slice
    _add(spans, "dispatch.held", 0, 20)          # idle 0..10
    _add(spans, "dispatch.form", 20, 50)         # idle 30..50
    _add(spans, "dispatch.engine", 50, 100)
    _add(spans, "pad", 50, 55)                   # idle 50..55
    _add(spans, "serve.replay.b64", 55, 58)      # idle 55..58
    _add(spans, "train.stage", 80, 90)
    _add(spans, "train.load", 85, 95)            # overlaps the stage
    rec = _rec()
    assert _read("idle_held.serve", rec) == pytest.approx(10.0)
    assert _read("idle_dispatch_host.serve", rec) == pytest.approx(28.0)
    assert _read("idle_stage.train", rec) == pytest.approx(10.0)
    assert _read("idle_graph_host.train", rec) == pytest.approx(10.0)
    # every idle moment under one of the thread's states: the whole idle
    everything = program_spans.idle_within(
        rec, lambda name: name.startswith("dispatch."))
    assert everything == pytest.approx(70.0)


def test_queue_parts_and_rows_read_the_slices_requests(spans):
    batch = spans.new_id()
    for i, (held, behind) in enumerate([(1, 9), (2, 8), (3, 7), (10, 0)]):
        _add(spans, "queue", -20, 10 + i, parent=batch, ref=str(i),
             attrs=(("held_ns", held * 10**6), ("behind_ns", behind * 10**6),
                    ("wake_ns", 0), ("rows", 1)))
    # a split request: its longest chunk counts, once
    _add(spans, "queue", 0, 30, ref="split",
         attrs=(("held_ns", 4 * 10**6), ("behind_ns", 0), ("wake_ns", 0)))
    _add(spans, "queue", 0, 20, ref="split",
         attrs=(("held_ns", 50 * 10**6), ("behind_ns", 0), ("wake_ns", 0)))
    # answered after the slice: not the slice's
    _add(spans, "queue", 90, 150, ref="late",
         attrs=(("held_ns", 99 * 10**6), ("behind_ns", 0), ("wake_ns", 0)))
    for queued in (0, 64, 128, 192):
        _add(spans, "admit", 1, 2, attrs=(("queued", queued), ("rows", 1),
                                           ("admitted", 1), ("bound", 256)))
    rec = _rec()
    assert sorted(program_spans.queue_phase_s(rec, "held_ns")) == \
        pytest.approx([1e-3, 2e-3, 3e-3, 4e-3, 10e-3])
    assert _read("queue_held_ms.serve", rec) == pytest.approx(8.8)
    assert _read("queue_behind_ms.serve", rec) == pytest.approx(8.8)
    assert _read("queue_rows_p99.serve", rec) == pytest.approx(74.25)


@pytest.mark.parametrize("metric", [
    "queue_held_ms.serve", "queue_behind_ms.serve", "queue_rows_p99.serve",
    "idle_held.serve", "idle_dispatch_host.serve", "idle_stage.train",
    "idle_graph_host.train"])
def test_without_the_programs_spans_the_readers_give_none(spans, metric,
                                                          monkeypatch):
    rec = _rec()
    assert _read(metric, rec) is None
    _add(spans, "dispatch.empty", 120, 150)     # none inside the slice
    assert _read(metric, rec) is None
    rec.profile = None
    assert _read(metric, rec) is None
    # a program with no recorder (the port before it had one)
    monkeypatch.delattr(profiler, "SPANS")
    assert _read(metric, _rec()) is None
