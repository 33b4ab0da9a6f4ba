"""The port's span recorder (common/profiler.py `SPANS`) on the CPU: the
batcher's dispatch-thread states and request spans, the split of each
request's queue wait, the records of sheds, the engine's and the
trainer's host legs, and the Chrome trace that carries the spans.

A fake engine and a fake clock drive the batcher; the engine and the
trainer take the graph path through the stand-in backend of
tests/test_torch_compile.py.  "Recording" is the flag a torch profiler
sets (`torch_profiler._is_profiler_enabled`), set here by monkeypatch,
or a real CPU profile where a range's name is checked."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common import profiler
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.serving import engine as engine_lib
from elasticdl_tpu_torch.serving.batcher import (
    ENGINE,
    HELD,
    OK,
    OVERLOADED,
    DynamicBatcher,
)
from elasticdl_tpu_torch.worker import trainer as trainer_lib
from test_torch_compile import StandInBackend, _deepfm_batch, _trainer

torch.set_num_threads(2)

MNIST = "mnist.mnist_functional_api.custom_model"
MNIST_SPEC = {"features": {"shape": [784], "dtype": "float32"}}
WAIT_S = 10.0


@pytest.fixture(autouse=True)
def spans():
    profiler.SPANS.clear()
    yield profiler.SPANS
    profiler.SPANS.clear()


@pytest.fixture
def recording(monkeypatch):
    """Spans are recorded, as while a torch profiler records."""
    monkeypatch.setattr(profiler.torch_profiler, "_is_profiler_enabled",
                        True)


@pytest.fixture
def ranges(monkeypatch):
    """The names of the record_function ranges entered."""
    entered = []
    real = profiler.torch_profiler.record_function

    def counted(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(profiler.torch_profiler, "record_function", counted)
    return entered


def _until(predicate, timeout=WAIT_S):
    end = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.001)


class FakeClock:
    """The batcher's clock, set by the test; `step` > 0 advances it by
    that much at every read."""

    def __init__(self, step=0.0):
        self.t = 0.0
        self.step = step
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            t = self.t
            self.t += self.step
            return t


class FakeEngine:
    """Buckets 4 and 8; `release` holds a call inside predict; the step
    moves from 3 to 4 after `swap_after` calls (a hot swap)."""

    max_bucket = 8

    def __init__(self, swap_after=None):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.release.set()
        self.swap_after = swap_after
        self.calls = []

    def bucket_for(self, rows):
        return 4 if rows <= 4 else 8 if rows <= 8 else None

    def validate(self, features):
        return None

    def predict(self, features, rows, phase_out=None):
        self.entered.set()
        assert self.release.wait(WAIT_S)
        self.calls.append(rows)
        if phase_out is not None:
            phase_out.update(pad=0.0, compute=0.0, unpack=0.0)
        step = 3 if self.swap_after is None or \
            len(self.calls) <= self.swap_after else 4
        return np.asarray(features["x"])[:rows, :1], step


def _req(rows, value=0.0):
    return {"x": np.full((rows, 2), value, np.float32)}


def _wake(batcher):
    with batcher._cond:
        batcher._cond.notify_all()


def _a_in_the_engine(clock, **kwargs):
    """A batcher whose first request, A (1 row, enqueued at 0), was held
    for its 1-s deadline, popped at 1.5 and sits in the engine."""
    engine = FakeEngine()
    engine.release.clear()
    batcher = DynamicBatcher(engine, max_latency_s=1.0, max_batch=8,
                             clock=clock, **kwargs)
    _until(lambda: batcher._wait == "dispatch.empty")
    a = batcher.submit(_req(1), request_id="A")
    _until(lambda: batcher._wait == HELD)
    clock.t = 1.5
    _wake(batcher)
    assert engine.entered.wait(WAIT_S)
    _until(lambda: batcher._busy == ENGINE)
    return engine, batcher, a


def _queue_parts(result):
    p = result.phases_s
    return p["queue_wait"], p["queue_held"], p["queue_behind"], \
        p["queue_wake"]


def test_the_queue_wait_splits_by_what_the_dispatch_thread_did():
    """A waited 1 s of deadline and woke 0.5 s late; B queued 1 s behind
    A's forward; each split sums to its wait exactly."""
    clock = FakeClock()
    engine, batcher, a = _a_in_the_engine(clock)
    clock.t = 2.0
    b = batcher.submit(_req(1), request_id="B")
    clock.t = 3.0
    engine.release.set()
    results = [f.result(timeout=WAIT_S) for f in (a, b)]
    batcher.shutdown()
    assert [r.code for r in results] == [OK, OK]
    assert _queue_parts(results[0]) == (1.5, 1.0, 0.0, 0.5)
    assert _queue_parts(results[1]) == (1.0, 0.0, 1.0, 0.0)
    series = batcher.metrics.phase
    for phase in ("queue_wait", "queue_held", "queue_behind",
                  "queue_wake"):
        assert series.labels(phase=phase).snapshot()["count"] == 2


def test_the_split_sums_exactly_for_split_requests_and_reruns():
    """Under a clock that advances 2^-8 s at every read, every answer's
    queue parts sum to its wait, split and rerun requests too."""
    clock = FakeClock(step=2.0 ** -8)
    engine = FakeEngine(swap_after=1)
    batcher = DynamicBatcher(engine, max_latency_s=2.0 ** -6, max_batch=8,
                             max_queue_rows=128, clock=clock)
    futures = [batcher.submit(_req(rows), request_id=str(i))
               for i, rows in enumerate([18, 3, 20, 1, 8, 5, 11])]
    results = [f.result(timeout=WAIT_S) for f in futures]
    batcher.shutdown()
    assert [r.code for r in results] == [OK] * len(results)
    assert batcher.metrics.snapshot()["split_reruns"] >= 1
    for r in results:
        wait, held, behind, wake = _queue_parts(r)
        assert held + behind + wake == wait
        assert min(held, behind, wake) >= 0.0


def test_a_shed_keeps_the_queue_and_the_dispatch_state():
    clock = FakeClock()
    engine, batcher, a = _a_in_the_engine(clock, max_queue_rows=2)
    clock.t = 2.0
    queued = [batcher.submit(_req(1)) for _ in range(2)]
    clock.t = 2.5
    shed = batcher.submit(_req(1), request_id="D").result(timeout=WAIT_S)
    assert shed.code == OVERLOADED
    clock.t = 3.0
    engine.release.set()
    assert all(f.result(timeout=WAIT_S).code == OK for f in [a] + queued)
    batcher.shutdown()
    (record,) = batcher.metrics.snapshot()["sheds"]
    assert record == {
        "at_s": 2.5, "request_id": "D", "rows": 1, "queued_rows": 2,
        "bound_rows": 2, "oldest_age_s": 0.5, "state": ENGINE,
        "state_s": 1.0, "bucket_in_flight": 4}
    assert batcher.metrics.snapshot()["shed"] == 1.0


def test_the_health_rpc_keeps_to_the_scalars():
    from elasticdl_tpu_torch.serving.server import ServingServicer

    engine = FakeEngine()
    engine.step, engine.buckets, engine.compile_count = 3, (4, 8), 2
    engine.swap_count = 0
    batcher = DynamicBatcher(engine, max_latency_s=0.001, max_queue_rows=0)
    assert batcher.submit(_req(1)).result(timeout=WAIT_S).code == OVERLOADED
    response = ServingServicer(engine, batcher).health(None, None)
    batcher.shutdown()
    names = {m.name for m in response.metrics}
    assert "shed" in names and "sheds" not in names


@pytest.fixture(scope="module")
def mnist():
    spec = get_model_spec(ZOO_DIR, MNIST)
    x = np.random.RandomState(0).rand(2, 784).astype(np.float32)
    state = trainer_lib.Trainer(spec.model, spec.optimizer, spec.loss,
                                device="cpu").init_state(0, x)
    return spec, dict(state.model.state_dict())


def _graphed_engine(monkeypatch, mnist):
    spec, variables = mnist
    engine = engine_lib.ServingEngine(
        spec.model, dict(variables), step=7, feature_spec=MNIST_SPEC,
        buckets=(2, 8), device="cpu", precompile=False)
    engine._graphs.backend = StandInBackend()
    monkeypatch.setattr(engine, "graph_ok", lambda: True)
    engine.warmup()
    return engine


def _mnist_rows(rows, seed=1):
    return {"features": np.random.RandomState(seed).rand(
        rows, 784).astype(np.float32)}


def _graphed_trainer(monkeypatch):
    trainer = _trainer()
    trainer._graphs.backend = StandInBackend()
    monkeypatch.setattr(trainer, "graph_ok", lambda state, batches: True)
    batch = _deepfm_batch(n=32)
    return trainer, trainer.init_state(0, batch["features"])


def test_off_nothing_is_recorded_and_no_range_entered(monkeypatch, mnist,
                                                      spans, ranges):
    engine = _graphed_engine(monkeypatch, mnist)
    reads = []
    real_clock = engine.clock
    engine.clock = lambda: reads.append(1) or real_clock()
    batcher = DynamicBatcher(engine, max_latency_s=0.001)
    futures = [batcher.submit(_mnist_rows(rows), request_id=str(rows))
               for rows in (1, 3, 8)]
    assert all(f.result(timeout=WAIT_S).code == OK for f in futures)
    batcher.shutdown()
    calls = engine._graphs.replays["serving_forward"]
    assert calls >= 2 and len(reads) == 4 * calls
    trainer, state = _graphed_trainer(monkeypatch)
    for seed in range(3):
        staged = trainer.stage_batch(_deepfm_batch(n=32, seed=seed))
        trainer.train_on_batch_stack(state, [staged])
    assert trainer._graphs.replays["steps"] == 2
    # torch's own ranges (the optimizer's) are none of the recorder's
    assert spans.spans() == []
    assert [n for n in ranges if n.startswith(("serve.", "train."))] == []


def _by_name(found, name):
    return [s for s in found if s.name == name]


def _contiguous(legs, start, end):
    assert legs[0].start_ns == start and legs[-1].end_ns <= end
    for a, b in zip(legs, legs[1:]):
        assert a.end_ns == b.start_ns and a.parent_id == b.parent_id


def test_recorded_request_spans_share_the_id_and_name_their_batch(
        monkeypatch, mnist, spans, recording):
    engine = _graphed_engine(monkeypatch, mnist)
    batcher = DynamicBatcher(engine, max_latency_s=0.005)
    ids = [f"r{i}" for i in range(6)]
    futures = [batcher.submit(_mnist_rows(rows, seed), request_id=rid)
               for seed, (rid, rows) in enumerate(zip(ids, (1, 2, 3, 2, 5,
                                                            8)))]
    assert all(f.result(timeout=WAIT_S).code == OK for f in futures)
    batcher.shutdown()
    found = spans.spans()
    batches = {s.span_id: s for s in _by_name(found, "batch")}
    for rid in ids:
        (admit,) = [s for s in _by_name(found, "admit") if s.ref == rid]
        (queue,) = [s for s in _by_name(found, "queue") if s.ref == rid]
        attrs = dict(admit.attrs)
        assert attrs["admitted"] == 1 and attrs["bound"] == 32
        assert admit.end_ns == queue.start_ns
        batch = batches[queue.parent_id]
        assert batch.ref == f"b{batch.span_id}"
        assert batch.start_ns == queue.end_ns
        held, behind, wake = (dict(queue.attrs)[k] for k in
                              ("held_ns", "behind_ns", "wake_ns"))
        assert abs(held + behind + wake
                   - (queue.end_ns - queue.start_ns)) <= 2
    # the engine's legs under each batch, from the pad to the copy out
    for batch in batches.values():
        legs = sorted((s for s in found if s.parent_id == batch.span_id
                       and s.name != "queue"), key=lambda s: s.start_ns)
        bucket = dict(batch.attrs)["bucket"]
        assert [s.name for s in legs] == [
            "pad", "copy_in", f"serve.replay.b{bucket}", "unpack"]
        _contiguous(legs, legs[0].start_ns, batch.end_ns)
    states = [s for s in found if s.name.startswith("dispatch.")]
    assert {s.name for s in states} >= {"dispatch.held", "dispatch.form",
                                        "dispatch.engine"}
    names = {s.name.rsplit(".b", 1)[0] if s.name.startswith(
        "serve.replay.b") else s.name for s in found}
    assert names <= events.RECORDER_SPANS


def test_a_recorded_shed_is_an_admit_span_admitting_nothing(spans,
                                                             recording):
    batcher = DynamicBatcher(FakeEngine(), max_latency_s=0.001,
                             max_queue_rows=0)
    shed = batcher.submit(_req(1), request_id="S").result(timeout=WAIT_S)
    batcher.shutdown()
    assert shed.code == OVERLOADED
    (admit,) = _by_name(spans.spans(), "admit")
    assert admit.ref == "S" and dict(admit.attrs) == {
        "queued": 0, "rows": 1, "admitted": 0, "bound": 0}


def test_the_trainers_legs_nest_under_one_call(monkeypatch, spans,
                                               recording):
    trainer, state = _graphed_trainer(monkeypatch)
    for seed in range(3):
        staged = trainer.stage_batch(_deepfm_batch(n=32, seed=seed))
        trainer.train_on_batch_stack(state, [staged])
    found = spans.spans()
    assert len(_by_name(found, "train.stage")) == 3
    calls = _by_name(found, "train.call")
    assert len(calls) == 3
    legs = [sorted((s for s in found if s.parent_id == c.span_id),
                   key=lambda s: s.start_ns) for c in calls]
    # the first call runs eagerly; the second captures, then replays
    assert legs[0] == []
    for call, call_legs in zip(calls[1:], legs[1:]):
        assert [s.name for s in call_legs] == [
            "train.check", "train.load", "train.replay", "train.finish"]
        assert call_legs[0].start_ns >= call.start_ns
        _contiguous(call_legs, call_legs[0].start_ns, call.end_ns)


def test_a_chrome_trace_carries_the_spans_and_the_replay_ranges(
        monkeypatch, mnist, tmp_path, spans):
    engine = _graphed_engine(monkeypatch, mnist)
    trainer, state = _graphed_trainer(monkeypatch)
    staged = [trainer.stage_batch(_deepfm_batch(n=32, seed=s))
              for s in range(3)]
    trainer.train_on_batch_stack(state, staged[:1])
    trainer.train_on_batch_stack(state, staged[1:2])
    batcher = DynamicBatcher(engine, max_latency_s=0.001)
    with profiler.trace(str(tmp_path)) as path:
        # the replay runs on the batcher's thread: its range is recorded
        assert batcher.submit(_mnist_rows(3), request_id="t").result(
            timeout=WAIT_S).code == OK
        trainer.train_on_batch_stack(state, staged[2:])
    batcher.shutdown()
    with open(path) as f:
        trace_events = json.load(f)["traceEvents"]
    (mark,) = [e for e in trace_events if e.get("name") ==
               profiler.TRACE_MARK and e.get("cat") == "user_annotation"]
    names = {e["name"] for e in trace_events
             if e.get("cat") == "user_annotation"}
    assert {"serve.replay.b8", "train.replay"} <= names
    placed = [e for e in trace_events if e.get("cat") == "program_span"]
    begins = {e["name"] for e in placed if e["ph"] == "b"}
    assert begins >= {"admit", "queue", "batch", "dispatch.engine", "pad",
                      "copy_in", "serve.replay.b8", "unpack", "train.call",
                      "train.check", "train.load", "train.replay",
                      "train.finish"}
    # on the trace's clock: each overlaps the traced block's annotation
    # (the batcher's first state began before it)
    for e in placed:
        if e["ph"] == "b":
            assert e["ts"] <= mark["ts"] + mark["dur"] + 1e3
        else:
            assert e["ts"] >= mark["ts"] - 1e3
    # the replay's span and its range agree to within the offset's error
    (span,) = [e for e in placed if e["name"] == "train.replay"
               and e["ph"] == "b"]
    (rng,) = [e for e in trace_events if e.get("name") == "train.replay"
              and e.get("cat") == "user_annotation"]
    assert abs(span["ts"] - rng["ts"]) < 2e3
