"""The port's window lineage and incident flight recorder
(common/lineage.py, common/flight.py) and the event tap they hang off
(common/events.py) against the JAX package's.  One script emits the
same events through each package's stream under one fake clock; the
lineage records, snapshots, histograms and offline joins (`from_events`,
`decompose`, `dominant_phase`) match exactly, and the two recorders
write the same bundles, byte for byte.  The JAX recorder is built
without a program registry, as the port's always is: a bundle of either
has no `programs.json`."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from elasticdl_tpu.common import events as jax_events
from elasticdl_tpu.common import flight as jax_flight
from elasticdl_tpu.common import history as jax_history
from elasticdl_tpu.common import lineage as jax_lineage
from elasticdl_tpu.common import metrics as jax_metrics
from elasticdl_tpu_torch.common import events as port_events
from elasticdl_tpu_torch.common import flight as port_flight
from elasticdl_tpu_torch.common import history as port_history
from elasticdl_tpu_torch.common import lineage as port_lineage
from elasticdl_tpu_torch.common import metrics as port_metrics

torch.set_num_threads(2)

JAX = SimpleNamespace(events=jax_events, flight=jax_flight,
                      history=jax_history, lineage=jax_lineage,
                      metrics=jax_metrics)
PORT = SimpleNamespace(events=port_events, flight=port_flight,
                       history=port_history, lineage=port_lineage,
                       metrics=port_metrics)


class FakeClock:
    def __init__(self, start=5_000.0, step=0.25):
        self.now = start
        self.step = step

    def __call__(self):
        self.now += self.step
        return self.now


@pytest.fixture(autouse=True)
def _unconfigured_streams():
    # a Local job elsewhere in the process may have left a role behind
    for m in (JAX, PORT):
        m.events.configure(None)
    yield
    for m in (JAX, PORT):
        m.events.configure(None)


def _emit_lives(m, clock):
    """Six windows' stamps and the decisions around them: 0 and 5 reach
    first serve (5 re-armed on the way), 1 stops before serving, 2 is a
    replay whose seal was never seen, 3 is forfeited mid-train and 4 is
    dropped by the buffer; then predict spans, an eviction, a refused
    reload, a breach, its recovery and a second breach, a recompile
    storm and a straggler."""
    e = m.events

    def stamp(wid, phase, reason, **kw):
        e.emit(e.WINDOW_SPAN, window_id=wid, phase=phase, reason=reason,
               at_unix_s=round(clock(), 6), **kw)

    for wid in (0, 1, 3, 4, 5):
        stamp(wid, "ingest_wait", "sealed",
              ingest_unix_s=round(clock() - 3.0 - wid, 6), records=128)
    stamp(2, "ingest_wait", "replayed", ingest_unix_s=4_990.5, records=128)
    for wid in (0, 1, 3, 5):
        stamp(wid, "arm_wait", "armed", tasks=4)
    stamp(2, "arm_wait", "rearmed", tasks=2)
    stamp(5, "arm_wait", "rearmed", tasks=1)
    for step, wid in enumerate((0, 0, 1, 0, 2, 5, 0, 1), start=1):
        stamp(wid, "train", "trained", step=step, start=32 * step)
        stamp(wid, "admission", "admitted", rows=64)
    stamp(3, "train", "dropped")
    e.emit(e.STREAM_WINDOW_DROPPED, window=4, name="stream:w000004",
           records=128)
    for wid in (0, 1, 5):
        stamp(wid, "checkpoint", "produced", step=8)
        stamp(wid, "reload_wait", "reloaded", step=8)
    for wid in (0, 5):
        stamp(wid, "serve_wait", "served", step=8)
    for rid in range(3):
        e.emit(e.PREDICT_SPAN, request_id=f"rq-{rid:04d}",
               reason="sampled", phases_s={"compute": 0.004 * rid})
    e.emit(e.POLICY_DECISION, action="evict", reason="straggler",
           worker_id=2, tick=4)
    e.emit(e.FLEET_RELOAD_REFUSED, pending_step=7, skew=12)
    e.emit(e.SLO_BREACH, slo="staleness_p99", fast_burn=20.0,
           slow_burn=3.0)
    e.emit(e.SLO_RECOVERED, slo="staleness_p99", fast_burn=0.5,
           slow_burn=1.0)
    e.emit(e.SLO_BREACH, slo="staleness_p99", fast_burn=15.0,
           slow_burn=2.0)
    e.emit(e.RECOMPILE_STORM, program="train_step", signatures=9,
           budget=4)
    e.emit(e.STRAGGLER_DETECTED, worker_id=1, ratio=3.5)


def _run(m, incident_dir):
    clock = FakeClock()
    reg = m.metrics.MetricsRegistry()
    counter = reg.counter("master_test_events_total", "fixture")
    history = m.history.MetricHistory(registries=[reg], clock=clock)
    lineage = m.lineage.WindowLineage(clock=clock, capacity=4)
    recorder = m.flight.FlightRecorder(
        incident_dir=incident_dir, ring_capacity=8, max_bundles=3,
        snapshot_fn=lambda: {"tasks": {"todo": 1}, "ts": 9.0, "pid": 1},
        history=history).install()
    seen = []
    m.events.add_observer(seen.append)
    lineage.install()
    try:
        for _ in range(3):
            counter.inc(2)
            history.tick()
        _emit_lives(m, clock)
        awaiting = (lineage.windows_awaiting_checkpoint(8),
                    lineage.windows_awaiting_reload(8),
                    lineage.windows_awaiting_serve(8))
        pending = recorder.snapshot()["pending"]
        written = recorder.flush()
        again = recorder.breach({"slo": "staleness_p99", "fast_burn": 1})
        fresh = recorder.breach({"slo": "fleet_skew", "fast_burn": 30.0})
        stormed = recorder.storm({"program": "eval_step"})
        manual = recorder.capture("manual", {"why": "test", "ts": 1.0})
    finally:
        lineage.close()
        recorder.close()
        m.events.remove_observer(seen.append)
    stable = [{k: v for k, v in r.items() if k not in ("ts", "pid")}
              for r in seen]
    states = m.lineage.from_events(stable)
    decomps = {wid: m.lineage.decompose(s) for wid, s in states.items()}
    files = {}
    for name in sorted(os.listdir(incident_dir)):
        for fname in sorted(os.listdir(os.path.join(incident_dir, name))):
            with open(os.path.join(incident_dir, name, fname), "rb") as f:
                files[(name, fname)] = f.read()
    listed = [{k: v for k, v in b.items() if k != "path"}
              for b in m.flight.list_bundles(incident_dir)]
    return {
        "records": lineage.records(),
        "snapshot": lineage.snapshot(),
        "open": lineage.open_decompositions(),
        "lineage_metrics": lineage.registry.snapshot(),
        "awaiting": awaiting,
        "events": stable,
        "decomps": decomps,
        "decomps_now": {wid: m.lineage.decompose(s, now=5_100.0)
                        for wid, s in states.items()},
        "dominant": m.lineage.dominant_phase(list(decomps.values())),
        "dominant_none": m.lineage.dominant_phase([]),
        "pending": pending,
        "written": [os.path.basename(p) for p in written],
        "again": [os.path.basename(p) for p in again],
        "fresh": [os.path.basename(p) for p in fresh],
        "stormed": [os.path.basename(p) for p in stormed],
        "manual": os.path.basename(manual),
        "recorder": {k: v for k, v in recorder.snapshot().items()
                     if k != "incident_dir"},
        "files": files,
        "listed": listed,
        "loaded": m.flight.load_bundle(os.path.join(
            incident_dir, listed[-1]["bundle"])),
    }


def test_lineage_and_bundles_match_the_jax_modules(tmp_path):
    want = _run(JAX, str(tmp_path / "jax"))
    got = _run(PORT, str(tmp_path / "port"))
    for key in want:
        assert got[key] == want[key], key
    # what the script covers
    complete = [d["window_id"] for d in want["records"] if d["complete"]]
    assert complete == [0, 5]
    assert want["decomps"][5]["rearmed"] and want["decomps"][2]["replayed"]
    assert want["decomps"][3]["dropped"] and want["decomps"][4]["dropped"]
    assert want["decomps"][1]["blocked_phase"] == "serve_wait"
    assert set(want["decomps"][0]["phases"]) == set(
        port_lineage.PHASE_ORDER)
    assert want["snapshot"]["windows_traced"] == 2
    # the tap queued one capture per trigger key; the second breach of
    # staleness_p99 merged into the queued first, and once flushed (the
    # recovery re-armed its key) a breach of it captures again
    assert want["written"] == [
        "incident-0001-window_dropped", "incident-0002-policy_eviction",
        "incident-0003-reload_refused", "incident-0004-slo_breach",
        "incident-0005-recompile_storm"]
    assert want["again"] == ["incident-0006-slo_breach"]
    assert want["fresh"] == ["incident-0007-slo_breach"]
    assert want["stormed"] == ["incident-0008-recompile_storm"]
    assert want["manual"] == "incident-0009-manual"
    # rotation kept the newest three
    assert [b["bundle"] for b in want["listed"]] == [
        "incident-0007-slo_breach", "incident-0008-recompile_storm",
        "incident-0009-manual"]
    assert not any(f == "programs.json" for _, f in want["files"])
    loaded = want["loaded"]
    assert loaded["manifest"]["trigger"] == "manual"
    assert loaded["master"] == {"tasks": {"todo": 1}}
    assert loaded["history"]["samples"] == 3
    assert loaded["manifest"]["counts"] == {
        "spans": 3, "decisions": 7, "lineage": 8}


def test_observers_see_every_emit_without_a_log_and_never_raise(tmp_path):
    seen = []

    def broken(record):
        raise RuntimeError("an observer that fails")

    port_events.add_observer(broken)
    port_events.add_observer(seen.append)
    port_events.add_observer(seen.append)      # registered once
    try:
        assert not port_events.enabled()
        port_events.emit(port_events.STREAM_WINDOW_SEALED, window=3,
                         records=8)
    finally:
        port_events.remove_observer(broken)
        port_events.remove_observer(seen.append)
    port_events.remove_observer(seen.append)   # absent: a no-op
    assert [r["event"] for r in seen] == ["stream_window_sealed"]
    assert seen[0]["window"] == 3
    with pytest.raises(ValueError, match="unknown span event"):
        port_events.emit("no_such_event")
    assert port_events.VOCABULARY == jax_events.VOCABULARY
    for name in ("WINDOW_PHASES", "WINDOW_REASONS", "SPAN_PHASES",
                 "SPAN_REASONS", "INCIDENT_TRIGGERS", "POLICY_ACTIONS",
                 "POLICY_REASONS", "SERVING_SCALE_ACTIONS",
                 "SERVING_SCALE_REASONS"):
        assert getattr(port_events, name) == getattr(jax_events, name)


def test_log_rotation_env_wire_and_read_order_match(tmp_path, monkeypatch):
    """The same emits through each package with a 300-byte cap: the same
    generations on disk, read back in emit order."""
    out = {}
    for label, m in (("jax", JAX), ("port", PORT)):
        path = str(tmp_path / label / "events.jsonl")
        monkeypatch.delenv(m.events.ENV_EVENT_LOG, raising=False)
        m.events.configure(path, role="master", worker_id=3,
                           export_env=True, max_bytes=300)
        assert os.environ[m.events.ENV_EVENT_LOG] == path
        assert m.events.enabled()
        for i in range(12):
            m.events.emit(m.events.TASK_DISPATCHED, task_id=i)
        m.events.configure(None)
        assert not m.events.enabled()
        assert m.events.configure_from_env(role="worker") is True
        m.events.emit(m.events.TASK_CLAIMED, task_id=11)
        m.events.configure(None)
        evs = m.events.read_events(path)
        out[label] = (
            [(e["event"], e["task_id"], e["role"], e.get("worker_id"))
             for e in evs],
            os.path.exists(m.events.rotated_path(path)),
            m.events.task_chain(evs, 11))
        monkeypatch.delenv(m.events.ENV_EVENT_LOG)
        assert m.events.configure_from_env() is False
    assert out["port"] == out["jax"]
    events_read, rotated, chain = out["port"]
    assert rotated and chain == ["task_dispatched", "task_claimed"]
    # the rotation keeps one generation: the oldest lines are gone
    assert 0 < len(events_read) < 13
    assert events_read[-1] == ("task_claimed", 11, "worker", None)
    assert port_events.read_events(str(tmp_path / "missing.jsonl")) == []


def test_bundle_reads_skip_what_is_not_a_bundle(tmp_path):
    root = tmp_path / "incidents"
    root.mkdir()
    (root / "stray").mkdir()
    (root / "broken").mkdir()
    (root / "broken" / port_flight.MANIFEST_NAME).write_text("{nope")
    recorder = port_flight.FlightRecorder(incident_dir=str(root))
    path = recorder.capture("manual")
    with open(os.path.join(path, "spans.json"), "w") as f:
        f.write("{torn")
    assert [b["bundle"] for b in port_flight.list_bundles(str(root))] == [
        "incident-0001-manual"]
    loaded = port_flight.load_bundle(path)
    assert "spans" not in loaded and loaded["decisions"] == []
    assert port_flight.list_bundles(str(tmp_path / "none")) == []
    assert port_flight.FlightRecorder().capture("manual") is None
    with open(os.path.join(path, port_flight.MANIFEST_NAME)) as f:
        assert json.load(f)["format"] == jax_flight.BUNDLE_FORMAT
