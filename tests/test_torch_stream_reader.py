"""The port's stream reader and perpetual task windows
(elasticdl_tpu_torch/data/reader/stream_reader.py,
master/task_manager.py perpetual mode) against the JAX package's, on
the same seeds, fake clock and script.  Everything here is an integer or
host path, so every comparison is exact: records, window names, ids,
watermarks, lag, drops and replays, the `stream.poll` and `task.rearm`
faults and their counters, task ids and shards, the online snapshots,
the span events (bar `ts` and `pid`) and the journals' re-armed
shards.  The last test runs chip_smoke.py's stream phase with the model
on the CPU, so the script's checks are held here too."""

import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from elasticdl_tpu.common import events as jax_events
from elasticdl_tpu.common import faults as jax_faults
from elasticdl_tpu.data.reader import stream_reader as jax_sr
from elasticdl_tpu.master import task_manager as jax_tm
from elasticdl_tpu.proto import elasticdl_pb2 as jax_pb
from elasticdl_tpu_torch.common import events as port_events
from elasticdl_tpu_torch.common import faults as port_faults
from elasticdl_tpu_torch.data.reader import stream_reader as port_sr
from elasticdl_tpu_torch.master import task_manager as port_tm
from elasticdl_tpu_torch.proto import messages as port_pb

torch.set_num_threads(2)

JAX = SimpleNamespace(events=jax_events, faults=jax_faults, sr=jax_sr,
                      tm=jax_tm, pb=jax_pb)
PORT = SimpleNamespace(events=port_events, faults=port_faults, sr=port_sr,
                       tm=port_tm, pb=port_pb)
VOLATILE = ("ts", "pid", "role")


class FakeClock:
    def __init__(self, start=1_000.0, step=0.5):
        self.now = start
        self.step = step

    def __call__(self):
        self.now += self.step
        return self.now


def _stable(records):
    return [{k: v for k, v in r.items() if k not in VOLATILE}
            for r in records]


class _Tapped:
    """Observe one package's event stream and install a fault schedule
    for the block."""

    def __init__(self, m, schedule=()):
        self.m, self.schedule, self.seen = m, schedule, []

    def __enter__(self):
        self.m.events.add_observer(self.seen.append)
        self.m.faults.install(self.m.faults.FaultRegistry(
            schedule=[self.m.faults.FaultSpec(*s) for s in self.schedule],
            seed=3))
        return self

    def __exit__(self, *exc):
        self.stats = self.m.faults.stats()
        self.m.faults.uninstall()
        self.m.events.remove_observer(self.seen.append)


@pytest.mark.parametrize("seed,start,n", [
    (0, 0, 64), (7, 1000, 33), (2 ** 64 - 1, 2 ** 63, 17),
    (2 ** 63 + 5, 2 ** 40, 9), (123456789, 5, 1)])
def test_source_records_match_bit_for_bit(seed, start, n):
    """Content is a pure function of (seed, index), through splitmix64's
    mod-2^64 products (the wraparound is the algorithm)."""
    kw = dict(seed=seed, users=512, items=128, records_per_poll=64)
    want = jax_sr.ClickStreamSource(**kw).records(start, n, 12.5)
    got = port_sr.ClickStreamSource(**kw).records(start, n, 12.5)
    assert got == want
    x = np.random.default_rng(seed % 2 ** 32).integers(
        0, 2 ** 64, size=257, dtype=np.uint64)
    np.testing.assert_array_equal(port_sr._mix64(x), jax_sr._mix64(x))


def test_poll_stamps_from_the_injected_clock():
    for m in (JAX, PORT):
        clock = FakeClock(50.0, 2.0)
        source = m.sr.ClickStreamSource(seed=4, records_per_poll=3,
                                        clock=clock)
        assert [r["event_unix_s"] for r in source.poll()] == [52.0] * 3
        assert source.emitted == 3
    a = JAX.sr.ClickStreamSource(seed=4, clock=FakeClock()).poll(40)
    b = PORT.sr.ClickStreamSource(seed=4, clock=FakeClock()).poll(40)
    assert a == b


# stream.poll stalls at hits 2 (raise) and 5 (drop); task.rearm skips
# the 2nd arm.  Training keeps up two tasks a tick; tick 6 pulls three
# windows at once, so the 3-window buffer drops its oldest, which the
# ledger then replays.
SCHEDULE = (("stream.poll", 2, "raise"), ("stream.poll", 5, "drop"),
            ("task.rearm", 1, "raise"))


def _stream_script(m):
    clock = FakeClock()
    out = {"polled": [], "armed": [], "tasks": [], "lag": [],
           "released": [], "restored": []}
    with _Tapped(m, SCHEDULE) as tap:
        source = m.sr.ClickStreamSource(seed=11, users=32, items=16,
                                        records_per_poll=6, clock=clock)
        reader = m.sr.StreamReader(source, window_records=8,
                                   max_buffered_windows=3, clock=clock)
        tm = m.tm.TaskManager(perpetual=True, clock=clock)
        pending, left, ids = [], {}, {}
        for tick in range(14):
            out["polled"].append(reader.poll(24 if tick == 6 else None))
            pending += reader.take_new_windows()
            still = []
            for w in pending:
                n = tm.arm_window(w.name, len(w.records), 3,
                                  watermark_unix_s=w.watermark_unix_s,
                                  window_id=w.window_id,
                                  start_index=w.start_index)
                out["armed"].append((w.window_id, w.name, n))
                if n is None:
                    still.append(w)
                elif n:
                    left[w.name], ids[w.name] = n, w.window_id
            pending = still
            for _ in range(2):
                task = tm.get(0)
                if task is None:
                    break
                name = task.shard.name
                try:
                    recs = list(reader.read_records(task))
                except LookupError:
                    (entry,) = [e for e in tm.open_windows()
                                if e["name"] == name]
                    out["restored"].append(reader.restore_window(
                        name, entry["window_id"], entry["start"],
                        entry["records"], entry["watermark"]))
                    recs = list(reader.read_records(task))
                out["tasks"].append((
                    task.task_id, int(task.type), name, task.shard.start,
                    task.shard.end, recs))
                tm.report(task.task_id, True, worker_id=0,
                          records=len(recs), model_version=tick)
                left[name] -= 1
                if not left[name]:
                    out["released"].append((
                        tm.release_window(ids[name]),
                        reader.release_window(name)))
            out["lag"].append((reader.lag_s(), reader.watermark_unix_s))
        # the last open window is given up: counted lost
        open_ids = [e["window_id"] for e in tm.open_windows()]
        out["forfeit"] = (open_ids, tm.forfeit_window(open_ids[-1]),
                          tm.forfeit_window(open_ids[-1]))
        out["reader"] = reader.snapshot()
        out["shards"] = reader.create_shards()
        out["metadata"] = reader.metadata
        out["reader_metrics"] = reader.metrics_registry.snapshot()
        out["online"] = tm.online_snapshot()
        out["stream_metrics"] = {
            k: v for k, v in tm.counters.registry.snapshot().items()
            if k.startswith("master_stream_")}
        out["counters"] = tm.counters.as_dict()
        out["todo"] = tm.snapshot()["todo"]
    out["events"] = _stable(tap.seen)
    out["faults"] = tap.stats
    return out


def test_stream_windows_faults_drop_and_replay_match_the_jax_reader():
    want, got = _stream_script(JAX), _stream_script(PORT)
    for key in want:
        assert got[key] == want[key], key
    # the script reached what it means to cover
    assert want["faults"]["injected"] == 3
    assert want["reader"]["poll_faults"] == 2
    assert want["reader"]["dropped_windows"] >= 1
    assert want["restored"] and all(want["restored"])
    assert want["online"]["rearm_faults"] == 1
    assert want["online"]["windows_lost"] == 1
    assert want["online"]["duplicate_reports"] == 0
    assert len(want["released"]) >= 4
    names = {e["event"] for e in want["events"]}
    assert {"stream_window_sealed", "stream_window_dropped",
            "stream_window_restored", "stream_window_armed",
            "stream_window_released", "window_span"} <= names


def _ledger_script(m, path):
    """Arm three windows, finish some offsets, release one, then restart
    from the journal and drain what comes back."""
    clock = FakeClock()
    with _Tapped(m) as tap:
        tm = m.tm.TaskManager(perpetual=True, persist_path=path,
                              clock=clock)
        for wid in range(3):
            assert tm.arm_window(f"stream:w{wid:06d}", 10, 4,
                                 watermark_unix_s=100.0 + wid,
                                 window_id=wid, start_index=10 * wid) == 3
        assert tm.arm_window("stream:w000001", 10, 4, window_id=1) == 0
        done = []
        for _ in range(5):
            task = tm.get(0)
            done.append((task.shard.name, task.shard.start))
            assert tm.report(task.task_id, True, worker_id=0,
                             records=task.shard.end - task.shard.start)
        assert tm.release_window(0) is True
        base = tm.get(0).task_id      # leased, never reported: re-runs
        with open(path) as f:
            journal = json.load(f)
        successor = m.tm.TaskManager(
            perpetual=True, persist_path=path, clock=clock,
            metrics_registry=tm.counters.registry)
        rearmed = []
        first = None
        while True:
            task = successor.get(1)
            if task is None:
                break
            first = task.task_id if first is None else first
            rearmed.append((task.task_id - first, task.shard.name,
                            task.shard.start, task.shard.end))
            successor.report(task.task_id, True, worker_id=1,
                             records=task.shard.end - task.shard.start)
        acks = [successor.release_window(w) for w in (0, 1, 2)]
        refused = successor.arm_window("stream:w000000", 10, 4,
                                       window_id=0)
        with open(path) as f:
            final = json.load(f)
    return {"done": done, "journal": journal, "rearmed": rearmed,
            "acks": acks, "refused": refused, "final": final,
            "open": successor.open_windows(),
            "online": successor.online_snapshot(),
            "events": _stable(tap.seen), "base_ok": base >= 1 << 20}


def test_restart_rearms_the_same_undone_shards_from_each_journal(
        tmp_path):
    want = _ledger_script(JAX, str(tmp_path / "jax.json"))
    got = _ledger_script(PORT, str(tmp_path / "port.json"))
    assert got == want
    # exactly the undone offsets of the unreleased windows came back
    assert [r[1:] for r in want["rearmed"]] == [
        ("stream:w000001", 8, 10), ("stream:w000002", 0, 4),
        ("stream:w000002", 4, 8), ("stream:w000002", 8, 10)]
    assert want["acks"] == [False, True, True]
    assert want["refused"] == 0 and want["open"] == []
    # the successor adopted its predecessor's registry: one count
    assert want["online"]["windows_released"] == 3
    assert want["online"]["windows_armed"] == 3
    assert want["online"]["windows_lost"] == 0
    assert want["online"]["duplicate_reports"] == 0


def test_duplicate_reports_and_the_never_finishing_queue():
    for m in (JAX, PORT):
        done = []
        tm = m.tm.TaskManager(perpetual=True)
        tm.add_all_done_callback(lambda: done.append(True))
        assert tm.arm_window("stream:w000000", 4, 4, window_id=0) == 1
        task = tm.get(0)
        assert tm.report(task.task_id, True, worker_id=0, records=4)
        tm._todo.append(tm._new_task(task.shard, m.pb.TRAINING))
        dup = tm.get(0)
        assert tm.report(dup.task_id, True, worker_id=0, records=4)
        tm.maybe_finish_if_drained()
        assert not tm.finished and not done
        assert tm.online_snapshot()["duplicate_reports"] == 1
        assert tm.snapshot()["online"]["windows_armed"] == 1
        with pytest.raises(RuntimeError, match="perpetual"):
            m.tm.TaskManager().arm_window("w", 8, 4)
        assert m.tm.TaskManager().online_snapshot() is None


def test_read_records_after_release_raises_lookup_error():
    clock = FakeClock()
    reader = port_sr.StreamReader(
        port_sr.ClickStreamSource(seed=2, records_per_poll=8, clock=clock),
        window_records=8, clock=clock)
    reader.poll()
    (window,) = reader.take_new_windows()
    tm = port_tm.TaskManager(perpetual=True)
    assert tm.arm_window(window.name, 8, 8, window_id=0) == 1
    task = tm.get(0)
    assert list(reader.read_records(task)) == window.records
    assert reader.release_window(window.name)
    with pytest.raises(LookupError, match="no longer"):
        list(reader.read_records(task))
    with pytest.raises(ValueError, match="window_records"):
        port_sr.StreamReader(window.records, window_records=0)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)     # defines main(); does not run it
    return module


def test_the_chip_scripts_stream_phase_passes_its_checks_on_the_cpu(
        tmp_path):
    """chip_smoke.py's stream_judgment (a) and the freshness drill of (b)
    at their full shape, with the model on the CPU: 32 windows through
    the stall, the skipped arm, the buffer drop and its replay and the
    restart, twice with the same events and parameters."""
    cs = _chip_smoke()
    first = cs.stream_train("cpu", str(tmp_path / "run1"))
    cs.check_stream(first)
    second = cs.stream_train("cpu", str(tmp_path / "run2"))
    assert second["events"] == first["events"]
    assert second["losses"] == first["losses"]
    assert all(torch.equal(first["params"][k], second["params"][k])
               for k in first["params"])
    assert first["phase_quantiles_s"]["ingest_wait"]["p99"] > 0.5
    args = cs.cli.parse_args(["train", "--slo_staleness_p99_s", "30"])
    drill = cs.freshness_drill("cpu", str(tmp_path), first, args,
                               device="cpu")
    assert drill["bundles"] == ["incident-0001-slo_breach"]
