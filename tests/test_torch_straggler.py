"""Straggler detection in the port's TaskManager: counterparts of
tests/test_step_profiling.py's two straggler tests, and the same task
durations through both packages' managers (on one injected clock) give
the same flags, snapshots and events."""

import numpy as np
import pytest

from elasticdl_tpu.common import events as jax_events
from elasticdl_tpu.master import task_manager as jax_tm_mod
from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.master import task_manager as port_tm_mod
from elasticdl_tpu_torch.proto import messages as pb


class FakeClock:
    def __init__(self):
        self.t = 5000.0

    def __call__(self):
        return self.t


def _make_tm(module, clock, n_shards=256, **kwargs):
    shards = module.create_shards_from_ranges([("d", 0, n_shards)], 1)
    return module.TaskManager(training_shards=shards, num_epochs=1,
                              clock=clock, **kwargs)


def _run_fleet(tm, clock, rounds, durations_by_worker):
    """Lease and report `rounds` training tasks per worker; each lease
    lasts the given duration on the injected clock."""
    for _ in range(rounds):
        for wid, duration in durations_by_worker.items():
            task = tm.get(wid)
            assert task is not None
            clock.t += duration
            tm.report(task.task_id, success=True, worker_id=wid,
                      records=1)


def test_straggler_flagged_and_cleared(tmp_path):
    log = str(tmp_path / "events.jsonl")
    events.configure(log, role="master")
    clock = FakeClock()
    try:
        tm = _make_tm(port_tm_mod, clock, straggler_multiple=2.0,
                      straggler_min_tasks=3)
        _run_fleet(tm, clock, 2, {0: 0.01, 1: 0.01, 2: 0.5})
        # below min_tasks: nobody flagged yet
        assert tm.snapshot()["stragglers"] == []
        _run_fleet(tm, clock, 2, {0: 0.01, 1: 0.01, 2: 0.5})
        assert tm.snapshot()["stragglers"] == [2]
        stats = tm.straggler_snapshot()
        assert stats[2]["straggler"] is True
        assert stats[0]["straggler"] is False
        assert stats[2]["mean_task_s"] > stats[0]["mean_task_s"]
        assert tm.counters.registry.value(
            "master_straggler_workers_count") == 1.0
        flags = [e for e in events.read_events(log)
                 if e["event"] == events.STRAGGLER_DETECTED]
        assert len(flags) == 1
        assert flags[0]["worker_id"] == 2
        assert flags[0]["ratio"] >= 2.0
        # a recovered (dead) worker stops skewing the fleet
        tm.recover_tasks(2)
        assert tm.snapshot()["stragglers"] == []
        assert tm.counters.registry.value(
            "master_straggler_workers_count") == 0.0
    finally:
        events.configure(None)


def test_straggler_detection_disabled_and_single_worker():
    clock = FakeClock()
    tm = _make_tm(port_tm_mod, clock, straggler_multiple=0.0,
                  straggler_min_tasks=1)
    _run_fleet(tm, clock, 4, {0: 0.01, 1: 1.0})
    assert tm.snapshot()["stragglers"] == []  # multiple=0 disables

    tm = _make_tm(port_tm_mod, clock, straggler_multiple=2.0,
                  straggler_min_tasks=1)
    _run_fleet(tm, clock, 4, {0: 1.0})
    assert tm.snapshot()["stragglers"] == []  # no peer, no baseline


def test_the_dwell_clock_counts_from_the_first_flag():
    clock = FakeClock()
    tm = _make_tm(port_tm_mod, clock, straggler_multiple=2.0,
                  straggler_min_tasks=1)
    _run_fleet(tm, clock, 1, {0: 0.1, 1: 0.1, 2: 1.0})
    assert tm.straggler_snapshot()[2]["flagged_for_s"] == 0.0
    clock.t += 7.5
    assert tm.straggler_snapshot()[2]["flagged_for_s"] == 7.5


@pytest.mark.parametrize("seed,workers,multiple,min_tasks", [
    (0, 3, 3.0, 3), (1, 2, 2.0, 1), (2, 5, 1.5, 2), (3, 4, 0.0, 1)])
def test_same_durations_give_the_jax_packages_flags(tmp_path, seed,
                                                    workers, multiple,
                                                    min_tasks):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.05, 0.2, size=workers)
    slow = int(rng.integers(workers))
    clock_p, clock_j = FakeClock(), FakeClock()
    port = _make_tm(port_tm_mod, clock_p, straggler_multiple=multiple,
                    straggler_min_tasks=min_tasks)
    ref = _make_tm(jax_tm_mod, clock_j, straggler_multiple=multiple,
                   straggler_min_tasks=min_tasks)
    log_p, log_j = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    ever = set()
    events.configure(log_p, role="master")
    jax_events.configure(log_j, role="master")
    try:
        for step in range(30):
            wid = int(rng.integers(workers))
            duration = float(base[wid] * (6.0 if wid == slow and
                                          step > 10 else 1.0)
                             * rng.uniform(0.8, 1.2))
            pt, jt = port.get(wid), ref.get(wid)
            clock_p.t += duration
            clock_j.t += duration
            port.report(pt.task_id, success=True, worker_id=wid, records=1)
            ref.report(jt.task_id, success=True, worker_id=wid, records=1)
            assert port.snapshot()["stragglers"] == \
                ref.snapshot()["stragglers"]
            assert port.straggler_snapshot() == ref.straggler_snapshot()
            ever |= set(port.snapshot()["stragglers"])
        # detection is off at multiple 0; otherwise someone was flagged
        assert bool(ever) == (multiple > 0)
        # a worker's loss clears it in both
        port.recover_tasks(slow)
        ref.recover_tasks(slow)
        assert port.straggler_snapshot() == ref.straggler_snapshot()
    finally:
        events.configure(None)
        jax_events.configure(None)

    def flags(path, read):
        return [{k: v for k, v in e.items() if k not in ("ts", "pid")}
                for e in read(path)
                if e["event"] == events.STRAGGLER_DETECTED]

    assert flags(log_p, events.read_events) == flags(
        log_j, jax_events.read_events)
    assert port.counters.registry.value(
        "master_straggler_workers_count") == ref.counters.registry.value(
        "master_straggler_workers_count")


def test_master_snapshot_merges_worker_stats():
    """Master.snapshot carries the straggler stats beside the retry and
    fault counters."""
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.master.servicer import MasterServicer

    master = Master.__new__(Master)
    clock = FakeClock()
    master.task_manager = _make_tm(port_tm_mod, clock,
                                   straggler_multiple=2.0,
                                   straggler_min_tasks=1)
    # the per-worker rows start from the telemetry the servicer holds
    master.servicer = MasterServicer(master.task_manager)
    _run_fleet(master.task_manager, clock, 1, {0: 0.1, 1: 0.9})
    snap = master.snapshot()
    assert snap["workers"][1]["straggler"] is True
    assert set(snap) == {"tasks", "workers", "resilience", "faults"}
    assert snap["tasks"]["stragglers"] == [1]
    assert pb.TRAINING in snap["tasks"]["counters"]["by_type"]
