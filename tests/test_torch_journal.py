"""The task journal (master fault tolerance) of the port's TaskManager
and Master: counterparts of tests/test_master_restart.py's 12 tests, and
the cross-package checks — the same get/report sequence through both
packages' TaskManagers on an injected clock gives journals equal as
parsed JSON and restored task sequences equal in ids, types and shards,
and each package restores the other's journal."""

import json
import os
import random
import types

import pytest

from elasticdl_tpu.master import task_manager as jax_tm_mod
from elasticdl_tpu.proto import elasticdl_pb2 as jpb
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.data.record_io import write_tfrecords
from elasticdl_tpu_torch.master import main as port_main
from elasticdl_tpu_torch.master import task_manager as port_tm_mod
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.master.task_manager import (
    TaskManager,
    create_shards_from_ranges,
)
from elasticdl_tpu_torch.proto import messages as pb


def _tm(tmp_path, records=320, per_task=64, epochs=2):
    shards = create_shards_from_ranges([("f", 0, records)], per_task)
    return TaskManager(
        training_shards=shards,
        num_epochs=epochs,
        shuffle_shards=True,
        shuffle_seed=0,
        persist_path=str(tmp_path / "task_state.json"),
    )


def _drain(tm, records=64, version=-1):
    keys = []
    while True:
        task = tm.get(0)
        if task is None:
            return keys
        keys.append((task.shard.name, task.shard.start, task.shard.end))
        tm.report(task.task_id, success=True, records=records,
                  model_version=version)


def test_restart_skips_done_shards(tmp_path):
    tm = _tm(tmp_path)
    done = []
    for _ in range(3):  # finish 3 of 5 epoch-1 tasks
        task = tm.get(0)
        done.append((task.shard.name, task.shard.start, task.shard.end))
        tm.report(task.task_id, success=True, records=64)
    tm2 = _tm(tmp_path)
    assert tm2.counters.records_done == 3 * 64
    remaining = _drain(tm2)
    # epoch 1's remaining two shards are exactly the ones never
    # reported, then epoch 2 re-runs everything
    assert len(remaining) == 2 + 5
    assert set(remaining[:2]) == {
        ("f", lo, lo + 64) for lo in range(0, 320, 64)} - set(done)
    assert tm2.finished
    assert tm2.counters.records_done == 2 * 320


def test_restart_mid_later_epoch(tmp_path):
    tm = _tm(tmp_path)
    for _ in range(5):  # all of epoch 1
        task = tm.get(0)
        tm.report(task.task_id, success=True, records=64)
    task = tm.get(0)  # first task of epoch 2
    tm.report(task.task_id, success=True, records=64)
    tm2 = _tm(tmp_path)
    assert len(_drain(tm2)) == 4  # only epoch 2's remaining shards
    assert tm2.finished
    assert tm2.counters.records_done == 2 * 320


def test_unreported_inflight_shard_reruns(tmp_path):
    """A shard leased but never reported is not journaled: the relaunch
    re-queues it (at-least-once)."""
    tm = _tm(tmp_path)
    leased = tm.get(0)
    done = tm.get(0)
    tm.report(done.task_id, success=True, records=64)
    tm2 = _tm(tmp_path)
    keys = [start for _, start, _ in _drain(tm2)]
    assert len(keys) == 4 + 5
    assert leased.shard.start in keys[:4]


def test_corrupt_journal_falls_back_to_fresh_epoch(tmp_path):
    tm = _tm(tmp_path)
    task = tm.get(0)
    tm.report(task.task_id, success=True, records=64)
    (tmp_path / "task_state.json").write_text("{not json")
    tm2 = _tm(tmp_path)  # must not raise; trains the full epoch again
    assert len(_drain(tm2)) == 10 and tm2.finished


def test_journal_written_atomically(tmp_path):
    tm = _tm(tmp_path)
    task = tm.get(0)
    tm.report(task.task_id, success=True, records=64)
    path = tmp_path / "task_state.json"
    assert path.exists()
    assert not os.path.exists(str(path) + ".tmp")
    state = json.loads(path.read_text())
    assert state["epoch"] == 1
    assert len(state["done_training_shards"]) == 1


def test_cutoff_drops_shards_newer_than_model_checkpoint(tmp_path):
    shards = create_shards_from_ranges([("f", 0, 320)], 64)
    path = str(tmp_path / "task_state.json")
    tm = TaskManager(training_shards=shards, num_epochs=1,
                     shuffle_shards=True, shuffle_seed=0,
                     persist_path=path)
    for step in (2, 4):  # two shards done at steps <= checkpoint step 4
        task = tm.get(0)
        tm.report(task.task_id, success=True, records=64,
                  model_version=step)
    task = tm.get(0)  # a third finishes at step 6, past the checkpoint
    tm.report(task.task_id, success=True, records=64, model_version=6)
    tm2 = TaskManager(training_shards=shards, num_epochs=1,
                      shuffle_shards=True, shuffle_seed=0,
                      persist_path=path, restore_cutoff_step=4)
    assert tm2.counters.records_done == 2 * 64  # post-cutoff re-counted
    assert len(_drain(tm2)) == 3  # 2 never done + 1 post-checkpoint
    assert tm2.finished and tm2.counters.records_done == 320


def test_master_discards_orphaned_journal(tmp_path):
    """A journal with no model checkpoint beside it is ignored (and
    removed): the job retrains the epoch instead of dropping data."""
    data = str(tmp_path / "t.tfrecord")
    write_tfrecords(data, [b"x" * 10 for _ in range(128)])
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "task_state.json").write_text(
        '{"epoch": 1, "done_training_shards": '
        '[["%s", 0, 64, 1.0]], "records_done": 64}' % data)
    args = cli.parse_args(
        ["train", "--training_data", data, "--records_per_task", "64",
         "--num_epochs", "1", "--checkpoint_dir", str(ckpt)])
    args.job_type = "train"
    master = Master(args)
    n = 0
    while master.task_manager.get(0) is not None:
        n += 1
    assert n == 2
    assert json.loads((ckpt / "task_state.json").read_text())[
        "done_training_shards"] == []


def test_malformed_entries_fall_back_without_destroying_journal_progress(
        tmp_path):
    shards = create_shards_from_ranges([("f", 0, 320)], 64)
    path = tmp_path / "task_state.json"
    path.write_text('{"epoch": 1, "done_training_shards": [["f", 0, 64]], '
                    '"records_done": 64}')  # entry missing its version
    tm = TaskManager(training_shards=shards, num_epochs=1,
                     shuffle_shards=True, shuffle_seed=0,
                     persist_path=str(path))
    count = 0
    while tm.get(0) is not None:
        count += 1
    assert count == 5  # full fresh epoch


def test_unknown_version_with_cutoff_reruns(tmp_path):
    shards = create_shards_from_ranges([("f", 0, 128)], 64)
    path = str(tmp_path / "task_state.json")
    tm = TaskManager(training_shards=shards, num_epochs=1,
                     persist_path=path)
    task = tm.get(0)
    tm.report(task.task_id, success=True, records=64)  # version unknown
    tm2 = TaskManager(training_shards=shards, num_epochs=1,
                      persist_path=path, restore_cutoff_step=100)
    count = 0
    while tm2.get(0) is not None:
        count += 1
    assert count == 2  # both shards re-queued


def _epoch_bump_journal(path):
    path.write_text(json.dumps({
        "epoch": 2,                       # the journal says epoch 1 is
        "done_training_shards": [],       # done ...
        "epoch_history": [[1, 20]],       # ... at step 20
        "records_done": 128,
    }))


def test_untrusted_epoch_bump_regresses(tmp_path):
    shards = create_shards_from_ranges([("f", 0, 128)], 64)
    path = tmp_path / "task_state.json"
    _epoch_bump_journal(path)
    tm = TaskManager(training_shards=shards, num_epochs=2,
                     shuffle_shards=True, shuffle_seed=0,
                     persist_path=str(path),
                     restore_cutoff_step=10)  # covers only step 10
    assert len(_drain(tm, version=99)) == 4  # epoch 1 again, then 2
    assert tm.finished


def test_trusted_epoch_bump_resumes_later_epoch(tmp_path):
    shards = create_shards_from_ranges([("f", 0, 128)], 64)
    path = tmp_path / "task_state.json"
    _epoch_bump_journal(path)
    tm = TaskManager(training_shards=shards, num_epochs=2,
                     shuffle_shards=True, shuffle_seed=0,
                     persist_path=str(path),
                     restore_cutoff_step=25)  # covers the bump
    count = 0
    while tm.get(0) is not None:
        count += 1
    assert count == 2  # only epoch 2


def test_non_dict_journal_falls_back(tmp_path):
    shards = create_shards_from_ranges([("f", 0, 128)], 64)
    path = tmp_path / "task_state.json"
    path.write_text("[1, 2, 3]")  # valid JSON, wrong shape
    tm = TaskManager(training_shards=shards, num_epochs=1,
                     persist_path=str(path))
    count = 0
    while tm.get(0) is not None:
        count += 1
    assert count == 2  # fresh epoch, no crash


def test_master_cutoff_is_the_newest_committed_step(tmp_path):
    """The Master's cutoff is the newest step whose state.pt is in
    place, passes its manifest check and loads, the step a restore
    takes; a torn step directory and a step that fails its check do not
    count."""
    import torch

    ckpt = tmp_path / "ckpt"
    for step, committed in ((8, True), (16, True), (20, True), (24, False)):
        (ckpt / str(step)).mkdir(parents=True)
        if committed:
            torch.save({"step": step, "model": {}, "optimizer": {}},
                       str(ckpt / str(step) / "state.pt"))
    (ckpt / ".manifests").mkdir()
    (ckpt / ".manifests" / "20.json").write_text(json.dumps(
        {"files": {"state.pt": {"size": 0, "sha256": "0" * 64}}}))
    assert port_main.latest_model_checkpoint_step(str(ckpt)) == 16
    assert port_main.latest_model_checkpoint_step(
        str(tmp_path / "none")) is None


# ---- cross-package ---------------------------------------------------------


SOURCES = [("a.tfrecord", 0, 300), ("b.tfrecord", 0, 170)]
PER_TASK = 32


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def seeded_id_base(monkeypatch):
    """Both packages draw a journaled generation's id base from
    `random.Random()`; seed that draw the same in both."""
    shim = types.SimpleNamespace(
        Random=lambda *a: random.Random(a[0] if a and a[0] is not None
                                        else 20241017))
    monkeypatch.setattr(port_tm_mod, "random", shim)
    monkeypatch.setattr(jax_tm_mod, "random", shim)


def _managers(path, cutoff=None, epochs=2, clock=None):
    clock = clock or FakeClock()
    port = port_tm_mod.TaskManager(
        training_shards=port_tm_mod.create_shards_from_ranges(
            SOURCES, PER_TASK),
        num_epochs=epochs, shuffle_shards=True, shuffle_seed=0,
        persist_path=str(path / "port.json"), restore_cutoff_step=cutoff,
        clock=clock)
    ref = jax_tm_mod.TaskManager(
        training_shards=jax_tm_mod.create_shards_from_ranges(
            SOURCES, PER_TASK),
        num_epochs=epochs, shuffle_shards=True, shuffle_seed=0,
        persist_path=str(path / "jax.json"), restore_cutoff_step=cutoff,
        clock=clock)
    return port, ref


def _script(port, ref, clock, rng, n):
    """n leases through both managers: each task reported done (at a
    version that grows with the step), failed, or left in flight."""
    seen = []
    version = 0
    for _ in range(n):
        clock.t += float(rng.integers(1, 5))
        pt, jt = port.get(0), ref.get(0)
        if pt is None or jt is None:
            assert pt is None and jt is None
            break
        seen.append(((pt.task_id, int(pt.type), pt.shard.name,
                      pt.shard.start, pt.shard.end),
                     (jt.task_id, int(jt.type), jt.shard.name,
                      jt.shard.start, jt.shard.end)))
        fate = rng.random()
        if fate < 0.75:
            version += 4
            for tm, task in ((port, pt), (ref, jt)):
                tm.report(task.task_id, success=True, worker_id=0,
                          records=task.shard.end - task.shard.start,
                          model_version=version)
        elif fate < 0.9:
            for tm, task in ((port, pt), (ref, jt)):
                tm.report(task.task_id, success=False, worker_id=0)
    return seen


def _sequence(tm, typed=True):
    out = []
    while True:
        task = tm.get(0)
        if task is None:
            return out
        out.append((task.task_id, int(task.type), task.shard.name,
                    task.shard.start, task.shard.end))
        tm.report(task.task_id, success=True,
                  records=task.shard.end - task.shard.start,
                  model_version=10 ** 6)


@pytest.mark.parametrize("seed,steps,cutoff", [
    (0, 12, None), (1, 20, 40), (2, 30, 24), (3, 8, 0)])
def test_journals_and_restores_match_the_jax_package(
        tmp_path, seeded_id_base, seed, steps, cutoff):
    import numpy as np

    rng = np.random.default_rng(seed)
    clock = FakeClock()
    port, ref = _managers(tmp_path, clock=clock)
    seen = _script(port, ref, clock, rng, steps)
    assert [p for p, _ in seen] == [j for _, j in seen]
    with open(tmp_path / "port.json") as f:
        port_journal = json.load(f)
    with open(tmp_path / "jax.json") as f:
        jax_journal = json.load(f)
    assert port_journal == jax_journal
    # relaunch both from their journals (same id base again)
    port2, ref2 = _managers(tmp_path, cutoff=cutoff, clock=clock)
    assert port2.counters.records_done == ref2.counters.records_done
    assert _sequence(port2) == _sequence(ref2)


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_package_restores_the_others_journal(tmp_path, reader):
    """A journal written by one package, read by the other: the same
    remaining shards and records."""
    import numpy as np

    clock = FakeClock()
    port, ref = _managers(tmp_path, clock=clock)
    _script(port, ref, clock, np.random.default_rng(5), 14)
    # swap the journals: each package reads the other's file
    os.replace(tmp_path / "port.json", tmp_path / "swap.json")
    os.replace(tmp_path / "jax.json", tmp_path / "port.json")
    os.replace(tmp_path / "swap.json", tmp_path / "jax.json")
    port2, ref2 = _managers(tmp_path, cutoff=30, clock=clock)
    tm = port2 if reader == "port" else ref2
    other = ref2 if reader == "port" else port2
    assert tm.counters.records_done == other.counters.records_done
    shards = [s[2:] for s in _sequence(tm)]
    assert shards == [s[2:] for s in _sequence(other)]
    assert tm.finished


def test_journal_layout_keys_are_the_jax_packages(tmp_path):
    port = _tm(tmp_path)
    ref = jax_tm_mod.TaskManager(
        training_shards=jax_tm_mod.create_shards_from_ranges(
            [("f", 0, 320)], 64),
        num_epochs=2, shuffle_shards=True, shuffle_seed=0,
        persist_path=str(tmp_path / "jax.json"))
    for tm, training in ((port, pb.TRAINING), (ref, jpb.TRAINING)):
        task = tm.get(0)
        assert task.type == training
        tm.report(task.task_id, success=True, records=64, model_version=3)
    with open(tmp_path / "task_state.json") as f:
        got = json.load(f)
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    assert sorted(got) == sorted(want) == [
        "done_training_shards", "epoch", "epoch_history", "records_done"]
    assert got == want
