"""The port's control plane (elasticdl_tpu_torch/master: task manager,
evaluation service, servicer) against the JAX package's, on the same
shards, seed, clock and script: the (task_id, type, shard) sequence and
the counters match exactly (an integer path), the merged eval metrics
within 1e-6 (the same float64 rank sums over the same float32 samples;
the bound only absorbs summation order)."""

import json

import numpy as np
import pytest
import torch

from elasticdl_tpu.master.evaluation_service import (
    EvaluationService as JaxEval,
)
from elasticdl_tpu.master.servicer import MasterServicer as JaxServicer
from elasticdl_tpu.master.task_manager import TaskManager as JaxTM
from elasticdl_tpu.master.task_manager import (
    create_shards_from_ranges as jax_shards,
)
from elasticdl_tpu.proto import elasticdl_pb2 as jpb
from elasticdl_tpu_torch.master import task_manager as port_tm
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.model_zoo.common.metrics import (
    auc,
    binary_accuracy,
)
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto.service import InProcessMasterClient

torch.set_num_threads(2)

EVAL_TOL = 1e-6
SOURCES = [("a.tfrecord", 0, 100), ("b.tfrecord", 0, 70),
           ("c.tfrecord", 10, 50)]
VAL_SOURCES = [("v.tfrecord", 0, 45)]


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _task(task):
    if task is None:
        return None
    return (task.task_id, int(task.type), task.shard.name,
            task.shard.start, task.shard.end, task.model_version)


def _managers(clock, **kwargs):
    common = dict(num_epochs=2, lease_timeout_s=10.0, max_task_retries=1,
                  shuffle_shards=True, shuffle_seed=0, clock=clock,
                  **kwargs)
    jtm = JaxTM(training_shards=jax_shards(SOURCES, 16),
                evaluation_shards=jax_shards(VAL_SOURCES, 16), **common)
    ptm = port_tm.TaskManager(
        training_shards=port_tm.create_shards_from_ranges(SOURCES, 16),
        evaluation_shards=port_tm.create_shards_from_ranges(
            VAL_SOURCES, 16),
        **common)
    return jtm, ptm


def _script(tm, clock):
    """One fixed sequence of queue operations; returns everything it
    observed."""
    out = []
    done_calls = []
    tm.add_all_done_callback(lambda: done_calls.append(clock()))
    completions = []
    tm.add_completion_callback(
        lambda task, ok: completions.append((task.task_id, bool(ok))))
    final = []

    def final_eval():
        if final:
            return []
        final.append(1)
        return [(s, 1, 99) for s in tm._evaluation_shards]

    tm.add_pre_finish_provider(final_eval)

    def get(wid, task_type=None):
        task = tm.get(wid, task_type=task_type)
        out.append(("get", wid, _task(task)))
        return task

    def report(task, **kwargs):
        out.append(("report", task.task_id, kwargs,
                    tm.report(task.task_id, worker_id=kwargs.pop(
                        "worker_id", 0), **kwargs)))

    # get and report
    t0, t1, t2 = get(0), get(1), get(2)
    report(t0, success=True, records=16)
    report(t0, success=True, records=16)      # stale: already reported
    # a transient re-queue under the fake clock: held for 1 s
    report(t2, success=False, transient=True)
    held = get(2)
    out.append(("held_back", held.task_id != t2.task_id))
    report(held, success=True, records=16)
    clock.t += 1.5
    # a failure: re-queued at the back once (max_task_retries=1); its
    # second failure, in the drain below, drops it
    report(t1, success=False)
    # recover_tasks for a dead worker: its leases go to the front
    a, b = get(3), get(3)
    out.append(("recovered", tm.recover_tasks(3)))
    out.append(("dead_gets_nothing", tm.get(3) is None))
    # a lease expiry
    c = get(4)
    clock.t += 5
    out.append(("reaped_early", tm.reap_expired_tasks()))
    clock.t += 6
    out.append(("reaped", tm.reap_expired_tasks()))
    # an eval injection goes to the front
    out.append(("evals", tm.create_evaluation_tasks(7)))
    report(get(5, task_type=1), success=True, records=16, worker_id=5)
    # drain everything: epoch rollover, then the pre-finish final eval
    wid = 0
    for _ in range(500):
        task = get(wid % 3)
        if task is None:
            out.append(("none", tm.finished))
            if tm.finished:
                break
            continue
        if task.task_id == t1.task_id:
            report(task, success=False, worker_id=wid % 3)
        else:
            report(task, success=True,
                   records=task.shard.end - task.shard.start,
                   worker_id=wid % 3)
        wid += 1
    out.append(("counters", tm.counters.as_dict()))
    out.append(("done_calls", done_calls, "completions", completions))
    del a, b, c
    return out


def test_task_sequence_matches_the_jax_task_manager():
    jclock, pclock = FakeClock(), FakeClock()
    jtm, ptm = _managers(jclock), _managers(pclock)
    jtm, ptm = jtm[0], ptm[1]
    want = _script(jtm, jclock)
    got = _script(ptm, pclock)
    assert got == want
    gets = [e for e in got if e[0] == "get" and e[2] is not None]
    types = {e[2][1] for e in gets}
    assert types == {0, 1}
    # both epochs ran, the final eval came at version 99, and the
    # counters saw the failure, the recovery and the expiry
    assert ptm.finished and ptm.snapshot()["epoch"] == 2
    assert any(e[2][5] == 99 for e in gets)
    counters = ptm.counters.as_dict()
    assert counters["failed"] == 2 and counters["recovered"] == 2
    assert counters["expired"] == 1
    assert ptm.snapshot()["transient_requeues"] == 1


@pytest.mark.parametrize("seed", [0, 3, None])
def test_epoch_shuffles_and_ids_match(seed):
    jtm = JaxTM(training_shards=jax_shards(SOURCES, 7), num_epochs=3,
                shuffle_shards=seed is not None, shuffle_seed=seed)
    ptm = port_tm.TaskManager(
        training_shards=port_tm.create_shards_from_ranges(SOURCES, 7),
        num_epochs=3, shuffle_shards=seed is not None, shuffle_seed=seed)
    seqs = []
    for tm in (jtm, ptm):
        seq = []
        while True:
            task = tm.get(0)
            if task is None:
                break
            seq.append(_task(task))
            tm.report(task.task_id, success=True)
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert len(seqs[1]) == 3 * len(jax_shards(SOURCES, 7))
    assert [t[0] for t in seqs[1]] == list(range(len(seqs[1])))


def test_create_shards_from_ranges_matches():
    for shuffle, seed in ((False, None), (True, 5)):
        want = [(s.name, s.start, s.end)
                for s in jax_shards(SOURCES, 9, shuffle, seed)]
        got = [(s.name, s.start, s.end)
               for s in port_tm.create_shards_from_ranges(SOURCES, 9,
                                                          shuffle, seed)]
        assert got == want


def test_waiting_parts_raise(tmp_path):
    """The journal runs now (persist_path writes task_state.json from
    construction on); perpetual windows still wait for the online
    loop."""
    path = tmp_path / "task_state.json"
    tm = port_tm.TaskManager(
        training_shards=port_tm.create_shards_from_ranges(SOURCES, 9),
        persist_path=str(path))
    assert json.loads(path.read_text())["epoch"] == 1
    task = tm.get(0)
    tm.report(task.task_id, success=True, records=9, model_version=3)
    assert json.loads(path.read_text())["done_training_shards"] == [
        [task.shard.name, task.shard.start, task.shard.end, 3]]
    with pytest.raises(NotImplementedError, match="perpetual"):
        port_tm.TaskManager(perpetual=True)


def _eval_reports(rng):
    """(version, worker, key, samples_only, final, labels, preds, metrics,
    n) tuples: keyed and unkeyed deliveries, continuation chunks, a
    re-delivery that replaces its first try, two versions."""
    out = []
    for version in (4, 8):
        for key in (1, 2, 3):
            labels = (rng.rand(50) < 0.4).astype(np.float32)
            preds = (rng.randn(50) + labels).astype(np.float32)
            out.append((version, key % 2, key, False, False, labels[:30],
                        preds[:30], {"auc": 0.5}, 50))
            out.append((version, key % 2, key, True, True, labels[30:],
                        preds[30:], {}, 0))
        # task 2 re-delivered: replaces its earlier contribution
        labels = (rng.rand(40) < 0.5).astype(np.float32)
        preds = rng.randn(40).astype(np.float32)
        out.append((version, 1, 2, False, True, labels, preds,
                    {"auc": 0.6}, 40))
        # unkeyed deliveries accumulate
        for _ in range(2):
            labels = (rng.rand(20) < 0.5).astype(np.float32)
            preds = rng.randn(20).astype(np.float32)
            out.append((version, 0, 0, False, True, labels, preds,
                        {"auc": 0.7}, 20))
    return out


def test_evaluation_service_metrics_match_the_jax_service():
    from model_zoo.common import metrics as jax_metrics

    class Queue:
        def __init__(self):
            self.versions = []

        def create_evaluation_tasks(self, version):
            self.versions.append(version)
            return 1

    jq, pq = Queue(), Queue()
    jsvc = JaxEval(jq, evaluation_steps=4, eval_metrics={
        "auc": jax_metrics.auc, "accuracy": jax_metrics.binary_accuracy})
    psvc = EvaluationService(pq, evaluation_steps=4, eval_metrics={
        "auc": auc, "accuracy": binary_accuracy})
    for version in (1, 3, 4, 6, 8, 9, 13, 16):
        jsvc.on_version_report(version)
        psvc.on_version_report(version)
    assert pq.versions == jq.versions == [4, 8, 13]
    for (version, wid, key, samples_only, final, labels, preds, metrics,
         n) in _eval_reports(np.random.RandomState(0)):
        jreq = jpb.ReportEvaluationMetricsRequest(
            worker_id=wid, model_version=version, pred_width=1,
            samples_only=samples_only, eval_task_key=key, final_chunk=final,
            num_examples=n)
        for name, value in metrics.items():
            jreq.metrics[name] = value
        jreq.eval_labels.extend(labels.tolist())
        jreq.eval_preds.extend(preds.tolist())
        jsvc.report_metrics(jreq)
        psvc.report_metrics(pb.ReportEvaluationMetricsRequest(
            worker_id=wid, model_version=version, pred_width=1,
            samples_only=samples_only, eval_task_key=key,
            final_chunk=final, num_examples=n, metrics=dict(metrics),
            eval_labels=labels, eval_preds=preds))
        want, got = jsvc.history[version], psvc.history[version]
        assert set(got) == set(want)
        for name in want:
            assert abs(got[name] - want[name]) <= EVAL_TOL, name
    want, got = jsvc.latest_metrics(), psvc.latest_metrics()
    assert set(got) == {"auc", "accuracy"}
    for name in want:
        assert abs(got[name] - want[name]) <= EVAL_TOL, name
    # the exact AUC is not the weighted mean of the reported scalars
    assert abs(got["auc"] - 0.6) > 1e-3


def test_servicer_wait_sentinel_and_job_finished_match():
    jtm = JaxTM(training_shards=jax_shards([("a", 0, 10)], 10))
    ptm = port_tm.TaskManager(
        training_shards=port_tm.create_shards_from_ranges([("a", 0, 10)],
                                                          10))
    jsvc, psvc = JaxServicer(jtm), MasterServicer(ptm)
    client = InProcessMasterClient(psvc)
    seen = []
    for svc, mod, call in ((jsvc, jpb, lambda m, r: getattr(jsvc, m)(r,
                                                                     None)),
                           (psvc, pb, lambda m, r: getattr(client, m)(r))):
        steps = []
        first = call("get_task", mod.GetTaskRequest(worker_id=0))
        wait = call("get_task", mod.GetTaskRequest(worker_id=1))
        steps.append((first.task.task_id, first.job_finished,
                      wait.task.task_id, int(wait.task.type),
                      wait.job_finished))
        req = mod.ReportTaskResultRequest(task_id=first.task.task_id,
                                          worker_id=0)
        req.exec_counters["records"] = 10
        call("report_task_result", req)
        call("report_version",
             mod.ReportVersionRequest(worker_id=0, model_version=3))
        done = call("get_task", mod.GetTaskRequest(worker_id=1))
        steps.append((done.task.task_id, int(done.task.type),
                      done.job_finished, svc.max_model_version))
        seen.append(steps)
    assert seen[0] == seen[1]
    assert seen[1] == [(0, False, -1, int(pb.WAIT), False),
                       (-1, int(pb.WAIT), True, 3)]
    assert ptm.counters.records_done == 10
