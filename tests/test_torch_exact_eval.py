"""The port's evaluation service (master/evaluation_service.py) against
the JAX package's, on the cases of tests/test_exact_eval.py.

Each case feeds the same seeded reports, through each package's own
`report_evaluation_with_samples`, to both services and holds them equal
after every delivery: per version the same history (within EVAL_TOL),
the same set of versions marked exact, and the same sample rows kept
after pruning.  Then the case's own checks, as the JAX test makes them.

One more twin holds a metric fn that raises to its weighted mean.  Two
cases of the port's own hold the off-lock exact pass: an ingest that
races it never publishes a stale value (its retry publishes the exact
one), and a report of another version completes while a pass is held.
Every case runs under a time limit of its own.
"""

import threading

import numpy as np
import pytest

from _torch_limits import within
from elasticdl_tpu.master.evaluation_service import (
    EvaluationService as JaxService,
)
from elasticdl_tpu.proto import elasticdl_pb2 as jpb
from elasticdl_tpu.worker.worker import (
    report_evaluation_with_samples as jax_report,
)
from elasticdl_tpu_torch.master import evaluation_service as es
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.model_zoo.common.metrics import auc
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.worker.worker import report_evaluation_with_samples
from model_zoo.common.metrics import auc as jax_auc

# both packages score one float32 sample set with the same numpy AUC;
# the acceptance pin of tests/test_exact_eval.py is 1e-6
EVAL_TOL = 1e-6
# seconds each case may take (each runs in well under one here)
CASE_LIMIT_S = 60


class _DirectClient:
    """Routes worker reports straight into an evaluation service (the
    servicers of both packages pass them through)."""

    def __init__(self, service):
        self._service = service
        self.requests = []

    def report_evaluation_metrics(self, req):
        self.requests.append(req)
        self._service.report_metrics(req)


class _NoTasks:
    def add_all_done_callback(self, cb):
        pass


def _merged(agg):
    _, labels, preds, width = agg.sample_snapshot()
    if not labels:
        return width, np.zeros(0, np.float32), np.zeros(0, np.float32)
    return width, np.concatenate(labels), np.concatenate(preds)


class _Twin:
    """One JAX and one port service, given the same reports.
    `metric(auc_fn)` builds a metric fn over either package's AUC."""

    def __init__(self, metric=lambda fn: fn):
        self.jax = JaxService(_NoTasks(),
                              eval_metrics={"auc": metric(jax_auc)})
        self.port = EvaluationService(_NoTasks(),
                                      eval_metrics={"auc": metric(auc)})
        self.jax_client = _DirectClient(self.jax)
        self.port_client = _DirectClient(self.port)

    def report(self, *args, **kwargs):
        jax_report(self.jax_client, *args, **kwargs)
        report_evaluation_with_samples(self.port_client, *args, **kwargs)
        self.check()

    def raw(self, labels, preds, metrics=None, **fields):
        """One hand-built request to each service."""
        jreq = jpb.ReportEvaluationMetricsRequest(**fields)
        for name, value in (metrics or {}).items():
            jreq.metrics[name] = value
        jreq.eval_labels.extend(np.asarray(labels).tolist())
        jreq.eval_preds.extend(np.asarray(preds).ravel().tolist())
        self.jax.report_metrics(jreq)
        self.port.report_metrics(pb.ReportEvaluationMetricsRequest(
            metrics=dict(metrics or {}),
            eval_labels=np.asarray(labels, np.float32),
            eval_preds=np.asarray(preds, np.float32).ravel(), **fields))
        self.check()

    def latest(self):
        want, got = self.jax.latest_metrics(), self.port.latest_metrics()
        _close(got, want)
        self.check()
        return got

    def check(self):
        assert set(self.port.history) == set(self.jax.history)
        for version, want in self.jax.history.items():
            _close(self.port.history[version], want)
        assert self.port._history_exact == self.jax._history_exact
        assert set(self.port._aggs) == set(self.jax._aggs)
        for version, jagg in self.jax._aggs.items():
            pagg = self.port._aggs[version]
            assert pagg.samples_dropped == jagg.samples_dropped
            assert pagg.num_examples == jagg.num_examples
            assert pagg.sample_rows == jagg.sample_rows
            (pw, pl, pp), (jw, jl, jp) = _merged(pagg), _merged(jagg)
            assert pw == jw
            np.testing.assert_array_equal(pl, jl)
            np.testing.assert_array_equal(pp, jp)


def _close(got, want):
    assert set(got) == set(want)
    for name in want:
        assert abs(got[name] - want[name]) <= EVAL_TOL, (name, got, want)


def _skewed_shards(seed=0):
    """Three shards with very different base rates and score scales, so
    the weighted AUC mean is visibly biased (tests/test_exact_eval.py)."""
    rng = np.random.RandomState(seed)
    shards = []
    for frac_pos, scale, n in [(0.9, 1.0, 300), (0.1, 0.2, 500),
                               (0.5, 3.0, 221)]:
        labels = (rng.rand(n) < frac_pos).astype(np.int32)
        preds = (labels * 0.8 + rng.randn(n)) * scale
        shards.append((labels, preds.astype(np.float32)))
    return shards


# ---- the twins of tests/test_exact_eval.py ---------------------------


@within(CASE_LIMIT_S)
def test_sharded_auc_equals_single_pass():
    shards = _skewed_shards()
    twin = _Twin()
    for wid, (labels, preds) in enumerate(shards):
        twin.report(wid, model_version=7,
                    metrics={"auc": float(auc(labels, preds))},
                    num_examples=len(labels), labels=labels, preds=preds)
    exact = float(auc(np.concatenate([s[0] for s in shards]),
                      np.concatenate([s[1] for s in shards])))
    assert twin.latest()["auc"] == pytest.approx(exact, abs=EVAL_TOL)
    ns = [len(s[0]) for s in shards]
    weighted = sum(float(auc(lbl, prd)) * n
                   for (lbl, prd), n in zip(shards, ns)) / sum(ns)
    assert abs(weighted - exact) > 1e-3


@within(CASE_LIMIT_S)
def test_chunked_samples_counted_once():
    rng = np.random.RandomState(1)
    n = 100_000  # more than one chunk of (1 + 2)-wide rows
    labels = rng.randint(0, 2, n)
    preds = rng.randn(n, 2).astype(np.float32)

    def two_col(auc_fn):
        return lambda lbl, prd: auc_fn(lbl, prd[:, 1] - prd[:, 0])

    twin = _Twin(two_col)
    score = two_col(auc)
    twin.report(0, model_version=1,
                metrics={"auc": float(score(labels, preds))},
                num_examples=n, labels=labels, preds=preds)
    requests = twin.port_client.requests
    assert len(requests) == len(twin.jax_client.requests) > 1
    assert sum(not r.samples_only for r in requests) == 1
    assert [r.final_chunk for r in requests] == \
        [r.final_chunk for r in twin.jax_client.requests]
    agg = twin.port._aggs[1]
    assert agg.num_examples == agg.sample_rows == n
    assert twin.latest()["auc"] == pytest.approx(
        float(score(labels, preds)), abs=EVAL_TOL)


@within(CASE_LIMIT_S)
def test_sample_cap_falls_back_to_weighted_mean():
    twin = _Twin()
    labels = np.array([0, 1] * 200)
    preds = np.linspace(-1, 1, 400).astype(np.float32)
    twin.report(0, 3, {"auc": 0.5}, 400, labels, preds, task_id=11)
    for service in (twin.jax, twin.port):
        service._aggs[3]._max_sample_rows = 100
    twin.report(1, 3, {"auc": 0.5}, 400, labels, preds, task_id=12)
    assert twin.port._aggs[3].samples_dropped
    assert twin.latest()["auc"] == pytest.approx(0.5)


@within(CASE_LIMIT_S)
def test_redelivered_task_replaces_not_duplicates():
    shards = _skewed_shards()
    twin = _Twin()
    labels0, preds0 = shards[0]
    twin.report(0, 7, {"auc": 0.4}, 100, labels0[:100], preds0[:100],
                task_id=5)
    twin.report(1, 7, {"auc": float(auc(labels0, preds0))},
                len(labels0), labels0, preds0, task_id=5)
    twin.report(2, 7, {"auc": float(auc(*shards[1]))},
                len(shards[1][0]), shards[1][0], shards[1][1], task_id=6)
    agg = twin.port._aggs[7]
    assert agg.num_examples == agg.sample_rows == \
        len(labels0) + len(shards[1][0])
    assert twin.latest()["auc"] == pytest.approx(
        float(auc(np.concatenate([labels0, shards[1][0]]),
                  np.concatenate([preds0, shards[1][1]]))), abs=EVAL_TOL)


@within(CASE_LIMIT_S)
def test_mixed_pred_widths_segregated():
    rng = np.random.RandomState(3)
    n1, n2 = 600, 100
    labels1 = rng.randint(0, 2, n1)
    preds1 = rng.randn(n1).astype(np.float32)
    labels2 = rng.randint(0, 2, n2)
    preds2 = rng.randn(n2, 3).astype(np.float32)

    def width_tolerant(auc_fn):
        def score(lbl, prd):
            prd = np.asarray(prd)
            return auc_fn(lbl, prd if prd.ndim == 1 else prd[:, -1])
        return score

    twin = _Twin(width_tolerant)
    twin.report(0, 9, {"auc": float(auc(labels1, preds1))}, n1, labels1,
                preds1, task_id=1)
    twin.report(1, 9, {"auc": 0.5}, n2, labels2, preds2, task_id=2)
    agg = twin.port._aggs[9]
    assert sorted(r.pred_width for r in agg.reports.values()
                  if r.label_chunks) == [1, 3]
    assert twin.latest()["auc"] == pytest.approx(
        float(auc(labels1, preds1)), abs=EVAL_TOL)


@within(CASE_LIMIT_S)
def test_mismatched_continuation_chunk_rejected():
    twin = _Twin()
    labels = np.array([0, 1, 0, 1], np.float32)
    preds = np.array([0.1, 0.9, 0.2, 0.8], np.float32)
    twin.raw(labels, preds, {"auc": 1.0}, worker_id=0, model_version=1,
             num_examples=4, pred_width=1, eval_task_key=1,
             final_chunk=False)
    twin.raw([0.0, 1.0], [0.1, 0.2, 0.3, 0.4], worker_id=0,
             model_version=1, pred_width=2, samples_only=True,
             eval_task_key=1, final_chunk=True)
    assert twin.port._aggs[1].sample_rows == 4
    assert twin.latest()["auc"] == pytest.approx(
        float(auc(labels, preds)), abs=EVAL_TOL)


@within(CASE_LIMIT_S)
def test_large_set_exact_computed_off_lock():
    rng = np.random.RandomState(5)
    n = es.INLINE_EXACT_ROWS + 1000
    labels = rng.randint(0, 2, n)
    preds = rng.randn(n).astype(np.float32)
    lock_free = []

    def noting(auc_fn):
        def score(lbl, prd):
            if auc_fn is auc:
                lock_free.append(not twin.port._lock.locked())
            return auc_fn(lbl, prd)
        return score

    twin = _Twin(noting)
    twin.report(0, 2, {"auc": 0.0}, n, labels, preds, task_id=1)
    assert 2 in twin.port._history_exact
    assert twin.port.history[2]["auc"] == pytest.approx(
        float(auc(labels, preds)), abs=EVAL_TOL)
    # the first chunk (at most INLINE_EXACT_ROWS) is scored under the
    # lock, the whole delivery off it
    assert lock_free == [False, True]


@within(CASE_LIMIT_S)
def test_old_version_samples_pruned():
    twin = _Twin()
    rng = np.random.RandomState(0)
    for version in range(5):
        labels = rng.randint(0, 2, 50)
        preds = rng.randn(50).astype(np.float32)
        twin.report(0, version, {"auc": float(auc(labels, preds))}, 50,
                    labels, preds, task_id=version)
    kept = sorted(twin.port._aggs)[-EvaluationService.SAMPLE_VERSIONS_KEPT:]
    for version, agg in twin.port._aggs.items():
        if version in kept:
            assert agg.sample_rows == 50
        else:
            assert agg.samples_dropped and agg.sample_rows == 0
        assert "auc" in twin.port.history[version]
    # with no aggregates left, both fall back to the newest history entry
    for service in (twin.jax, twin.port):
        service._aggs.clear()
    assert twin.latest() == twin.port.history[4]


@within(CASE_LIMIT_S)
def test_a_metric_that_raises_keeps_its_weighted_mean():
    """A metric fn that fails on the merged set leaves that metric at
    the weighted mean of the reported scalars; the others stay exact
    (both packages log the failure and go on)."""
    def failing(auc_fn):
        def score(lbl, prd):
            raise ValueError("no score")
        return score

    twin = _Twin(failing)
    for service in (twin.jax, twin.port):
        service._eval_metrics["exact_auc"] = \
            jax_auc if service is twin.jax else auc
    shards = _skewed_shards(seed=4)
    for wid, (labels, preds) in enumerate(shards):
        twin.report(wid, 3, {"auc": 0.25 * (wid + 1)}, len(labels),
                    labels, preds, task_id=wid)
    ns = [len(s[0]) for s in shards]
    got = twin.latest()
    assert got["auc"] == pytest.approx(
        sum(0.25 * (i + 1) * n for i, n in enumerate(ns)) / sum(ns))
    assert got["exact_auc"] == pytest.approx(float(auc(
        np.concatenate([s[0] for s in shards]),
        np.concatenate([s[1] for s in shards]))), abs=EVAL_TOL)


# ---- the off-lock pass under concurrent reports ----------------------


class _Publishes(dict):
    """A history dict that keeps every value written to it."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __setitem__(self, version, value):
        self.log.append((version, dict(value)))
        super().__setitem__(version, value)


class _HeldPass:
    """A metric fn whose first call made with the service lock free (the
    off-lock pass) waits until the test releases it."""

    def __init__(self, service_of):
        self._service_of = service_of
        self.scoring = threading.Event()
        self.release = threading.Event()
        self.off_lock_calls = []

    def __call__(self, labels, preds):
        if not self._service_of()._lock.locked():
            self.off_lock_calls.append(threading.current_thread().name)
            if len(self.off_lock_calls) == 1:
                self.scoring.set()
                assert self.release.wait(CASE_LIMIT_S)
        return auc(labels, preds)


def _large_delivery(seed, n):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, n)
    preds = (labels * 0.5 + rng.randn(n)).astype(np.float32)
    return labels, preds


@within(CASE_LIMIT_S)
def test_a_racing_ingest_never_publishes_a_stale_value():
    held = _HeldPass(lambda: service)
    service = EvaluationService(_NoTasks(), eval_metrics={"auc": held})
    service.history = _Publishes()
    client = _DirectClient(service)
    labels1, preds1 = _large_delivery(11, es.INLINE_EXACT_ROWS + 1000)
    # positives scored below every other row: the merged AUC moves away
    # from the first delivery's
    labels2 = np.ones(2000, np.int64)
    preds2 = (np.random.RandomState(12).randn(2000) - 10).astype(np.float32)

    first = threading.Thread(
        name="first", target=report_evaluation_with_samples,
        args=(client, 0, 4, {"auc": 0.0}, len(labels1), labels1, preds1),
        kwargs={"task_id": 1})
    first.start()
    assert held.scoring.wait(CASE_LIMIT_S)
    # the pass over the first delivery is held; a second delivery of the
    # same version lands (and, as a completed delivery, scores the new
    # merged set off the lock itself)
    report_evaluation_with_samples(client, 1, 4, {"auc": 0.0},
                                   len(labels2), labels2, preds2, task_id=2)
    held.release.set()
    first.join(CASE_LIMIT_S)
    assert not first.is_alive()

    stale = auc(labels1, preds1)
    exact = auc(np.concatenate([labels1, labels2]),
                np.concatenate([preds1, preds2]))
    assert abs(stale - exact) > 1e-2
    published = [value["auc"] for version, value in service.history.log
                 if version == 4]
    assert all(abs(v - stale) > 1e-9 for v in published), published
    # the first publish was the first chunk's exact value, and no weighted
    # mean of the reported scalars (0.0) replaced an exact one after it
    assert min(published) > 0.5, published
    assert service.history[4]["auc"] == pytest.approx(exact, abs=EVAL_TOL)
    assert 4 in service._history_exact
    # the held pass found its generation stale and scored a new snapshot
    assert held.off_lock_calls == [
        "first", threading.current_thread().name, "first"]


@within(CASE_LIMIT_S)
def test_the_lock_is_free_while_a_pass_scores():
    held = _HeldPass(lambda: service)
    service = EvaluationService(_NoTasks(), eval_metrics={"auc": held})
    client = _DirectClient(service)
    labels1, preds1 = _large_delivery(21, es.INLINE_EXACT_ROWS + 1000)
    labels2, preds2 = _large_delivery(22, 300)

    big = threading.Thread(
        target=report_evaluation_with_samples,
        args=(client, 0, 1, {"auc": 0.0}, len(labels1), labels1, preds1),
        kwargs={"task_id": 1})
    big.start()
    assert held.scoring.wait(CASE_LIMIT_S)
    other = threading.Thread(
        target=report_evaluation_with_samples,
        args=(client, 1, 2, {"auc": 0.0}, len(labels2), labels2, preds2),
        kwargs={"task_id": 2})
    other.start()
    other.join(CASE_LIMIT_S / 2)
    done_while_held = not other.is_alive() and not held.release.is_set()
    held.release.set()
    big.join(CASE_LIMIT_S)
    assert done_while_held
    assert not big.is_alive()
    assert service.history[2]["auc"] == pytest.approx(
        auc(labels2, preds2), abs=EVAL_TOL)
    assert service.history[1]["auc"] == pytest.approx(
        auc(labels1, preds1), abs=EVAL_TOL)
    assert service._history_exact == {1, 2}
