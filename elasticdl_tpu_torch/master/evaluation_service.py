"""Evaluation service: schedules eval tasks and aggregates worker metrics
(the port's copy of the JAX package's master/evaluation_service.py).

Eval tasks ride the training queue; workers run forward-only over a
shard and report per-shard metrics plus the raw (label, prediction)
samples, keyed by task, so job-level rank metrics (AUC) are recomputed
exactly over the merged validation set: a weighted mean of per-shard
AUCs is biased whenever shards differ.  A large merged set is scored
outside the service's lock, so concurrent reports do not wait behind
its sort, and a weighted mean never replaces a published exact value.
With a `summary_writer`
(common/summary.py) each version's job-level metrics are written as
`eval/<name>` scalars at that version, again as shards accumulate.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger(__name__)

# Exact recomputation is O(merged rows); at or below this count it runs
# on every report, above it once per completed delivery (final_chunk)
# and on reads (latest_metrics).
EAGER_EXACT_ROWS = 1 << 20

# Above this count an eager exact pass runs off the service lock, on a
# chunk snapshot, and publishes only if no ingest raced it: a sort of a
# million rows takes tens to hundreds of ms, and under the lock every
# concurrent worker report would wait behind it.
INLINE_EXACT_ROWS = 1 << 17

# Snapshots an off-lock pass scores before it gives up on ingests that
# keep racing it (the next completed delivery schedules a new pass).
OFF_LOCK_ATTEMPTS = 4


def _exact_metrics(label_chunks, pred_chunks, width, eval_metrics
                   ) -> Dict[str, float]:
    """Merge sample chunks and score every metric fn over the merged
    set.  O(rows), and safe outside the service lock on a
    `sample_snapshot()`: chunk arrays are never changed in place, a
    re-delivery replaces its chunk list whole.  A metric fn that raises
    leaves that metric at its weighted shard mean."""
    out: Dict[str, float] = {}
    if not label_chunks:
        return out
    labels = np.concatenate(label_chunks)
    preds = np.concatenate(pred_chunks).reshape(len(labels), width)
    if width == 1:
        preds = preds[:, 0]
    for name, fn in eval_metrics.items():
        try:
            out[name] = float(fn(labels, preds))
        except Exception:
            logger.exception("exact recomputation of metric %r failed; "
                             "keeping the weighted shard mean", name)
    return out


class _TaskReport:
    """One eval task's contribution: scalar metrics and sample chunks.
    Keyed storage makes re-delivery idempotent: a re-queued task
    replaces its earlier contribution instead of double-counting it."""

    __slots__ = ("metrics", "num_examples", "label_chunks", "pred_chunks",
                 "pred_width")

    def __init__(self):
        self.metrics: Dict[str, float] = {}
        self.num_examples = 0
        self.label_chunks = []
        self.pred_chunks = []
        # the width of this delivery's prediction rows, fixed by its
        # first sample chunk
        self.pred_width: Optional[int] = None


class _VersionAgg:
    def __init__(self, max_sample_rows: int = 1 << 24):
        self.reports: Dict[object, _TaskReport] = {}
        self.samples_dropped = False
        # bumped on every change: an off-lock exact pass publishes only if
        # the generation it scored is still the current one
        self.generation = 0
        self._max_sample_rows = max_sample_rows
        # unkeyed reports accumulate, one slot per delivery; their
        # continuation chunks attach to the worker's latest slot
        self._unkeyed_seq = 0
        self._unkeyed_last: Dict[int, object] = {}
        self._cache_key = None
        self._cache_val: Dict[str, float] = {}
        self._dirty = True

    def ingest(self, req: pb.ReportEvaluationMetricsRequest):
        if req.eval_task_key:
            key = req.eval_task_key
        elif req.samples_only and req.worker_id in self._unkeyed_last:
            key = self._unkeyed_last[req.worker_id]
        else:
            self._unkeyed_seq += 1
            key = ("w", req.worker_id, self._unkeyed_seq)
            self._unkeyed_last[req.worker_id] = key
        if not req.samples_only:
            # first chunk of a (re-)delivery: reset this task's slot
            report = self.reports[key] = _TaskReport()
            report.metrics = dict(req.metrics)
            report.num_examples = req.num_examples or 1
        else:
            report = self.reports.setdefault(key, _TaskReport())
        if req.num_samples and not self.samples_dropped:
            if self.sample_rows + req.num_samples > self._max_sample_rows:
                self.drop_samples(
                    f"sample cap ({self._max_sample_rows} rows) exceeded")
            else:
                width = max(1, req.pred_width)
                if report.pred_width is None:
                    report.pred_width = width
                if width != report.pred_width:
                    # a continuation chunk disagreeing with its own
                    # delivery's width would mis-reshape every row
                    logger.warning(
                        "Ignoring eval sample chunk with pred_width=%d for "
                        "a delivery that started at width=%d (worker %d, "
                        "v%d, task %r)", width, report.pred_width,
                        req.worker_id, req.model_version, key)
                else:
                    report.label_chunks.append(
                        np.asarray(req.eval_labels, np.float32))
                    report.pred_chunks.append(
                        np.asarray(req.eval_preds, np.float32))
        self.generation += 1
        self._dirty = True

    def drop_samples(self, reason: str):
        """Memory valve: discard sample chunks; this version's metrics
        fall back to weighted shard means."""
        if not self.samples_dropped:
            logger.warning("Dropping eval samples (%s); rank metrics for "
                           "this version fall back to weighted shard "
                           "means", reason)
        self.samples_dropped = True
        for report in self.reports.values():
            report.label_chunks = []
            report.pred_chunks = []
        self.generation += 1
        self._dirty = True

    @property
    def num_examples(self) -> int:
        return sum(r.num_examples for r in self.reports.values())

    @property
    def sample_rows(self) -> int:
        return sum(len(c) for r in self.reports.values()
                   for c in r.label_chunks)

    def weighted_means(self) -> Dict[str, float]:
        total = self.num_examples
        if not total:
            return {}
        out: Dict[str, float] = {}
        for report in self.reports.values():
            for name, value in report.metrics.items():
                out[name] = out.get(name, 0.0) + value * report.num_examples
        return {k: v / total for k, v in out.items()}

    def sample_snapshot(self):
        """(generation, label_chunks, pred_chunks, width) of the merged
        samples, of the width with the most rows when deliveries disagree
        (mixed widths cannot share one matrix; the rest count through the
        weighted means).  O(chunks) list copies, cheap under the lock; the
        caller merges and scores them outside it."""
        by_width: Dict[int, list] = {}
        for report in self.reports.values():
            if report.label_chunks:
                by_width.setdefault(report.pred_width or 1, []).append(
                    report)
        if not by_width:
            return self.generation, [], [], 1
        rows_of = {w: sum(len(c) for r in reports for c in r.label_chunks)
                   for w, reports in by_width.items()}
        width = max(rows_of, key=lambda w: rows_of[w])
        if len(by_width) > 1:
            logger.warning(
                "Mixed pred widths in one eval version (%s rows per "
                "width); exact metrics use width=%d only", rows_of, width)
        labels = [c for r in by_width[width] for c in r.label_chunks]
        preds = [c for r in by_width[width] for c in r.pred_chunks]
        return self.generation, labels, preds, width

    def result(self, eval_metrics=None, exact: bool = True
               ) -> Dict[str, float]:
        """Weighted shard means, overridden by the exact recomputation
        over the merged samples when `exact` and metric fns are given.
        Cached until the contributions change."""
        if not self.num_examples:
            return {}
        key = (id(eval_metrics), exact)
        if not self._dirty and self._cache_key == key:
            return self._cache_val
        out = self.weighted_means()
        if exact and eval_metrics and self.sample_rows:
            _, labels, preds, width = self.sample_snapshot()
            out.update(_exact_metrics(labels, preds, width, eval_metrics))
        self.seed_cache(key, out)
        return out

    def seed_cache(self, key, value: Dict[str, float]) -> None:
        """`value` is this agg's result for `key` until it changes."""
        self._cache_key = key
        self._cache_val = value
        self._dirty = False


class EvaluationService:
    # merged samples are kept for this many most recent versions; older
    # versions freeze their exact result and free the samples
    SAMPLE_VERSIONS_KEPT = 2

    def __init__(self, task_manager, evaluation_steps: int = 0,
                 start_delay_secs: int = 0, throttle_secs: int = 0,
                 summary_writer=None, eval_metrics=None):
        self._tm = task_manager
        self._summary = summary_writer
        # {name: fn(labels, preds)} from the zoo's eval_metrics_fn: with
        # it, job-level metrics are recomputed over the merged samples
        self._eval_metrics = eval_metrics
        self._evaluation_steps = evaluation_steps
        self._start_delay_secs = start_delay_secs
        self._throttle_secs = throttle_secs
        self._lock = threading.Lock()
        self._aggs: Dict[int, _VersionAgg] = {}
        # the versions whose history holds an exactly recomputed value
        self._history_exact = set()
        self._last_eval_version = 0
        self._last_eval_time = 0.0
        self._start_time = time.time()
        self.history: Dict[int, Dict[str, float]] = {}

    # ---- scheduling ----------------------------------------------------

    def on_version_report(self, model_version: int):
        """A worker reported progress: inject an eval round when the
        version moved `evaluation_steps` past the last one (and the
        start-delay and throttle gates allow)."""
        if not self._evaluation_steps:
            return
        now = time.time()
        with self._lock:
            if now - self._start_time < self._start_delay_secs:
                return
            if (model_version - self._last_eval_version
                    < self._evaluation_steps):
                return
            if now - self._last_eval_time < self._throttle_secs:
                return
            self._last_eval_version = model_version
            self._last_eval_time = now
        n = self._tm.create_evaluation_tasks(model_version)
        logger.info("Injected %d eval tasks at model version %d",
                    n, model_version)

    # ---- aggregation ---------------------------------------------------

    def report_metrics(self, req: pb.ReportEvaluationMetricsRequest):
        version = req.model_version
        heavy = None
        with self._lock:
            agg = self._aggs.setdefault(version, _VersionAgg())
            if self._eval_metrics is None and req.num_samples:
                # no metric fns here: samples could never be used
                req.eval_labels = req.eval_preds = None
            agg.ingest(req)
            rows = agg.sample_rows
            # exact on every report of a small merged set, and once per
            # completed delivery of a large one, never once per chunk
            eager = (rows <= EAGER_EXACT_ROWS or req.final_chunk
                     or not req.num_samples)
            inline = eager and (rows <= INLINE_EXACT_ROWS
                                or not self._eval_metrics or not rows)
            if inline:
                self.history[version] = agg.result(self._eval_metrics,
                                                   exact=True)
                self._history_exact.add(version)
            else:
                result = agg.result(self._eval_metrics, exact=False)
                if eager:
                    # a large merged set is scored off the lock
                    heavy = agg.sample_snapshot()
                if version not in self._history_exact:
                    # a weighted mean never replaces an exact value
                    # already published for this version
                    self.history[version] = result
            self._prune_samples_locked(version)
            n, sampled = agg.num_examples, agg.sample_rows
        if heavy is not None:
            self._publish_exact(version, agg, heavy)
        with self._lock:
            metrics = self.history[version]
        logger.info("Eval metrics v%d (n=%d, sampled=%d): %s",
                    version, n, sampled, metrics)
        if self._summary is not None:
            # the job-level curve, rewritten as shards accumulate
            self._summary.scalars(
                {f"eval/{k}": v for k, v in metrics.items()}, step=version)
            self._summary.flush()

    def _publish_exact(self, version: int, agg: _VersionAgg, snapshot):
        """Score `snapshot` outside the lock and publish it as `version`'s
        exact value if no ingest changed `agg` meanwhile; else score a new
        snapshot, up to OFF_LOCK_ATTEMPTS in all."""
        for attempt in range(OFF_LOCK_ATTEMPTS):
            generation, labels, preds, width = snapshot
            if not labels:
                # the chunks went (version pruned, sample cap) and the
                # lock holder that dropped them froze the best value
                return
            exact = _exact_metrics(labels, preds, width, self._eval_metrics)
            with self._lock:
                if agg.samples_dropped:
                    return
                if agg.generation == generation:
                    merged = {**agg.weighted_means(), **exact}
                    self.history[version] = merged
                    self._history_exact.add(version)
                    # later readers under the lock hit the cache instead
                    # of scoring O(rows) there
                    agg.seed_cache((id(self._eval_metrics), True), merged)
                    return
                # an ingest raced the pass: the stale value must not
                # publish, and the racer may be a mid-delivery chunk that
                # schedules no pass of its own, so score the new samples
                if attempt == OFF_LOCK_ATTEMPTS - 1:
                    logger.warning(
                        "off-lock exact eval for v%d kept racing ingests; "
                        "leaving the weighted mean until the next "
                        "completed delivery", version)
                else:
                    snapshot = agg.sample_snapshot()

    def _prune_samples_locked(self, current_version: int):
        keep = sorted(self._aggs)[-self.SAMPLE_VERSIONS_KEPT:]
        for version, agg in self._aggs.items():
            if version not in keep and not agg.samples_dropped:
                # freeze the exact result so far, then free the samples
                self.history[version] = agg.result(self._eval_metrics)
                agg.drop_samples(f"version {version} superseded")

    def latest_metrics(self) -> Optional[Dict[str, float]]:
        with self._lock:
            if not self._aggs:
                return (self.history[max(self.history)] if self.history
                        else None)
            version = max(self._aggs)
            self.history[version] = self._aggs[version].result(
                self._eval_metrics)
            self._history_exact.add(version)
            return self.history[version]
