"""The master of a Local job (the port's copy of the Local subset of the
JAX package's master/main.py): shards from the readers -> task manager
-> evaluation service -> servicer -> wait for completion, with the final
evaluation round injected when the queue first drains.

A train job with `--checkpoint_dir` journals its finished training
shards at `<checkpoint_dir>/task_state.json`, trusted up to the newest
committed model checkpoint's step, so a relaunched job with the same
flags restores the model and trains only the shards it has not seen.  A
journal with no model checkpoint beside it is orphaned and discarded
(resuming the queue without the model would drop that data).  The
evaluation rounds' job-level metrics go to TensorBoard under
`<tensorboard_log_dir>/master` when that flag is set; `snapshot()` adds
the fault, retry and straggler stats to the task counters.

Judgment (the JAX master's wiring): with `--history_interval`,
`--slo_interval` or `--incident_dir` set, the master builds a
`MetricHistory` over its registries, an incident `FlightRecorder` tapped
on the event stream (bundles under `--incident_dir`), and an
`SloEvaluator` over the shipped SLOs whose breaches the recorder
captures.  `start()` runs the history and SLO threads, each only at an
interval > 0; `stop()` flushes and untaps the recorder, then stops
both.  `snapshot()` gains `slo` (with the history's health) and
`flight`.  A Local job serves nothing: `staleness_p99` and `fleet_skew`
stay `no_data`, and the two ratio SLOs read `ok` over the router's
request counters, which exist at zero once `proto/service.py` is
imported (as in the JAX package's Local job).  None of this touches
training, so a job ends on the same state with the flags as without
them.

Observability (the JAX Local runner's): `start_telemetry(port)` serves
/metrics, /healthz and /varz over the master's registries
(common/telemetry.py; `--telemetry_port`, 0 = ephemeral), and /varz
carries `snapshot()` and the program registry's summary, which `top`,
`slo` and `programs` render.  `snapshot()` builds what the JAX master's
does for a job without pods: the task counters, the online line of a
perpetual queue, the SLO report with the history's health, the
per-worker rows (the telemetry workers send with their task reports,
merged with the straggler stats), the fault and retry counters and the
flight recorder's state.  The recorder takes the process's program
registry, so a recompile storm captures a bundle at once and every
bundle has a `programs.json`.

What the JAX master builds only with a `PodManager` waits for the pods
and stays with the cluster slice (ROADMAP.md queue 1, item 12): the
serving fleet, the `FreshnessTracker` it feeds and both policy engines
(ported in master/serving_fleet.py and master/policy.py, and built by
the online loop, online/pipeline.py), the recovery clock, the pod rows
of `snapshot()` and the gRPC server.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from elasticdl_tpu_torch.common import faults, resilience
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common import telemetry as telemetry_lib
from elasticdl_tpu_torch.common.flight import FlightRecorder
from elasticdl_tpu_torch.common.history import MetricHistory
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_handler import load_module
from elasticdl_tpu_torch.common.programs import default_program_registry
from elasticdl_tpu_torch.common.save_utils import intact_steps
from elasticdl_tpu_torch.common.slo import SloEvaluator, shipped_specs
from elasticdl_tpu_torch.common.summary import SummaryWriter
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_manager import (
    TaskManager,
    create_shards_from_ranges,
)
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger(__name__)


class Master:
    """Owns the control plane of one job."""

    # judgment (history, SLOs, flight recorder): None unless a judgment
    # flag is set
    metric_history = None
    slo_evaluator = None
    flight_recorder = None
    # the /metrics, /healthz, /varz server, once start_telemetry ran
    telemetry = None

    def __init__(self, args):
        self.args = args
        self.job_type = args.job_type
        training_shards = (
            create_shards_from_ranges(
                create_data_reader(args.training_data).create_shards(),
                args.records_per_task)
            if args.training_data and self.job_type == "train" else []
        )
        evaluation_shards = (
            create_shards_from_ranges(
                create_data_reader(args.validation_data).create_shards(),
                args.records_per_task)
            if args.validation_data else []
        )
        prediction_shards = []
        if args.prediction_data and self.job_type == "predict":
            prediction_shards = create_shards_from_ranges(
                create_data_reader(args.prediction_data).create_shards(),
                args.records_per_task)
        if not (training_shards or evaluation_shards or prediction_shards):
            raise ValueError(
                f"job type {self.job_type!r} has no input data "
                "(--training_data / --validation_data / --prediction_data)")
        persist_path = restore_cutoff = None
        if args.checkpoint_dir and self.job_type == "train":
            persist_path = os.path.join(args.checkpoint_dir,
                                        "task_state.json")
            restore_cutoff = latest_model_checkpoint_step(
                args.checkpoint_dir)
            if restore_cutoff is None and os.path.exists(persist_path):
                logger.warning("Discarding orphaned task journal %s (no "
                               "model checkpoint to pair it with)",
                               persist_path)
                try:
                    os.remove(persist_path)
                except OSError:
                    pass
        self.task_manager = TaskManager(
            training_shards=training_shards,
            evaluation_shards=evaluation_shards,
            prediction_shards=prediction_shards,
            num_epochs=args.num_epochs,
            lease_timeout_s=args.task_lease_timeout_s,
            shuffle_shards=True,
            shuffle_seed=0,
            persist_path=persist_path,
            restore_cutoff_step=restore_cutoff,
            straggler_multiple=args.straggler_multiple,
            straggler_min_tasks=args.straggler_min_tasks,
        )
        # evaluate-only jobs: the eval round is the job
        if self.job_type == "evaluate" and evaluation_shards:
            self.task_manager.create_evaluation_tasks(model_version=0)
        self.eval_summary = SummaryWriter(
            os.path.join(args.tensorboard_log_dir, "master")
            if args.tensorboard_log_dir else None)
        self.evaluation_service = EvaluationService(
            self.task_manager,
            evaluation_steps=args.evaluation_steps,
            start_delay_secs=args.evaluation_start_delay_secs,
            throttle_secs=args.evaluation_throttle_secs,
            summary_writer=self.eval_summary,
            eval_metrics=self._load_eval_metrics(args),
        )
        self.servicer = MasterServicer(
            self.task_manager, evaluation_service=self.evaluation_service)
        if (args.history_interval > 0 or args.slo_interval > 0
                or args.incident_dir):
            self.metric_history = MetricHistory(
                registries=self.telemetry_registries(),
                capacity=args.history_capacity,
                interval_s=args.history_interval,
            )
            # without --incident_dir the rings still fill but nothing is
            # captured
            self.flight_recorder = FlightRecorder(
                incident_dir=args.incident_dir or None,
                ring_capacity=args.incident_ring,
                max_bundles=args.incident_max_bundles,
                snapshot_fn=self.snapshot,
                history=self.metric_history,
                # a recompile storm pends an immediate capture, and every
                # bundle gains a programs.json ledger section
                program_registry=default_program_registry(),
            ).install()
            self.slo_evaluator = SloEvaluator(
                self.metric_history,
                specs=shipped_specs(args),
                interval_s=args.slo_interval,
                on_breach=self.flight_recorder.breach,
            )
        self._done = threading.Event()
        self.task_manager.add_all_done_callback(self._done.set)
        # The final evaluation over the validation set, injected by the
        # task manager the moment the queue first drains.
        self._final_eval_done = False
        self._evaluation_shards = evaluation_shards
        if evaluation_shards and self.job_type == "train":
            self.task_manager.add_pre_finish_provider(self._final_eval_tasks)

    @staticmethod
    def _load_eval_metrics(args):
        """The zoo module's eval_metrics_fn, so job-level rank metrics
        (AUC) are recomputed exactly over the merged worker samples."""
        if not args.model_def:
            return None
        module, _ = load_module(args.model_zoo, args.model_def)
        factory = getattr(module, args.eval_metrics_fn, None)
        return factory() if factory else None

    def _final_eval_tasks(self):
        """Pre-finish provider (runs under the task-manager lock): the
        final evaluation round, exactly once."""
        if self._final_eval_done:
            return []
        self._final_eval_done = True
        version = self.servicer.max_model_version
        logger.info("Final evaluation: %d tasks at version %d",
                    len(self._evaluation_shards), version)
        return [(shard, pb.EVALUATION, version)
                for shard in self._evaluation_shards]

    def start(self) -> None:
        """Start the metric-history and SLO threads; each runs only at
        an interval > 0 (at 0, a caller ticks by hand)."""
        if self.metric_history is not None and self.metric_history.start():
            logger.info("Metric history sampling every %.1fs",
                        self.metric_history.interval_s)
        if self.slo_evaluator is not None and self.slo_evaluator.start():
            logger.info("SLO evaluator ticking every %.1fs",
                        self.slo_evaluator.interval_s)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the job finished (True) or `timeout` passed
        (False)."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            remaining = None if deadline is None else deadline - time.time()
            if remaining is not None and remaining <= 0:
                return False
            wait_s = 0.2 if remaining is None else min(0.2, remaining)
            if self._done.wait(timeout=wait_s) and self.task_manager.finished:
                return True

    def snapshot(self) -> dict:
        """Task progress, the online line of a perpetual queue, the SLO
        report, per-worker telemetry merged with the straggler stats,
        the process-wide retry and fault counters (common/resilience.py,
        common/faults.py) and the flight recorder's state: the JAX
        master's snapshot of a job without pods."""
        out = {"tasks": self.task_manager.snapshot()}
        online = self.task_manager.online_snapshot()
        if online is not None:
            out["online"] = online
        if self.slo_evaluator is not None:
            slo = self.slo_evaluator.snapshot()
            slo["history"] = self.metric_history.snapshot()
            if online is not None:
                # how many samples of the armed-watermark lag gauge the
                # history holds (`slo`'s stream-lag line)
                slo["history"]["stream_lag_samples"] = len(
                    self.metric_history.series(
                        "master_stream_watermark_lag_seconds"))
            out["slo"] = slo
        out["workers"] = self.servicer.worker_telemetry()
        # straggler stats come from the task manager's lease clock:
        # merged onto the same per-worker rows
        for wid, stats in self.task_manager.straggler_snapshot().items():
            out["workers"].setdefault(wid, {}).update(stats)
        out["resilience"] = resilience.stats()
        out["faults"] = faults.stats()
        if self.flight_recorder is not None:
            out["flight"] = self.flight_recorder.snapshot()
        return out

    def telemetry_registries(self) -> list:
        """The master's registries: the process-wide default, the task
        manager's and, with judgment on, the SLO evaluator's."""
        registries = [metrics_lib.default_registry(),
                      self.task_manager.counters.registry]
        if self.slo_evaluator is not None:
            registries.append(self.slo_evaluator.metrics_registry)
        return registries

    def start_telemetry(self, port: int = 0) -> Optional[int]:
        """Serve /metrics, /healthz and /varz on `port` (0: ephemeral);
        returns the bound port, or None when the server could not start
        (telemetry never takes the job down)."""
        if self.telemetry is not None:
            return self.telemetry.port
        self.telemetry = telemetry_lib.TelemetryServer(
            registries=self.telemetry_registries(),
            role="master",
            port=port,
            healthz_fn=lambda: {
                "job_finished": self.task_manager.finished},
            varz_fn=lambda: {"snapshot": self.snapshot()},
        )
        try:
            started = self.telemetry.start()
        except OSError:
            logger.exception("telemetry server failed to start")
            self.telemetry = None
            return None
        logger.info("Master telemetry on port %d", started)
        return started

    def stop(self) -> None:
        if self.telemetry is not None:
            self.telemetry.stop()
            self.telemetry = None
        if self.flight_recorder is not None:
            # write the tap's queued captures while the components can
            # still give a coherent snapshot, then untap
            self.flight_recorder.flush()
            self.flight_recorder.close()
        if self.slo_evaluator is not None:
            self.slo_evaluator.stop()
        if self.metric_history is not None:
            self.metric_history.stop()
        self.eval_summary.close()


def latest_model_checkpoint_step(checkpoint_dir: str) -> Optional[int]:
    """The step a relaunch restores: the newest committed model
    checkpoint (its `state.pt` in place) that passes its manifest check,
    by the rule `CheckpointSaver.maybe_restore` applies; None when there
    is none.  Step-based, never a clock comparison."""
    steps = intact_steps(checkpoint_dir)
    return steps[-1] if steps else None
