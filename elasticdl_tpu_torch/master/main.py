"""The master of a job (the port of the JAX package's master/main.py):
shards from the readers -> task manager -> evaluation service ->
servicer -> wait for completion, with the final evaluation round
injected when the queue first drains.

A cluster job (`python -m elasticdl_tpu_torch.master.main
--distribution_strategy AllReduce --use_process_k8s true ...`) gives
the master a Kubernetes client (`main()` picks it: `--use_process_k8s`
runs worker pods as local processes, `--use_fake_k8s` keeps them in
memory, and the real client raises without its package).  The master
then builds what the JAX master builds with one: the recovery clock,
the rendezvous server, the pod manager (worker commands are the
master's flags re-serialized, `_worker_command`) and the training
policy engine over it, serves its methods on `--port`
(master/server.py, HTTP in place of gRPC), and adds the pod rows to
`snapshot()`.  A train job with `--output` ends with one SAVE_MODEL
task, which the leading rank exports.  `main()` applies
`--compilation_cache_dir` first (ops/_build.py `set_cache_dir`), and the
worker commands carry it, with the policy engine's bounds and
thresholds (`--min_workers`, `--max_workers`, ...), which
`PolicyConfig.from_args` reads.

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

The serving fleet (the JAX master's gates and order): with a pod
manager and `--serving_replicas > 0` the master builds a
`FreshnessTracker` (a step's produced time read from its manifest when
`--checkpoint_dir` is set) and a `ServingFleetManager` whose replica
pods run `python -m elasticdl_tpu_torch.client.main serve` over the
job's checkpoint directory (`_serving_command`); with
`--max_serving_replicas > 0` too, a `ServingPolicyEngine` over the
fleet.  `start()` places the fleet (its probe loop runs only at
`--serving_probe_interval > 0`, the policy engine's only at
`--serving_policy_interval > 0`), `stop()` stops both, and `snapshot()`
gains `serving_fleet`, `serving_policy` and `freshness`.  A replica pod
over a checkpoint directory also gets `--feature_spec`, the serving
signature of one training record through the zoo's feed: `serve`
refuses a checkpoint directory without one, and the JAX master's
command passes none (ROADMAP.md queue 3).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

from elasticdl_tpu_torch.common import args as args_lib
from elasticdl_tpu_torch.common import events, faults, resilience
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common import telemetry as telemetry_lib
from elasticdl_tpu_torch.common.flight import FlightRecorder
from elasticdl_tpu_torch.common.constants import (
    KEEP_ALIVE_INTERVAL_S,
    DistributionStrategy,
)
from elasticdl_tpu_torch.common.export import feature_meta
from elasticdl_tpu_torch.common.history import MetricHistory
from elasticdl_tpu_torch.common.k8s_client import (
    FakeK8sClient,
    K8sClient,
    ProcessK8sClient,
    parse_volumes,
)
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_handler import load_module
from elasticdl_tpu_torch.common.programs import default_program_registry
from elasticdl_tpu_torch.common.save_utils import (
    read_produced_meta,
    restorable_step,
)
from elasticdl_tpu_torch.common.slo import SloEvaluator, shipped_specs
from elasticdl_tpu_torch.common.summary import SummaryWriter
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.freshness import FreshnessTracker
from elasticdl_tpu_torch.master.pod_manager import PodManager
from elasticdl_tpu_torch.master.policy import (
    PolicyConfig,
    PolicyEngine,
    ServingPolicyConfig,
    ServingPolicyEngine,
)
from elasticdl_tpu_torch.master.recovery import RecoveryClock
from elasticdl_tpu_torch.master.rendezvous_server import RendezvousServer
from elasticdl_tpu_torch.master.server import MasterServer
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.serving_fleet import (
    ServingFleetConfig,
    ServingFleetManager,
)
from elasticdl_tpu_torch.master.task_manager import (
    TaskManager,
    create_shards_from_ranges,
)
from elasticdl_tpu_torch.ops import _build
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
    # a cluster job's control plane: None without a k8s client
    recovery_clock = None
    rendezvous_server = None
    pod_manager = None
    policy_engine = None
    # the serving fleet: None without a pod manager and replicas
    serving_fleet = None
    serving_policy = None
    freshness = None
    # the replicas' --feature_spec, once serving_signature computed it
    _serving_signature = None
    # the RPC server and its port, once start_rpc ran
    rpc_server = None
    bound_port = None

    def __init__(self, args, k8s_client=None):
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
        self._k8s = k8s_client
        if k8s_client is not None:
            self.recovery_clock = RecoveryClock()
            self.rendezvous_server = RendezvousServer(
                coordinator_port=args.coordinator_port)
            self.pod_manager = PodManager(
                k8s_client,
                task_manager=self.task_manager,
                rendezvous_server=self.rendezvous_server,
                job_name=args.job_name,
                num_workers=args.num_workers,
                image=args.image_name,
                worker_command=self._worker_command,
                relaunch_on_worker_failure=args.relaunch_on_worker_failure,
                worker_resources=_parse_resources(
                    args.worker_resource_request),
                priority_class=args.worker_pod_priority,
                on_job_abort=self._on_job_abort,
                recovery_clock=self.recovery_clock,
                volumes=parse_volumes(args.volume),
                workers_per_group=args.workers_per_group,
            )
        self.servicer = MasterServicer(
            self.task_manager, evaluation_service=self.evaluation_service,
            rendezvous_server=self.rendezvous_server,
            recovery_clock=self.recovery_clock)
        if self.pod_manager is not None:
            # built with the pods so snapshot() and /metrics show it; its
            # thread runs only at --policy_interval > 0
            self.policy_engine = PolicyEngine(
                self.task_manager, self.pod_manager,
                PolicyConfig.from_args(args),
                telemetry_fn=self.servicer.worker_telemetry)
        if self.pod_manager is not None and args.serving_replicas > 0:
            produced_time_fn = None
            if args.checkpoint_dir:
                def produced_time_fn(step, _dir=args.checkpoint_dir):
                    meta = read_produced_meta(_dir, step)
                    return meta.get("produced_unix_s") if meta else None
            self.freshness = FreshnessTracker(
                produced_time_fn=produced_time_fn)
            self.serving_fleet = ServingFleetManager(
                k8s_client,
                ServingFleetConfig.from_args(args),
                job_name=args.job_name,
                image=args.image_name,
                command_fn=self._serving_command,
                freshness=self.freshness,
            )
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
        if self.serving_fleet is not None and args.max_serving_replicas > 0:
            # without the history and SLO loops the burn and shed signals
            # read 0, and the engine only scales down on batch fill
            self.serving_policy = ServingPolicyEngine(
                self.serving_fleet,
                ServingPolicyConfig.from_args(args),
                history=self.metric_history,
                evaluator=self.slo_evaluator,
            )
        self._done = threading.Event()
        self._aborted: Optional[str] = None
        self.task_manager.add_all_done_callback(self._done.set)
        # The final evaluation over the validation set, injected by the
        # task manager the moment the queue first drains.
        self._final_eval_done = False
        self._evaluation_shards = evaluation_shards
        if evaluation_shards and self.job_type == "train":
            self.task_manager.add_pre_finish_provider(self._final_eval_tasks)
        # a cluster job's export rides the queue: one SAVE_MODEL task with
        # the output dir in its rider, after the final evaluation round
        self._save_model_done = False
        if self.pod_manager is not None and self.job_type == "train" \
                and args.output:
            self.task_manager.add_pre_finish_provider(self._save_model_tasks)

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

    def _save_model_tasks(self):
        if self._save_model_done:
            return []
        self._save_model_done = True
        rider = json.dumps({"output": self.args.output,
                            "saved_model": bool(
                                self.args.export_saved_model)})
        return [(pb.Shard(), pb.SAVE_MODEL, -1, rider)]

    def _worker_command(self, worker_id: int):
        """A worker pod's command: this master's flags re-serialized,
        plus the worker's id and the master's address."""
        worker_args = args_lib.build_arguments_from_parsed_result(
            self.args, filter_args={"job_type", "worker_id",
                                    "master_addr"})
        port = self.bound_port or self.args.port
        host = self._k8s.master_host(self.args.job_name)
        return ([sys.executable, "-m", "elasticdl_tpu_torch.worker.main"]
                + worker_args
                + ["--master_addr", f"{host}:{port}",
                   "--worker_id", str(worker_id),
                   "--job_type", self.job_type])

    def _serving_command(self, replica_id: int):
        """A serving replica pod's command: `serve` over the job's
        checkpoint directory, so every replica hot-reloads the steps the
        trainer writes, on --device as the workers run."""
        command = [sys.executable, "-m", "elasticdl_tpu_torch.client.main",
                   "serve", "--model_zoo", self.args.model_zoo,
                   "--model_def", self.args.model_def,
                   "--port", str(self.args.serving_port)]
        if self.args.checkpoint_dir:
            command += ["--checkpoint_dir", self.args.checkpoint_dir,
                        "--feature_spec", self.serving_signature()]
        return command + ["--device", self.args.device]

    def serving_signature(self) -> str:
        """The serving signature (`feature_meta` as JSON) of the first
        training record through the zoo's feed; computed once."""
        if self._serving_signature is None:
            module, _ = load_module(self.args.model_zoo, self.args.model_def)
            feed = getattr(module, self.args.dataset_fn)
            reader = create_data_reader(self.args.training_data)
            name, start, _ = reader.create_shards()[0]
            records = list(reader.read_records(pb.Task(
                shard=pb.Shard(name=name, start=start, end=start + 1))))
            batch = feed(records, getattr(reader, "metadata", {}))
            self._serving_signature = json.dumps(
                feature_meta(batch["features"]))
        return self._serving_signature

    def _on_job_abort(self, reason: str) -> None:
        logger.error("Job aborted: %s", reason)
        self._aborted = reason
        self._done.set()

    def start_rpc(self, port: Optional[int] = None) -> int:
        """Serve the servicer's methods on `port` (default --port; 0:
        ephemeral) and start the lease reaper; returns the bound port."""
        self.rpc_server = MasterServer(self.servicer)
        self.bound_port = self.rpc_server.start(
            self.args.port if port is None else port)
        logger.info("Master serving on port %d", self.bound_port)
        self.task_manager.start_lease_reaper()
        return self.bound_port

    def start(self, port: Optional[int] = None) -> Optional[int]:
        """Start the job's threads.  A cluster job (or a caller that
        names a port) first serves the RPC methods, then creates the
        worker pods and starts the policy engine (its loop only at
        --policy_interval > 0).  The metric-history and SLO threads run
        only at an interval > 0 (at 0, a caller ticks by hand).
        Returns the RPC port, or None without one."""
        if self.pod_manager is not None or port is not None:
            self.start_rpc(port)
        if self.pod_manager is not None:
            self.pod_manager.start()
        if self.policy_engine is not None and self.policy_engine.start():
            logger.info("Policy engine ticking every %.1fs",
                        self.policy_engine.config.interval_s)
        if self.serving_fleet is not None:
            self.serving_fleet.start()
            logger.info("Serving fleet: %d replicas placed (probe interval "
                        "%.1fs)", self.serving_fleet.config.replicas,
                        self.serving_fleet.config.interval_s)
        if self.metric_history is not None and self.metric_history.start():
            logger.info("Metric history sampling every %.1fs",
                        self.metric_history.interval_s)
        if self.slo_evaluator is not None and self.slo_evaluator.start():
            logger.info("SLO evaluator ticking every %.1fs",
                        self.slo_evaluator.interval_s)
        if self.serving_policy is not None and self.serving_policy.start():
            logger.info("Serving policy engine ticking every %.1fs (fleet "
                        "bounds [%d, %d])",
                        self.serving_policy.config.interval_s,
                        self.serving_policy.config.min_replicas,
                        self.serving_policy.config.max_replicas)
        if self.pod_manager is not None:
            # a restored journal may already be terminal: no report will
            # drain the queue, so check once now
            self.task_manager.maybe_finish_if_drained()
        return self.bound_port

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the job finished (True), aborted or `timeout`
        passed (False).  A cluster master logs its workers that went
        silent (the lease reaper recovers their tasks)."""
        deadline = None if timeout is None else time.time() + timeout
        stale_after = 3 * KEEP_ALIVE_INTERVAL_S
        next_stale_check = time.time() + stale_after
        while True:
            remaining = None if deadline is None else deadline - time.time()
            if remaining is not None and remaining <= 0:
                return False
            wait_s = 0.2 if remaining is None else min(0.2, remaining)
            if self._done.wait(timeout=wait_s):
                if self._aborted is not None:
                    return False
                if self.task_manager.finished:
                    return True
            if self.pod_manager is not None \
                    and time.time() > next_stale_check:
                next_stale_check = time.time() + stale_after
                alive = set(self.pod_manager.alive_workers())
                stale = {w: round(t, 1) for w, t in
                         self.servicer.stale_workers(stale_after).items()
                         if w in alive}
                if stale:
                    logger.warning("Workers silent > %.0fs (the lease "
                                   "reaper will recover their tasks): %s",
                                   stale_after, stale)

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
        if self.recovery_clock is not None:
            out["recovery"] = self.recovery_clock.snapshot()
        if self.pod_manager is not None:
            out["pods"] = self.pod_manager.snapshot()
        if self.policy_engine is not None:
            out["policy"] = self.policy_engine.snapshot()
        if self.serving_fleet is not None:
            out["serving_fleet"] = self.serving_fleet.snapshot()
        if self.serving_policy is not None:
            out["serving_policy"] = self.serving_policy.snapshot()
        if self.freshness is not None:
            out["freshness"] = self.freshness.snapshot()
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
        for component in (self.recovery_clock, self.pod_manager,
                          self.policy_engine, self.serving_fleet,
                          self.serving_policy, self.freshness):
            if component is not None:
                registries.append(component.metrics_registry)
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
                "job_finished": self.task_manager.finished,
                "aborted": self._aborted},
            varz_fn=lambda: {"snapshot": self.snapshot(),
                             "rpc_port": self.bound_port},
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
        if self.serving_policy is not None:
            self.serving_policy.stop()
        if self.policy_engine is not None:
            self.policy_engine.stop()
        if self.serving_fleet is not None:
            self.serving_fleet.stop()
        if self.pod_manager is not None:
            self.pod_manager.stop()
        if self.rpc_server is not None:
            self.rpc_server.stop(grace=1.0)
            self.rpc_server = None
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
    checkpoint that passes its manifest check and whose state loads
    (`save_utils.restorable_step`, the rule `maybe_restore` and a
    cluster group's restore apply); None when there is none.
    Step-based, never a clock comparison."""
    return restorable_step(checkpoint_dir)


def _parse_resources(spec: str) -> dict:
    """'cpu=1,memory=4096Mi' -> {'cpu': '1', 'memory': '4096Mi'}"""
    out = {}
    for part in (spec or "").split(","):
        if "=" in part:
            key, value = part.split("=", 1)
            out[key.strip()] = value.strip()
    return out


def k8s_client_for(args):
    """The cluster a job's pods run on: local processes
    (--use_process_k8s), memory (--use_fake_k8s), or Kubernetes through
    its API server (the in-cluster configuration, else the kubeconfig;
    K8sConfigError when there is neither).  None for a Local job."""
    if args.distribution_strategy == DistributionStrategy.LOCAL:
        return None
    if args.use_process_k8s:
        return ProcessK8sClient()
    if args.use_fake_k8s:
        return FakeK8sClient()
    return K8sClient(namespace=args.namespace, job_name=args.job_name)


def main(argv=None, k8s_client=None, linger_s: float = 60.0,
         on_started=None) -> int:
    """The master process's entry point.  A cluster strategy builds the
    elastic control plane over the client `k8s_client_for` picks (a
    caller may pass one); `on_started(master)`, when given, is called
    once the master serves and its pods are created.  Exit code 0 when
    the job finished, 1 when it aborted."""
    args = args_lib.parse_master_args(argv)
    # the libraries' directory before anything is built or loaded (the
    # host scanner indexes the training data)
    _build.set_cache_dir(args.compilation_cache_dir)
    if k8s_client is None:
        k8s_client = k8s_client_for(args)
    # a chaos run's fault schedule travels in the environment
    faults.configure_from_env()
    # --event_log wins; else the environment's; export_env hands the
    # path to the worker processes the same way
    if args.event_log:
        events.configure(args.event_log, role="master", export_env=True)
    else:
        events.configure_from_env(role="master")
    master = Master(args, k8s_client=k8s_client)
    try:
        master.start()
        master.start_telemetry(args.telemetry_port)
        if on_started is not None:
            on_started(master)
        ok = master.wait()
        logger.info("Job complete: %s", master.snapshot())
        if master.recovery_clock is not None and \
                master.recovery_clock.history:
            logger.info("Elastic recoveries this job: %s",
                        [round(s, 2) for s in master.recovery_clock.history])
        metrics = master.evaluation_service.latest_metrics()
        if metrics:
            logger.info("Final metrics: %s", metrics)
        # linger: the workers see job_finished, flush and exit before
        # the server goes (a cluster master waits for them, at most
        # linger_s; the pods still alive then are stopped)
        deadline = time.time() + linger_s
        while master.pod_manager is not None \
                and master.pod_manager.alive_workers() \
                and time.time() < deadline:
            time.sleep(0.1)
    finally:
        master.stop()
        stop = getattr(k8s_client, "stop", None)
        if stop is not None:
            stop()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
