"""Job construction for the Local strategy and the serving command (the
port's copy of `train`/`evaluate`/`predict`, `_train_local`, `serve` and
`build_serving_server` from the JAX package's client/api.py): master and
worker threads in one process, no cluster.

The path of a train job: TFRecord shards -> the master's task queue ->
worker thread(s) -> one shared ModelOwner (Trainer on the device;
periodic checkpoints) -> evaluation rounds with an exact AUC -> final
metrics, the model export when `--output` names a directory, and an exit
code that says whether the job succeeded.  The evaluate and predict jobs
run from `--checkpoint_dir_for_init`.

`serve` answers Predict and Health over HTTP (serving/server.py) from an
export (`--export_dir`) or a live checkpoint directory
(`--checkpoint_dir`, hot-reloaded as the trainer writes new steps).

A zoo module that exports `build_tiered_store` (deepfm.deepfm_tiered)
trains over the tiered embedding store (store/): the runner builds the
store, wraps the feeds with its id -> slot translation, attaches it to
the trainer and the checkpoint saver, starts its threads and stops them
when the job ends.  Planning is eager on the one worker's feed thread,
and deferred to the trainer (in step order) with more than one worker,
with `--steps_per_execution` > 1, or when the job resumes from a
checkpoint (the restore must precede the first plan).

Resilience, as in the JAX package's Local runner: a train job with
`--checkpoint_dir` journals its finished shards beside the checkpoints
(master/main.py), so running the same command again after a crash
restores the newest checkpoint and trains only the shards it had not
covered.  A fault schedule in the environment (`ELASTICDL_FAULT_SCHEDULE`
or `ELASTICDL_FAULT_SEED`, common/faults.py) is installed at the start
of the job; the workers' data services retry the master calls under the
`ELASTICDL_RPC_*` policy (common/resilience.py).  `--tensorboard_log_dir`
gives the master and each worker a summary writer
(`<dir>/master`, `<dir>/worker-<id>`); `--profile_dir` traces worker 0's
first training task.

With `--history_interval`, `--slo_interval` or `--incident_dir` the
master also samples its metrics, judges the SLOs and keeps an incident
flight recorder (master/main.py); `run_local` starts those threads and
`Master.stop` ends them.  The cluster strategies wait for their slice
of the port and raise NotImplementedError.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from elasticdl_tpu_torch.common import events, faults
from elasticdl_tpu_torch.common.constants import DistributionStrategy
from elasticdl_tpu_torch.common.export import SINGLE_FEATURE_KEY, export_model
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.metrics import default_registry
from elasticdl_tpu_torch.common.model_handler import get_model_spec
from elasticdl_tpu_torch.common.profiler import PhaseTimer
from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.device import resolve_device
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.proto.service import InProcessMasterClient
from elasticdl_tpu_torch.worker.sync import ModelOwner
from elasticdl_tpu_torch.worker.trainer import Trainer
from elasticdl_tpu_torch.worker.worker import Worker

logger = get_logger(__name__)

LOCAL = DistributionStrategy.LOCAL
# seconds a worker thread may take to notice the finished job and exit
WORKER_JOIN_S = 60.0


@dataclass
class LocalJob:
    """What a finished Local job leaves: `exit_code` is what `train`,
    `evaluate` and `predict` return."""

    ok: bool
    master: Master
    owner: ModelOwner
    workers: List[Worker]
    phase_timer: PhaseTimer
    metrics: Optional[Dict[str, float]] = None

    @property
    def exit_code(self) -> int:
        return 0 if self.ok else 1


def train(args) -> int:
    return run_local(args, job_type="train").exit_code


def evaluate(args) -> int:
    return run_local(args, job_type="evaluate").exit_code


def predict(args) -> int:
    return run_local(args, job_type="predict").exit_code


def _check_supported(args, job_type: str) -> None:
    if args.distribution_strategy != LOCAL:
        raise NotImplementedError(
            f"--distribution_strategy {args.distribution_strategy} (a "
            "cluster job) waits for the cluster slice of the port "
            "(ROADMAP.md queue 1, item 12); use Local")
    if job_type in ("evaluate", "predict") and \
            not args.checkpoint_dir_for_init:
        raise ValueError(
            f"{job_type} requires --checkpoint_dir_for_init (evaluating "
            "or predicting with random weights is meaningless)")


def run_local(args, job_type: str = "train") -> LocalJob:
    """Master and worker threads in one process; returns the finished
    job.  A worker thread that dies outside its task loop's reporting
    path fails the job and its exception re-raises here."""
    _check_supported(args, job_type)
    device = resolve_device(args.device)
    spec = get_model_spec(
        args.model_zoo, args.model_def,
        model_params=args.model_params,
        dataset_fn=args.dataset_fn,
        loss=args.loss,
        optimizer=args.optimizer,
        eval_metrics_fn=args.eval_metrics_fn,
        custom_data_reader=args.custom_data_reader,
        callbacks=args.callbacks,
        prediction_outputs_processor=args.prediction_outputs_processor,
        arena_dtype=args.arena_dtype,
        store_cache_dtype=args.store_cache_dtype,
    )
    build_tiered_store = getattr(spec.module, "build_tiered_store", None)
    if build_tiered_store is not None:
        _check_tiered(args, job_type)
    args.job_type = job_type
    events.configure(args.event_log or None, role="local")
    # a chaos run's schedule travels in the environment; a no-op
    # otherwise (a registry a caller installed stays)
    faults.configure_from_env()

    master = Master(args)
    try:
        # the metric-history and SLO threads (only at an interval > 0)
        master.start()
        client = InProcessMasterClient(master.servicer)
        data_origin = {
            "train": args.training_data,
            "evaluate": args.validation_data,
            "predict": args.prediction_data,
        }[job_type]

        def make_reader(origin=data_origin):
            # one reader per worker thread: zoo readers promise no thread
            # safety
            if spec.custom_data_reader is not None:
                return spec.custom_data_reader(data_origin=origin)
            return create_data_reader(origin)

        if job_type in ("evaluate", "predict"):
            saver = CheckpointSaver(args.checkpoint_dir_for_init)
            if saver.latest_step() is None:
                raise ValueError(
                    f"--checkpoint_dir_for_init "
                    f"{args.checkpoint_dir_for_init!r} contains no "
                    "checkpoint")
        elif args.checkpoint_dir:
            saver = CheckpointSaver(args.checkpoint_dir,
                                    keep_max=args.keep_checkpoint_max)
        elif args.checkpoint_dir_for_init:
            saver = CheckpointSaver(args.checkpoint_dir_for_init)
        else:
            saver = None

        # one model for the whole job: every worker thread shares the
        # owner
        owner = ModelOwner(
            Trainer(model=spec.model, optimizer=spec.optimizer,
                    loss_fn=spec.loss, use_bf16=args.use_bf16,
                    device=device),
            checkpoint_saver=saver,
            checkpoint_steps=args.checkpoint_steps,
        )
        master.task_manager.maybe_finish_if_drained()
        phase_timer = PhaseTimer()
        store = None
        if build_tiered_store is not None:
            store = _attach_tiered_store(build_tiered_store, args, spec,
                                         owner, saver, phase_timer)
        try:
            return _run_workers(args, job_type, spec, master, client,
                                owner, saver, phase_timer, make_reader)
        finally:
            if store is not None:
                # drain the pending write-backs, then stop both threads
                store.stop()
    except BaseException:
        # a job that fails to start still untaps its flight recorder and
        # ends its judgment threads (stopping twice is harmless)
        master.stop()
        raise


def _check_tiered(args, job_type: str) -> None:
    """The tiered store trains only, and without mid-train evaluation,
    as in the JAX package."""
    if job_type != "train":
        raise ValueError(
            f"a tiered-store model cannot run a {job_type} job: its "
            "features are cache slots the store assigns while training; "
            "serve its checkpoint through store.serving."
            "TieredServingEngine")
    if args.validation_data:
        raise ValueError(
            "tiered embedding store does not support mid-train "
            "evaluation yet: the eval path prepares admission plans it "
            "never applies, corrupting the cache map; drop "
            "--validation_data for tiered runs")


def _attach_tiered_store(build_tiered_store, args, spec, owner, saver,
                         phase_timer):
    """Build the job's store, wrap the feeds, attach it to the trainer
    and the saver, and start its threads; returns it."""
    store = build_tiered_store(registry=default_registry(),
                               phase_timer=phase_timer)
    reasons = []
    if args.num_workers != 1:
        # N feed producers cannot plan in batch order
        reasons.append(f"{args.num_workers} workers")
    if args.steps_per_execution != 1:
        # a K-step block takes one union plan over its raw batches
        reasons.append(f"steps_per_execution={args.steps_per_execution}")
    if saver is not None and saver.latest_step() is not None:
        # the sidecar restore must come before the first plan
        reasons.append("a resumed checkpoint")
    if reasons:
        store.enable_deferred_prepare()
        logger.info("tiered store: deferred planning (%s)",
                    ", ".join(reasons))
    spec.feed = store.wrap_feed(spec.feed)
    spec.feed_bulk = store.wrap_feed(spec.feed_bulk)
    owner.trainer.tiered_store = store
    if saver is not None:
        saver.attach_tiered_store(store)
    store.start()
    logger.info("tiered embedding store active: cache_rows=%d "
                "host_dtype=%s cache_dtype=%s", store.cache_rows,
                store.host.host_dtype, store.cache_dtype)
    return store


def _run_workers(args, job_type, spec, master, client, owner, saver,
                 phase_timer, make_reader) -> LocalJob:
    workers: List[Worker] = []
    errors: List[BaseException] = []

    def run_worker(worker):
        try:
            worker.run()
        except BaseException as exc:   # re-raised by run_local
            errors.append(exc)
            # its leases go back to the queue, so the other threads can
            # drain it instead of waiting on them forever
            master.task_manager.recover_tasks(worker.worker_id)
            raise

    threads = []
    for wid in range(args.num_workers):
        worker = Worker(
            worker_id=wid,
            master_client=client,
            data_reader=make_reader(),
            spec=spec,
            minibatch_size=args.minibatch_size,
            model_owner=owner,
            steps_per_execution=args.steps_per_execution,
            compact_wire=args.compact_wire,
            wire_format=args.wire_format,
            phase_timer=phase_timer,
            validation_reader=(make_reader(args.validation_data)
                               if job_type == "train"
                               and args.validation_data else None),
            tensorboard_dir=(
                os.path.join(args.tensorboard_log_dir, f"worker-{wid}")
                if args.tensorboard_log_dir else ""),
            # one process, one profiler: only worker 0 traces
            profile_dir=args.profile_dir if wid == 0 else "",
        )
        workers.append(worker)
        threads.append(threading.Thread(
            target=run_worker, args=(worker,), daemon=True,
            name=f"worker-{wid}"))
    for thread in threads:
        thread.start()
    # until the job finishes, or every worker thread is gone without it
    while any(t.is_alive() for t in threads) and \
            not master.wait(timeout=1.0):
        pass
    for thread in threads:
        thread.join(timeout=WORKER_JOIN_S)
    stuck = [t.name for t in threads if t.is_alive()]
    if stuck:
        logger.error("worker threads did not exit: %s", stuck)
    ok = master.task_manager.finished and not stuck and not errors
    master.stop()
    if saver is not None:
        # flush in-flight async writes; a failed write re-raises
        saver.close()
    metrics = master.evaluation_service.latest_metrics()
    if metrics:
        logger.info("Final metrics: %s", metrics)
    if job_type == "predict" and args.output:
        _write_predictions(args.output, workers)
    elif args.output and owner.state is not None:
        export_model(owner.state, spec, args.output,
                     saved_model=bool(args.export_saved_model),
                     sample_features=owner.sample_features)
        logger.info("Exported model to %s", args.output)
    logger.info("Job %s: %s", "succeeded" if ok else "failed",
                master.snapshot())
    if errors:
        raise errors[0]
    return LocalJob(ok=ok, master=master, owner=owner, workers=workers,
                    phase_timer=phase_timer, metrics=metrics)


def _write_predictions(output: str, workers) -> None:
    """The workers' per-task prediction arrays merged in task order (so
    the row order is the same across runs) into one .npy."""
    by_task = {}
    for w in workers:
        by_task.update(w.predictions)
    if not by_task:
        return
    path = output
    if not path.endswith(".npy"):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "predictions.npy")
    np.save(path, np.concatenate([by_task[t] for t in sorted(by_task)]))
    logger.info("Wrote predictions to %s", path)


def serve(args) -> int:
    """`serve`: online inference for a zoo model over HTTP, from a
    params.pt export (--export_dir) or a live checkpoint directory
    (--checkpoint_dir, with hot reload)."""
    events.configure(args.event_log or None, role="serving")
    server = build_serving_server(args)
    port = server.start(args.port)
    logger.info("serving %s on port %d (ctrl-c to stop)", args.model_def,
                port)
    try:
        server.wait()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        server.stop()
    return 0


def build_serving_server(args):
    """Assemble (but do not start) the engine/batcher/reloader/server
    stack from parsed `serve` args — split from serve() so tests and
    embedders drive the lifecycle themselves."""
    import json

    from elasticdl_tpu_torch.serving.batcher import DynamicBatcher
    from elasticdl_tpu_torch.serving.engine import ServingEngine
    from elasticdl_tpu_torch.serving.reloader import CheckpointReloader
    from elasticdl_tpu_torch.serving.server import ServingServer

    if bool(args.export_dir) == bool(args.checkpoint_dir):
        raise ValueError(
            "serve needs exactly one of --export_dir or --checkpoint_dir")
    device = resolve_device(args.device)
    spec = get_model_spec(args.model_zoo, args.model_def,
                          model_params=args.model_params,
                          arena_dtype=args.arena_dtype,
                          store_cache_dtype=args.store_cache_dtype)
    buckets = tuple(
        int(b) for b in str(args.batch_buckets).split(",") if b.strip()
    )
    reloader = None
    if args.export_dir:
        engine = ServingEngine.from_export(
            args.export_dir, spec, buckets=buckets, device=device)
    else:
        feature_spec = args.feature_spec
        if not feature_spec:
            raise ValueError(
                "--checkpoint_dir serving needs --feature_spec (inline "
                "JSON or a path to an export_meta.json)")
        if os.path.exists(feature_spec):
            with open(feature_spec) as f:
                meta = json.load(f)
            feature_spec = meta.get("features", meta)
        else:
            feature_spec = json.loads(feature_spec)
        sample = {
            name: np.zeros((1, *leaf["shape"]), np.dtype(leaf["dtype"]))
            for name, leaf in feature_spec.items()
        }
        if set(sample) == {SINGLE_FEATURE_KEY}:
            sample = sample[SINGLE_FEATURE_KEY]
        engine = ServingEngine.from_checkpoint(
            args.checkpoint_dir, spec, sample, buckets=buckets,
            device=device)
        reloader = CheckpointReloader(
            engine, args.checkpoint_dir,
            poll_interval_s=args.reload_poll_seconds)
    batcher = DynamicBatcher(
        engine,
        max_latency_s=args.max_batch_latency_ms / 1000.0,
        max_queue_rows=args.max_queue_rows or None,
        reject_oversized=args.reject_oversized,
    )
    return ServingServer(engine, batcher, reloader,
                         telemetry_port=args.telemetry_port)
