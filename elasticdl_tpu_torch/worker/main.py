"""A cluster job's worker process (the port of the JAX package's
worker/main.py).

    python -m elasticdl_tpu_torch.worker.main --master_addr HOST:PORT \
        --worker_id N <the master's flags>

The master launches it (master/main.py `_worker_command`) with its own
flags re-serialized.  The worker reaches the master over HTTP
(`MasterStub`), reports its address and keeps reporting its liveness
(`start_keep_alive`), waits for a settled, confirmed epoch of the
rendezvous, and runs one rank of the data-parallel group
(worker/spmd.py).  A master that stays unreachable past the retry
budget ends the worker with exit code 45 (a charged relaunch); the
ranks' own restarts exit 43 (wedged) and 44 (a new topology).  It
applies `--compilation_cache_dir` first: with the directory shared by
the job's pods, a relaunched or added worker loads the kernel libraries
an earlier pod built.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from elasticdl_tpu_torch.common import args as args_lib
from elasticdl_tpu_torch.common import events, faults
from elasticdl_tpu_torch.common.constants import (
    KEEP_ALIVE_INTERVAL_S,
    WorkerEnv,
)
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_handler import get_model_spec
from elasticdl_tpu_torch.common.net_utils import get_reachable_address
from elasticdl_tpu_torch.common.preemption import (
    MaintenanceNoticeWatcher,
    any_notice_checker,
    file_notice_checker,
    gce_metadata_checker,
    install_preemption_hook,
)
from elasticdl_tpu_torch.common.resilience import (
    RETRY_EXHAUSTED_EXIT_CODE,
    RetryBudgetExhausted,
    default_policy,
)
from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
from elasticdl_tpu_torch.common.telemetry import TelemetryServer
from elasticdl_tpu_torch.data.reader import create_data_reader
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto.service import MasterStub
from elasticdl_tpu_torch.worker.spmd import (
    SPMDWorker,
    wait_for_confirmed_epoch,
)

logger = get_logger(__name__)


def build_master_client(addr: str, retry_policy=None) -> MasterStub:
    """A stub of the master at `addr`, its calls under `retry_policy`
    (default: the env-tuned policy).  A master that is not up yet is
    waited for by the first call's retries, in place of gRPC's
    channel-ready wait."""
    policy = retry_policy if retry_policy is not None else default_policy()
    return MasterStub(addr, retry_policy=policy)


def start_keep_alive(client, worker_id: int, master_addr: str) -> str:
    """Report this worker's reachable address now, then its liveness on
    a daemon thread every KEEP_ALIVE_INTERVAL_S; returns the address."""
    address = get_reachable_address(master_addr)

    def beat():
        try:
            client.keep_alive(pb.KeepAliveRequest(
                worker_id=worker_id, timestamp_ms=int(time.time() * 1000),
                address=address))
        except Exception:
            pass  # the master briefly unreachable: liveness is best-effort

    beat()

    def loop():
        while True:
            time.sleep(KEEP_ALIVE_INTERVAL_S)
            beat()

    threading.Thread(target=loop, daemon=True).start()
    return address


def main(argv=None) -> int:
    # a chaos run's fault schedule travels in the environment
    faults.configure_from_env()
    try:
        return _main(argv)
    except RetryBudgetExhausted as exc:
        # the master stayed unreachable past the whole retry budget: the
        # charged exit code, so the pod manager relaunches us
        logger.error("Worker retry budget exhausted: %s", exc)
        sys.exit(RETRY_EXHAUSTED_EXIT_CODE)


def _main(argv=None) -> int:
    args = args_lib.parse_worker_args(argv)
    # the job's shared library cache: a relaunched or added worker loads
    # the libraries an earlier pod built instead of building them
    _build.set_cache_dir(args.compilation_cache_dir)
    worker_id = int(os.environ.get(WorkerEnv.WORKER_ID, args.worker_id))
    master_addr = os.environ.get(WorkerEnv.MASTER_ADDR, args.master_addr)
    if args.event_log:
        events.configure(args.event_log, role="worker",
                         worker_id=worker_id)
    else:
        events.configure_from_env(role="worker", worker_id=worker_id)
    # /metrics, /healthz, /varz on an ephemeral port: the argv is the
    # master's, and a fixed port would collide on a shared host
    telemetry = TelemetryServer(role="worker")
    try:
        telemetry.start()
        logger.info("Worker %d telemetry on port %d", worker_id,
                    telemetry.port)
    except OSError:
        logger.exception("telemetry server failed to start")
    budget = args.rpc_retry_budget_s
    rpc_policy = (default_policy(max_elapsed_s=budget) if budget
                  else default_policy())
    client = build_master_client(master_addr, retry_policy=rpc_policy)
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
    origin = {"train": args.training_data,
              "evaluate": args.validation_data,
              "predict": args.prediction_data}[args.job_type]
    if spec.custom_data_reader is not None:
        reader = spec.custom_data_reader(data_origin=origin)
    else:
        reader = create_data_reader(origin)
    ckpt_dir = args.checkpoint_dir or args.checkpoint_dir_for_init
    saver_factory = None
    if ckpt_dir:
        def saver_factory():
            return CheckpointSaver(ckpt_dir,
                                   keep_max=args.keep_checkpoint_max)
    my_addr = start_keep_alive(client, worker_id, master_addr)
    cluster, me = wait_for_confirmed_epoch(client, worker_id,
                                           rpc_policy=rpc_policy)
    logger.info("Worker %d joined epoch %d as rank %d/%d (addr=%s, "
                "coordinator=%s)", worker_id, cluster.rendezvous_id,
                me.rank, cluster.world_size, my_addr,
                cluster.coordinator_address)
    worker = SPMDWorker(
        worker_id=worker_id,
        master_client=client,
        data_reader=reader,
        spec=spec,
        minibatch_size=args.minibatch_size,
        process_id=me.rank,
        num_processes=cluster.world_size,
        coordinator_address=cluster.coordinator_address,
        use_bf16=args.use_bf16,
        checkpoint_saver_factory=saver_factory,
        checkpoint_steps=args.checkpoint_steps,
        initial_epoch=cluster.rendezvous_id,
        output_dir=args.output if args.job_type == "predict" else "",
        wedge_grace_s=args.wedge_grace_s,
        steps_per_execution=args.steps_per_execution,
        compact_wire=args.compact_wire,
        wire_format=args.wire_format,
        tensorboard_dir=(os.path.join(args.tensorboard_log_dir,
                                      f"worker-{worker_id}")
                         if args.tensorboard_log_dir else ""),
        profile_dir=(os.path.join(args.profile_dir, f"worker-{worker_id}")
                     if args.profile_dir else ""),
        rpc_policy=rpc_policy,
        device=args.device,
    )
    if saver_factory is not None:
        # SIGTERM with a grace window: drain (a rank of several) or save
        # (a single rank) before the process goes
        install_preemption_hook(worker.save_checkpoint_and_flush)
    notice = args.preemption_notice_file
    if notice:
        checker = (any_notice_checker(gce_metadata_checker("preempted"),
                                      gce_metadata_checker(
                                          "maintenance-event"))
                   if notice == "gce-metadata"
                   else file_notice_checker(notice))
        # the hook only sets the drain flag: the main thread stops at
        # its next task boundary
        MaintenanceNoticeWatcher(checker, worker.drain_and_stop).start()
    ok = worker.run()
    logger.info("Worker %d exiting (clean=%s)", worker_id, ok)
    telemetry.stop()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
