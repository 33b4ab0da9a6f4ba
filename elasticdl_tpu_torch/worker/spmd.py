"""One rank of a cluster job: a data-parallel model over a
torch.distributed group (the port of the JAX package's worker/spmd.py).

Every rank of the group runs the same step on its rows of each global
batch, and one all-reduce joins the gradients (worker/trainer.py
`train_on_global_batch`): there is one model, and every rank holds the
same parameters bit for bit after every step.

Task flow: the master owns the shard queue; the ranks fetch the
group-synchronized assignment for (epoch, seq) with get_spmd_task
(master/spmd_assigner.py), so all train the same shard in the same
order.  Each rank reads only its rows of every full global batch
(`TaskDataService.local_batches_for_task`); a task's padded tail is read
whole by every rank, which keeps its own rows.  Rank 0 alone reports
tasks and model versions, reports evaluation metrics, writes
predictions and checkpoints.

Elasticity: a membership change bumps the rendezvous epoch.  A rank
whose get_spmd_task answers `epoch_stale` restarts its process (exit
code 44) for the new topology, as the JAX ranks do: the replacement
joins the settled, confirmed epoch (`wait_for_confirmed_epoch`), forms
a fresh group and restores the newest committed checkpoint, every rank
the same step (`_restore`), and the task queue re-leases whatever the
old group held.  A rank whose task fails while the epoch moves (a
collective whose peer died: gloo reports the closed connection at once)
restarts the same way; a failure without an epoch change stands.  A
rank stuck past `--wedge_grace_s` behind a newer epoch (a collective
that hangs) is restarted by the watchdog thread (exit code 43).  Both
codes relaunch without charge (master/pod_manager.py).

Each rank logs its kernel launches as one JSON line when it exits
(`KERNEL_LAUNCHES_TAG`), with the nvcc builds it ran and their seconds
(`kernel_builds`), so whoever ran the job reads every rank's counts
from the pods' output.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from elasticdl_tpu_torch.common import profiler as profiler_lib
from elasticdl_tpu_torch.common import programs as programs_lib
from elasticdl_tpu_torch.common import resilience
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_handler import (
    ModelSpec,
    resolve_wire_format,
)
from elasticdl_tpu_torch.common.save_utils import (
    LOAD_ERRORS,
    committed_steps,
    is_sharded,
    verify_step,
)
from elasticdl_tpu_torch.common.summary import SummaryWriter
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.ops import scatter_add as sa
from elasticdl_tpu_torch.parallel import collectives
from elasticdl_tpu_torch.parallel import mesh as mesh_lib
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.worker.sync import (
    INIT_SEED,
    first_rows,
    state_at_version,
)
from elasticdl_tpu_torch.worker.task_data_service import (
    TaskDataService,
    prefetch_batches,
)
from elasticdl_tpu_torch.worker.trainer import Trainer, map_host_batch
from elasticdl_tpu_torch.worker.worker import (
    export_for_task,
    invoke_callbacks,
    report_evaluation_with_samples,
)

logger = get_logger(__name__)

# the prefix of the JSON line of kernel launches a rank logs on exit
KERNEL_LAUNCHES_TAG = "kernel launches: "

# step-phase attribution: one rank per process, so one timer per process
_phase_timer = profiler_lib.PhaseTimer()


def kernel_launches() -> dict:
    """This process's launch counts of the hand kernels."""
    return {
        "flash_attention_fwd": dict(fa.flash_attention.launches_by_kernel),
        "flash_attention_bwd": dict(
            fa.flash_attention.backward_launches_by_kernel),
        "scatter_add": sa.scatter_add.launches,
    }


def kernel_builds() -> dict:
    """The hand kernels' nvcc builds this process ran, with their
    seconds (a library loaded from the cache records none)."""
    return {name: rec["compile_seconds_total"] for name, rec in
            programs_lib.default_program_registry().ledger().items()
            if name.startswith("kernel_build_")}


def state_digest(state) -> str:
    """sha256 over the model's state dict (names, dtypes, bytes) and the
    step: equal digests mean bit-equal states."""
    digest = hashlib.sha256(str(int(state.step)).encode())
    for name, tensor in sorted(state.model.state_dict().items()):
        digest.update(name.encode())
        digest.update(str(tensor.dtype).encode())
        digest.update(tensor.detach().cpu().contiguous().reshape(-1)
                      .view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def wait_for_confirmed_epoch(
    client,
    worker_id: int,
    poll_s: float = 0.5,
    timeout_s: Optional[float] = None,
    rpc_policy: Optional[resilience.RetryPolicy] = None,
):
    """Block until this worker is a member of a settled and
    group-confirmed epoch; returns (cluster_spec, my_worker_spec), or
    (None, None) on timeout.

    Three gates, in order: membership (I appear in the spec); settled
    (the world size equals the pod manager's target,
    expected_world_size, or any nonzero world when it publishes none);
    confirmed (every member's main thread confirmed this exact epoch).
    The barrier keeps a rank wedged in a collective, which cannot
    confirm, out of every group: its watchdog restarts it, the epoch
    moves, the survivors confirm the new one."""
    if rpc_policy is None:
        rpc_policy = resilience.default_policy()
    deadline = None if timeout_s is None else time.time() + timeout_s
    confirm = 0
    while True:
        # each poll gets the full retry budget; a master that stays dead
        # past it raises RetryBudgetExhausted (worker/main.py: exit 45)
        spec = rpc_policy.call(
            lambda: client.get_cluster_spec(pb.GetClusterSpecRequest(
                worker_id=worker_id, confirm_epoch=confirm)),
            description="get_cluster_spec")
        me = next((w for w in spec.workers if w.worker_id == worker_id),
                  None)
        settled = me is not None and (
            spec.world_size == spec.expected_world_size
            or (spec.expected_world_size == 0 and spec.world_size > 0))
        if settled and spec.all_confirmed and confirm == spec.rendezvous_id:
            return spec, me
        # confirm the epoch now observed; recorded on the next poll
        confirm = spec.rendezvous_id if settled else 0
        if deadline is not None and time.time() > deadline:
            return None, None
        time.sleep(poll_s)


class SPMDWorker:
    """One rank of a cluster job."""

    # class-level defaults: tests build bare instances with __new__
    wire_format = "plain"
    compact_wire = False
    mesh = None

    # the group's join deadline: a rank that entered it with a stale
    # epoch would anchor the whole recovery on it; the watchdog normally
    # restarts such a rank within its grace, this is the backstop
    INIT_TIMEOUT_S = 60
    # the watchdog's exit code (a rank stuck behind a newer epoch)
    WEDGED_EXIT_CODE = 43
    # a clean restart for a new topology
    TOPOLOGY_RESTART_EXIT_CODE = 44
    # how long a finished run waits for its background prewarm
    PREWARM_JOIN_S = 120.0

    def __init__(
        self,
        worker_id: int,
        master_client,
        data_reader,
        spec: ModelSpec,
        minibatch_size: int = 64,  # the GLOBAL batch size
        process_id: int = 0,
        num_processes: int = 1,
        coordinator_address: str = "",
        use_bf16: bool = False,
        seed: int = INIT_SEED,
        checkpoint_saver=None,
        checkpoint_saver_factory=None,
        checkpoint_steps: int = 0,
        wait_sleep_s: float = 0.2,
        initial_epoch: int = 0,
        wedge_grace_s: float = 20.0,
        output_dir: str = "",
        tensorboard_dir: str = "",
        profile_dir: str = "",
        steps_per_execution: int = 1,
        compact_wire: bool = False,
        wire_format: str = "",
        rpc_policy: Optional[resilience.RetryPolicy] = None,
        device: str = "cuda",
        mesh: Optional[mesh_lib.ProcessMesh] = None,
    ):
        self.worker_id = worker_id
        # one policy for every control-plane call this rank makes; an
        # exhausted budget reaches worker/main.py (exit code 45)
        self._rpc_policy = (rpc_policy if rpc_policy is not None
                            else resilience.default_policy())
        self.spec = spec
        self.minibatch_size = minibatch_size
        # the dedup format's padded shapes follow each rank's own sticky
        # packer caps, which grow at different steps on different ranks:
        # the ranks' batches would stop matching.  Dedup becomes compact.
        if (wire_format or "").strip().lower() == "dedup":
            logger.warning(
                "--wire_format=dedup is not supported across ranks "
                "(per-rank dedup caps diverge); using the compact wire "
                "format instead")
            wire_format = "compact"
        self.wire_format = resolve_wire_format(spec, wire_format,
                                               compact_wire, logger)
        self.compact_wire = self.wire_format == "compact"
        # >1: that many data-parallel steps per trainer call over local
        # stacks (the grouping is the same on every rank)
        self.steps_per_execution = max(1, int(steps_per_execution))
        self.process_id = process_id
        self.num_processes = num_processes
        self._coordinator = coordinator_address
        self._client = master_client
        self._data_service = TaskDataService(master_client, data_reader,
                                             worker_id)
        self._data_service.phase_timer = _phase_timer
        self._reader = data_reader
        self._use_bf16 = use_bf16
        self._seed = seed
        self._device = device
        # a mesh the caller built (any axes; the cluster path builds a
        # data-only one per epoch, as the JAX worker does)
        self._given_mesh = mesh
        self._saver = checkpoint_saver
        self._saver_factory = checkpoint_saver_factory
        self._checkpoint_steps = checkpoint_steps
        self._wait_sleep_s = wait_sleep_s
        self._epoch = initial_epoch
        self.state = None
        self.trainer: Optional[Trainer] = None
        # the prewarm's (sample batch, world sizes), until it starts
        self._prewarm_plan = None
        self._prewarm_thread = None
        self.last_loss = None
        self.remesh_count = 0
        self._preempted = False
        self._output_dir = output_dir
        self._recovery_t0: Optional[float] = None
        self._wedge_grace_s = wedge_grace_s
        self._epoch_stale_since: Optional[float] = None
        self._watchdog_started = False
        # set while the main thread polls the confirmation barrier: it is
        # then live and epoch-aware, so the watchdog leaves it alone
        self._in_rendezvous_wait = False
        self.step_timer = profiler_lib.StepTimer()
        programs_lib.default_program_registry().bind_step_rate(
            "worker_train_step_many"
            if self.steps_per_execution > 1 else "worker_train_step",
            lambda: self.step_timer.steps_per_sec,
            steps_per_execution=self.steps_per_execution,
        )
        # one rank writes scalars: every rank holds the same state
        self._summary = SummaryWriter(
            tensorboard_dir if (tensorboard_dir and process_id == 0)
            else None)
        self._profile_dir = profile_dir
        self._profiled = False
        self.sample_features = None
        self.predictions = {}

    # ---- runtime lifecycle --------------------------------------------

    def setup(self) -> None:
        """Join the group and build the trainer on this rank's device."""
        if self.num_processes > 1 and not self._watchdog_started:
            # before the join: a rank blocked joining a group of a newer
            # epoch can only be saved by a process restart
            self._watchdog_started = True
            threading.Thread(target=self._watchdog, daemon=True).start()
        self.mesh = self._given_mesh or mesh_lib.create_mesh(
            self.num_processes, self.process_id, self._device,
            self._coordinator, init_timeout_s=self.INIT_TIMEOUT_S,
            collective_timeout_s=self._wedge_grace_s)
        if self._saver is None and self._saver_factory is not None:
            self._saver = self._saver_factory()
        self.trainer = Trainer(
            model=self.spec.model, optimizer=self.spec.optimizer,
            loss_fn=self.spec.loss, use_bf16=self._use_bf16,
            device=self.mesh.device,
            param_sharding_fn=self.spec.param_sharding)
        self.trainer.phase_timer = _phase_timer
        logger.info("SPMD rank %d/%d up on %s (backend %s), epoch %d",
                    self.process_id, self.num_processes, self.mesh.device,
                    self.mesh.backend or "none", self._epoch)

    def _ensure_state(self, batch) -> None:
        if self.sample_features is None:
            # one host row, kept for export signatures
            self.sample_features = first_rows(batch["features"])
        if self.state is not None:
            return
        checking = self._check_newest_step()
        self.state = self.trainer.init_state_global(
            self._seed, batch["features"], self.mesh)
        self._maybe_prewarm(batch)
        self._restore(checking)

    def _check_newest_step(self):
        """Rank 0 starts checking the newest committed step against its
        manifest on a thread, so the hash of its files runs beside the
        state's init (hashlib and file reads release the GIL): (step, a
        future of `verify_step`), or None."""
        if self._saver is None or not self.is_leader:
            return None
        steps = committed_steps(self._saver.checkpoint_dir)
        if not steps:
            return None
        executor = ThreadPoolExecutor(max_workers=1)
        future = executor.submit(verify_step, self._saver.checkpoint_dir,
                                 steps[-1])
        executor.shutdown(wait=False)
        return steps[-1], future

    def _restore(self, checking=None) -> None:
        """Every rank restores the same step, or falls back together:
        rank 0 checks the committed steps newest first against their
        manifests and sends the first intact one to every rank, each rank
        loads it, and the group moves to the next older intact step
        unless every rank loaded it.  A step older than the one restored
        is never read.  When every intact step fails on some rank, the
        load error raises on all of them.  `checking` is the check that
        `_check_newest_step` started."""
        if self._saver is None:
            return

        def intact(step):
            if checking is not None and step == checking[0]:
                return checking[1].result()
            return verify_step(self._saver.checkpoint_dir, step)

        # newest first; checked one at a time, on rank 0 only
        candidates = (iter(reversed(committed_steps(
            self._saver.checkpoint_dir))) if self.is_leader else iter(()))
        tried = []
        while True:
            step = next((s for s in candidates if intact(s)), None)
            got = collectives.broadcast_ints(
                [] if step is None else [step], self.mesh)
            if not got:
                break
            step = got[0]
            tried.append(step)
            error = None
            try:
                self._saver.load_step_into(self.state, step)
            except LOAD_ERRORS as exc:
                error = exc
            if collectives.all_true(error is None, self.mesh):
                logger.info("Rank %d restored checkpoint step %d",
                            self.process_id, step)
                return
            logger.warning(
                "checkpoint step %d did not restore on every rank (here: "
                "%s); the group falls back to the previous step", step,
                error or "loaded")
        if tried:
            raise RuntimeError(
                f"no checkpoint step of {tried} restored on every rank")

    def _maybe_prewarm(self, batch) -> None:
        """Plan the compile of the train step ahead for the world sizes a
        failure would leave (world - 1 and world / 2): its abstract
        compile records the cost and builds the kernel libraries that
        world's step loads into the library cache
        (`--compilation_cache_dir`), so a relaunched rank of that world
        loads them instead of building.  The captured CUDA graph is not
        handed on: it lives in the process that captured it.  Once,
        after the first init; a group of more than one rank only; a
        failure is logged and never fails the task.  It runs in the
        background from the end of the rank's first task
        (`_start_prewarm`): tracing on fake tensors holds the
        interpreter lock, which would slow the restore and the first
        steps that a recovery waits for.  In the port's zoo no world size
        changes the libraries a step loads (the flash kernels are chosen
        by dtype, head size and alignment, the scatter-add by device),
        and the first task's steps have loaded them: the libraries the
        prewarm names are in the cache already, and what it adds is the
        cost record of that world's step in the ledger."""
        if self.num_processes <= 1 or getattr(self, "_prewarmed", False):
            return
        self._prewarmed = True
        try:
            worlds = sorted({self.num_processes - 1,
                             self.num_processes // 2}
                            - {0, self.num_processes})
            if not worlds or "labels" not in batch:
                # prediction-only feeds carry no labels; the train step
                # (the thing worth prewarming) is not on their path
                return
            local_rows = len(np.asarray(batch["labels"]))
            rows = self.minibatch_size

            def zeros_like_rows(a):
                a = np.asanyarray(a)
                if a.ndim == 0 or a.shape[0] != local_rows:
                    return a
                return np.zeros((rows,) + a.shape[1:], a.dtype).view(
                    type(a))

            sample = {
                "features": map_host_batch(zeros_like_rows,
                                           batch["features"]),
                "labels": zeros_like_rows(batch["labels"]),
            }
            logger.info("elastic prewarm: the train step for %s-rank "
                        "worlds, after the first task",
                        "/".join(str(w) for w in worlds))
            self._prewarm_plan = (sample, worlds)
        except Exception:  # advisory path: never fail the task for it
            logger.exception("elastic prewarm setup skipped")

    def _start_prewarm(self) -> None:
        """Start the planned prewarm (`_maybe_prewarm`), once."""
        plan, self._prewarm_plan = self._prewarm_plan, None
        if plan is None:
            return
        try:
            self._prewarm_thread = self.trainer.prewarm_for_device_counts(
                *plan)
        except Exception:  # advisory path: never fail the task for it
            logger.exception("elastic prewarm skipped")

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0

    # ---- wedge watchdog --------------------------------------------------
    # A collective whose peer died may hang rather than fail (NCCL does).
    # The main loop only looks at the epoch between tasks, so a rank stuck
    # inside a collective when the epoch moves is restarted by this
    # thread: epoch past ours for longer than the grace -> exit, and the
    # pod manager relaunches the process for the new topology.

    def _watchdog(self, poll_s: float = 2.0) -> None:
        while True:
            time.sleep(poll_s)
            try:
                spec = self._client.get_cluster_spec(
                    pb.GetClusterSpecRequest(worker_id=self.worker_id))
            except Exception:
                continue  # master briefly unreachable
            if spec.rendezvous_id <= self._epoch or self._in_rendezvous_wait:
                self._epoch_stale_since = None
                continue
            now = time.time()
            if self._epoch_stale_since is None:
                self._epoch_stale_since = now
                continue
            if now - self._epoch_stale_since > self._wedge_grace_s:
                logger.error(
                    "Rank %d wedged: epoch moved %d -> %d but the main "
                    "loop has not re-rendezvoused in %.0fs; restarting "
                    "the process", self.process_id, self._epoch,
                    spec.rendezvous_id, now - self._epoch_stale_since)
                self.log_launches()
                os._exit(self.WEDGED_EXIT_CODE)

    # ---- main loop -----------------------------------------------------

    def drain_and_stop(self) -> None:
        """Maintenance-notice hook (thread-safe): flag only; the main loop
        drains at its next task boundary."""
        self._preempted = True

    def run(self) -> bool:
        try:
            return self._run()
        finally:
            # a prewarm still running in the background ends before the
            # interpreter does (a thread torn down inside torch aborts
            # the process)
            if self._prewarm_thread is not None:
                self._prewarm_thread.join(timeout=self.PREWARM_JOIN_S)

    def _run(self) -> bool:
        if self.trainer is None:
            self.setup()
        seq = 0
        while True:
            if self._preempted:
                logger.info("Rank %d stopping at a task boundary "
                            "(preemption/maintenance notice)",
                            self.process_id)
                if self.num_processes == 1 and self._saver is not None:
                    self._save()
                    self._saver.wait_until_finished()
                return False
            resp = self._rpc_policy.call(
                lambda: self._client.get_spmd_task(pb.GetSpmdTaskRequest(
                    worker_id=self.worker_id, rendezvous_id=self._epoch,
                    seq=seq)),
                description="get_spmd_task")
            if resp.job_finished:
                logger.info("Job finished; SPMD rank %d exiting",
                            self.process_id)
                self._flush_predictions()
                if self.is_leader and self.step_timer.steps_per_sec:
                    self.step_timer.log(f"rank {self.process_id}: ")
                self._summary.close()
                if self._saver is not None:
                    self._saver.wait_until_finished()
                invoke_callbacks(self.spec.callbacks, "on_job_end")
                self.log_launches(digest=True)
                return True
            if resp.epoch_stale:
                logger.info("Rank %d: epoch %d stale; re-rendezvous",
                            self.process_id, self._epoch)
                if not self._re_rendezvous():
                    return False
                seq = 0
                continue
            task = resp.task
            if task.task_id < 0 or task.type == pb.WAIT:
                time.sleep(self._wait_sleep_s)
                continue
            try:
                self._process_task(task)
                self._start_prewarm()
            except Exception:
                if self.num_processes > 1 and self._epoch_moved():
                    logger.exception(
                        "Rank %d: task %d failed while the epoch moved "
                        "(a peer left the group)", self.process_id,
                        task.task_id)
                    self._restart_for_topology_change()
                raise
            seq += 1

    def _epoch_moved(self) -> bool:
        """True when the rendezvous epoch passes ours within the wedge
        grace: the pod manager has seen a member leave."""
        deadline = time.time() + self._wedge_grace_s
        while True:
            try:
                spec = self._client.get_cluster_spec(
                    pb.GetClusterSpecRequest(worker_id=self.worker_id))
                if spec.rendezvous_id != self._epoch:
                    return True
            except Exception:
                pass   # master briefly unreachable
            if time.time() > deadline:
                return False
            time.sleep(self._wait_sleep_s)

    def _process_task(self, task: pb.Task) -> int:
        # no per-rank failure report: a failed collective step is the
        # whole group's, and the epoch bump recovers it
        invoke_callbacks(self.spec.callbacks, "on_task_start", task)
        records = 0
        if task.type == pb.TRAINING:
            records = self._train_task(task)
            if self.is_leader:
                with _phase_timer.phase("report"):
                    self._data_service.report_task(
                        task, records=records,
                        model_version=int(self.state.step),
                        telemetry=self._telemetry_payload())
                try:
                    self._client.report_version(pb.ReportVersionRequest(
                        worker_id=self.worker_id,
                        model_version=int(self.state.step)))
                except Exception:
                    pass
        elif task.type == pb.EVALUATION:
            if not self._has_trained_state():
                # never score random parameters; the condition is the
                # same on every rank, and the leader re-queues the task
                if self.is_leader:
                    self._data_service.report_task(
                        task, err="no trained state for evaluation",
                        transient=True)
            else:
                records = self._evaluate_task(task)
                if self.is_leader:
                    self._data_service.report_task(task, records=records)
        elif task.type == pb.PREDICTION:
            records = self._predict_task(task)
            if self.is_leader:
                self._data_service.report_task(task, records=records)
        elif task.type == pb.SAVE_MODEL:
            self._save()
            # a sharded state's export gathers on every rank; the leader
            # writes and reports
            if self.is_leader or is_sharded(self.state):
                try:
                    export_for_task(self.state, self.spec, task,
                                    sample_features=self.sample_features)
                except RuntimeError as exc:
                    if self.is_leader:
                        self._data_service.report_task(task, err=str(exc))
                else:
                    if self.is_leader:
                        self._data_service.report_task(task, records=0)
        else:
            logger.warning("SPMD worker ignoring task type %s", task.type)
            if self.is_leader:
                self._data_service.report_task(task, records=0)
        invoke_callbacks(self.spec.callbacks, "on_task_end", task, records)
        return records

    def _telemetry_payload(self) -> dict:
        """The leader's telemetry on its task reports, the Worker's
        shape (int64 on the wire, rates in milli units)."""
        payload = {
            "steps_per_sec_milli": int(self.step_timer.steps_per_sec * 1000),
            "model_step": int(self.state.step) if self.state else 0,
        }
        for phase, ms in _phase_timer.totals_milli().items():
            payload[f"phase_{phase}_ms"] = ms
        return payload

    def _train_task(self, task: pb.Task) -> int:
        if self._profile_dir and not self._profiled:
            self._profiled = True
            cuda = self.mesh.device.type == "cuda"
            with profiler_lib.trace(self._profile_dir, cuda=cuda,
                                    name=f"task-{task.task_id}"):
                with profiler_lib.annotate(f"task-{task.task_id}"):
                    records = self._train_task_inner(task)
                if cuda:
                    torch.cuda.synchronize(self.mesh.device)
            return records
        return self._train_task_inner(task)

    def _stage(self, batch, is_local: bool, local_start: int):
        """This rank's rows of a global batch on its device."""
        with _phase_timer.phase("h2d_stage"):
            if is_local:
                return mesh_lib.make_global_batch_from_local(
                    batch, self.mesh, self.minibatch_size, local_start,
                    self.trainer.stage_batch)
            return mesh_lib.make_global_batch(batch, self.mesh,
                                              self.trainer.stage_batch)

    def _train_task_inner(self, task: pb.Task) -> int:
        records = 0
        start, stop = mesh_lib.local_batch_range(self.mesh,
                                                 self.minibatch_size)
        feed, feed_bulk = self._feeds()
        batches = self._data_service.local_batches_for_task(
            task, self.minibatch_size, feed, feed_bulk, start, stop)

        def mark_recovered():
            if self._recovery_t0 is not None:
                logger.info("elastic recovery: %.2fs (epoch %d, world %d, "
                            "resumed at step %d)",
                            time.time() - self._recovery_t0, self._epoch,
                            self.num_processes, int(self.state.step))
                self._recovery_t0 = None

        def single_step(shard):
            self.state, loss = self.trainer.train_on_global_batch(
                self.state, shard, self.mesh)
            self.last_loss = loss
            mark_recovered()
            self.step_timer.tick()
            _phase_timer.step_done()
            self._maybe_checkpoint()

        # single-step dispatch stages batch k+1 while batch k runs
        device_stage = None
        if self.steps_per_execution == 1:
            def device_stage(item):
                batch, real, is_local = item
                return batch, real, is_local, self._stage(batch, is_local,
                                                          start)
        pending = []
        for item in prefetch_batches(batches, device_stage=device_stage,
                                     phase_timer=_phase_timer):
            batch, real, is_local = item[:3]
            self._ensure_state(batch)
            records += real
            if self.steps_per_execution == 1:
                single_step(item[3])
                continue
            if is_local and self._recovery_t0 is None:
                pending.append(batch)
                if len(pending) == self.steps_per_execution:
                    shards = [self._stage(b, True, start) for b in pending]
                    pending = []
                    self.state, losses = \
                        self.trainer.train_on_global_batch_stack(
                            self.state, shards, self.mesh)
                    self.last_loss = losses[-1]
                    mark_recovered()
                    for _ in shards:
                        self.step_timer.tick()
                        _phase_timer.step_done()
                    self._maybe_checkpoint(stride=len(shards))
                continue
            # data order: a padded tail never trains before held batches
            for held in pending:
                single_step(self._stage(held, True, start))
            pending = []
            single_step(self._stage(batch, is_local, start))
        for held in pending:   # the task's tail of a group
            single_step(self._stage(held, True, start))
        _phase_timer.flush()
        if self.last_loss is not None and self._summary.active:
            self._summary.scalars(
                {"train/loss": float(self.last_loss),
                 "train/steps_per_sec": self.step_timer.steps_per_sec},
                step=int(self.state.step))
        return records

    def _evaluate_task(self, task: pb.Task) -> int:
        records = 0
        all_labels, all_preds = [], []
        eval_state, actual_version = None, None
        feed, feed_bulk = self._feeds()
        for batch, real in self._data_service.batches_for_task(
                task, self.minibatch_size, feed, feed_bulk=feed_bulk):
            self._ensure_state(batch)
            if actual_version is None:
                # the same on every rank (same state, same files), so
                # every rank restores, or falls back, together
                eval_state, actual_version = state_at_version(
                    self.state, self._saver, task.model_version)
            preds = self.trainer.predict_on_global_batch(
                eval_state, self._stage(batch, False, 0), self.mesh)
            all_labels.append(np.asarray(batch["labels"])[:real])
            all_preds.append(preds[:real])
            records += real
        if records and self.is_leader:
            labels = np.concatenate(all_labels)
            preds = np.concatenate(all_preds)
            version = (actual_version if actual_version is not None
                       and actual_version >= 0 else int(self.state.step))
            metrics = {name: float(fn(labels, preds))
                       for name, fn in self.spec.eval_metrics.items()}
            report_evaluation_with_samples(
                self._client, self.worker_id, version, metrics, records,
                labels, preds, task_id=task.task_id)
        return records

    def _predict_task(self, task: pb.Task) -> int:
        records = 0
        rows = []
        processor = self.spec.prediction_outputs_processor
        feed, feed_bulk = self._feeds()
        for batch, real in self._data_service.batches_for_task(
                task, self.minibatch_size, feed, feed_bulk=feed_bulk):
            self._ensure_state(batch)
            preds = self.trainer.predict_on_global_batch(
                self.state, self._stage(batch, False, 0), self.mesh)
            rows.append(preds[:real])
            records += real
        if rows and processor is not None and self.is_leader:
            # leader only, so the zoo's sink sees each batch once
            for chunk in rows:
                processor.process(chunk, self.worker_id)
        if rows:
            # keyed by task: a task run again after a restart replaces
            # its rows; the leader makes each task's rows durable at once
            self.predictions[task.task_id] = np.concatenate(rows)
            if self.is_leader and self._output_dir:
                os.makedirs(self._output_dir, exist_ok=True)
                np.save(os.path.join(self._output_dir,
                                     f"part-{task.task_id:05d}.npy"),
                        self.predictions[task.task_id])
        return records

    def _flush_predictions(self) -> None:
        """A predict job's part files, joined into predictions.npy."""
        if not self.is_leader or not self._output_dir:
            return
        parts = sorted(glob.glob(os.path.join(self._output_dir,
                                              "part-*.npy")))
        if not parts:
            return
        merged = np.concatenate([np.load(p) for p in parts])
        np.save(os.path.join(self._output_dir, "predictions.npy"), merged)
        logger.info("Merged %d prediction part files (%d rows)",
                    len(parts), len(merged))

    def _has_trained_state(self) -> bool:
        if self.state is not None and int(self.state.step) > 0:
            return True
        return self._saver is not None and \
            self._saver.latest_step() is not None

    # ---- elasticity ----------------------------------------------------

    def log_launches(self, digest: bool = False) -> None:
        """Log this process's kernel launches as one JSON line, with the
        state's step and, when `digest` (the job's end), its sha256."""
        line = {"worker_id": self.worker_id, "rank": self.process_id,
                "epoch": self._epoch, "world": self.num_processes,
                "launches": kernel_launches(),
                "kernel_builds": kernel_builds()}
        if self.state is not None:
            line["step"] = int(self.state.step)
            if digest:
                line["state_sha256"] = state_digest(self.state)
        logger.info("%s%s", KERNEL_LAUNCHES_TAG, json.dumps(line))

    def _restart_for_topology_change(self) -> None:
        """Exit for a relaunch at a new topology, after a bounded wait
        for the leader's checkpoint writes in flight."""
        saver = self._saver
        if saver is not None:
            flusher = threading.Thread(target=saver.wait_until_finished,
                                       daemon=True)
            flusher.start()
            flusher.join(timeout=10.0)
        logger.info("Rank %d: topology change; restarting the process",
                    self.process_id)
        self.log_launches()
        os._exit(self.TOPOLOGY_RESTART_EXIT_CODE)

    def _re_rendezvous(self, settle_timeout_s: float = 60.0) -> bool:
        """Membership changed.  A group of several processes restarts
        its process (a fresh group, a fresh restore: no rank carries
        state of the old group).  Only a topology that stays one process
        rebuilds in place."""
        # the decision comes before any barrier: a rank that confirmed
        # the new epoch and then exited would release the barrier for a
        # group whose members are gone
        if self.num_processes > 1:
            self._restart_for_topology_change()
        self._recovery_t0 = time.time()
        peek = self._rpc_policy.call(
            lambda: self._client.get_cluster_spec(
                pb.GetClusterSpecRequest(worker_id=self.worker_id)),
            description="get_cluster_spec.peek")
        if peek.world_size > 1 or peek.expected_world_size > 1:
            self._restart_for_topology_change()
        self._in_rendezvous_wait = True
        try:
            spec, me = wait_for_confirmed_epoch(
                self._client, self.worker_id, poll_s=self._wait_sleep_s,
                timeout_s=settle_timeout_s, rpc_policy=self._rpc_policy)
        finally:
            self._in_rendezvous_wait = False
        if spec is None:
            logger.warning("Worker %d: no confirmed epoch within %.0fs; "
                           "restarting", self.worker_id, settle_timeout_s)
            return False
        if me is None or spec.world_size == 0:
            logger.warning("Worker %d evicted at epoch %d; exiting",
                           self.worker_id, spec.rendezvous_id)
            return False
        self._epoch = spec.rendezvous_id
        self.process_id = me.rank
        self.num_processes = spec.world_size
        self._coordinator = spec.coordinator_address or self._coordinator
        self.state = None  # init + restore on the next batch
        self.trainer = None
        self.setup()
        self.remesh_count += 1
        logger.info("Rank %d re-rendezvoused: epoch %d, world %d (%.2fs)",
                    self.process_id, self._epoch, self.num_processes,
                    time.time() - self._recovery_t0)
        return True

    # ---- checkpoints -----------------------------------------------------

    def save_checkpoint_and_flush(self) -> None:
        """The preemption hook.  A rank of several sets its drain flag
        only: a signal lands on each rank at another point, and a save
        then would race the step; periodic checkpoints and re-leased
        tasks cover the recovery.  A single rank saves and waits."""
        if self.num_processes > 1:
            self._preempted = True
            logger.info("Rank %d preempted; draining at the next task "
                        "boundary", self.process_id)
            return
        self._save()
        if self._saver is not None:
            self._saver.wait_until_finished()

    def _save(self) -> None:
        # the leader writes; every rank holds the same state, or its
        # shards, which every rank's save gathers
        if self._saver is not None and self.state is not None and (
                self.is_leader or is_sharded(self.state)):
            self._saver.save(self.state)

    def _maybe_checkpoint(self, stride: int = 1) -> None:
        # a crossing check: a K-step dispatch may jump past a multiple
        if (self._checkpoint_steps
                and int(self.state.step) % self._checkpoint_steps < stride):
            self._save()

    def _feeds(self):
        """(feed, feed_bulk) in the resolved wire format."""
        metadata = getattr(self._reader, "metadata", {})
        fn = (self.spec.feed_bulk_compact if self.compact_wire
              else self.spec.feed_bulk)

        def feed(records):
            return self.spec.feed(records, metadata)

        if fn is None:
            return feed, None
        return feed, lambda buf, sizes: fn(buf, sizes, metadata)

