"""Pod manager: elastic scheduling of worker pods (the port of the JAX
package's master/pod_manager.py).

Creates the worker pods, watches their events, relaunches failed pods
within a budget per replacement chain, recovers a lost worker's tasks
and drives the rendezvous epoch.  Exit codes 43 (the wedge watchdog) and
44 (a topology restart) are restarts the worker asked for and relaunch
without charge.  The restartable unit can be a group of
`workers_per_group` workers (a slice whose collectives stall when one
member dies): a real failure of one member restarts its peers too.
`scale_up`, `scale_down` (whole groups) and `evict_worker` are the
policy engine's actuators; a replacement master adopts the job's live
pods, their groups read back from the `elasticdl-group` label.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from elasticdl_tpu_torch.common import faults, resilience
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common.constants import PodStatus, PodType
from elasticdl_tpu_torch.common.k8s_client import AbstractK8sClient, PodSpec
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)


def _is_not_found(exc: Exception) -> bool:
    """True when a k8s-client error means 'pod already gone' (ApiException
    status 404 or an equivalent message) as opposed to a transient
    apiserver failure worth retrying."""
    if getattr(exc, "status", None) == 404:
        return True
    return "not found" in str(exc).lower()


class PodManager:
    def __init__(
        self,
        k8s_client: AbstractK8sClient,
        task_manager=None,
        rendezvous_server=None,
        job_name: str = "elasticdl",
        num_workers: int = 1,
        image: str = "",
        worker_command=None,
        relaunch_on_worker_failure: int = 3,
        worker_resources: Optional[Dict[str, str]] = None,
        priority_class: str = "",
        on_job_abort=None,
        recovery_clock=None,
        volumes: Optional[List[Dict[str, str]]] = None,
        workers_per_group: int = 1,
    ):
        self._k8s = k8s_client
        self._tm = task_manager
        self._rendezvous = rendezvous_server
        self._job_name = job_name
        self._num_workers = num_workers
        self._image = image
        self._worker_command = worker_command or (lambda wid: [])
        self._relaunch_budget = relaunch_on_worker_failure
        self._resources = worker_resources or {}
        self._priority_class = priority_class
        self._volumes = volumes or []
        # Group-granular failure handling: one lost host stalls the
        # collectives of every rank it shares a slice with, so
        # the schedulable/restartable unit is the group of
        # `workers_per_group` workers sharing a slice.  When one member
        # truly fails, the surviving members are proactively restarted
        # (they are wedged in dead collectives anyway) instead of each
        # waiting out its own wedge-watchdog grace.  1 = per-worker
        # granularity (the reference's model).
        self._workers_per_group = max(1, workers_per_group)
        self._group_of: Dict[int, int] = {}
        self._next_slot = 0
        # pod names we deleted as part of a group restart: their DELETED
        # events relaunch WITHOUT charging the chain budget
        self._group_restart_pods: set = set()
        # Fired when the last worker dies with its relaunch chain exhausted
        # — without it a fully-crashed job would hang the master forever.
        self._on_job_abort = on_job_abort or (lambda reason: None)
        self._recovery_clock = recovery_clock

        self._lock = threading.Lock()
        self._next_worker_id = 0
        self._pod_by_worker: Dict[int, str] = {}
        self._worker_by_pod: Dict[str, int] = {}
        self._relaunch_count: Dict[int, int] = {}
        self._phases: Dict[str, str] = {}
        self.stopped = False
        # chaos-run observability: registry-backed so snapshot(),
        # /metrics, and `elasticdl top` all read the same series
        self.metrics_registry = metrics_lib.MetricsRegistry()
        self._losses_seen = self.metrics_registry.counter(
            "master_pod_losses_total",
            "worker pods lost (preemption, failure, scale-down)",
        )
        self._relaunches = self.metrics_registry.counter(
            "master_pod_relaunches_total",
            "replacement worker pods launched after a loss",
        )
        self.metrics_registry.gauge_fn(
            "master_workers_alive_count",
            lambda: float(len(self._pod_by_worker)),
            "workers currently in the membership",
        )
        self._evictions = self.metrics_registry.counter(
            "master_pod_evictions_total",
            "straggler pods evicted by the policy engine",
        )
        self._launch_failures = self.metrics_registry.counter(
            "master_pod_launch_failures_total",
            "worker launches absorbed after apiserver create failures",
        )
        # Shared resilience policy for apiserver deletes (was a bespoke
        # single-retry loop): NotFound is terminal, anything else gets one
        # backed-off retry before we fall back to the wedge watchdog.
        self._delete_policy = resilience.RetryPolicy(
            initial_backoff_s=0.1,
            max_backoff_s=1.0,
            max_elapsed_s=None,
            max_attempts=2,
            retryable=lambda exc: not _is_not_found(exc),
        )

    # ---- lifecycle -----------------------------------------------------

    def start(self):
        # Master fault tolerance: a REPLACEMENT master adopts the job's
        # live worker pods (listed by label) instead of double-launching —
        # the workers keep training through the master outage and
        # reconnect via their RPC retry loops.
        adopted = 0
        failed_history = 0
        with self._lock:
            listed = self._k8s.list_pods()
            failed_history = sum(
                1
                for _, wid, phase, _addr in listed
                if wid >= 0 and phase == PodStatus.FAILED
            )
            for name, worker_id, phase, address in listed:
                if worker_id < 0:
                    continue
                # Every listed worker id is burned regardless of phase: a
                # Failed/Succeeded pod OBJECT still exists under its name
                # (restartPolicy=Never), and re-launching under the same
                # id would collide with it (409 AlreadyExists on real
                # Kubernetes).
                self._next_worker_id = max(
                    self._next_worker_id, worker_id + 1
                )
                if phase not in (PodStatus.PENDING, PodStatus.RUNNING):
                    continue
                self._pod_by_worker[worker_id] = name
                self._worker_by_pod[name] = worker_id
                self._phases[name] = phase
                if self._rendezvous is not None and phase == PodStatus.RUNNING:
                    self._rendezvous.add_worker(worker_id, address)
                # Seed the relaunch chain with the job's visible failure
                # history: without this, every master restart would reset
                # every budget and a crash-looping worker co-located with
                # master churn would be relaunched forever, never reaching
                # the abort failsafe.  (Approximation: listed Failed pods
                # can't be attributed to chains, so each adopted chain is
                # charged the global count — conservative toward abort.)
                if failed_history:
                    self._relaunch_count[worker_id] = max(
                        self._relaunch_count.get(worker_id, 0),
                        failed_history,
                    )
                adopted += 1
            # Rebuild slice groups for adopted workers from the
            # `elasticdl-group` pod label each launch stamps (exact
            # identity across master failover); pods without the label —
            # older jobs, clients without label storage — fall back to
            # packing in sorted-id order, whose worst case is a spurious
            # budget-free peer restart.
            unlabeled = []
            for wid in sorted(self._pod_by_worker):
                labels = {}
                try:
                    labels = self._k8s.get_pod_labels(
                        self._pod_by_worker[wid]
                    )
                except Exception as exc:
                    # demoted to packed grouping below — log it, or the
                    # resulting mis-grouped restart is undebuggable
                    logger.warning(
                        "Label lookup failed for adopted pod %s (%s); "
                        "falling back to packed group assignment",
                        self._pod_by_worker[wid], exc,
                    )
                tag = str(labels.get("elasticdl-group", ""))
                if tag.isdigit():
                    self._group_of[wid] = int(tag)
                else:
                    unlabeled.append(wid)
            base = max(self._group_of.values(), default=-1) + 1
            for i, wid in enumerate(unlabeled):
                self._group_of[wid] = base + i // self._workers_per_group
            self._next_slot = (
                max(self._group_of.values(), default=-1) + 1
            ) * self._workers_per_group
            if self._rendezvous is not None and adopted:
                self._rendezvous.set_expected(len(self._pod_by_worker))
        if adopted:
            logger.info("Adopted %d live worker pods", adopted)
        self._k8s.start_watch(self._event_cb)
        # Make-up launches fill VACANCIES in partially-occupied adopted
        # groups first (a worker that died alongside its master must
        # rejoin its slice, not open a singleton group); only then do new
        # slots open new groups.
        with self._lock:
            occupancy: Dict[int, int] = {}
            for g in self._group_of.values():
                occupancy[g] = occupancy.get(g, 0) + 1
            vacancies = [
                g
                for g, count in sorted(occupancy.items())
                for _ in range(self._workers_per_group - count)
                if count < self._workers_per_group
            ]
        for _ in range(max(0, self._num_workers - adopted)):
            group = vacancies.pop(0) if vacancies else None
            self._launch_worker(group=group)

    def stop(self):
        self.stopped = True
        with self._lock:
            pods = list(self._worker_by_pod)
        for pod in pods:
            self._k8s.delete_pod(pod)

    # ---- scaling -------------------------------------------------------

    def scale_up(self, n: int = 1) -> int:
        """Launch n new workers; returns how many actually launched.
        Apiserver failures are absorbed per-launch — they charge no
        relaunch chain and leave no phantom membership (_launch_worker),
        so the policy loop simply retries from real state next tick."""
        launched = 0
        for _ in range(n):
            if self.stopped:
                break
            if self._launch_worker() is not None:
                launched += 1
        return launched

    def scale_down(self, n: int = 1, prefer=()) -> List[int]:
        """Remove n workers, rounded DOWN to whole `workers_per_group`
        slice groups — deleting part of a group would only wedge the
        survivors in dead collectives.  Victim groups are ranked:
        groups containing a `prefer` worker (flagged stragglers, idle
        workers) first, then groups with in-flight vacancies (fewest
        live members — already below strength, cheapest to retire), then
        newest.  Graceful: victims' in-flight tasks are recovered via
        the DELETED event path.  Returns the worker ids removed."""
        if self.stopped or n <= 0:
            return []
        prefer = set(prefer)
        wpg = self._workers_per_group
        with self._lock:
            if wpg <= 1:
                ranked = sorted(
                    self._pod_by_worker,
                    key=lambda w: (0 if w in prefer else 1, -w),
                )
                victims = ranked[:n]
            else:
                groups: Dict[int, List[int]] = {}
                for wid in self._pod_by_worker:
                    groups.setdefault(
                        self._group_of.get(wid, -1), []
                    ).append(wid)
                n_groups = n // wpg
                if n_groups <= 0:
                    logger.info(
                        "scale_down(%d) rounds to zero whole groups "
                        "(workers_per_group=%d); refusing a partial-"
                        "group delete", n, wpg,
                    )
                    return []
                ranked_groups = sorted(
                    groups,
                    key=lambda g: (
                        0 if any(w in prefer for w in groups[g]) else 1,
                        len(groups[g]),
                        -g,
                    ),
                )
                victims = [
                    w
                    for g in ranked_groups[:n_groups]
                    for w in sorted(groups[g])
                ]
            pods = [(w, self._pod_by_worker[w]) for w in victims]
        removed: List[int] = []
        for w, pod in pods:
            try:
                faults.fire(faults.POINT_POD_DELETE)
                self._delete_policy.call(
                    lambda: self._k8s.delete_pod(pod),
                    description="scale_down_delete",
                )
            except (resilience.RetryBudgetExhausted,
                    faults.InjectedFault) as exc:
                logger.warning(
                    "scale_down: could not delete %s (%s); it stays in "
                    "the fleet", pod, exc,
                )
                continue
            except Exception as exc:
                if not _is_not_found(exc):
                    raise
            removed.append(w)
        return removed

    def evict_worker(self, worker_id: int) -> bool:
        """Policy-driven eviction of a flagged straggler: delete its pod
        so the DELETED event relaunches it budget-free (chronic slowness
        is not a crash) on fresh capacity, its leased tasks recovering
        via the loss path.  Group-aware: the victim's slice peers are
        restarted first, exactly as for a real member failure — they
        would wedge in the dead collective otherwise.  Returns False
        when the worker is unknown, the manager is stopped, or the
        apiserver refused the delete."""
        if self.stopped:
            return False
        with self._lock:
            pod = self._pod_by_worker.get(worker_id)
            if pod is None:
                return False
            group = self._group_of.get(worker_id)
        try:
            # Fire before acting so an injected apiserver error aborts
            # the eviction atomically — no half-restarted group.
            faults.fire(faults.POINT_POD_DELETE)
        except faults.InjectedFault as exc:
            logger.warning(
                "evict of worker %d aborted by injected apiserver "
                "error: %s", worker_id, exc,
            )
            return False
        with self._lock:
            if self._pod_by_worker.get(worker_id) != pod:
                return False  # lost/retired while we weren't holding
            self._group_restart_pods.add(pod)
        self._restart_group_peers(group, lost_worker=worker_id)
        try:
            self._delete_policy.call(
                lambda: self._k8s.delete_pod(pod),
                description="evict_pod",
            )
        except resilience.RetryBudgetExhausted as exc:
            logger.warning(
                "evict: could not delete %s (%s); straggler stays until "
                "the next policy tick", pod, exc,
            )
            with self._lock:
                self._group_restart_pods.discard(pod)
            return False
        except Exception as exc:
            if not _is_not_found(exc):
                raise
            # Already gone: its own FAILED/DELETED event recovers it.
            with self._lock:
                self._group_restart_pods.discard(pod)
        self._evictions.inc()
        return True

    def _launch_worker(
        self, worker_id: Optional[int] = None,
        group: Optional[int] = None,
    ) -> Optional[int]:
        with self._lock:
            if self.stopped:
                return None
            if worker_id is None:
                worker_id = self._next_worker_id
                self._next_worker_id += 1
            if group is None:
                group = self._next_slot // self._workers_per_group
                self._next_slot += 1
            self._group_of[worker_id] = group
            pod_name = self._register_worker_locked(worker_id)
        spec = PodSpec(
            name=pod_name,
            pod_type=PodType.WORKER,
            worker_id=worker_id,
            image=self._image,
            command=self._worker_command(worker_id),
            resources=self._resources,
            priority_class=self._priority_class,
            volumes=self._volumes,
            # durable slice-group identity: a replacement master reads it
            # back during adoption (get_pod_labels), so group restarts
            # survive failover exactly, not by approximation
            labels={"elasticdl-group": str(group)},
        )
        logger.info("Launching %s", pod_name)
        try:
            faults.fire(faults.POINT_POD_CREATE)
            self._k8s.create_pod(spec)
        except Exception as exc:
            # Absorbed, not propagated: the pod never existed, so no
            # DELETED event will ever clean it up — unregister the
            # phantom membership here and charge NO relaunch chain.
            logger.warning("Launch of %s failed: %s", pod_name, exc)
            self._launch_failures.inc()
            with self._lock:
                self._pod_by_worker.pop(worker_id, None)
                self._worker_by_pod.pop(pod_name, None)
                self._group_of.pop(worker_id, None)
                self._relaunch_count.pop(worker_id, None)
                if self._rendezvous is not None:
                    self._rendezvous.set_expected(
                        len(self._pod_by_worker)
                    )
            return None
        return worker_id

    def _register_worker_locked(self, worker_id: int) -> str:
        pod_name = f"{self._job_name}-worker-{worker_id}"
        self._pod_by_worker[worker_id] = pod_name
        self._worker_by_pod[pod_name] = worker_id
        if self._rendezvous is not None:
            self._rendezvous.set_expected(len(self._pod_by_worker))
        return pod_name

    # ---- event handling ------------------------------------------------

    # Exit codes that mean "restart me, I did not crash": the wedge
    # watchdog (43) and clean topology-change restarts (44) from
    # worker/spmd.py.  They relaunch WITHOUT charging the chain's
    # failure budget — a handful of elasticity events must never
    # exhaust a healthy worker's budget.
    INTENTIONAL_RESTART_CODES = (43, 44)

    def _event_cb(self, pod_name: str, phase: str, address: str = "",
                  exit_code=None):
        try:
            faults.fire(faults.POINT_POD_WATCH)
        except faults.InjectedFault as exc:
            # A dropped/failed watch delivery: real watches miss events
            # too; the next status event (or pod relist) re-converges.
            logger.warning(
                "pod watch event for %s dropped (%s)", pod_name, exc
            )
            return
        worker_id = self._worker_by_pod.get(pod_name)
        if worker_id is None:
            return
        prev = self._phases.get(pod_name)
        self._phases[pod_name] = phase
        # Repeated RUNNING events are NOT deduped: real k8s assigns
        # pod.status.pod_ip after the first Running event, and add_worker
        # is idempotent on (worker_id, address) anyway.
        if phase == prev and phase != PodStatus.RUNNING:
            return
        if phase != prev:
            logger.info("Pod %s: %s -> %s", pod_name, prev, phase)
        if phase == PodStatus.RUNNING:
            if self._rendezvous is not None:
                self._rendezvous.add_worker(worker_id, address)
        elif phase in (PodStatus.FAILED, PodStatus.DELETED):
            self._on_worker_lost(
                worker_id, pod_name, phase, exit_code=exit_code
            )
        elif phase == PodStatus.SUCCEEDED:
            with self._lock:
                self._pod_by_worker.pop(worker_id, None)
                self._worker_by_pod.pop(pod_name, None)
                self._group_of.pop(worker_id, None)
                if self._rendezvous is not None:
                    self._rendezvous.set_expected(len(self._pod_by_worker))

    def _on_worker_lost(self, worker_id: int, pod_name: str, phase: str,
                        exit_code=None):
        if self._recovery_clock is not None and not self.stopped:
            self._recovery_clock.mark_loss()
        self._losses_seen.inc()
        # 1. failure detector -> task lease recovery (at-least-once)
        if self._tm is not None:
            self._tm.recover_tasks(worker_id)
        # 2. membership epoch bump -> workers re-mesh
        if self._rendezvous is not None:
            self._rendezvous.remove_worker(worker_id)
        with self._lock:
            group_restart = pod_name in self._group_restart_pods
            self._group_restart_pods.discard(pod_name)
            group = self._group_of.pop(worker_id, None)
            self._pod_by_worker.pop(worker_id, None)
            self._worker_by_pod.pop(pod_name, None)
            if self._rendezvous is not None:
                # Transiently lower until a relaunch re-registers; if the
                # chain is exhausted this IS the new target, so waiting
                # workers don't deadlock on a world size that cannot come.
                self._rendezvous.set_expected(len(self._pod_by_worker))
        # 3. relaunch within budget.  DELETED = intentional (scale-down)
        # and is not relaunched — EXCEPT deletes this manager issued
        # itself as part of a group restart, which relaunch budget-free.
        # The budget is tracked per replacement CHAIN: a replacement pod
        # inherits the failure count of the worker it replaces, so a
        # crash-looping worker fails the chain after `budget` relaunches
        # instead of looping forever under fresh ids.  Id allocation and
        # chain-count update happen in ONE critical section so two
        # near-simultaneous failures cannot under-count the chain.
        if self.stopped or (
            phase == PodStatus.DELETED and not group_restart
        ):
            return
        intentional = group_restart or (
            exit_code in self.INTENTIONAL_RESTART_CODES
        )
        with self._lock:
            count = self._relaunch_count.get(worker_id, 0)
            if not intentional and count >= self._relaunch_budget:
                logger.error(
                    "Worker %d exhausted relaunch budget (%d)",
                    worker_id, self._relaunch_budget,
                )
                new_id = None
                none_alive = not self._pod_by_worker
            else:
                # New worker id (reference: replacements get fresh ids);
                # id allocation + chain count in one critical section.
                # Intentional self-restarts (watchdog / topology change /
                # group restarts) inherit the chain count unchanged.
                new_id = self._next_worker_id
                self._next_worker_id += 1
                self._relaunch_count[new_id] = (
                    count if intentional else count + 1
                )
        if new_id is not None:
            # peers first: sweeping after the launch would catch the
            # fresh replacement in its own group's restart
            if not intentional:
                self._restart_group_peers(group, lost_worker=worker_id)
            # the replacement joins the lost worker's slice group
            self._relaunches.inc()
            self._launch_worker(new_id, group=group)
        elif none_alive:
            self._on_job_abort(
                f"all workers dead; worker {worker_id} exhausted its "
                f"relaunch budget ({self._relaunch_budget})"
            )

    def _restart_group_peers(self, group: Optional[int],
                             lost_worker: int) -> None:
        """Slice-granular recovery: a real failure of one group member
        means its peers are wedged in dead collectives.  Delete their
        pods now (marked, so the DELETED events relaunch budget-free)
        instead of letting each wait out its own wedge-watchdog grace —
        the group re-forms in one rendezvous epoch."""
        if self._workers_per_group <= 1 or group is None:
            return
        with self._lock:
            peers = [
                (w, self._pod_by_worker[w])
                for w, g in self._group_of.items()
                if g == group and w != lost_worker
                and w in self._pod_by_worker
            ]
            for _, pod in peers:
                self._group_restart_pods.add(pod)
        for w, pod in peers:
            logger.info(
                "Group %d restart: deleting peer worker %d (%s) of "
                "failed worker %d", group, w, pod, lost_worker,
            )
            # Shared resilience policy: transient apiserver errors get one
            # backed-off retry — losing the budget-free marker on a
            # transient failure would leave the wedged peer waiting out
            # its full wedge-watchdog grace.  NotFound means the peer is already gone (its
            # own watchdog beat us) — fine, its FAILED event relaunches
            # via the intentional-exit path.
            try:
                self._delete_policy.call(
                    lambda: self._k8s.delete_pod(pod),
                    description="delete_pod",
                )
            except resilience.RetryBudgetExhausted as exc:
                logger.warning(
                    "Group %d restart: could not delete peer %s "
                    "(%s); it will recover via its wedge watchdog",
                    group, pod, exc,
                )
                with self._lock:
                    self._group_restart_pods.discard(pod)
            except Exception as exc:
                if not _is_not_found(exc):
                    raise
                with self._lock:
                    self._group_restart_pods.discard(pod)

    # ---- introspection -------------------------------------------------

    def alive_workers(self):
        with self._lock:
            return sorted(self._pod_by_worker)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "alive": len(self._pod_by_worker),
                "losses_seen": int(self._losses_seen.value()),
                "relaunches": int(self._relaunches.value()),
                "evictions": int(self._evictions.value()),
                "launch_failures": int(self._launch_failures.value()),
            }
