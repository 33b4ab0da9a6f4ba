"""The serving fleet manager: N health-probed serving replicas behind
the master, with placement, relaunch, scaling and a rolling hot-reload
(the port of the JAX package's master/serving_fleet.py).

The master supervises the serving tier as it supervises training pods:
it places `--serving_replicas` replicas through the `AbstractK8sClient`
(common/k8s_client.py), probes each through the Serving Health RPC,
and replaces one that fails its probes or whose pod dies.  Two fleet
guarantees follow from stateless requests and the `model_step` that
rides every response:

- failover: the client-side `FleetRouter` (proto/service.py) spreads
  Predict traffic over the replicas this manager keeps alive, and the
  probe results (liveness, batcher fill) feed its ranking;
- a rolling hot-reload under a skew SLO: when a newer checkpoint lands,
  the manager swaps ONE replica per tick, and refuses a target step
  whose projected cross-replica `model_step` spread would exceed
  `step_skew_slo` (the `serving_fleet_model_step_skew_steps` gauge).

Everything is deterministic under an injected clock: `serving.
replica_kill` fires before every replacement, `fleet.reload_step` before
every sequenced swap and `fleet.scale` before every scale action (an
injected raise aborts that action for the tick), probes fire
`rpc.health_probe` inside the client, and every decision lands in a
clock-free `decisions` list.  At `interval_s` 0 no thread starts; the
caller ticks by hand.  The manager watches no pod stream: it reads each
pod's phase inside its own tick.

Replicas are in-process `ServingServicer`s in the online loop (its
`client_factory`); the default client is a `ServingStub` to
`{address}:{port}`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.common import events, faults
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common.constants import PodStatus, PodType
from elasticdl_tpu_torch.common.k8s_client import PodSpec
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.proto import serving as spb

logger = get_logger(__name__)

#: Closed vocabulary for fleet decision records (mirrors the policy
#: engine's action/reason discipline): a decision an operator cannot
#: grep for by exact name never reached the dashboards.
FLEET_ACTIONS = frozenset({
    "relaunch", "relaunch_aborted",
    "reload_step", "reload_refused", "reload_aborted", "reload_failed",
    "scale_up", "scale_down", "scale_aborted",
})

#: Pod phases that mean the replica process is gone for good and the
#: only remediation is a replacement pod.
_DEAD_PHASES = (PodStatus.FAILED, PodStatus.DELETED, PodStatus.SUCCEEDED)


@dataclass
class ServingFleetConfig:
    """Fleet shape and probe thresholds (docs/SERVING.md "Fleet" maps
    each field to its --flag)."""

    replicas: int = 0            # 0 = fleet disabled
    interval_s: float = 0.0      # probe loop period; 0 = loop disabled
    probe_failures: int = 3      # consecutive failures before relaunch
    step_skew_slo: int = 0       # max cross-replica step spread; 0 = off
    port: int = 50061            # serving gRPC port on each replica

    @classmethod
    def from_args(cls, args) -> "ServingFleetConfig":
        return cls(
            replicas=getattr(args, "serving_replicas", 0),
            interval_s=getattr(args, "serving_probe_interval", 0.0),
            probe_failures=max(
                1, getattr(args, "serving_probe_failures", 3)
            ),
            step_skew_slo=getattr(args, "serving_step_skew_slo", 0),
            port=getattr(args, "serving_port", 50061),
        )


class _Replica:
    """Mutable per-replica state the probe loop maintains."""

    def __init__(self, replica_id: int):
        self.replica_id = replica_id
        self.incarnation = 0
        self.pod_name = ""
        self.address = ""
        self.client = None
        self.healthy = False
        self.probe_failures = 0
        self.model_step = 0
        self.fill_ratio = 0.0
        self.queue_depth = 0
        self.shed = 0
        # serve-path phase tails (batcher histogram p99s riding the
        # health RPC's scalar-metric list) — `elasticdl top` columns
        self.queue_wait_p99_s = 0.0
        self.compute_p99_s = 0.0
        # idle detection: a replica whose `produced_unix_s` stamp did
        # not advance between probes dispatched nothing in that window,
        # so its (frozen) fill_ratio no longer describes current load
        self.produced_unix_s = -1.0
        self.idle = False


class ServingFleetManager:
    """Places, probes, relaunches, and rolling-reloads serving replicas.

    Injectable collaborators keep the loop testable in-process:

    - `client_factory(replica_id, address)` builds the probe/data client
      for one replica incarnation (default: a `ServingStub` over an
      insecure channel to `{address}:{config.port}`, with a one-attempt
      policy so every probe fires `rpc.health_probe` exactly once and a
      failed probe is a failed probe, not a hidden retry loop).
    - `reload_fn(replica_id) -> bool` performs ONE sequenced hot-swap on
      that replica (in-process fleets pass the replica's
      `CheckpointReloader.check_once`); `pending_step_fn()` returns the
      newest checkpoint step on disk, or None.  Pod-based replicas that
      self-reload can leave both unset — the manager then only observes
      skew, it does not sequence.
    - `router`: a `FleetRouter` kept in sync — relaunches swap in the
      fresh client, probe results feed its overload-aware ranking.
    """

    def __init__(
        self,
        k8s_client,
        config: ServingFleetConfig,
        job_name: str = "elasticdl",
        image: str = "",
        command_fn: Optional[Callable[[int], list]] = None,
        client_factory: Optional[Callable[[int, str], object]] = None,
        reload_fn: Optional[Callable[[int], bool]] = None,
        pending_step_fn: Optional[Callable[[], Optional[int]]] = None,
        router=None,
        clock: Callable[[], float] = time.time,
        freshness=None,
    ):
        self._k8s = k8s_client
        self.config = config
        self._job_name = job_name
        self._image = image
        self._command_fn = command_fn
        self._client_factory = client_factory or self._default_client
        self._reload_fn = reload_fn
        self._pending_step_fn = pending_step_fn
        self._router = router
        self._clock = clock
        # master/freshness.py FreshnessTracker: every pending-step probe
        # that reveals a newer checkpoint advances the latest-produced
        # reference the router scores Predict responses against
        self._freshness = freshness
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

        self._replicas: Dict[int, _Replica] = {}
        #: live placement target; `scale_up`/`scale_down` move it between
        #: the serving policy engine's min/max while `config.replicas`
        #: stays the initial placement size.
        self._target = config.replicas
        self._ticks_done = 0
        self._relaunched = 0
        self._scaled_up = 0
        self._scaled_down = 0
        self._reloads_done = 0
        self._refused_targets = set()
        self._last_skew = 0
        self._max_skew = 0
        #: Most recent completed reload (replica/step/clock stamp) — the
        #: reload-sequencing fact window lineage turns into per-window
        #: `reload_wait` stamps (pipeline reads it after each tick).
        self._last_reload: Optional[dict] = None
        #: clock-free decision records in tick order (same contract as
        #: PolicyEngine.decisions: byte-comparable across same-seed runs).
        self.decisions: List[dict] = []

        self.metrics_registry = metrics_lib.MetricsRegistry()
        self._ticks = self.metrics_registry.counter(
            "serving_fleet_ticks_total",
            "fleet probe-loop ticks executed",
        )
        self._probes = self.metrics_registry.counter(
            "serving_fleet_probes_total",
            "health probes by outcome",
            labelnames=("outcome",),
        )
        self._decisions_total = self.metrics_registry.counter(
            "serving_fleet_decisions_total",
            "fleet actions taken, by action",
            labelnames=("action",),
        )
        self._relaunches = self.metrics_registry.counter(
            "serving_fleet_relaunches_total",
            "replicas replaced after probe failures or pod death",
        )
        self._reload_steps = self.metrics_registry.counter(
            "serving_fleet_reload_steps_total",
            "sequenced per-replica hot-swaps performed",
        )
        self._reloads_refused = self.metrics_registry.counter(
            "serving_fleet_reloads_refused_total",
            "rolling reloads refused by the model_step skew SLO",
        )
        self._scale_actions = self.metrics_registry.counter(
            "serving_fleet_scale_actions_total",
            "fleet scale actions, by direction (aborted = fleet.scale "
            "fault skipped the action atomically)",
            labelnames=("direction",),
        )
        self.metrics_registry.gauge_fn(
            "serving_fleet_target_replicas_count",
            lambda: float(self._target),
            "live placement target the scale actions move between "
            "--min_serving_replicas and --max_serving_replicas",
        )
        self.metrics_registry.gauge_fn(
            "serving_fleet_replicas_count",
            lambda: float(
                sum(1 for r in self._replicas.values() if r.healthy)
            ),
            "replicas that passed their last health probe",
        )
        self.metrics_registry.gauge_fn(
            "serving_fleet_model_step_skew_steps",
            lambda: float(self._last_skew),
            "max-min model_step across probed replicas (the skew SLO "
            "gauge, measured in steps)",
        )

    # ---- lifecycle -----------------------------------------------------

    def _default_client(self, replica_id: int, address: str):
        from elasticdl_tpu_torch.common.resilience import default_policy
        from elasticdl_tpu_torch.proto.service import ServingStub

        # One attempt per probe: retrying inside the prober would hide
        # exactly the failures the relaunch threshold counts.
        return ServingStub(f"{address}:{self.config.port}",
                           retry_policy=default_policy(max_attempts=1))

    def place(self) -> int:
        """Ensure every replica slot has a pod (idempotent); returns the
        number of slots launched this call."""
        launched = 0
        with self._lock:
            for rid in range(self.config.replicas):
                if rid not in self._replicas:
                    rep = _Replica(rid)
                    self._replicas[rid] = rep
                    self._launch_locked(rep)
                    launched += 1
        return launched

    def start(self) -> bool:
        """Place the fleet and start the probe loop; the loop is a no-op
        (returns False) when interval_s <= 0 — tests tick() by hand."""
        self.place()
        if self.config.interval_s <= 0 or self._thread is not None:
            return False
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="serving-fleet", daemon=True
        )
        self._thread.start()
        return True

    def stop(self):
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._thread = None

    def _run(self):
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:
                # The fleet loop must never take down the job brain.
                logger.exception("serving fleet tick failed")

    # ---- placement -----------------------------------------------------

    def _launch_locked(self, rep: _Replica) -> None:
        """Create (or re-create) the pod + stable service for one replica
        slot and hand the router a fresh client."""
        service = f"{self._job_name}-serving-{rep.replica_id}"
        rep.pod_name = f"{service}-{rep.incarnation}"
        rep.address = service
        labels = {
            "app": "elasticdl",
            "elasticdl-job": self._job_name,
            "elasticdl-serving-replica": str(rep.replica_id),
        }
        spec = PodSpec(
            name=rep.pod_name,
            pod_type=PodType.SERVING,
            worker_id=rep.replica_id,
            image=self._image,
            command=list(self._command_fn(rep.replica_id))
            if self._command_fn else [],
            labels=labels,
        )
        try:
            self._k8s.create_pod(spec)
            if rep.incarnation == 0:
                # Stable per-replica DNS name: relaunches keep the same
                # address, so clients never re-resolve.
                try:
                    self._k8s.create_service(
                        service, labels, self.config.port
                    )
                except NotImplementedError:
                    pass
        except Exception:
            logger.exception(
                "serving replica %d pod create failed", rep.replica_id
            )
            rep.pod_name = ""
        rep.healthy = False
        rep.probe_failures = 0
        try:
            rep.client = self._client_factory(rep.replica_id, rep.address)
        except Exception:
            logger.exception(
                "serving replica %d client build failed", rep.replica_id
            )
            rep.client = None
        if self._router is not None and rep.client is not None:
            self._router.set_client(rep.replica_id, rep.client)

    def _relaunch_locked(self, rep: _Replica, cause: str) -> dict:
        """Replace one replica: fires `serving.replica_kill` first — an
        injected raise/drop models the apiserver failing the replacement,
        aborting it for this tick (the next tick retries)."""
        try:
            faults.fire(faults.POINT_SERVING_REPLICA_KILL)
        except faults.InjectedFault as exc:
            logger.warning(
                "serving replica %d relaunch aborted: %s",
                rep.replica_id, exc,
            )
            return self._record(
                "relaunch_aborted", replica=rep.replica_id, cause=cause
            )
        if self._router is not None:
            self._router.mark_down(rep.replica_id)
        if rep.pod_name:
            try:
                self._k8s.delete_pod(rep.pod_name)
            except Exception:
                logger.warning(
                    "serving replica %d pod delete failed (continuing)",
                    rep.replica_id,
                )
        rep.incarnation += 1
        self._launch_locked(rep)
        self._relaunched += 1
        self._relaunches.inc()
        record = self._record(
            "relaunch", replica=rep.replica_id, cause=cause,
            incarnation=rep.incarnation,
        )
        events.emit(
            events.SERVING_REPLICA_RELAUNCHED,
            replica=rep.replica_id, cause=cause,
            incarnation=rep.incarnation,
        )
        return record

    # ---- elastic scaling (docs/SERVING.md "Autoscaling & backpressure")

    def scale_up(self, count: int = 1) -> Optional[dict]:
        """Place `count` fresh replica slots (new ids above the highest
        live one, so retired ids are never resurrected into a stale
        service name).  Fires `fleet.scale` BEFORE any mutation: an
        injected raise aborts the whole action atomically — nothing
        placed, nothing counted — and the caller retries next tick."""
        with self._lock:
            count = int(count)
            if count <= 0:
                return None
            try:
                faults.fire(faults.POINT_FLEET_SCALE)
            except faults.InjectedFault as exc:
                logger.warning("fleet scale_up aborted: %s", exc)
                self._scale_actions.labels(direction="aborted").inc()
                return self._record(
                    "scale_aborted", direction="up", count=count
                )
            added = []
            for _ in range(count):
                rid = max(self._replicas) + 1 if self._replicas else 0
                rep = _Replica(rid)
                self._replicas[rid] = rep
                self._launch_locked(rep)
                added.append(rid)
            self._target = len(self._replicas)
            self._scaled_up += len(added)
            self._scale_actions.labels(direction="up").inc()
            self._refresh_skew_locked()
            return self._record(
                "scale_up", replicas=added, target=self._target
            )

    def scale_down(self, count: int = 1,
                   prefer: str = "unhealthy") -> Optional[dict]:
        """Retire `count` replicas — probe-failing ones first when
        `prefer="unhealthy"`, then the newest (highest id) healthy ones —
        through the router (so mid-sweep requests fail over, not fail)
        and the apiserver.  Refuses to empty the fleet (keeps >= 1).
        Fires `fleet.scale` before any mutation; an injected raise
        aborts the whole action atomically."""
        with self._lock:
            count = min(int(count), len(self._replicas) - 1)
            if count <= 0:
                return None
            try:
                faults.fire(faults.POINT_FLEET_SCALE)
            except faults.InjectedFault as exc:
                logger.warning("fleet scale_down aborted: %s", exc)
                self._scale_actions.labels(direction="aborted").inc()
                return self._record(
                    "scale_aborted", direction="down", count=count
                )
            if prefer == "unhealthy":
                unhealthy = sorted(
                    rid for rid, rep in self._replicas.items()
                    if not rep.healthy
                )
                healthy = sorted(
                    (rid for rid, rep in self._replicas.items()
                     if rep.healthy),
                    reverse=True,
                )
                victims = (unhealthy + healthy)[:count]
            else:
                victims = sorted(self._replicas, reverse=True)[:count]
            for rid in victims:
                rep = self._replicas.pop(rid)
                if self._router is not None:
                    self._router.remove_client(rid)
                if rep.pod_name:
                    try:
                        self._k8s.delete_pod(rep.pod_name)
                    except Exception:
                        logger.warning(
                            "retired replica %d pod delete failed "
                            "(continuing)", rid,
                        )
            self._target = len(self._replicas)
            self._scaled_down += len(victims)
            self._scale_actions.labels(direction="down").inc()
            self._refresh_skew_locked()
            return self._record(
                "scale_down", replicas=victims, target=self._target
            )

    def live_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    def healthy_replicas(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values() if r.healthy)

    def mean_fill_ratio(self) -> float:
        """Mean batcher fill across healthy replicas (last probe) — the
        serving policy engine's batch-fill signal."""
        with self._lock:
            fills = [
                rep.fill_ratio for rep in self._replicas.values()
                if rep.healthy
            ]
            return sum(fills) / len(fills) if fills else 0.0

    def fill_signal(self) -> float:
        """Effective batch-fill for the serving policy engine's
        scale-down path: the MINIMUM across healthy replicas, counting a
        replica that produced nothing since its previous probe as 0.0.
        The mean hides over-provisioning — a busy replica's full batches
        mask three idle peers whose last-reported fill is frozen at its
        spike-era value — while a zero minimum is direct evidence the
        fleet holds capacity the traffic provably is not using."""
        with self._lock:
            fills = [
                0.0 if rep.idle else rep.fill_ratio
                for rep in self._replicas.values()
                if rep.healthy
            ]
            return min(fills) if fills else 0.0

    def _reload_gap_locked(self) -> int:
        """Steps the furthest-behind healthy replica still trails the
        newest pending checkpoint — > 0 means a rolling-reload sequence
        is mid-flight (a freshly scaled replica would boot at the
        pending step, making this gap the projected scale skew)."""
        if self._pending_step_fn is None:
            return 0
        try:
            target = self._pending_step_fn()
        except Exception:
            return 0
        if target is None or target in self._refused_targets:
            return 0
        steps = [
            rep.model_step for rep in self._replicas.values()
            if rep.healthy
        ]
        if not steps:
            return 0
        return max(0, int(target) - min(steps))

    def projected_scale_skew(self) -> int:
        """The `model_step` spread a scale action taken NOW could create:
        the reload-guard signal the serving policy engine checks against
        the skew SLO before acting (0 when no reload is in flight)."""
        with self._lock:
            return self._reload_gap_locked()

    def reload_in_progress(self) -> bool:
        with self._lock:
            return self._reload_gap_locked() > 0

    # ---- the loop body -------------------------------------------------

    def tick(self) -> List[dict]:
        """One probe-and-act pass; returns the decision records made.
        Serialized under a lock so a background tick and a test-driven
        tick cannot interleave."""
        with self._lock:
            return self._tick_locked()

    def _tick_locked(self) -> List[dict]:
        self._ticks_done += 1
        self._ticks.inc()
        records: List[dict] = []
        for rid in sorted(self._replicas):
            record = self._probe_locked(self._replicas[rid])
            if record is not None:
                records.append(record)
        self._refresh_skew_locked()
        record = self._maybe_reload_locked()
        if record is not None:
            records.append(record)
        return records

    def _probe_locked(self, rep: _Replica) -> Optional[dict]:
        # Death first: a FAILED/DELETED pod needs no probe quorum.
        phase = PodStatus.UNKNOWN
        if rep.pod_name:
            try:
                phase = self._k8s.get_pod_phase(rep.pod_name)
            except Exception:
                phase = PodStatus.UNKNOWN
        if not rep.pod_name or phase in _DEAD_PHASES:
            rep.healthy = False
            return self._relaunch_locked(rep, cause="pod_dead")

        try:
            if rep.client is None:
                raise ConnectionError("no client for replica")
            # fires rpc.health_probe inside the client, once per probe
            response = rep.client.health(spb.HealthRequest())
        except Exception as exc:
            self._probes.labels(outcome="error").inc()
            rep.probe_failures += 1
            rep.healthy = False
            logger.warning(
                "serving replica %d probe failed (%d/%d): %s",
                rep.replica_id, rep.probe_failures,
                self.config.probe_failures, exc,
            )
            if rep.probe_failures >= self.config.probe_failures:
                return self._relaunch_locked(rep, cause="probe")
            return None

        self._probes.labels(outcome="ok").inc()
        rep.probe_failures = 0
        rep.healthy = bool(response.serving)
        rep.model_step = int(response.model_step)
        rep.queue_depth = int(response.queue_depth)
        health_metrics = {m.name: m.value for m in response.metrics}
        rep.fill_ratio = float(health_metrics.get("batch_fill_ratio", 0.0))
        rep.shed = int(health_metrics.get("shed", 0))
        rep.queue_wait_p99_s = float(
            health_metrics.get("phase_queue_wait_p99_s", 0.0)
        )
        rep.compute_p99_s = float(
            health_metrics.get("phase_compute_p99_s", 0.0)
        )
        produced = health_metrics.get("produced_unix_s")
        if produced is not None:
            stamp = float(produced)
            rep.idle = stamp <= rep.produced_unix_s
            rep.produced_unix_s = stamp
        if self._router is not None:
            self._router.mark_live(rep.replica_id)
            self._router.observe_health(
                rep.replica_id,
                fill_ratio=rep.fill_ratio,
                queue_depth=rep.queue_depth,
                model_step=rep.model_step,
                produced_unix_s=produced,
            )
        return None

    # ---- rolling hot-reload --------------------------------------------

    def _refresh_skew_locked(self) -> None:
        steps = [
            rep.model_step for rep in self._replicas.values() if rep.healthy
        ]
        self._last_skew = (
            max(steps) - min(steps) if len(steps) > 1 else 0
        )
        self._max_skew = max(self._max_skew, self._last_skew)

    def _maybe_reload_locked(self) -> Optional[dict]:
        """One sequenced reload step per tick: pick the furthest-behind
        healthy replica, refuse outright if swapping it would break the
        skew SLO, fire `fleet.reload_step`, then swap."""
        if self._reload_fn is None or self._pending_step_fn is None:
            return None
        try:
            target = self._pending_step_fn()
        except Exception:
            logger.exception("pending-step probe failed")
            return None
        if target is not None and self._freshness is not None:
            self._freshness.note_produced(int(target))
        if target is None or target in self._refused_targets:
            return None
        steps = {
            rid: rep.model_step
            for rid, rep in self._replicas.items() if rep.healthy
        }
        behind = [rid for rid in sorted(steps) if steps[rid] < target]
        if not behind:
            return None
        victim = min(behind, key=lambda rid: (steps[rid], rid))
        projected = dict(steps)
        projected[victim] = target
        skew = max(projected.values()) - min(projected.values())
        slo = self.config.step_skew_slo
        if slo > 0 and skew > slo:
            # Terminal for this target step: re-deciding the same refusal
            # every tick would only spam the decision log.
            self._refused_targets.add(target)
            self._reloads_refused.inc()
            record = self._record(
                "reload_refused", target_step=int(target),
                projected_skew=int(skew), slo=int(slo),
            )
            events.emit(
                events.FLEET_RELOAD_REFUSED, target_step=int(target),
                projected_skew=int(skew), slo=int(slo),
            )
            return record
        try:
            faults.fire(faults.POINT_FLEET_RELOAD_STEP)
        except faults.InjectedFault as exc:
            logger.warning(
                "reload step for replica %d aborted: %s", victim, exc
            )
            return self._record(
                "reload_aborted", replica=victim, target_step=int(target)
            )
        try:
            swapped = bool(self._reload_fn(victim))
        except Exception:
            logger.exception("reload step for replica %d failed", victim)
            swapped = False
        if not swapped:
            return self._record(
                "reload_failed", replica=victim, target_step=int(target)
            )
        rep = self._replicas[victim]
        rep.model_step = int(target)
        self._reloads_done += 1
        self._reload_steps.inc()
        self._refresh_skew_locked()
        if self._router is not None:
            self._router.observe_health(
                victim, fill_ratio=rep.fill_ratio,
                queue_depth=rep.queue_depth, model_step=rep.model_step,
            )
        record = self._record(
            "reload_step", replica=victim, target_step=int(target),
            skew=int(self._last_skew),
        )
        self._last_reload = {
            "replica": int(victim),
            "step": int(target),
            "unix_s": round(float(self._clock()), 6),
        }
        events.emit(
            events.FLEET_RELOAD_STEP, replica=victim,
            step=int(target), skew=int(self._last_skew),
        )
        return record

    # ---- bookkeeping ---------------------------------------------------

    def last_reload(self) -> Optional[dict]:
        """Most recent completed sequenced reload
        ({replica, step, unix_s}) or None before the first swap."""
        with self._lock:
            return dict(self._last_reload) if self._last_reload else None

    def _record(self, action: str, **inputs) -> dict:
        assert action in FLEET_ACTIONS, action
        self._decisions_total.labels(action=action).inc()
        record = {"tick": self._ticks_done, "action": action}
        record.update(inputs)
        self.decisions.append(record)
        logger.info("fleet decision: %s", record)
        return record

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "replicas": {
                    rid: {
                        "pod": rep.pod_name,
                        "addr": rep.address,
                        "healthy": rep.healthy,
                        "model_step": rep.model_step,
                        "fill_ratio": round(rep.fill_ratio, 3),
                        "queue_depth": rep.queue_depth,
                        "shed": rep.shed,
                        "queue_wait_p99_s": round(
                            rep.queue_wait_p99_s, 6
                        ),
                        "compute_p99_s": round(rep.compute_p99_s, 6),
                        "probe_failures": rep.probe_failures,
                        "incarnation": rep.incarnation,
                    }
                    for rid, rep in sorted(self._replicas.items())
                },
                "ticks": self._ticks_done,
                "relaunches": self._relaunched,
                "target_replicas": self._target,
                "scale_ups": self._scaled_up,
                "scale_downs": self._scaled_down,
                "reload_steps": self._reloads_done,
                "model_step_skew": self._last_skew,
                "max_model_step_skew": self._max_skew,
                "step_skew_slo": self.config.step_skew_slo,
                "decisions": list(self.decisions),
                "interval_s": self.config.interval_s,
            }
