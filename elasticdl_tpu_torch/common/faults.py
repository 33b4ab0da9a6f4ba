"""Deterministic, seeded fault injection (the port's copy of the JAX
package's common/faults.py).

A process-wide registry of named injection points that the control
plane calls `fire()` on, and a seed-driven plan deciding, per point and
per hit index, whether to raise, delay or drop.

- **Deterministic trace.**  The plan is a pure function of the seed, and
  a firing is identified by (point, hit_index, action), never by the
  clock.  Two runs with the same seed and workload emit byte-identical
  `trace_text()` however threads interleave, as long as every scheduled
  fault fires (`all_fired()`).  For the same seed and points,
  `schedule_json()` and `trace_text()` are byte-identical to the JAX
  package's, so a schedule written by one package runs in the other.
- **Zero cost when disabled.**  The module-level `fire(point)` is one
  attribute read and a None check when no registry is installed.
- **Where the port fires.**  `rpc.get_task` and `rpc.report` before
  each call of `InProcessMasterClient` (proto/service.py),
  `rpc.predict` and `rpc.health_probe` per attempt of a `ServingStub`
  with a retry policy, `checkpoint.write` per save
  (common/save_utils.py) and `serving.reload` per hot reload
  (serving/reloader.py).  The other points name boundaries of slices
  still to come (the cluster and the online loop).
- A subprocess inherits the plan through `ELASTICDL_FAULT_SCHEDULE` (an
  explicit plan) or `ELASTICDL_FAULT_SEED` (the default seeded plan);
  `configure_from_env()` installs it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

# Canonical injection points.  Adding one is cheap; each names the
# boundary it guards, not the module that hosts it.
POINT_RPC_GET_TASK = "rpc.get_task"
POINT_RPC_REPORT = "rpc.report"
POINT_RENDEZVOUS_JOIN = "rendezvous.join"
POINT_CHECKPOINT_WRITE = "checkpoint.write"
POINT_WORKER_HEARTBEAT = "worker.heartbeat"
POINT_POD_WATCH = "pod.watch"
POINT_RPC_PREDICT = "rpc.predict"
POINT_SERVING_RELOAD = "serving.reload"
# Scaling/actuation boundaries (master/policy.py + pod_manager scale
# paths): apiserver errors mid-scale are part of the chaos surface.
POINT_POD_CREATE = "pod.create"
POINT_POD_DELETE = "pod.delete"
POINT_POLICY_TICK = "policy.tick"
# Serving-fleet boundaries (master/serving_fleet.py + the Health RPC):
# a probe that errors, an apiserver that fails the replica replacement,
# and a rolling-reload step that dies mid-swap are each one scheduled
# fault away.
POINT_RPC_HEALTH_PROBE = "rpc.health_probe"
POINT_SERVING_REPLICA_KILL = "serving.replica_kill"
POINT_FLEET_RELOAD_STEP = "fleet.reload_step"
# Online continuous-learning boundaries (data/reader/stream_reader.py +
# master/task_manager.py perpetual mode): a stream poll that stalls and
# a window re-arm the queue never sees are the two ways fresh data stops
# reaching training without anything crashing.
POINT_STREAM_POLL = "stream.poll"
POINT_TASK_REARM = "task.rearm"
# Sharded-store boundary (store/sharding.py): the master reassigns a dead
# or evicted worker's row range to a successor; a handoff that errors
# mid-move leaves the shard orphaned until the next retry — exactly the
# window the chaos soak aims at.
POINT_STORE_SHARD_HANDOFF = "store.shard_handoff"
# Serving control-loop boundaries (traffic/generator.py +
# master/serving_fleet.py scale paths): a traffic tick that dies must
# not corrupt the offered-request schedule, and an apiserver error
# mid-scale must abort the whole action atomically — the serving policy
# engine retries it next tick with its streaks frozen.
POINT_TRAFFIC_TICK = "traffic.tick"
POINT_FLEET_SCALE = "fleet.scale"

POINTS = (
    POINT_RPC_GET_TASK,
    POINT_RPC_REPORT,
    POINT_RENDEZVOUS_JOIN,
    POINT_CHECKPOINT_WRITE,
    POINT_WORKER_HEARTBEAT,
    POINT_POD_WATCH,
    POINT_RPC_PREDICT,
    POINT_SERVING_RELOAD,
    POINT_POD_CREATE,
    POINT_POD_DELETE,
    POINT_POLICY_TICK,
    POINT_RPC_HEALTH_PROBE,
    POINT_SERVING_REPLICA_KILL,
    POINT_FLEET_RELOAD_STEP,
    POINT_STREAM_POLL,
    POINT_TASK_REARM,
    POINT_STORE_SHARD_HANDOFF,
    POINT_TRAFFIC_TICK,
    POINT_FLEET_SCALE,
)

ACTIONS = ("raise", "delay", "drop")

# Registry-backed injection counters (common/metrics.py): the plan and
# firing bookkeeping below stay the deterministic trace's source of
# truth (trace_text); these series are what /metrics and
# Master.snapshot read.
from elasticdl_tpu_torch.common import metrics as _metrics  # noqa: E402

_hits_counter = _metrics.default_registry().counter(
    "faults_point_hits_total",
    "fire() calls per injection point (plan scheduled or not)",
    labelnames=("point",),
)
_injected_counter = _metrics.default_registry().counter(
    "faults_injected_total",
    "scheduled faults actually executed, by action",
    labelnames=("action",),
)

# Env wire format for subprocesses: the parent serializes its registry's
# plan; `configure_from_env()` rebuilds an identical one in the child.
ENV_SCHEDULE = "ELASTICDL_FAULT_SCHEDULE"
ENV_SEED = "ELASTICDL_FAULT_SEED"


class InjectedFault(Exception):
    """An injected failure (the `raise` action).  Classified as retryable
    by resilience.is_retryable_error: injected faults model transient
    infrastructure errors."""


class DroppedRequest(InjectedFault):
    """An injected drop: the request/event is lost in flight.  At RPC
    sites this surfaces as an error (the caller cannot tell a dropped
    request from a failed one); at event sites the caller swallows it and
    skips delivery."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: at the `at`-th hit of `point`, do `action`."""

    point: str
    at: int
    action: str  # "raise" | "delay" | "drop"
    delay_s: float = 0.0

    def key(self) -> Tuple[str, int]:
        return (self.point, self.at)

    def describe(self) -> str:
        extra = f" delay={self.delay_s:.3f}s" if self.action == "delay" else ""
        return f"{self.point}#{self.at} {self.action}{extra}"


class FaultRegistry:
    """Seeded fault plan + thread-safe hit counting + canonical trace."""

    def __init__(
        self,
        schedule: Iterable[FaultSpec] = (),
        seed: Optional[int] = None,
    ):
        self.seed = seed
        self._lock = threading.Lock()
        self._plan: Dict[str, Dict[int, FaultSpec]] = {}
        for spec in schedule:
            if spec.action not in ACTIONS:
                raise ValueError(f"unknown fault action {spec.action!r}")
            self._plan.setdefault(spec.point, {})[spec.at] = spec
        self._hits: Dict[str, int] = {}
        self._fired: Dict[Tuple[str, int], FaultSpec] = {}
        self._notes: Dict[str, List[str]] = {}

    # ---- construction ---------------------------------------------------

    @classmethod
    def from_seed(
        cls,
        seed: int,
        points: Iterable[str] = POINTS,
        faults_per_point: int = 2,
        max_hit: int = 8,
        actions: Iterable[str] = ACTIONS,
    ) -> "FaultRegistry":
        """Derive a schedule purely from `seed`: for each point (in the
        given, fixed order) pick `faults_per_point` distinct hit indices
        below `max_hit` and an action for each.  Same seed => same plan,
        on any host."""
        import random

        rng = random.Random(seed)
        actions = tuple(actions)
        schedule = []
        for point in points:
            for at in sorted(rng.sample(range(max_hit), faults_per_point)):
                action = rng.choice(actions)
                delay = (
                    round(rng.uniform(0.01, 0.05), 3)
                    if action == "delay"
                    else 0.0
                )
                schedule.append(FaultSpec(point, at, action, delay))
        return cls(schedule, seed=seed)

    # ---- the hot path ---------------------------------------------------

    def fire(self, point: str) -> None:
        """Count one hit of `point` and execute any fault scheduled at
        this hit index.  Raises InjectedFault/DroppedRequest for the
        raise/drop actions; sleeps for delay; no-op otherwise."""
        with self._lock:
            hit = self._hits.get(point, 0)
            self._hits[point] = hit + 1
            spec = self._plan.get(point, {}).get(hit)
            if spec is not None:
                self._fired[spec.key()] = spec
        _hits_counter.labels(point=point).inc()
        if spec is None:
            return
        _injected_counter.labels(action=spec.action).inc()
        if spec.action == "delay":
            time.sleep(spec.delay_s)
            return
        if spec.action == "drop":
            raise DroppedRequest(f"injected drop at {spec.describe()}")
        raise InjectedFault(f"injected failure at {spec.describe()}")

    def note(self, key: str, detail: str = "") -> None:
        """Record a test-driven chaos event (a kill, a corruption) in the
        trace.  Keep `detail` free of run-variant data (clocks, pids) —
        notes are part of the byte-compared trace."""
        with self._lock:
            self._notes.setdefault(key, []).append(detail)

    # ---- introspection --------------------------------------------------

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def all_fired(self) -> bool:
        """True when every scheduled fault has fired (the workload drove
        each point past its highest scheduled hit index)."""
        with self._lock:
            planned = sum(len(v) for v in self._plan.values())
            return len(self._fired) == planned

    def unfired(self) -> List[str]:
        with self._lock:
            return sorted(
                spec.describe()
                for by_hit in self._plan.values()
                for spec in by_hit.values()
                if spec.key() not in self._fired
            )

    def stats(self) -> dict:
        with self._lock:
            by_action: Dict[str, int] = {}
            for spec in self._fired.values():
                by_action[spec.action] = by_action.get(spec.action, 0) + 1
            return {
                "planned": sum(len(v) for v in self._plan.values()),
                "injected": len(self._fired),
                "by_action": by_action,
                "hits": dict(sorted(self._hits.items())),
                "notes": sum(len(v) for v in self._notes.values()),
            }

    def trace_text(self) -> str:
        """Canonical fault trace: plan, firings, and notes in a fixed
        sort order with no timestamps — byte-identical across same-seed
        runs that fired the full plan and issued the same notes."""
        with self._lock:
            lines = [f"fault-trace v1 seed={self.seed}"]
            plan = sorted(
                (spec for by_hit in self._plan.values()
                 for spec in by_hit.values()),
                key=lambda s: (s.point, s.at),
            )
            for spec in plan:
                lines.append(f"plan {spec.describe()}")
            for key in sorted(self._fired):
                lines.append(f"fired {self._fired[key].describe()}")
            for key in sorted(self._notes):
                for i, detail in enumerate(self._notes[key]):
                    suffix = f" {detail}" if detail else ""
                    lines.append(f"note {key}#{i}{suffix}")
        return "\n".join(lines) + "\n"

    # ---- (de)serialization ---------------------------------------------

    def schedule_json(self) -> str:
        with self._lock:
            specs = sorted(
                (spec for by_hit in self._plan.values()
                 for spec in by_hit.values()),
                key=lambda s: (s.point, s.at),
            )
            return json.dumps(
                [
                    {
                        "point": s.point,
                        "at": s.at,
                        "action": s.action,
                        "delay_s": s.delay_s,
                    }
                    for s in specs
                ]
            )

    @classmethod
    def from_schedule_json(
        cls, text: str, seed: Optional[int] = None
    ) -> "FaultRegistry":
        schedule = [
            FaultSpec(
                point=str(e["point"]),
                at=int(e["at"]),
                action=str(e["action"]),
                delay_s=float(e.get("delay_s", 0.0)),
            )
            for e in json.loads(text)
        ]
        return cls(schedule, seed=seed)

    def env(self) -> Dict[str, str]:
        """Env vars that reproduce this registry in a subprocess (pair
        with configure_from_env)."""
        out = {ENV_SCHEDULE: self.schedule_json()}
        if self.seed is not None:
            out[ENV_SEED] = str(self.seed)
        return out


# ---- process-wide singleton ---------------------------------------------

_active: Optional[FaultRegistry] = None


def install(registry: FaultRegistry) -> FaultRegistry:
    global _active
    _active = registry
    return registry


def uninstall() -> None:
    global _active
    _active = None


def get_registry() -> Optional[FaultRegistry]:
    return _active


def fire(point: str) -> None:
    """Module-level hot path: no-op unless a registry is installed."""
    registry = _active
    if registry is not None:
        registry.fire(point)


def note(key: str, detail: str = "") -> None:
    registry = _active
    if registry is not None:
        registry.note(key, detail)


def configure_from_env(environ=None) -> Optional[FaultRegistry]:
    """Install a registry described by the environment (a Local job's
    process, a subprocess of a chaos run).  ELASTICDL_FAULT_SCHEDULE
    carries an explicit plan; ELASTICDL_FAULT_SEED alone derives the
    default seeded plan.  Returns the installed registry, or None when
    neither is set."""
    environ = os.environ if environ is None else environ
    schedule = environ.get(ENV_SCHEDULE, "")
    seed_text = environ.get(ENV_SEED, "")
    seed = int(seed_text) if seed_text else None
    if schedule:
        return install(FaultRegistry.from_schedule_json(schedule, seed=seed))
    if seed is not None:
        return install(FaultRegistry.from_seed(seed))
    return None


def stats() -> dict:
    registry = _active
    return registry.stats() if registry is not None else {}
