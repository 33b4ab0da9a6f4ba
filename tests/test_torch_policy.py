"""The port's trainer policy engine (master/policy.py `PolicyEngine`)
against the JAX package's, on the cases of tests/test_policy_engine.py
that need no PodManager: eviction after the dwell, within the budget and
the cooldown; backlog scale-up with its hysteresis and ceiling, aligned
to whole groups; data_wait scale-down preferring stragglers, and no
signal without step progress; the watermark-lag scale-up of a perpetual
job; a `policy.tick` fault skipping a tick.  Both engines drive the same
duck-typed pool and task manager (the online loop's `_TrainerPool` and
`_TaskManagerProxy` are one such pair); decisions, `policy_decision`
events, snapshots and the pool's actions must be equal."""

from types import SimpleNamespace

import pytest
import torch

from elasticdl_tpu.common import events as jax_events
from elasticdl_tpu.common import faults as jax_faults
from elasticdl_tpu.master import policy as jax_policy
from elasticdl_tpu_torch.common import events as port_events
from elasticdl_tpu_torch.common import faults as port_faults
from elasticdl_tpu_torch.master import policy as port_policy

torch.set_num_threads(2)

JAX = SimpleNamespace(policy=jax_policy, faults=jax_faults,
                      events=jax_events)
PORT = SimpleNamespace(policy=port_policy, faults=port_faults,
                       events=port_events)


@pytest.fixture(autouse=True)
def _clean_globals():
    yield
    for m in (JAX, PORT):
        m.faults.uninstall()
        m.events.configure(None)


class FakeClock:
    def __init__(self, start=1000.0):
        self.t = start

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class StubTaskManager:
    """The two snapshots the engine reads, scriptable."""

    def __init__(self):
        self.todo = 0
        self.stragglers = {}

    def snapshot(self):
        return {"todo": self.todo}

    def straggler_snapshot(self):
        return dict(self.stragglers)


class StubPool:
    """The pod manager's surface the engine actuates, over integer ids
    in groups of `wpg`: an eviction restarts the victim's whole group on
    fresh ids, scale-up launches fresh ids, scale-down drops preferred
    victims first, then the newest."""

    def __init__(self, n, wpg=1, tm=None):
        self._alive = list(range(n))
        self._next = n
        self._wpg = wpg
        self._tm = tm
        self.group_of = {w: w // wpg for w in self._alive}
        self.actions = []

    def alive_workers(self):
        return sorted(self._alive)

    def evict_worker(self, wid):
        if wid not in self._alive:
            return False
        group = self.group_of[wid]
        victims = [w for w in self._alive if self.group_of[w] == group]
        for w in victims:
            self._alive.remove(w)
            if self._tm is not None:
                self._tm.stragglers.pop(w, None)
        fresh = list(range(self._next, self._next + len(victims)))
        self._next += len(victims)
        for w in fresh:
            self._alive.append(w)
            self.group_of[w] = group
        self.actions.append(("evict", wid, victims, fresh))
        return True

    def scale_up(self, n):
        fresh = list(range(self._next, self._next + n))
        self._next += n
        for i, w in enumerate(fresh):
            self._alive.append(w)
            self.group_of[w] = 1000 + (w - i % self._wpg) // self._wpg
        self.actions.append(("scale_up", n, fresh))
        return n

    def scale_down(self, n, prefer=()):
        order = [w for w in prefer if w in self._alive] + sorted(
            (w for w in self._alive if w not in prefer), reverse=True)
        victims = order[:n]
        for w in victims:
            self._alive.remove(w)
        self.actions.append(("scale_down", n, list(prefer), victims))
        return victims


def _evict_dwell_budget(m, clk, tm, telemetry):
    pool = StubPool(4, wpg=2, tm=tm)
    engine = m.policy.PolicyEngine(tm, pool, m.policy.PolicyConfig(
        min_workers=2, max_workers=4, workers_per_group=2,
        straggler_dwell_s=30.0, eviction_budget=1), clock=clk)
    tm.stragglers = {1: {"straggler": True, "flagged_for_s": 10.0,
                         "mean_task_s": 5.0}}
    out = [engine.tick()]                     # dwell not met
    tm.stragglers[1]["flagged_for_s"] = 31.0
    out.append(engine.tick())                 # evicts worker 1's group
    tm.stragglers = {2: {"straggler": True, "flagged_for_s": 100.0,
                         "mean_task_s": 5.0}}
    out.append(engine.tick())                 # budget spent
    return engine, pool, out


def _evict_cooldown(m, clk, tm, telemetry):
    pool = StubPool(3, tm=tm)
    engine = m.policy.PolicyEngine(tm, pool, m.policy.PolicyConfig(
        min_workers=1, max_workers=3, straggler_dwell_s=10.0,
        eviction_budget=2, eviction_cooldown_s=500.0), clock=clk)
    tm.stragglers = {0: {"straggler": True, "flagged_for_s": 50.0},
                     1: {"straggler": True, "flagged_for_s": 50.0}}
    out = [engine.tick(), engine.tick()]      # evict 0, then cooldown
    clk.advance(501.0)
    out.append(engine.tick())                 # evict 1
    return engine, pool, out


def _backlog_ceiling(m, clk, tm, telemetry):
    tm.todo = 40
    pool = StubPool(2, tm=tm)
    engine = m.policy.PolicyEngine(tm, pool, m.policy.PolicyConfig(
        min_workers=2, max_workers=6, backlog_per_worker=4.0,
        backlog_ticks=2, scale_step=2, scale_hold_ticks=1), clock=clk)
    return engine, pool, [engine.tick() for _ in range(7)]


def _backlog_groups(m, clk, tm, telemetry):
    tm.todo = 100
    pool = StubPool(2, wpg=2, tm=tm)
    engine = m.policy.PolicyEngine(tm, pool, m.policy.PolicyConfig(
        min_workers=2, max_workers=6, workers_per_group=2,
        backlog_per_worker=1.0, backlog_ticks=1, scale_step=1,
        scale_hold_ticks=0), clock=clk)
    return engine, pool, [engine.tick() for _ in range(3)]


def _data_wait_stragglers(m, clk, tm, telemetry):
    pool = StubPool(4, tm=tm)
    engine = m.policy.PolicyEngine(tm, pool, m.policy.PolicyConfig(
        min_workers=2, max_workers=4, backlog_per_worker=1e9,
        data_wait_share=0.5, data_wait_ticks=2, scale_step=1,
        scale_hold_ticks=0), telemetry_fn=lambda: telemetry, clock=clk)

    def starve():
        entry = telemetry.setdefault(
            0, {"phase_data_wait_ms": 0.0, "phase_compute_ms": 0.0})
        entry["phase_data_wait_ms"] += 800.0
        entry["phase_compute_ms"] += 200.0

    out = []
    for i in range(8):
        if i == 2:
            tm.stragglers = {0: {"straggler": True, "flagged_for_s": 0.0}}
        starve()
        out.append(engine.tick())
    return engine, pool, out


def _no_progress(m, clk, tm, telemetry):
    telemetry[0] = {"phase_data_wait_ms": 900.0, "phase_compute_ms": 100.0}
    pool = StubPool(3, tm=tm)
    engine = m.policy.PolicyEngine(tm, pool, m.policy.PolicyConfig(
        min_workers=1, max_workers=3, backlog_per_worker=1e9,
        data_wait_share=0.5, data_wait_ticks=2, scale_hold_ticks=0),
        telemetry_fn=lambda: telemetry, clock=clk)
    return engine, pool, [engine.tick() for _ in range(3)]


def _stream_lag(m, clk, tm, telemetry):
    lag = iter([10.0, 90.0, 95.0, 120.0, 20.0, 99.0, 99.0, 99.0, 99.0])
    pool = StubPool(1, tm=tm)
    engine = m.policy.PolicyEngine(
        tm, pool, m.policy.PolicyConfig(
            min_workers=1, max_workers=3, stream_lag_s=60.0,
            stream_lag_ticks=2, scale_hold_ticks=1),
        clock=clk, stream_lag_fn=lambda: next(lag))
    return engine, pool, [engine.tick() for _ in range(9)]


def _tick_fault(m, clk, tm, telemetry):
    tm.stragglers = {0: {"straggler": True, "flagged_for_s": 100.0}}
    pool = StubPool(2, tm=tm)
    engine = m.policy.PolicyEngine(tm, pool, m.policy.PolicyConfig(
        min_workers=1, max_workers=2, straggler_dwell_s=1.0,
        eviction_budget=1), clock=clk)
    m.faults.install(m.faults.FaultRegistry(
        [m.faults.FaultSpec(m.faults.POINT_POLICY_TICK, 0, "raise")]))
    out = [engine.tick(), engine.metrics_registry.value(
        "master_policy_skipped_ticks_total"), engine.tick()]
    m.faults.uninstall()
    return engine, pool, out


SCENARIOS = {
    "evict_dwell_budget": _evict_dwell_budget,
    "evict_cooldown": _evict_cooldown,
    "backlog_ceiling": _backlog_ceiling,
    "backlog_groups": _backlog_groups,
    "data_wait_stragglers": _data_wait_stragglers,
    "no_progress": _no_progress,
    "stream_lag": _stream_lag,
    "tick_fault": _tick_fault,
}


def _run(m, scenario):
    seen = []

    def observe(record):
        if record.get("event") == "policy_decision":
            seen.append({k: v for k, v in record.items()
                         if k not in ("ts", "pid", "role")})

    m.events.add_observer(observe)
    try:
        engine, pool, out = scenario(m, FakeClock(), StubTaskManager(), {})
    finally:
        m.events.remove_observer(observe)
    return {"ticks": out, "decisions": engine.decisions,
            "snapshot": engine.snapshot(), "events": seen,
            "actions": pool.actions, "alive": pool.alive_workers()}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_equal_the_jax_engines(name):
    jax = _run(JAX, SCENARIOS[name])
    port = _run(PORT, SCENARIOS[name])
    assert port == jax
    # the no-progress case must decide nothing; every other one acts
    assert bool(port["decisions"]) == (name != "no_progress")


def test_the_reference_outcomes_hold():
    """The port's engine on its own: the outcomes the JAX tests assert."""
    run = _run(PORT, _backlog_ceiling)
    assert [d and d["action"] for d in run["ticks"]] == [
        None, "scale_up", None, "scale_up", None, None, None]
    assert len(run["alive"]) == 6
    run = _run(PORT, _data_wait_stragglers)
    removed = [d["removed"] for d in run["ticks"] if d]
    assert removed == [[3], [0]]
    assert run["alive"] == [1, 2]
    run = _run(PORT, _tick_fault)
    assert run["ticks"][0] is None and run["ticks"][1] == 1.0
    assert run["ticks"][2]["action"] == "evict"
    run = _run(PORT, _stream_lag)
    assert [d["reason"] for d in run["decisions"]] == ["stream_lag"] * 2


def test_interval_zero_disables_the_thread_and_from_args_reads_defaults():
    engine = port_policy.PolicyEngine(
        StubTaskManager(), StubPool(1), port_policy.PolicyConfig())
    assert engine.start() is False
    engine.stop()
    args = SimpleNamespace(num_workers=3, min_workers=2, max_workers=0,
                           policy_interval=5.0, stream_lag_s=30.0)
    assert port_policy.PolicyConfig.from_args(args) == \
        port_policy.PolicyConfig(**vars(
            jax_policy.PolicyConfig.from_args(args)))
    assert port_policy.PolicyConfig.from_args(args).max_workers == 3
