"""The port's serving fleet against the JAX package's: `FleetRouter`
(proto/service.py), `ServingFleetManager` (master/serving_fleet.py) and
`ServingPolicyEngine` (master/policy.py).

- The router's membership cases of tests/test_fleet_router_membership.py,
  each run on both routers with the same stub replicas: same responses,
  same stats, same penalty buckets.
- The fleet cases of tests/test_serving_fleet.py on three in-process
  ctr_mlp replicas per package (engine + batcher + reloader over one
  checkpoint directory, killable clients, one fake clock): placement and
  probe bookkeeping, a replica kill with failover and relaunch, probe
  failures, the rolling reload under the skew SLO, the seeded chaos
  scenario, and the `fleet.scale` fault.  Decisions, snapshots, the
  fleet's span events and the fault trace must equal the JAX fleet's.
  Each package trains nothing: the two checkpoints' weights differ, and
  no decision reads a prediction.
- `ServingPolicyEngine` on one fake fleet per package (the cases of
  tests/test_serving_policy.py): equal decision lists, events and
  snapshots."""

import json
import types
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.common import events as jax_events
from elasticdl_tpu.common import faults as jax_faults
from elasticdl_tpu.common import k8s_client as jax_k8s
from elasticdl_tpu.common import model_handler as jax_handler
from elasticdl_tpu.common import resilience as jax_resilience
from elasticdl_tpu.common import save_utils as jax_save
from elasticdl_tpu.master import policy as jax_policy
from elasticdl_tpu.master import serving_fleet as jax_fleet
from elasticdl_tpu.proto import serving_pb2 as jax_spb
from elasticdl_tpu.proto import service as jax_service
from elasticdl_tpu.serving import batcher as jax_batcher
from elasticdl_tpu.serving import engine as jax_engine
from elasticdl_tpu.serving import reloader as jax_reloader
from elasticdl_tpu.serving import server as jax_server
from elasticdl_tpu.worker import trainer as jax_trainer
from elasticdl_tpu_torch.common import events as port_events
from elasticdl_tpu_torch.common import faults as port_faults
from elasticdl_tpu_torch.common import k8s_client as port_k8s
from elasticdl_tpu_torch.common import model_handler as port_handler
from elasticdl_tpu_torch.common import resilience as port_resilience
from elasticdl_tpu_torch.common import save_utils as port_save
from elasticdl_tpu_torch.common.constants import PodStatus
from elasticdl_tpu_torch.master import policy as port_policy
from elasticdl_tpu_torch.master import serving_fleet as port_fleet
from elasticdl_tpu_torch.proto import serving as port_spb
from elasticdl_tpu_torch.proto import service as port_service
from elasticdl_tpu_torch.serving import batcher as port_batcher
from elasticdl_tpu_torch.serving import engine as port_engine
from elasticdl_tpu_torch.serving import reloader as port_reloader
from elasticdl_tpu_torch.serving import server as port_server
from elasticdl_tpu_torch.worker import trainer as port_trainer

torch.set_num_threads(2)

CTR = "clickstream.ctr_mlp.custom_model"
BUCKETS = (2,)
REPLICAS = 3
SEED = 20260805
_FLEET_EVENTS = ("serving_replica_relaunched", "fleet_reload_step",
                 "fleet_reload_refused")

JAX = SimpleNamespace(
    name="jax", events=jax_events, faults=jax_faults, k8s=jax_k8s,
    resilience=jax_resilience, policy=jax_policy, fleet=jax_fleet,
    spb=jax_spb, service=jax_service, batcher=jax_batcher,
    engine=jax_engine, reloader=jax_reloader, server=jax_server)
PORT = SimpleNamespace(
    name="port", events=port_events, faults=port_faults, k8s=port_k8s,
    resilience=port_resilience, policy=port_policy, fleet=port_fleet,
    spb=port_spb, service=port_service, batcher=port_batcher,
    engine=port_engine, reloader=port_reloader, server=port_server)


@pytest.fixture(autouse=True)
def _clean_globals():
    yield
    for m in (JAX, PORT):
        m.faults.uninstall()
        m.events.configure(None)


class FakeClock:
    def __init__(self, start=1000.0):
        self.now = start

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def _no_sleep_policy(m, max_attempts=8):
    return m.resilience.RetryPolicy(
        initial_backoff_s=0.0, max_backoff_s=0.0, max_elapsed_s=30.0,
        max_attempts=max_attempts, sleep=lambda _s: None)


# ---- the router's membership cases ----------------------------------------


class StubClient:
    """A scripted replica; `on_predict` retires replicas from inside a
    sweep, as a concurrent scale_down does."""

    def __init__(self, m, mode="ok", on_predict=None):
        self.m = m
        self.mode = mode
        self.on_predict = on_predict
        self.calls = 0

    def predict(self, request, timeout=None):
        self.calls += 1
        if self.on_predict is not None:
            self.on_predict()
        if self.mode == "raise":
            raise ConnectionError("replica gone")
        response = self.m.spb.PredictResponse()
        response.code = (self.m.spb.SERVING_OVERLOADED
                         if self.mode == "shed" else self.m.spb.SERVING_OK)
        response.model_step = 7
        return response

    def health(self, request, timeout=None):
        return self.predict(request, timeout=timeout)


def _retired_mid_sweep_is_retryable(m):
    router = m.service.FleetRouter(clients={0: StubClient(m)},
                                   retry_policy=_no_sleep_policy(m, 4))
    ranked = router._ranked
    orders = [[9], [8, 7]]
    router._ranked = lambda: orders.pop(0) if orders else ranked()
    out = [int(router.predict(m.spb.PredictRequest()).code)]
    router._ranked = lambda: [9]
    with pytest.raises(m.resilience.RetryBudgetExhausted,
                       match="no serving replica survived"):
        router.predict(m.spb.PredictRequest())
    return router, out


def _retired_fails_over(m):
    router = m.service.FleetRouter(retry_policy=_no_sleep_policy(m, 4))
    survivor = StubClient(m)

    def retire_self():
        router.remove_client(0)
        raise ConnectionError("retired mid-flight")

    router.set_client(0, StubClient(m, on_predict=retire_self))
    router.set_client(1, survivor)
    out = [int(router.predict(m.spb.PredictRequest()).code),
           survivor.calls, 0 in router._penalty]
    return router, out


def _join_during_shed(m):
    shedder = StubClient(m, mode="shed")
    router = m.service.FleetRouter(clients={0: shedder},
                                   retry_policy=_no_sleep_policy(m, 4))
    out = [int(router.predict(m.spb.PredictRequest()).code),
           router._penalty[0]]
    joiner = StubClient(m)
    router.set_client(1, joiner)
    out += [router._penalty[1],
            int(router.predict(m.spb.PredictRequest()).code), joiner.calls]
    return router, out


def _mark_live_after_remove(m):
    router = m.service.FleetRouter(
        clients={0: StubClient(m), 1: StubClient(m)},
        retry_policy=_no_sleep_policy(m, 4))
    router.mark_down(0)
    router.remove_client(0)
    router.mark_live(0)
    out = [0 in router._penalty, 0 in router._fill]
    router.set_client(0, StubClient(m))
    out.append(router._penalty[0])
    return router, out


MEMBERSHIP = {
    "all_candidates_retired_mid_sweep": _retired_mid_sweep_is_retryable,
    "replica_retired_mid_sweep_fails_over": _retired_fails_over,
    "join_during_whole_fleet_shed": _join_during_shed,
    "mark_live_cannot_resurrect_a_bucket": _mark_live_after_remove,
}
MEMBERSHIP_EXPECTED = {
    "all_candidates_retired_mid_sweep": [0],
    "replica_retired_mid_sweep_fails_over": [0, 1, False],
    "join_during_whole_fleet_shed": [1, 1, 0, 0, 1],
    "mark_live_cannot_resurrect_a_bucket": [False, False, 0],
}


def _router_view(router):
    stats = router.stats()
    return {"stats": stats, "ids": router.replica_ids(),
            "penalty": dict(router._penalty), "fill": dict(router._fill),
            "skew": router.observed_step_skew()}


@pytest.mark.parametrize("name", sorted(MEMBERSHIP))
def test_router_membership_equals_the_jax_router(name):
    runs = {}
    for m in (JAX, PORT):
        router, out = MEMBERSHIP[name](m)
        runs[m.name] = (out, _router_view(router))
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == MEMBERSHIP_EXPECTED[name]


def test_router_samples_every_kth_request_and_scores_freshness():
    """Trace ids and sampling: with trace_sample_rate 0.5 every second
    request carries its id on the wire; each served response's model_step
    reaches the freshness tracker."""
    seen, scored = {}, []

    class Freshness:
        def observe_response(self, step):
            scored.append(step)
            return 3, 0.5

    for m in (JAX, PORT):
        ids = []

        class Echo(StubClient):
            def predict(self, request, timeout=None, _ids=ids):
                _ids.append(request.request_id)
                return super().predict(request, timeout)

        router = m.service.FleetRouter(
            clients={0: Echo(m)}, retry_policy=_no_sleep_policy(m),
            freshness=Freshness(), trace_sample_rate=0.5)
        for _ in range(4):
            router.predict(m.spb.PredictRequest())
        seen[m.name] = (ids, router.stats()["last_staleness_steps"])
    assert seen["port"] == seen["jax"] == (
        ["", "rq-00000002", "", "rq-00000004"], 3)
    assert scored == [7] * 8


# ---- the fleet over real in-process replicas --------------------------------


class KillableClient:
    def __init__(self, m, servicer):
        self._inner = m.service.InProcessServingClient(servicer)
        self.killed = False

    def predict(self, request, timeout=None):
        if self.killed:
            raise ConnectionError("replica killed")
        return self._inner.predict(request, timeout=timeout)

    def health(self, request, timeout=None):
        if self.killed:
            raise ConnectionError("replica killed")
        return self._inner.health(request, timeout=timeout)


class _JaxModel:
    """ctr_mlp's checkpoints through the JAX package."""

    def __init__(self, ckpt_dir, sample):
        self.spec = jax_handler.get_model_spec("model_zoo", CTR)
        variables = dict(self.spec.model.init(jax.random.PRNGKey(0),
                                              sample))
        self.params = {"params": variables.pop("params")}
        self.saver = jax_save.CheckpointSaver(ckpt_dir, async_save=False)

    def save_step(self, step, scale):
        params = jax.tree.map(lambda a: a * scale, self.params)
        state = jax_trainer.TrainState(
            step=jnp.asarray(step, jnp.int32), params=params,
            opt_state=self.spec.optimizer.init(params), model_state={})
        self.saver.save(state, force=True)
        self.saver.wait_until_finished()

    def engine(self, ckpt_dir, sample):
        return jax_engine.ServingEngine.from_checkpoint(
            ckpt_dir, self.spec, sample, buckets=BUCKETS)


class _PortModel:
    """ctr_mlp's checkpoints through the port, on the CPU."""

    def __init__(self, ckpt_dir, sample):
        self.spec = port_handler.get_model_spec(port_handler.ZOO_DIR, CTR)
        trainer = port_trainer.Trainer(self.spec.model, self.spec.optimizer,
                                       self.spec.loss, device="cpu")
        self.state = trainer.init_state(0, sample)
        self.base = {k: v.clone()
                     for k, v in self.state.model.state_dict().items()}
        self.saver = port_save.CheckpointSaver(ckpt_dir)

    def save_step(self, step, scale):
        self.state.model.load_state_dict(
            {k: v * scale for k, v in self.base.items()})
        self.state.step = step
        self.saver.save(self.state)
        self.saver.wait_until_finished()

    def engine(self, ckpt_dir, sample):
        return port_engine.ServingEngine.from_checkpoint(
            ckpt_dir, self.spec, sample, buckets=BUCKETS, device="cpu")


class Fleet:
    """Three replicas over one checkpoint directory, a router and a
    tick-driven fleet manager, all of one package."""

    def __init__(self, m, tmp_path, skew_slo=10, probe_failures=2):
        self.m = m
        self.sample = np.zeros((2, 128), np.float32)
        self.sample[0, 3] = self.sample[0, 70] = 1.0
        self.sample[1, 9] = self.sample[1, 100] = 1.0
        self.ckpt_dir = str(tmp_path / m.name)
        self.model = (_JaxModel if m is JAX else _PortModel)(
            self.ckpt_dir, self.sample)
        self.latest_step = None
        self.save_step(1, 1.0)
        self.clock = FakeClock()
        self.replicas = {}
        for rid in range(REPLICAS):
            engine = self.model.engine(self.ckpt_dir, self.sample)
            batcher = m.batcher.DynamicBatcher(engine, max_latency_s=0.002)
            reloader = m.reloader.CheckpointReloader(
                engine, self.ckpt_dir, poll_interval_s=3600.0)
            servicer = m.server.ServingServicer(engine, batcher, reloader)
            self.replicas[rid] = {"engine": engine, "batcher": batcher,
                                  "reloader": reloader,
                                  "servicer": servicer, "client": None}
        self.k8s = m.k8s.FakeK8sClient()
        self.router = m.service.FleetRouter(
            retry_policy=_no_sleep_policy(m))
        self.manager = m.fleet.ServingFleetManager(
            self.k8s, m.fleet.ServingFleetConfig(
                replicas=REPLICAS, interval_s=0.0,
                probe_failures=probe_failures, step_skew_slo=skew_slo),
            job_name="fleet", client_factory=self._client_factory,
            reload_fn=lambda rid: self.replicas[rid]["reloader"]
            .check_once(),
            pending_step_fn=lambda: self.latest_step,
            router=self.router, clock=self.clock)
        self.manager.place()
        self.request = m.server.make_predict_request(self.sample)

    def _client_factory(self, rid, _address):
        rep = self.replicas[rid]
        rep["client"] = KillableClient(self.m, rep["servicer"])
        return rep["client"]

    def save_step(self, step, scale):
        self.model.save_step(step, scale)
        self.latest_step = step

    def kill(self, rid):
        self.replicas[rid]["client"].killed = True
        pod = self.manager.snapshot()["replicas"][rid]["pod"]
        self.k8s.emit(pod, PodStatus.FAILED, exit_code=1)

    def step_tick(self, dt=1.0):
        records = self.manager.tick()
        self.clock.advance(dt)
        return records

    def predict(self):
        return int(self.router.predict(self.request).code)

    def close(self):
        for rep in self.replicas.values():
            rep["batcher"].shutdown()
        self.model.saver.close()


def _fleet_view(fleet):
    snap = fleet.manager.snapshot()
    for rep in snap["replicas"].values():
        # batcher tails are wall-clock seconds
        rep.pop("queue_wait_p99_s")
        rep.pop("compute_p99_s")
    return {"snapshot": snap,
            "engine_steps": [fleet.replicas[r]["engine"].step
                             for r in range(REPLICAS)],
            "router_skew": fleet.router.max_observed_step_skew}


def _kill_failover(f):
    f.step_tick()
    codes = [f.predict() for _ in range(6)]
    f.kill(1)
    codes += [f.predict() for _ in range(6)]
    records = f.step_tick()
    codes += [f.predict() for _ in range(6)]
    return {"codes": codes, "records": records,
            "error_failovers": f.router.stats()["failovers"]["error"] >= 1,
            "replacement": int(f.replicas[1]["client"].predict(
                f.request).code)}


def _probe_failures(f):
    m = f.m
    reg = m.faults.install(m.faults.FaultRegistry([
        m.faults.FaultSpec(m.faults.POINT_RPC_HEALTH_PROBE, 1, "raise"),
        m.faults.FaultSpec(m.faults.POINT_RPC_HEALTH_PROBE, 4, "raise")],
        seed=SEED))
    records = [f.step_tick(), f.step_tick(), f.step_tick()]
    return {"records": records, "fired": reg.all_fired(),
            "trace": reg.trace_text()}


def _rolling_reload(f):
    f.step_tick()
    f.save_step(5, 2.0)
    codes, records = [], []
    for _ in range(3):
        codes.append(f.predict())
        records.append(f.step_tick())
        codes.append(f.predict())
    f.save_step(50, 3.0)
    records += [f.step_tick(), f.step_tick()]
    return {"codes": codes, "records": records}


def _chaos(f):
    m = f.m
    reg = m.faults.install(m.faults.FaultRegistry([
        m.faults.FaultSpec(m.faults.POINT_RPC_HEALTH_PROBE, 1, "raise"),
        m.faults.FaultSpec(m.faults.POINT_RPC_HEALTH_PROBE, 4, "raise"),
        m.faults.FaultSpec(m.faults.POINT_RPC_HEALTH_PROBE, 7, "raise"),
        m.faults.FaultSpec(m.faults.POINT_SERVING_REPLICA_KILL, 0, "raise"),
        m.faults.FaultSpec(m.faults.POINT_FLEET_RELOAD_STEP, 0, "raise")],
        seed=SEED))
    reg.note("scenario", "probe-flap-then-rolling-reload")
    codes = []
    for tick in range(1, 9):
        if tick == 4:
            f.save_step(5, 2.0)
        f.step_tick()
        codes.append(f.predict())
    return {"codes": codes, "fired": reg.all_fired(),
            "trace": reg.trace_text(),
            "decisions_json": json.dumps(f.manager.decisions,
                                         sort_keys=True)}


FLEET_CASES = {
    "replica_kill_failover_and_relaunch": _kill_failover,
    "probe_failures_trigger_relaunch": _probe_failures,
    "rolling_reload_holds_the_skew_slo": _rolling_reload,
    "chaos_probe_flap_then_rolling_reload": _chaos,
}


def _fleet_run(m, tmp_path, case):
    seen = []

    def observe(record):
        if record.get("event") in _FLEET_EVENTS:
            seen.append({k: v for k, v in record.items()
                         if k not in ("ts", "pid", "role")})

    m.events.add_observer(observe)
    f = Fleet(m, tmp_path)
    try:
        out = case(f)
        out.update(_fleet_view(f))
    finally:
        f.close()
        m.faults.uninstall()
        m.events.remove_observer(observe)
    out["events"] = seen
    return out


@pytest.mark.parametrize("name", sorted(FLEET_CASES))
def test_fleet_equals_the_jax_fleet(tmp_path, name):
    jax_run = _fleet_run(JAX, tmp_path, FLEET_CASES[name])
    port_run = _fleet_run(PORT, tmp_path, FLEET_CASES[name])
    assert port_run == jax_run
    snap = port_run["snapshot"]
    if "codes" in port_run:
        assert set(port_run["codes"]) == {int(port_spb.SERVING_OK)}
    if name == "chaos_probe_flap_then_rolling_reload":
        assert port_run["fired"]
        assert [d["action"] for d in json.loads(
            port_run["decisions_json"])] == [
            "relaunch_aborted", "relaunch", "reload_aborted",
            "reload_step", "reload_step", "reload_step"]
        assert snap["max_model_step_skew"] == 4
    if name == "rolling_reload_holds_the_skew_slo":
        assert [r[0]["action"] if r else None
                for r in port_run["records"]] == [
            "reload_step"] * 3 + ["reload_refused", None]
        assert port_run["engine_steps"] == [5] * REPLICAS
    if name == "replica_kill_failover_and_relaunch":
        assert snap["replicas"][1]["pod"] == "fleet-serving-1-1"


def test_chaos_fleet_trace_is_byte_stable(tmp_path):
    a = _fleet_run(PORT, tmp_path / "a", _chaos)
    b = _fleet_run(PORT, tmp_path / "b", _chaos)
    assert (a["decisions_json"], a["events"], a["trace"]) == \
        (b["decisions_json"], b["events"], b["trace"])


class _StubHealthClient:
    def __init__(self, m, step):
        self.m, self.step = m, step

    def health(self, _request, timeout=None):
        spb = self.m.spb
        return spb.HealthResponse(
            serving=True, model_step=self.step, queue_depth=2,
            metrics=[spb.ScalarMetric(name="batch_fill_ratio", value=0.5),
                     spb.ScalarMetric(name="shed", value=3.0),
                     spb.ScalarMetric(name="phase_queue_wait_p99_s",
                                      value=0.012),
                     spb.ScalarMetric(name="phase_compute_p99_s",
                                      value=0.034),
                     spb.ScalarMetric(name="produced_unix_s",
                                      value=1000.0)])


def test_placement_and_probe_bookkeeping_equal_the_jax_managers():
    runs = {}
    for m in (JAX, PORT):
        k8s = m.k8s.FakeK8sClient()
        steps = {0: 3, 1: 3, 2: 9}
        router = m.service.FleetRouter(retry_policy=_no_sleep_policy(m))
        manager = m.fleet.ServingFleetManager(
            k8s, m.fleet.ServingFleetConfig(replicas=3, interval_s=0.0),
            job_name="j",
            client_factory=lambda rid, _a, _m=m: _StubHealthClient(
                _m, steps[rid]),
            router=router, clock=FakeClock())
        placed = [manager.place(), manager.place(), manager.start()]
        records = [manager.tick(), manager.tick()]
        manager.stop()
        runs[m.name] = (placed, records, manager.snapshot(),
                        router.observed_step_skew(), manager.fill_signal(),
                        manager.projected_scale_skew(),
                        [(s.name, s.worker_id, s.labels)
                         for s in k8s.create_calls],
                        dict(k8s.services))
    assert runs["port"] == runs["jax"]
    snap = runs["port"][2]
    assert snap["replicas"][1]["pod"] == "j-serving-1-0"
    assert snap["model_step_skew"] == 6
    # the second probe saw the same produced stamp: the replicas are idle
    assert runs["port"][4] == 0.0


def test_fleet_scale_fault_aborts_atomically_then_retries():
    runs = {}
    for m in (JAX, PORT):
        router = m.service.FleetRouter(retry_policy=_no_sleep_policy(m))
        manager = m.fleet.ServingFleetManager(
            m.k8s.FakeK8sClient(),
            m.fleet.ServingFleetConfig(replicas=1, interval_s=0.0),
            job_name="scalefleet",
            client_factory=lambda rid, addr: object(), router=router)
        manager.place()
        out = []
        for action, count in (("scale_up", 2), ("scale_down", 1)):
            m.faults.install(m.faults.FaultRegistry([
                m.faults.FaultSpec(m.faults.POINT_FLEET_SCALE, 0,
                                   "raise")]))
            out.append(getattr(manager, action)(count))
            out.append(manager.live_replicas())
            out.append(getattr(manager, action)(count))
            out.append(router.replica_ids())
            m.faults.uninstall()
        snap = manager.snapshot()
        runs[m.name] = (out, snap["scale_ups"], snap["scale_downs"],
                        snap["decisions"])
    assert runs["port"] == runs["jax"]
    out = runs["port"][0]
    assert [out[0]["action"], out[2]["action"]] == ["scale_aborted",
                                                    "scale_up"]
    assert out[1] == 1 and out[3] == [0, 1, 2]
    assert [out[4]["action"], out[6]["action"]] == ["scale_aborted",
                                                    "scale_down"]
    assert out[5] == 3 and len(out[7]) == 2


def test_fleet_config_from_args_reads_getattr_defaults():
    args = types.SimpleNamespace(serving_replicas=3,
                                 serving_probe_failures=0)
    port_cfg = port_fleet.ServingFleetConfig.from_args(args)
    assert vars(port_cfg) == vars(jax_fleet.ServingFleetConfig.from_args(
        args))
    assert port_cfg.probe_failures == 1 and port_cfg.port == 50061
    assert port_fleet.ServingFleetConfig.from_args(
        types.SimpleNamespace()).replicas == 0


# ---- the serving policy engine ----------------------------------------------


class FakeFleet:
    """The surface the serving policy touches, with recording
    actuators."""

    def __init__(self, live=1, skew_slo=0):
        self.config = types.SimpleNamespace(step_skew_slo=skew_slo)
        self._live = live
        self.fill = 0.0
        self.skew = 0
        self.abort_next = False
        self.calls = []

    def live_replicas(self):
        return self._live

    def fill_signal(self):
        return self.fill

    def projected_scale_skew(self):
        return self.skew

    def scale_up(self, step):
        self.calls.append(("up", step))
        if self.abort_next:
            self.abort_next = False
            return {"action": "scale_aborted", "replicas": []}
        added = list(range(self._live, self._live + step))
        self._live += step
        return {"action": "scale_up", "replicas": added}

    def scale_down(self, step, prefer="unhealthy"):
        self.calls.append(("down", step, prefer))
        if self.abort_next:
            self.abort_next = False
            return {"action": "scale_aborted", "replicas": []}
        victims = list(range(self._live - step, self._live))
        self._live -= step
        return {"action": "scale_down", "replicas": victims}


class FakeEvaluator:
    def __init__(self, burn=0.0):
        self.burn = burn

    def max_burn(self):
        return self.burn


class FakeHistory:
    def __init__(self, offered=0.0, sheds=0.0):
        self.offered = offered
        self.sheds = sheds

    def counter_delta(self, series, window_s):
        return {"rpc_fleet_requests_total": self.offered,
                "rpc_fleet_sheds_total": self.sheds}.get(series, 0.0)


# (fleet kwargs, evaluator burn, history (offered, sheds), config
# overrides, ticks, a mid-run change (tick, attribute, value))
SERVING_CASES = {
    "burn_streak_then_hold": (dict(live=1), 5.0, None, {}, 5, None),
    "shed_ratio_before_burn": (dict(live=1), 0.0, (100.0, 10.0), {}, 2,
                               None),
    "max_replicas_clamp": (dict(live=4), 9.0, None, {}, 6, None),
    "calm_underfilled_to_min": (
        dict(live=3), 0.0, (40.0, 0.0),
        dict(down_ticks=2, scale_hold_ticks=1), 8, None),
    "idle_fleet": (dict(live=2), 0.0, (0.0, 0.0), dict(down_ticks=2), 2,
                   None),
    "reload_guard_frozen_streak": (
        dict(live=1, skew_slo=4), 5.0, None, {}, 3, (2, "skew", 0)),
    "scale_fault_retries": (dict(live=1), 5.0, None, {}, 3, None),
    "pressure_burn_times_shed": (
        dict(live=1), 4.0, (100.0, 50.0), dict(up_ticks=99), 1, None),
}


def _serving_run(m, name):
    fleet_kw, burn, hist, overrides, ticks, change = SERVING_CASES[name]
    fleet = FakeFleet(**fleet_kw)
    if name == "reload_guard_frozen_streak":
        fleet.skew = 10
    if name == "scale_fault_retries":
        fleet.abort_next = True
    cfg = dict(min_replicas=1, max_replicas=4, up_ticks=2, down_ticks=3,
               scale_hold_ticks=2, scale_step=1)
    cfg.update(overrides)
    engine = m.policy.ServingPolicyEngine(
        fleet, m.policy.ServingPolicyConfig(**cfg),
        history=FakeHistory(*hist) if hist else None,
        evaluator=FakeEvaluator(burn), clock=lambda: 0.0)
    seen = []

    def observe(record):
        if record.get("event") == "serving_scale":
            seen.append({k: v for k, v in record.items()
                         if k not in ("ts", "pid", "role")})

    m.events.add_observer(observe)
    try:
        out = []
        for i in range(ticks):
            if change is not None and i == change[0]:
                setattr(fleet, change[1], change[2])
            out.append(engine.tick())
    finally:
        m.events.remove_observer(observe)
    return {"ticks": out, "decisions": engine.decisions,
            "snapshot": engine.snapshot(), "events": seen,
            "calls": fleet.calls, "live": fleet.live_replicas(),
            "pressure": engine.serving_pressure()}


@pytest.mark.parametrize("name", sorted(SERVING_CASES))
def test_serving_policy_decisions_equal_the_jax_engines(name):
    port = _serving_run(PORT, name)
    assert port == _serving_run(JAX, name)
    actions = [d and (d["action"], d["reason"]) for d in port["ticks"]]
    expected = {
        "burn_streak_then_hold": [None, ("scale_up", "burn_rate"), None,
                                  None, ("scale_up", "burn_rate")],
        "shed_ratio_before_burn": [None, ("scale_up", "shed_ratio")],
        "max_replicas_clamp": [None] * 6,
        "calm_underfilled_to_min": [
            None, ("scale_down", "batch_fill"), None,
            ("scale_down", "batch_fill"), None, None, None, None],
        "idle_fleet": [None, ("scale_down", "idle")],
        "reload_guard_frozen_streak": [
            None, ("scale_aborted", "reload_guard"),
            ("scale_up", "burn_rate")],
        "scale_fault_retries": [None, ("scale_aborted", "fault"),
                                ("scale_up", "burn_rate")],
        "pressure_burn_times_shed": [None],
    }[name]
    assert actions == expected
    if name == "pressure_burn_times_shed":
        assert port["pressure"] == pytest.approx(2.0)


def test_serving_policy_vocabulary_and_from_args():
    engine = port_policy.ServingPolicyEngine(
        FakeFleet(), port_policy.ServingPolicyConfig(),
        evaluator=FakeEvaluator())
    with pytest.raises(AssertionError):
        engine._record("explode", "burn_rate")
    with pytest.raises(AssertionError):
        engine._record("scale_up", "vibes")
    assert engine.start() is False
    args = types.SimpleNamespace(
        serving_replicas=2, min_serving_replicas=0,
        max_serving_replicas=6, serving_burn_threshold=2.0,
        serving_scale_step=2, serving_shed_window_s=15.0)
    cfg = port_policy.ServingPolicyConfig.from_args(args)
    assert vars(cfg) == vars(jax_policy.ServingPolicyConfig.from_args(args))
    assert (cfg.min_replicas, cfg.max_replicas, cfg.scale_step) == (2, 6, 2)


def test_engines_over_one_zoo_template_own_their_modules(tmp_path):
    """A fleet builds every replica's engine from one spec.  Each engine
    swaps its served variables into its own module for a forward, so two
    engines never share one (on the card their batchers' threads raced
    on a shared module's parameters) and the template stays as it was."""
    fleet = Fleet(PORT, tmp_path)
    try:
        template = dict(fleet.model.spec.model.state_dict())
        before = {k: v.clone() for k, v in template.items()}
        engines = [fleet.replicas[r]["engine"] for r in range(REPLICAS)]
        modules = {id(e._model) for e in engines}
        assert len(modules) == REPLICAS
        assert id(fleet.model.spec.model) not in modules
        fleet.step_tick()
        fleet.save_step(5, 2.0)
        fleet.step_tick()                       # replica 0 serves step 5
        preds = [engines[r].predict({"features": fleet.sample}, 2)
                 for r in (0, 1)]
        assert preds[0][1] == 5 and preds[1][1] == 1
        assert not np.allclose(preds[0][0], preds[1][0])
        assert all(torch.equal(template[k], before[k]) for k in before)
    finally:
        fleet.close()
