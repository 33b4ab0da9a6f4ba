"""The port's traffic generator (traffic/generator.py) against the JAX
package's: for every profile and seed, the two offer the same schedule,
the same (client, rows, payload seed) requests in the same order and the
same snapshot, byte for byte; an injected `traffic.tick` fault stalls
the same tick in both; and `router_request_fn` classifies the port's
serving codes as the JAX one classifies serving.proto's."""

import json
import random

import numpy as np
import pytest
import torch

from elasticdl_tpu.common import faults as jax_faults
from elasticdl_tpu.traffic import generator as jax_gen
from elasticdl_tpu_torch.common import faults as port_faults
from elasticdl_tpu_torch.common import metrics as port_metrics
from elasticdl_tpu_torch.proto import serving as spb
from elasticdl_tpu_torch.traffic import generator as port_gen

torch.set_num_threads(2)

SEEDS = (0, 17, 20260807)
PROFILES = ("poisson", "spike", "diurnal", "ramp")


@pytest.fixture(autouse=True)
def _clean_globals():
    yield
    jax_faults.uninstall()
    port_faults.uninstall()


def _recording_fn(outcomes=("ok",)):
    calls = []
    cycle = iter(list(outcomes) * 10000)

    def request_fn(client_id, rows, payload_seed):
        calls.append((client_id, rows, payload_seed))
        return next(cycle)

    return request_fn, calls


def _run(gen_module, profile, seed, ticks=24, outcomes=("ok",), **cfg):
    fn, calls = _recording_fn(outcomes)
    gen = gen_module.TrafficGenerator(fn, gen_module.TrafficConfig(
        profile=profile, base_qps=20.0, clients=3, seed=seed,
        spike_at_tick=5, spike_ticks=4, ramp_ticks=10,
        diurnal_period_ticks=8, **cfg))
    log = gen.run(ticks)
    return gen, calls, log


def test_vocabularies_are_the_jax_packages():
    assert port_gen.TRAFFIC_PROFILES == jax_gen.TRAFFIC_PROFILES
    assert port_gen.REQUEST_SHAPES == jax_gen.REQUEST_SHAPES
    with pytest.raises(AssertionError):
        port_gen.TrafficConfig(profile="thundering_herd")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("profile", PROFILES)
def test_schedule_requests_and_snapshot_equal_the_jax_generators(
        profile, seed):
    outcomes = ("ok", "shed", "ok", "failed")
    jax, jax_calls, jax_log = _run(jax_gen, profile, seed,
                                   outcomes=outcomes)
    port, port_calls, port_log = _run(port_gen, profile, seed,
                                      outcomes=outcomes)
    assert port.schedule == jax.schedule
    assert sum(port.schedule) > 0
    assert port_calls == jax_calls
    assert port_log == jax_log
    assert json.dumps(port.snapshot(), sort_keys=True) == \
        json.dumps(jax.snapshot(), sort_keys=True)
    assert [port._factor(t) for t in range(24)] == \
        [jax._factor(t) for t in range(24)]
    assert port.offered_qps() == jax.offered_qps()


@pytest.mark.parametrize("lam", [0.0, 0.5, 8.0, 40.0])
def test_knuth_poisson_draws_equal_the_jax_ones(lam):
    a, b = random.Random(11), random.Random(11)
    assert [port_gen._poisson(a, lam) for _ in range(200)] == \
        [jax_gen._poisson(b, lam) for _ in range(200)]


def test_a_tick_fault_stalls_the_same_tick_in_both():
    runs = {}
    for name, gen_module, faults in (("jax", jax_gen, jax_faults),
                                     ("port", port_gen, port_faults)):
        faults.install(faults.FaultRegistry([
            faults.FaultSpec(faults.POINT_TRAFFIC_TICK, 2, "raise")]))
        gen, calls, log = _run(gen_module, "spike", 20260807, ticks=8)
        assert faults.get_registry().all_fired()
        faults.uninstall()
        runs[name] = (gen.schedule, calls, log, gen.snapshot())
    assert runs["port"] == runs["jax"]
    assert [r["tick"] for r in runs["port"][2] if r["faulted"]] == [2]
    assert runs["port"][3]["tick_faults"] == 1


def test_metrics_registry_counts_what_was_offered():
    gen, calls, _ = _run(port_gen, "poisson", 5, ticks=6,
                         outcomes=("ok", "shed", "failed"))
    text = port_metrics.render_text([gen.metrics_registry])
    snap = gen.snapshot()
    assert snap["offered"] == len(calls) == sum(snap["schedule"])
    assert snap["offered"] == snap["ok"] + snap["shed"] + snap["failed"]
    assert f"traffic_requests_offered_total {snap['offered']}" in text \
        or f"traffic_requests_offered_total {float(snap['offered'])}" in text


def test_router_request_fn_classifies_the_serving_codes():
    class FakeRouter:
        mode = "ok"

        def predict(self, request, timeout=None):
            if self.mode == "raise":
                raise ConnectionError("fleet down")
            if self.mode == "drop":
                raise port_faults.DroppedRequest("lost in flight")
            return spb.PredictResponse(code={
                "ok": spb.SERVING_OK, "shed": spb.SERVING_OVERLOADED,
                "down": spb.SERVING_SHUTTING_DOWN,
                "bad": spb.SERVING_INVALID}[self.mode])

    router = FakeRouter()
    fn = port_gen.router_request_fn(
        router, lambda rows, seed: np.zeros((rows, 4), np.float32))
    expected = {"ok": "ok", "shed": "shed", "down": "shed",
                "bad": "failed", "raise": "failed", "drop": "failed"}
    for mode, outcome in expected.items():
        router.mode = mode
        assert fn(0, 2, 123) == outcome, mode
