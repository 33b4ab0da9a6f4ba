"""The port's metric history and SLO evaluator (common/history.py,
common/slo.py) against the JAX package's, on the same registry
mutations under one hand-ticked fake clock: series, windows, counter
deltas and rates, histogram windows and quantiles, SLO reports, burn
rates, states, breach/recover decisions and events all match exactly
(the same float64 arithmetic on the same samples).  Also: the judgment
flags parse to the JAX parser's defaults, and the Local master's
wiring."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from elasticdl_tpu.common import args as jax_args
from elasticdl_tpu.common import events as jax_events
from elasticdl_tpu.common import history as jax_history
from elasticdl_tpu.common import metrics as jax_metrics
from elasticdl_tpu.common import slo as jax_slo
from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.common import events as port_events
from elasticdl_tpu_torch.common import flight
from elasticdl_tpu_torch.common import history as port_history
from elasticdl_tpu_torch.common import metrics as port_metrics
from elasticdl_tpu_torch.common import slo as port_slo
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.model_zoo.deepfm.data import write_dataset

torch.set_num_threads(2)

JAX = SimpleNamespace(events=jax_events, history=jax_history,
                      metrics=jax_metrics, slo=jax_slo)
PORT = SimpleNamespace(events=port_events, history=port_history,
                       metrics=port_metrics, slo=port_slo)
JUDGMENT_FLAGS = ("history_interval", "history_capacity", "slo_interval",
                  "slo_staleness_p99_s", "trace_sample_rate",
                  "incident_dir", "incident_ring", "incident_max_bundles")


class FakeClock:
    def __init__(self, start=1000.0):
        self.now = start

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def _stable(records):
    return [{k: v for k, v in r.items() if k not in ("ts", "pid", "role")}
            for r in records]


# (steps, staleness s, fleet skew, requests, errors, sheds) per sample,
# 5 s apart: healthy, then a stall that breaches every SLO, then healthy
# until the 40-sample ring has aged the stall out of every window and
# each SLO recovers.
PHASES = ((10, 0.5, 2.0, 100, 0, 1), (6, 30.0, 20.0, 100, 5, 90),
          (45, 0.4, 1.0, 100, 0, 0))
WINDOWS = (7.0, 30.0, 60.0, 600.0)


def _judge(m):
    clock = FakeClock()
    reg = m.metrics.MetricsRegistry()
    staleness = reg.histogram(
        "master_train_to_serve_staleness_seconds", "fixture",
        min_value=1e-3, max_value=3600.0, growth=1.5)
    skew = reg.gauge("serving_fleet_model_step_skew_steps", "fixture")
    requests = reg.counter("rpc_fleet_requests_total", "fixture")
    errors = reg.counter("rpc_fleet_request_errors_total", "fixture")
    sheds = reg.counter("rpc_fleet_sheds_total", "fixture")
    history = m.history.MetricHistory(registries=[reg], capacity=40,
                                      clock=clock)
    args = SimpleNamespace(slo_staleness_p99_s=2.0)
    breaches, seen = [], []
    evaluator = m.slo.SloEvaluator(
        history, specs=m.slo.shipped_specs(args), clock=clock,
        on_breach=breaches.append)
    m.events.add_observer(seen.append)
    out = {"ticks": []}
    try:
        evaluator.tick()     # no evidence yet
        out["before"] = evaluator.report()
        for steps, stale, sk, req, err, shed in PHASES:
            for _ in range(steps):
                for _ in range(4):
                    staleness.record(stale)
                skew.set(sk)
                requests.inc(req)
                errors.inc(err)
                sheds.inc(shed)
                history.tick()
                evaluator.tick()
                clock.advance(5.0)
                out["ticks"].append((
                    evaluator.report(), evaluator.burn_rates(),
                    evaluator.max_burn(),
                    {s: evaluator.state(s) for s in sorted(
                        m.slo.SLO_NAMES)}))
        name = "master_train_to_serve_staleness_seconds"
        out["reads"] = {
            w: (history.window("serving_fleet_model_step_skew_steps", w),
                history.counter_delta("rpc_fleet_requests_total", w),
                history.rate("rpc_fleet_request_errors_total", w),
                history.exceedance_ratio(
                    "serving_fleet_model_step_skew_steps", 5.0, w),
                history.histogram_window(name, w),
                history.histogram_quantile(name, 0.5, w),
                history.histogram_quantile(name, 0.99, w),
                history.histogram_exceedance(name, 2.0, w))
            for w in WINDOWS}
        out["series"] = {n: history.series(n)
                         for n in history.series_names()}
        out["latest"] = history.latest(f"{name}_p99")
        out["history"] = history.snapshot()
        out["slo"] = evaluator.snapshot()
        out["status"] = evaluator.metrics_registry.snapshot()
    finally:
        m.events.remove_observer(seen.append)
    out["breaches"] = breaches
    out["events"] = _stable(seen)
    return out


def test_history_and_slo_judgment_match_the_jax_modules():
    want, got = _judge(JAX), _judge(PORT)
    for key in want:
        assert got[key] == want[key], key
    # the script went through every state of every SLO
    assert all(row["state"] == "no_data" for row in want["before"])
    decisions = [(d["slo"], d["event"]) for d in want["slo"]["decisions"]]
    for name in sorted(jax_slo.SLO_NAMES):
        assert (name, "slo_breach") in decisions, name
        assert (name, "slo_recovered") in decisions, name
    assert [d["slo"] for d in want["breaches"]] == [
        d for d, e in decisions if e == "slo_breach"]
    assert {e["event"] for e in want["events"]} == {
        "slo_breach", "slo_recovered"}
    assert want["history"]["samples"] == sum(p[0] for p in PHASES)


def test_shipped_specs_and_spec_validation_match():
    for args in (None, SimpleNamespace(slo_staleness_p99_s=7.5,
                                       serving_step_skew_slo=3)):
        assert [dataclasses.asdict(s)
                for s in port_slo.shipped_specs(args)] == [
            dataclasses.asdict(s) for s in jax_slo.shipped_specs(args)]
    assert port_slo.SLO_NAMES == jax_slo.SLO_NAMES
    assert port_slo.STATES == jax_slo.STATES
    with pytest.raises(AssertionError):
        port_slo.SloSpec(name="nope", kind="gauge", series="x",
                         objective=1.0)
    with pytest.raises(AssertionError):
        port_slo.SloSpec(name="predict_availability", kind="ratio",
                         series="x", objective=0.0)


def test_history_ring_resets_and_threads_match():
    for m in (JAX, PORT):
        clock = FakeClock()
        reg = m.metrics.MetricsRegistry()
        gauge = reg.gauge("master_test_events_count", "fixture")
        history = m.history.MetricHistory(registries=[reg], capacity=3,
                                          clock=clock)
        for value in (5.0, 8.0, 2.0, 4.0):
            gauge.set(value)
            history.tick()
            clock.advance(1.0)
        # capacity 3 keeps 8, 2, 4: the drop to 2 is a reset
        assert history.counter_delta("master_test_events_count",
                                     60.0) == 4.0
        assert history.start() is False        # interval 0: hand ticks
        evaluator = m.slo.SloEvaluator(history, specs=[], clock=clock)
        assert evaluator.start() is False
        looping = m.history.MetricHistory(registries=[reg],
                                          interval_s=0.01)
        assert looping.start() is True and looping.start() is False
        looping.stop()
        assert looping._thread is None


def test_judgment_flags_parse_to_the_jax_defaults():
    want = jax_args.parse_master_args([])
    got = cli.parse_args(["train"])
    for flag in JUDGMENT_FLAGS:
        assert getattr(got, flag) == getattr(want, flag), flag
        assert type(getattr(got, flag)) is type(getattr(want, flag))
    argv = ["--history_interval", "0.5", "--history_capacity", "64",
            "--slo_interval", "0.25", "--slo_staleness_p99_s", "9",
            "--trace_sample_rate", "0.5", "--incident_dir", "/x",
            "--incident_ring", "16", "--incident_max_bundles", "2"]
    want = jax_args.parse_master_args(argv)
    got = cli.parse_args(["train", *argv])
    for flag in JUDGMENT_FLAGS:
        assert getattr(got, flag) == getattr(want, flag), flag
    with pytest.raises(SystemExit):
        cli.parse_args(["train", "--history_capacity", "0"])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("criteo")
    return write_dataset(str(root), n_train=256, n_val=64)


def test_local_job_with_judgment_flags_ends_where_it_ends_without(
        data, tmp_path):
    """The master's history, SLO evaluator and flight recorder watch the
    job and change nothing in it: the final state is bit for bit the
    plain job's.  A Local job serves nothing: the ratio SLOs read `ok`
    over the fleet router's request counters, which exist at zero once
    proto/service.py is imported, as in the JAX package's Local job, and
    the others are `no_data`; a manual capture writes a bundle that
    reads back."""
    train_dir, val_dir = data
    flags = ["train", "--distribution_strategy", "Local",
             "--model_def", "deepfm.deepfm_functional_api.custom_model",
             "--model_params", "vocab_capacity=4096;embed_dim=8;lr=0.005",
             "--minibatch_size", "64", "--records_per_task", "128",
             "--use_bf16", "false", "--training_data", train_dir,
             "--validation_data", val_dir, "--evaluation_steps", "2",
             "--device", "cpu"]
    plain = api.run_local(cli.parse_args(flags), "train")
    incident_dir = str(tmp_path / "incidents")
    judged = api.run_local(cli.parse_args(
        flags + ["--history_interval", "0.01", "--slo_interval", "0.01",
                 "--incident_dir", incident_dir]), "train")
    assert plain.exit_code == judged.exit_code == 0
    want = plain.owner.state.model.state_dict()
    got = judged.owner.state.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert judged.owner.step == plain.owner.step == 4
    assert judged.metrics == plain.metrics
    master = judged.master
    assert plain.master.metric_history is None
    assert "slo" not in plain.master.snapshot()
    snap = master.snapshot()
    assert snap["slo"]["states"] == {
        port_slo.SLO_STALENESS_P99: "no_data",
        port_slo.SLO_FLEET_SKEW: "no_data",
        port_slo.SLO_PREDICT_AVAILABILITY: "ok",
        port_slo.SLO_PREDICT_SHED_RATIO: "ok"}
    assert snap["slo"]["history"]["samples"] >= 1
    assert snap["flight"]["incident_dir"] == incident_dir
    assert snap["flight"]["captured"] == []
    # stop() joined both threads and took the recorder off the tap
    assert master.metric_history._thread is None
    assert master.slo_evaluator._thread is None
    assert master.flight_recorder.observe not in port_events._observers
    assert master.slo_evaluator.metrics_registry in \
        master.telemetry_registries()
    path = master.flight_recorder.capture("manual")
    (listed,) = flight.list_bundles(incident_dir)
    bundle = flight.load_bundle(path)
    assert listed["path"] == path
    assert bundle["manifest"]["trigger"] == "manual"
    assert bundle["master"]["tasks"]["counters"]["by_type"] == {
        str(k): v for k, v in snap["tasks"]["counters"]["by_type"].items()}
    assert bundle["history"]["samples"] >= 1
    # the master's recorder takes the process's program registry: every
    # bundle carries its clock-free ledger
    assert "worker_train_step" in bundle["programs"]["ledger"]


def test_judgment_wiring_off_without_the_flags_and_on_with_any(tmp_path):
    train_dir, _ = write_dataset(str(tmp_path / "d"), n_train=64, n_val=8)
    base = ["train", "--distribution_strategy", "Local",
            "--training_data", train_dir, "--records_per_task", "64",
            "--device", "cpu"]
    for extra, built in (([], False), (["--slo_interval", "0"], False),
                         (["--incident_dir", str(tmp_path / "i")], True),
                         (["--history_interval", "2"], True)):
        args = cli.parse_args(base + extra)
        args.job_type = "train"
        master = Master(args)
        try:
            assert (master.flight_recorder is not None) is built
            assert (master.slo_evaluator is not None) is built
            if built:
                assert master.flight_recorder.observe in \
                    port_events._observers
                master.start()
                assert (master.metric_history._thread is not None) is (
                    args.history_interval > 0)
                assert master.slo_evaluator._thread is None
        finally:
            master.stop()
        if built:
            assert master.flight_recorder.observe not in \
                port_events._observers
            assert master.metric_history._thread is None
