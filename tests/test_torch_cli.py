"""The port's operator commands (elasticdl_tpu_torch/client/{top,slo,
programs,trace,lineage,incident}.py) against the JAX package's: the same
JSON into both packages' renderers gives the same bytes.

The inputs are the port's own: the snapshot and program summary of a
Local DeepFM job on the CPU (with the judgment flags and an event log),
the snapshot and event log of an online loop (ctr_mlp, fake clock,
the trainer and serving policy engines on), a traffic generator's
snapshot, and bundles the port's flight recorder wrote (a seeded SLO
breach with request spans, the job's manual capture with its
`programs.json`, and a serving engine's recompile storm), so the port's
event and bundle schemas are held too.

One difference in bytes, named where it is compared: `trace --summary`'s
compile header reads "program compiles:" where the JAX package's reads
"xla compiles:", because the port's compiles are first dispatches and
kernel builds, not XLA's.  `top`'s header carries the wall clock (and
its worker rows an "ago" column), so both commands run under one
patched `time.strftime` and `time.time`.

The command line (`client.main`) runs each command on the CPU beside
the JAX package's, with the JAX tests' cases for `incident` and
`lineage` (tests/test_flight.py, tests/test_lineage.py) on the port's
renderers.
"""

import json
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu.client import incident as jax_incident
from elasticdl_tpu.client import lineage as jax_lineage
from elasticdl_tpu.client import main as jax_main
from elasticdl_tpu.client import programs as jax_programs_cli
from elasticdl_tpu.client import slo as jax_slo
from elasticdl_tpu.client import top as jax_top
from elasticdl_tpu.client import trace as jax_trace
from elasticdl_tpu.common import flight as jax_flight
from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.client import incident, lineage, programs, slo
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.client import top, trace
from elasticdl_tpu_torch.common import events, flight
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common import programs as programs_lib
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.telemetry import TelemetryServer
from elasticdl_tpu_torch.model_zoo.deepfm.data import write_dataset
from elasticdl_tpu_torch.online.pipeline import OnlineConfig, OnlinePipeline
from elasticdl_tpu_torch.traffic.generator import (
    TrafficConfig,
    TrafficGenerator,
)

torch.set_num_threads(2)

# `trace --summary`'s compile header: the port's compiles are first
# dispatches and nvcc builds, not XLA's
COMPILE_HEADER = ("xla compiles:", "program compiles:")
FIXED_NOW = 1_800_000_000.0


@pytest.fixture(autouse=True)
def _unconfigured_streams():
    yield
    events.configure(None)


@pytest.fixture(scope="module")
def local_job(tmp_path_factory):
    """A small Local DeepFM job with an event log and the judgment
    flags; its manual capture; the program summary after it."""
    root = tmp_path_factory.mktemp("cli_job")
    train_dir, val_dir = write_dataset(str(root / "data"), n_train=256,
                                       n_val=64)
    log, incidents = str(root / "events.jsonl"), str(root / "incidents")
    job = api.run_local(cli.parse_args([
        "train", "--distribution_strategy", "Local",
        "--model_def", "deepfm.deepfm_functional_api.custom_model",
        "--model_params", "vocab_capacity=4096;embed_dim=8;lr=0.005",
        "--minibatch_size", "64", "--records_per_task", "64",
        "--num_workers", "2", "--use_bf16", "false",
        "--training_data", train_dir, "--validation_data", val_dir,
        "--event_log", log, "--incident_dir", incidents,
        "--history_interval", "0.01", "--slo_interval", "0.01",
        "--device", "cpu"]), "train")
    events.configure(None)
    assert job.ok
    job.master.flight_recorder.capture("manual")
    return {"job": job, "log": log, "incidents": incidents,
            "varz": {"pid": 4242, "role": "master",
                     "snapshot": job.master.snapshot(),
                     "programs": programs_lib.default_program_registry()
                     .summary()}}


@pytest.fixture(scope="module")
def online_loop(tmp_path_factory):
    """Eight ticks of an online loop with both policy engines on, its
    event log, and a traffic generator's snapshot."""
    root = tmp_path_factory.mktemp("cli_online")
    log = str(root / "events.jsonl")
    clk = [2_000_000.0]

    def clock():
        clk[0] += 0.125
        return clk[0]

    events.configure(log)
    pipe = OnlinePipeline(
        str(root / "loop"),
        get_model_spec(ZOO_DIR, "clickstream.ctr_mlp.custom_model"),
        OnlineConfig(seed=3, window_records=64, records_per_poll=64,
                     records_per_task=16, replicas=1, workers=1,
                     max_workers=2, max_serving_replicas=2),
        clock=clock, device="cpu")
    try:
        for _ in range(8):
            pipe.tick()
        snap = pipe.snapshot()
    finally:
        pipe.shutdown()
        events.configure(None)
    gen = TrafficGenerator(lambda *request: "ok",
                           TrafficConfig(profile="spike", seed=5,
                                         base_qps=8.0))
    for _ in range(6):
        gen.tick()
    return {"snapshot": snap, "log": log, "traffic": gen.snapshot()}


def _fixed_time(monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda *a: "12:34:56")
    monkeypatch.setattr(time, "time", lambda: FIXED_NOW)
    # both packages' `top` commands bind their clock where they are
    # defined (`clock=time.time`), out of the patch's reach: their "ago"
    # column followed the wall clock, so two commands run on either side
    # of a rounding boundary printed different ages
    for command in (top.top, jax_top.top):
        monkeypatch.setattr(command, "__defaults__",
                            (lambda: FIXED_NOW,) + command.__defaults__[1:])


# ---- top, slo, programs --------------------------------------------------


def test_top_renders_the_jobs_varz_as_the_jax_top(local_job, monkeypatch):
    _fixed_time(monkeypatch)
    varz = local_job["varz"]
    frame = top.render(varz, clock=lambda: FIXED_NOW)
    assert frame == jax_top.render(varz, clock=lambda: FIXED_NOW)
    assert "programs: n=" in frame and "slo: " in frame
    workers = varz["snapshot"]["workers"]
    assert sorted(workers) == [0, 1]
    assert all(w["steps_total"] > 0 and "phase_compute_ms" in w
               for w in workers.values())
    serving = {"metrics": {"serving_batch_rows_total": 12.0,
                           "serving_batch_latency_seconds_p50": 0.002}}
    assert top.render(varz, serving, clock=lambda: FIXED_NOW) == \
        jax_top.render(varz, serving, clock=lambda: FIXED_NOW)


def test_top_renders_the_online_and_traffic_lines(online_loop, monkeypatch):
    _fixed_time(monkeypatch)
    snap = online_loop["snapshot"]
    varz = {"snapshot": snap, "metrics": {
        "traffic_offered_per_sec": online_loop["traffic"]["offered_qps"]}}
    frame = top.render(varz, clock=lambda: FIXED_NOW)
    assert frame == jax_top.render(varz, clock=lambda: FIXED_NOW)
    lines = {line.split(":", 1)[0] for line in frame.splitlines()}
    assert {"online", "traffic", "fleet", "policy [off]", "freshness",
            "lineage", "slo"} <= lines
    (online,) = [l for l in frame.splitlines() if l.startswith("online:")]
    assert f"window={snap['online']['window']}" in online


def test_slo_renders_the_jobs_and_the_live_fleets_reports(local_job,
                                                          online_loop):
    for report in (local_job["varz"]["snapshot"]["slo"],
                   online_loop["snapshot"]["slo"]):
        assert slo.render_slo(report) == jax_slo.render_slo(report)
    assert "stream lag:" in slo.render_slo(online_loop["snapshot"]["slo"])


def test_programs_renders_the_jobs_ledger(local_job):
    summary = local_job["varz"]["programs"]
    text = programs.render_programs(summary)
    assert text == jax_programs_cli.render_programs(summary)
    assert "worker_train_step" in text and "worker_eval_step" in text
    rec = summary["ledger"]["worker_train_step"]
    assert rec["flops_per_execution"] > 0 and rec["bytes_per_execution"] > 0
    assert programs.render_programs({}) == jax_programs_cli.render_programs(
        {})


# ---- trace, lineage, incident --------------------------------------------


@pytest.mark.parametrize("which", ["local_job", "online_loop"])
def test_trace_of_a_port_log_equals_the_jax_trace(which, request):
    log = request.getfixturevalue(which)["log"]
    evts = events.read_events(log)
    doc = trace.build_chrome_trace(evts)
    assert json.dumps(doc, sort_keys=True) == json.dumps(
        jax_trace.build_chrome_trace(evts), sort_keys=True)
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "process_name"}
    assert "programs" in names
    text = trace.summarize(evts)
    assert text == jax_trace.summarize(evts).replace(*COMPILE_HEADER)
    assert "program compiles:" in text
    if which == "local_job":
        tasks = [e for e in doc["traceEvents"]
                 if e.get("cat") == "task" and e["name"].startswith("task ")]
        assert len(tasks) == len(trace.task_durations(evts)) > 0


def test_lineage_of_the_loops_log_equals_the_jax_report(online_loop):
    evts = events.read_events(online_loop["log"])
    report = lineage.render(evts)
    assert report == jax_lineage.render(evts)
    assert report.startswith("windows traced: ")
    assert lineage.render(evts, window_id=0) == jax_lineage.render(
        evts, window_id=0)


def _seeded_incidents(root):
    """The JAX flight tests' seeded bundle, through the port's recorder:
    a request span, a shed span, a breach decision and its capture."""
    recorder = flight.FlightRecorder(
        incident_dir=str(root),
        snapshot_fn=lambda: {"slo": {"slos": [{
            "slo": "staleness_p99", "state": "breach",
            "fast_burn": 12.5, "slow_burn": 3.0}]}})
    recorder.observe({"ts": 1.0, "event": events.PREDICT_SPAN,
                      "request_id": "rq-00000007", "reason": "sampled",
                      "phases_s": {"queue_wait": 0.004, "compute": 0.020}})
    recorder.observe({"ts": 2.0, "event": events.PREDICT_SPAN,
                      "request_id": "rq-00000008", "reason": "shed",
                      "phases_s": {}})
    breach = {"ts": 3.0, "event": events.SLO_BREACH,
              "slo": "staleness_p99", "fast_burn": 12.5, "tick": 4}
    recorder.observe(breach)
    recorder.breach({"slo": "staleness_p99", "fast_burn": 12.5})
    return recorder


def _storm_bundle(root, monkeypatch):
    from elasticdl_tpu_torch.serving.engine import ServingEngine
    from elasticdl_tpu_torch.worker.trainer import Trainer

    clk = [0.0]

    def clock():
        clk[0] += 0.001
        return clk[0]

    registry = programs_lib.ProgramRegistry(
        clock=clock, metrics=metrics_lib.MetricsRegistry())
    monkeypatch.setattr(programs_lib, "default_program_registry",
                        lambda: registry)
    recorder = flight.FlightRecorder(incident_dir=str(root),
                                     program_registry=registry)
    spec = get_model_spec(ZOO_DIR, "mnist.mnist_functional_api.custom_model")
    x = np.random.RandomState(0).rand(8, 784).astype(np.float32)
    state = Trainer(spec.model, spec.optimizer, spec.loss,
                    device="cpu").init_state(0, x[:2])
    engine = ServingEngine(
        spec.model, state.model.state_dict(), step=3,
        feature_spec={"features": {"shape": [784], "dtype": "float32"}},
        buckets=(2, 8), device="cpu", pad_to_bucket=False)
    for rows in (1, 3, 5):
        engine.predict({"features": x[:rows]}, rows)
    recorder.close()


def test_incident_listing_and_reports_equal_the_jax_commands(
        local_job, tmp_path, monkeypatch):
    _seeded_incidents(tmp_path / "seeded")
    _storm_bundle(tmp_path / "storm", monkeypatch)
    for root in (tmp_path / "seeded", tmp_path / "storm",
                 local_job["incidents"]):
        listed = flight.list_bundles(str(root))
        assert listed
        assert incident.format_listing(listed) == \
            jax_incident.format_listing(jax_flight.list_bundles(str(root)))
        for manifest in listed:
            bundle = flight.load_bundle(manifest["path"])
            assert incident.format_report(bundle) == \
                jax_incident.format_report(
                    jax_flight.load_bundle(manifest["path"]))
    (storm,) = flight.list_bundles(str(tmp_path / "storm"))
    bundle = flight.load_bundle(storm["path"])
    assert bundle["manifest"]["evidence"] == {
        "program": "serving_forward", "signatures": 3, "budget": 2}
    assert bundle["programs"]["ledger"]["serving_forward"]["storms"] == 1
    report = incident.format_report(bundle)
    assert "evidence: budget=2, program=serving_forward, signatures=3" \
        in report
    (manual,) = [m for m in flight.list_bundles(local_job["incidents"])
                 if m["trigger"] == "manual"]
    assert "worker_train_step" in flight.load_bundle(
        manual["path"])["programs"]["ledger"]


# ---- the command line ----------------------------------------------------


def _both(argv, capsys):
    """(rc, stdout) of the port's and the JAX package's command."""
    rc = cli.main(argv)
    out = capsys.readouterr().out
    jrc = jax_main.main(argv)
    jout = capsys.readouterr().out
    return (rc, out), (jrc, jout)


def test_scraping_commands_print_what_the_jax_commands_print(
        local_job, capsys, monkeypatch):
    varz = local_job["varz"]
    server = TelemetryServer(registries=[metrics_lib.MetricsRegistry()],
                             role="master", host="127.0.0.1",
                             varz_fn=lambda: {
                                 "pid": varz["pid"],
                                 "snapshot": varz["snapshot"],
                                 "programs": varz["programs"]})
    addr = f"127.0.0.1:{server.start()}"
    try:
        _fixed_time(monkeypatch)
        for argv in (["top", addr], ["slo", addr], ["slo", addr, "--json"],
                     ["programs", addr], ["programs", addr, "--json"]):
            port, ref = _both(argv, capsys)
            assert port == ref and port[0] == 0, argv
        assert "worker_train_step" in _both(["programs", addr], capsys)[0][1]
    finally:
        server.stop()
    # nothing listens there now
    assert cli.main(["top", addr]) == 1
    assert "cannot scrape" in capsys.readouterr().out


def test_log_and_bundle_commands_print_what_the_jax_commands_print(
        local_job, online_loop, tmp_path, capsys):
    _seeded_incidents(tmp_path / "seeded")
    log = online_loop["log"]
    for argv in (["lineage", log], ["lineage", log, "--window", "1"],
                 ["lineage", log, "--slowest", "1"],
                 ["incident", str(tmp_path / "seeded")],
                 ["incident", str(tmp_path / "seeded"), "--bundle",
                  "incident-0001"],
                 ["incident", local_job["incidents"], "--bundle",
                  "incident-0002"],
                 ["incident", str(tmp_path / "seeded"), "--bundle",
                  "incident-9"],
                 ["incident", str(tmp_path / "empty")],
                 ["trace", str(tmp_path / "missing.jsonl")]):
        port, ref = _both(argv, capsys)
        assert port == ref, argv
    for log in (local_job["log"], online_loop["log"]):
        port, ref = _both(["trace", log, "--summary"], capsys)
        assert port == (ref[0], ref[1].replace(*COMPILE_HEADER))
        chrome = str(tmp_path / "trace.json")
        rc = cli.main(["trace", log, "--chrome", chrome])
        assert rc == 0
        assert "task slices" in capsys.readouterr().out
        with open(chrome) as fh:
            doc = json.load(fh)
        assert doc == jax_trace.build_chrome_trace(events.read_events(log))


def test_the_jax_tests_incident_and_lineage_cases_on_the_port(
        tmp_path, capsys):
    """tests/test_flight.py's incident command cases and
    tests/test_lineage.py's lineage command cases, against the port."""
    _seeded_incidents(tmp_path)
    assert cli.main(["incident", str(tmp_path)]) == 0
    listing = capsys.readouterr().out
    assert "incident-0001-slo_breach" in listing
    assert cli.main(["incident", str(tmp_path), "--bundle",
                     "incident-0001"]) == 0
    report = capsys.readouterr().out
    for piece in ("incident incident-0001-slo_breach",
                  "trigger: slo_breach", "fast_burn=12.5",
                  "slo states at capture:", "decisions before the incident",
                  "request spans in the ring: 2 (1 forensic",
                  "compute=20.00ms", "rq-00000008 [shed]"):
        assert piece in report, piece
    lives = []
    for wid, base in ((0, 100.0), (1, 300.0)):
        for phase_at, reason in ((0.0, "sealed"), (1.0, "armed"),
                                 (3.0, "trained"), (4.0, "admitted"),
                                 (5.0, "produced"), (8.0, "reloaded"),
                                 (10.0, "served")):
            if wid == 1 and reason in ("reloaded", "served"):
                continue
            lives.append({"ts": base + phase_at, "event": events.WINDOW_SPAN,
                          "window_id": wid, "reason": reason,
                          "at_unix_s": base + phase_at,
                          "ingest_unix_s": base - 1.0})
    log = tmp_path / "lives.jsonl"
    log.write_text("".join(json.dumps(e) + "\n" for e in lives))
    port, ref = _both(["lineage", str(log)], capsys)
    assert port == ref and port[0] == 0
    assert "windows traced: 2 (1 complete, 1 open, 0 dropped, " \
        "0 replayed)" in port[1]
    bare = tmp_path / "bare.jsonl"
    bare.write_text(json.dumps({"ts": 1.0, "event": "task_trained"}) + "\n")
    assert cli.main(["lineage", str(bare)]) == 1
    assert "no window_span events" in capsys.readouterr().out


def test_the_command_line_knows_each_command_and_its_flags():
    for argv, want in (
            (["top", "h:1", "--watch", "--interval_s", "0.5",
              "--serving_addr", "h:2"],
             {"master_varz": "h:1", "watch": True, "interval_s": 0.5,
              "serving_addr": "h:2"}),
            (["slo", "h:1", "--json"], {"master_varz": "h:1", "json": True}),
            (["programs", "h:1"], {"varz_addr": "h:1", "json": False}),
            (["trace", "e.jsonl", "--chrome", "o.json", "--summary",
              "--slowest", "2"],
             {"event_log": "e.jsonl", "chrome": "o.json", "summary": True,
              "slowest": 2}),
            (["lineage", "e.jsonl", "--window", "3", "--slowest", "1"],
             {"event_log": "e.jsonl", "window": 3, "slowest": 1}),
            (["incident", "d", "--bundle", "b", "--spans", "4"],
             {"incident_dir": "d", "bundle": "b", "spans": 4})):
        args = vars(cli.parse_args(argv))
        jargs = vars(jax_main._build_parser().parse_args(argv))
        assert {k: args[k] for k in want} == want
        assert args == jargs
    with pytest.raises(SystemExit):
        cli.parse_args(["top", "h:1", "--bogus"])
