"""The port's fault registry (elasticdl_tpu_torch/common/faults.py) and
where the port fires it:

- counterparts of tests/test_resilience.py's registry tests;
- the cross-package contract: for the same seed and points,
  `schedule_json()` and `trace_text()` are byte-identical to the JAX
  package's, and a schedule written by one package runs in the other
  with the same trace;
- the method tables of proto/service.py against the JAX package's, the
  in-process master client firing its point before each call, a
  `ServingStub` over a real socket retrying `rpc.predict` and
  `rpc.health_probe` faults and HTTP 503 under its policy, and the
  reloader rejecting a reload at `serving.reload` while the served
  generation stays.
"""

import http.server
import random
import threading

import numpy as np
import pytest

from elasticdl_tpu.common import faults as jax_faults
from elasticdl_tpu.proto import service as jax_service
from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.faults import FaultRegistry, FaultSpec
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.resilience import (
    RetryBudgetExhausted,
    RetryPolicy,
)
from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
from elasticdl_tpu_torch.model_zoo.deepfm.data import synthetic_criteo
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto import serving as spb
from elasticdl_tpu_torch.proto import service
from elasticdl_tpu_torch.serving.engine import ServingEngine
from elasticdl_tpu_torch.serving.reloader import CheckpointReloader
from elasticdl_tpu_torch.worker.trainer import Trainer


@pytest.fixture(autouse=True)
def no_registry():
    faults.uninstall()
    yield
    faults.uninstall()


# ---- the registry ---------------------------------------------------------


def test_from_seed_is_deterministic():
    a = FaultRegistry.from_seed(42)
    b = FaultRegistry.from_seed(42)
    assert a.trace_text() == b.trace_text()
    assert a.schedule_json() == b.schedule_json()
    assert FaultRegistry.from_seed(43).schedule_json() != a.schedule_json()
    plan_lines = [line for line in a.trace_text().splitlines()
                  if line.startswith("plan ")]
    assert len(plan_lines) == 2 * len(faults.POINTS)


def test_fire_executes_scheduled_actions_in_hit_order():
    reg = FaultRegistry([FaultSpec("p", 1, "raise"),
                         FaultSpec("p", 2, "drop"),
                         FaultSpec("p", 3, "delay", delay_s=0.0)])
    reg.fire("p")  # hit 0: clean
    with pytest.raises(faults.InjectedFault):
        reg.fire("p")
    with pytest.raises(faults.DroppedRequest):
        reg.fire("p")
    reg.fire("p")  # hit 3: zero-length delay
    assert reg.hits("p") == 4
    assert reg.all_fired()
    assert reg.unfired() == []
    stats = reg.stats()
    assert stats["planned"] == stats["injected"] == 3
    assert stats["by_action"] == {"raise": 1, "drop": 1, "delay": 1}


def test_unfired_lists_pending_faults():
    reg = FaultRegistry([FaultSpec("p", 0, "raise"),
                         FaultSpec("q", 5, "raise")])
    with pytest.raises(faults.InjectedFault):
        reg.fire("p")
    assert not reg.all_fired()
    assert reg.unfired() == ["q#5 raise"]


def test_unknown_action_is_refused():
    with pytest.raises(ValueError, match="unknown fault action"):
        FaultRegistry([FaultSpec("p", 0, "explode")])


def test_trace_includes_notes_in_canonical_order():
    reg = FaultRegistry([], seed=9)
    reg.note("worker.kill", "worker-1")
    reg.note("worker.kill", "worker-0")
    reg.note("checkpoint.corrupt", "latest")
    text = reg.trace_text()
    assert text.startswith("fault-trace v1 seed=9\n")
    assert "note checkpoint.corrupt#0 latest" in text
    assert text.index("worker.kill#0 worker-1") < text.index(
        "worker.kill#1 worker-0")


def test_schedule_json_roundtrip_and_env_wire():
    reg = FaultRegistry.from_seed(11)
    clone = FaultRegistry.from_schedule_json(reg.schedule_json(), seed=11)
    assert clone.trace_text() == reg.trace_text()
    env = reg.env()
    assert env[faults.ENV_SEED] == "11"
    rebuilt = faults.configure_from_env(environ=env)
    assert rebuilt is not None and faults.get_registry() is rebuilt
    assert rebuilt.trace_text() == reg.trace_text()
    # the seed alone derives the default plan
    seeded = faults.configure_from_env(environ={faults.ENV_SEED: "11"})
    assert seeded.schedule_json() == reg.schedule_json()
    assert faults.configure_from_env(environ={}) is None


def test_module_fire_is_noop_without_registry():
    faults.fire(faults.POINT_RPC_GET_TASK)  # must not raise
    faults.note("ignored")
    assert faults.stats() == {}


def test_installed_registry_drives_module_fire():
    reg = faults.install(
        FaultRegistry([FaultSpec(faults.POINT_RPC_REPORT, 0, "raise")]))
    with pytest.raises(faults.InjectedFault):
        faults.fire(faults.POINT_RPC_REPORT)
    assert faults.stats()["injected"] == 1
    assert reg.all_fired()


# ---- the cross-package contract -------------------------------------------


def test_points_actions_and_env_names_are_the_jax_packages():
    assert faults.POINTS == jax_faults.POINTS
    assert faults.ACTIONS == jax_faults.ACTIONS
    assert (faults.ENV_SCHEDULE, faults.ENV_SEED) == (
        jax_faults.ENV_SCHEDULE, jax_faults.ENV_SEED)


def _drive(reg, hits_by_point, notes):
    for point, hits in hits_by_point:
        for _ in range(hits):
            try:
                reg.fire(point)
            except Exception as exc:
                assert "injected" in str(exc)
    for key, detail in notes:
        reg.note(key, detail)


@pytest.mark.parametrize("seed,points,per_point,max_hit,actions", [
    (0, None, 2, 8, None),
    (42, None, 3, 10, ("raise", "drop")),
    (20240805, ("rpc.get_task", "rpc.report", "checkpoint.write"), 2, 6,
     None),
    (7, ("serving.reload", "rpc.predict", "rpc.health_probe"), 1, 4,
     ("raise", "delay")),
])
def test_schedule_and_trace_are_byte_identical_to_the_jax_packages(
        seed, points, per_point, max_hit, actions):
    kw = {"faults_per_point": per_point, "max_hit": max_hit}
    if points is not None:
        kw["points"] = points
    if actions is not None:
        kw["actions"] = actions
    port = FaultRegistry.from_seed(seed, **kw)
    ref = jax_faults.FaultRegistry.from_seed(seed, **kw)
    assert port.schedule_json() == ref.schedule_json()
    assert port.trace_text() == ref.trace_text()
    # zero-length delays keep the drive quick; same hits, same notes
    rng = np.random.default_rng(seed)
    drive = [(p, max_hit) for p in (points or faults.POINTS)]
    notes = [("worker.kill", f"worker-{int(rng.integers(4))}")
             for _ in range(3)]
    port = FaultRegistry([FaultSpec(s.point, s.at, s.action, 0.0)
                          for s in _specs(port)], seed=seed)
    ref = jax_faults.FaultRegistry(
        [jax_faults.FaultSpec(s.point, s.at, s.action, 0.0)
         for s in _specs(ref)], seed=seed)
    _drive(port, drive, notes)
    _drive(ref, drive, notes)
    assert port.all_fired() and ref.all_fired()
    assert port.trace_text() == ref.trace_text()
    assert port.stats() == ref.stats()


def _specs(reg):
    return [spec for by_hit in reg._plan.values()
            for spec in by_hit.values()]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_schedule_written_by_one_package_runs_in_the_other(writer):
    seed = 1234
    made = (jax_faults if writer == "jax" else faults).FaultRegistry
    text = made.from_seed(seed, faults_per_point=1, max_hit=3,
                          actions=("raise", "drop")).schedule_json()
    port = faults.configure_from_env(
        environ={faults.ENV_SCHEDULE: text, faults.ENV_SEED: str(seed)})
    ref = jax_faults.FaultRegistry.from_schedule_json(text, seed=seed)
    drive = [(p, 3) for p in faults.POINTS]
    _drive(port, drive, [])
    _drive(ref, drive, [])
    assert port.unfired() == ref.unfired() == []
    assert port.trace_text() == ref.trace_text()


# ---- where the port fires -------------------------------------------------


def test_method_tables_are_the_jax_packages():
    assert service.METHOD_FAULT_POINTS == jax_service.METHOD_FAULT_POINTS
    assert service.SERVING_METHOD_FAULT_POINTS == \
        jax_service.SERVING_METHOD_FAULT_POINTS


class _Servicer:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name in service.MASTER_METHODS:
            return lambda request, ctx: self.calls.append(name) or name
        raise AttributeError(name)


def test_in_process_master_client_fires_before_each_call():
    servicer = _Servicer()
    client = service.InProcessMasterClient(servicer)
    reg = faults.install(FaultRegistry([
        FaultSpec(faults.POINT_RPC_GET_TASK, 1, "raise"),
        FaultSpec(faults.POINT_RPC_REPORT, 0, "drop")]))
    assert client.get_task(pb.GetTaskRequest()) == "get_task"
    with pytest.raises(faults.InjectedFault):
        client.get_task(pb.GetTaskRequest())
    # without a policy the fault reaches the caller and the call never
    # ran
    with pytest.raises(faults.DroppedRequest):
        client.report_task_result(pb.ReportTaskResultRequest())
    client.report_version(pb.ReportVersionRequest())
    client.report_evaluation_metrics(pb.ReportEvaluationMetricsRequest())
    assert servicer.calls == ["get_task", "report_version",
                              "report_evaluation_metrics"]
    assert reg.hits(faults.POINT_RPC_GET_TASK) == 2
    assert reg.hits(faults.POINT_RPC_REPORT) == 3


def _fast(**kw):
    return RetryPolicy(initial_backoff_s=0.001, max_backoff_s=0.002,
                       rng=random.Random(0), **kw)


class _FlakyHandler(http.server.BaseHTTPRequestHandler):
    """Answers predict and health; the first `fail` requests get 503."""

    protocol_version = "HTTP/1.1"
    fail = 0
    seen = []

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        type(self).seen.append(self.path)
        if type(self).fail > 0:
            type(self).fail -= 1
            body, status = b"stopping", 503
        elif self.path.endswith("/health"):
            body = spb.HealthResponse(serving=True,
                                      model_step=5).SerializeToString()
            status = 200
        else:
            body = spb.PredictResponse(model_step=5).SerializeToString()
            status = 200
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture
def flaky_server():
    _FlakyHandler.fail = 0
    _FlakyHandler.seen = []
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                             _FlakyHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def test_serving_stub_retries_faults_and_503_per_attempt(flaky_server):
    stub = service.ServingStub(flaky_server, timeout=10,
                               retry_policy=_fast())
    reg = faults.install(FaultRegistry([
        FaultSpec(faults.POINT_RPC_PREDICT, 0, "raise"),
        FaultSpec(faults.POINT_RPC_PREDICT, 1, "drop"),
        FaultSpec(faults.POINT_RPC_HEALTH_PROBE, 0, "raise")]))
    try:
        assert stub.predict(spb.PredictRequest()).model_step == 5
        # two injected attempts never reached the socket
        assert _FlakyHandler.seen == ["/elasticdl_tpu.Serving/predict"]
        assert reg.hits(faults.POINT_RPC_PREDICT) == 3
        _FlakyHandler.fail = 2
        assert stub.health(spb.HealthRequest()).serving
        # one injected attempt, then two 503s, then the answer
        assert reg.hits(faults.POINT_RPC_HEALTH_PROBE) == 4
        assert reg.unfired() == []
    finally:
        stub.close()


def test_serving_stub_without_a_policy_raises_the_fault(flaky_server):
    stub = service.ServingStub(flaky_server, timeout=10)
    faults.install(FaultRegistry([
        FaultSpec(faults.POINT_RPC_PREDICT, 0, "raise")]))
    try:
        with pytest.raises(faults.InjectedFault):
            stub.predict(spb.PredictRequest())
        assert _FlakyHandler.seen == []
        _FlakyHandler.fail = 1
        with pytest.raises(service.ServingRpcError) as info:
            stub.predict(spb.PredictRequest())
        assert info.value.status == 503
    finally:
        stub.close()


def test_serving_stub_gives_up_on_a_bounded_policy(flaky_server):
    stub = service.ServingStub(flaky_server, timeout=10,
                               retry_policy=_fast(max_attempts=3))
    _FlakyHandler.fail = 10
    try:
        with pytest.raises(RetryBudgetExhausted):
            stub.health(spb.HealthRequest())
        assert len(_FlakyHandler.seen) == 3
    finally:
        stub.close()


def test_reloader_rejects_an_injected_reload_and_keeps_serving(tmp_path):
    spec = get_model_spec(ZOO_DIR, "deepfm.deepfm_functional_api."
                          "custom_model",
                          model_params="vocab_capacity=4096;embed_dim=8")
    dense, sparse, _ = synthetic_criteo(2, seed=0)
    sample = {"dense": dense, "sparse": sparse}
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, device="cpu")
    state = trainer.init_state(0, sample)
    saver = CheckpointSaver(str(tmp_path), keep_max=0)

    def save(step):
        state.step = step
        saver.save(state)
        saver.wait_until_finished()

    save(1)
    engine = ServingEngine.from_checkpoint(str(tmp_path), spec, sample,
                                           buckets=(2,), device="cpu")
    reloader = CheckpointReloader(engine, str(tmp_path))
    try:
        reg = faults.install(FaultRegistry([
            FaultSpec(faults.POINT_SERVING_RELOAD, 0, "raise")]))
        save(2)
        assert not reloader.check_once()
        assert engine.step == 1 and reloader.rejected_count == 1
        assert "injected failure at serving.reload#0" in reloader.last_error
        # the rejected step is not retried; a newer one swaps in
        assert not reloader.check_once()
        save(3)
        assert reloader.check_once() and engine.step == 3
        assert reg.hits(faults.POINT_SERVING_RELOAD) == 2
    finally:
        reloader.stop()
        saver.close()


def test_an_injected_checkpoint_write_skips_that_save_only(tmp_path):
    spec = get_model_spec(ZOO_DIR, "deepfm.deepfm_functional_api."
                          "custom_model",
                          model_params="vocab_capacity=4096;embed_dim=8")
    dense, sparse, _ = synthetic_criteo(2, seed=0)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, device="cpu")
    state = trainer.init_state(0, {"dense": dense, "sparse": sparse})
    saver = CheckpointSaver(str(tmp_path))
    faults.install(FaultRegistry([
        FaultSpec(faults.POINT_CHECKPOINT_WRITE, 0, "raise")]))
    state.step = 8
    assert saver.save(state) is False
    saver.wait_until_finished()
    assert saver.all_steps() == []
    # the next crossing saves again
    state.step = 16
    assert saver.save(state) is True
    saver.close()
    assert saver.all_steps() == [16]
