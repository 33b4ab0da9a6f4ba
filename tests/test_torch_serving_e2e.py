"""Serving end to end on the CPU, the port's counterpart of
tests/test_serving_e2e.py: a DeepFM checkpoint (small vocab, f32, weights
from the JAX init carried by `params_from_jax`) served over a real HTTP
socket on an ephemeral port — mixed-size concurrent requests with a
checkpoint hot swap mid-stream, health, a corrupt step rejected while
serving goes on, invalid requests answered in band, the `serve` command
built from an export and from a checkpoint directory — and the port
server's predictions against the JAX servicer's for the same request
bytes.

Every call has its own timeout (the stub's `timeout=`), and every server
is stopped in a `finally`.
"""

import json
import os
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.proto import serving_pb2 as jspb
from elasticdl_tpu.serving.batcher import DynamicBatcher as JaxBatcher
from elasticdl_tpu.serving.engine import ServingEngine as JaxEngine
from elasticdl_tpu.serving.server import (
    ServingServicer as JaxServicer,
    from_tensor_proto as jax_from_tensor_proto,
)
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.client.api import build_serving_server
from elasticdl_tpu_torch.common.export import export_model, feature_meta
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.model_zoo.deepfm.data import synthetic_criteo
from elasticdl_tpu_torch.proto import serving as spb
from elasticdl_tpu_torch.proto.service import (
    InProcessServingClient,
    ServingRpcError,
    ServingStub,
)
from elasticdl_tpu_torch.serving.batcher import DynamicBatcher
from elasticdl_tpu_torch.serving.engine import ServingEngine
from elasticdl_tpu_torch.serving.reloader import CheckpointReloader
from elasticdl_tpu_torch.serving.server import (
    ServingServer,
    from_tensor_proto,
    make_predict_request,
)
from elasticdl_tpu_torch.worker.trainer import Trainer

torch.set_num_threads(2)

MODEL = "deepfm.deepfm_functional_api.custom_model"
PARAMS = "vocab_capacity=4096;embed_dim=8;lr=0.005"
BUCKETS = (2, 8)
# the mixed-traffic test's clients and request sizes: each client keeps
# one request in flight, so at most CLIENTS * max(ROW_CHOICES) rows are
# queued at once; the batcher's bound must hold them all, or a slow
# batch sheds one (the default bound is 4 * max(BUCKETS) = 32 < 44)
CLIENTS = 4
ROW_CHOICES = (1, 2, 3, 5, 8, 11)
MAX_QUEUED_ROWS = CLIENTS * max(ROW_CHOICES)
CALL_TIMEOUT_S = 60.0
# f32 on both sides, from the same carried weights; the JAX forward sums
# in another order (XLA's fusions), measured ~1e-6 on these logits.
TOL = 1e-4
# one step's logits served in a batch against the same step's forward on
# the request alone: the same f32 ops on other batch shapes, ~1e-7.
STEP_TOL = 1e-5


def _features(rows, seed):
    dense, sparse, _ = synthetic_criteo(rows, seed=seed)
    return {"dense": dense, "sparse": sparse}


class _Stack:
    """One serving deployment over a live checkpoint directory."""

    def __init__(self, tmp_path):
        self.spec = get_model_spec(ZOO_DIR, MODEL, model_params=PARAMS)
        self.sample = _features(2, seed=0)
        js = jax_spec("model_zoo", MODEL, model_params=PARAMS)
        self.jax_model = js.model
        self.jax_variables = js.model.init(jax.random.PRNGKey(0),
                                           self.sample)
        trainer = Trainer(self.spec.model, self.spec.optimizer,
                          self.spec.loss, device="cpu")
        self.state = trainer.init_state(0, self.sample)
        self.state.model.load_state_dict(params_from_jax(
            self.state.model, flatten_params(jax.tree.map(
                np.asarray, self.jax_variables["params"]))), strict=True)
        self.base = {k: v.clone()
                     for k, v in self.state.model.state_dict().items()}
        self.ckpt_dir = str(tmp_path / "ckpts")
        self.saver = CheckpointSaver(self.ckpt_dir, keep_max=0)
        self.save_step(1)
        self.engine = ServingEngine.from_checkpoint(
            self.ckpt_dir, self.spec, self.sample, buckets=BUCKETS,
            device="cpu")
        self.batcher = DynamicBatcher(self.engine, max_latency_s=0.005,
                                      max_queue_rows=MAX_QUEUED_ROWS)
        self.reloader = CheckpointReloader(self.engine, self.ckpt_dir,
                                           poll_interval_s=0.05)
        self.server = ServingServer(self.engine, self.batcher,
                                    self.reloader, host="127.0.0.1")
        port = self.server.start(0)
        self.stub = ServingStub(f"127.0.0.1:{port}",
                                timeout=CALL_TIMEOUT_S)

    def weights(self, step):
        """Step s serves the base weights with the output bias moved by
        s - 1: every step's logits sit a whole unit from the others."""
        sd = {k: v.clone() for k, v in self.base.items()}
        sd["mlp_out.bias"] += float(step - 1)
        return sd

    def save_step(self, step):
        self.state.model.load_state_dict(self.weights(step))
        self.state.step = step
        self.saver.save(self.state)
        self.saver.wait_until_finished()

    def reference(self, step, features):
        model = self.spec.model
        with torch.no_grad():
            out = torch.func.functional_call(
                model, self.weights(step),
                ({k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in features.items()},))
        return out.numpy()

    def wait_for(self, predicate, timeout=30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return True
            time.sleep(0.05)
        return False

    def close(self):
        self.stub.close()
        self.server.stop()
        self.saver.close()


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    s = _Stack(tmp_path_factory.mktemp("serving_e2e"))
    try:
        yield s
    finally:
        s.close()


def test_predictions_match_the_jax_servicer_for_the_same_bytes(stack):
    """The same request bytes through the port's socket and through the
    JAX ServingServicer (called directly on the JAX engine with a
    serving_pb2 request) give the same predictions within TOL."""
    jax_engine = JaxEngine(
        stack.jax_model, stack.jax_variables, step=1,
        feature_spec=feature_meta(stack.sample), buckets=BUCKETS)
    jax_batcher = JaxBatcher(jax_engine, max_latency_s=0.005)
    servicer = JaxServicer(jax_engine, jax_batcher)
    try:
        for rows, seed in ((1, 11), (5, 12), (8, 13), (13, 14)):
            request = make_predict_request(_features(rows, seed))
            request.request_id = f"r{seed}"
            wire = request.SerializeToString()
            want = servicer.predict(jspb.PredictRequest.FromString(wire),
                                    None)
            got = stack.stub.predict(spb.PredictRequest.FromString(wire))
            assert got.code == want.code == spb.SERVING_OK, got.error
            assert got.model_step == want.model_step == 1
            assert got.request_id == want.request_id == f"r{seed}"
            np.testing.assert_allclose(
                from_tensor_proto(got.predictions),
                jax_from_tensor_proto(want.predictions), rtol=TOL,
                atol=TOL)
    finally:
        jax_batcher.shutdown()


def test_mixed_concurrent_traffic_with_midstream_hot_swap(stack):
    """Concurrent clients send mixed batch sizes over the socket while a
    newer checkpoint lands: every request succeeds, each response is one
    whole step's forward (the step it names), no new batch shapes."""
    results, lock = [], threading.Lock()
    saw_swap = threading.Event()
    deadline = time.monotonic() + 30.0
    errors = []

    def client(seed):
        try:
            rng = np.random.RandomState(seed)
            sent = 0
            while True:
                sent += 1
                rows = int(rng.choice(ROW_CHOICES))
                x = _features(rows, seed=1000 * seed + sent)
                resp = stack.stub.predict(make_predict_request(x))
                with lock:
                    results.append((resp, x))
                if resp.code == spb.SERVING_OK and resp.model_step == 2:
                    saw_swap.set()
                if sent >= 12 and (saw_swap.is_set()
                                   or time.monotonic() > deadline):
                    return
        except BaseException as exc:   # reported below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(CLIENTS)]
    for t in threads:
        t.start()
    stack.save_step(2)
    for t in threads:
        t.join(timeout=CALL_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert stack.wait_for(lambda: stack.engine.step == 2)
    codes = [resp.code for resp, _ in results]
    assert codes == [spb.SERVING_OK] * len(codes)   # none dropped
    steps = {resp.model_step for resp, _ in results}
    assert steps <= {1, 2} and 2 in steps
    for resp, x in results:
        got = from_tensor_proto(resp.predictions)
        np.testing.assert_allclose(
            got, stack.reference(resp.model_step, x), rtol=STEP_TOL,
            atol=STEP_TOL)
    assert stack.engine.compile_count <= len(BUCKETS)
    assert stack.engine.swap_count == 1
    assert stack.reloader.reload_count == 1


def test_health_reports_serving_state(stack):
    health = stack.stub.health(spb.HealthRequest())
    assert health.serving
    assert health.buckets == list(BUCKETS)
    assert health.compile_count <= len(BUCKETS)
    assert health.model_step == stack.engine.step
    metrics = {m.name: m.value for m in health.metrics}
    assert metrics["ok_rows"] > 0
    assert 0.0 < metrics["batch_fill_ratio"] <= 1.0
    assert metrics["latency_p99_s"] > 0.0
    assert metrics["reload_count"] == stack.reloader.reload_count
    assert metrics["swap_count"] == stack.engine.swap_count
    assert metrics["produced_unix_s"] > 0.0
    assert [m.name for m in health.metrics] == sorted(metrics)
    # the telemetry surface beside it
    url = f"http://127.0.0.1:{stack.server.telemetry.port}"
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    assert "serving_reloads_total" in text
    assert 'serving_request_phase_seconds_count{phase="respond"}' in text
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        doc = json.loads(r.read())
    assert doc["status"] == "ok" and doc["model_step"] == stack.engine.step


def test_corrupt_checkpoint_rejected_serving_continues(stack):
    """A truncated state.pt in the newest step: the manifest gate rejects
    it, the engine keeps serving the previous step, and the bad step is
    never retried."""
    served_before = stack.engine.step
    rejected_before = stack.reloader.rejected_count
    step = served_before + 1
    # hold the poll loop off the step until it is truncated: the
    # never-retry set doubles as a gate
    stack.reloader._rejected_steps.add(step)
    stack.save_step(step)
    path = os.path.join(stack.ckpt_dir, str(step), "state.pt")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    stack.reloader._rejected_steps.discard(step)
    assert stack.wait_for(
        lambda: stack.reloader.rejected_count > rejected_before)
    assert stack.engine.step == served_before
    assert "integrity" in stack.reloader.last_error
    resp = stack.stub.predict(make_predict_request(stack.sample))
    assert resp.code == spb.SERVING_OK
    assert resp.model_step == served_before
    count_after = stack.reloader.rejected_count
    time.sleep(0.3)
    assert stack.reloader.rejected_count == count_after
    # a newer intact step still loads
    stack.save_step(step + 1)
    assert stack.wait_for(lambda: stack.engine.step == step + 1)
    resp = stack.stub.predict(make_predict_request(stack.sample))
    np.testing.assert_allclose(
        from_tensor_proto(resp.predictions),
        stack.reference(step + 1, stack.sample), rtol=STEP_TOL,
        atol=STEP_TOL)


def test_invalid_wire_request_gets_in_band_error(stack):
    request = spb.PredictRequest(inputs=[
        spb.NamedTensor(name="dense", tensor=spb.TensorProto(
            dtype="float32", shape=[1, 13], data=b"short")),
        spb.NamedTensor(name="sparse", tensor=spb.TensorProto(
            dtype="int32", shape=[1, 26], data=bytes(104)))])
    resp = stack.stub.predict(request)
    assert resp.code == spb.SERVING_INVALID
    assert "bytes" in resp.error
    # well-formed tensors under the wrong key: the engine's check
    resp = stack.stub.predict(make_predict_request(
        {"dense": stack.sample["dense"]}))
    assert resp.code == spb.SERVING_INVALID
    assert "do not match the model signature" in resp.error
    # a body that is not a message at all is an HTTP 400 (the method
    # name matches in either case), another path a 404; the connection
    # stays open for the next request
    conn = stack.stub._connection(CALL_TIMEOUT_S)
    conn.request("POST", "/elasticdl_tpu.Serving/Predict", b"\xff\xff")
    reply = conn.getresponse()
    assert reply.status == 400 and b"malformed" in reply.read()
    conn.request("POST", "/elasticdl_tpu.Serving/bogus", b"")
    reply = conn.getresponse()
    assert reply.status == 404 and b"unknown method" in reply.read()

    class NotAMessage:
        def SerializeToString(self):
            return b"\xff\xff"

    # the stub reads a status other than 200 as an error
    with pytest.raises(ServingRpcError, match="HTTP 400"):
        stack.stub.predict(NotAMessage())
    assert stack.stub.predict(make_predict_request(
        stack.sample)).code == spb.SERVING_OK


def test_cli_serve_builds_stack_from_export_and_checkpoint(stack, tmp_path):
    """`serve --export_dir ...` and `serve --checkpoint_dir ...
    --feature_spec <export_meta.json>`: parser -> api assembly -> a
    round trip over the socket and in process."""
    export_dir = str(tmp_path / "export")
    stack.state.model.load_state_dict(stack.weights(4))
    stack.state.step = 4
    export_model(stack.state, stack.spec, export_dir,
                 sample_features=stack.sample)
    ckpt = str(tmp_path / "ckpt")
    saver = CheckpointSaver(ckpt)
    saver.save(stack.state)
    saver.close()
    common = ["serve", "--model_def", MODEL, "--model_params", PARAMS,
              "--batch_buckets", "2,4", "--max_batch_latency_ms", "2",
              "--device", "cpu"]
    for source in (["--export_dir", export_dir],
                   ["--checkpoint_dir", ckpt, "--feature_spec",
                    os.path.join(export_dir, "export_meta.json")]):
        server = build_serving_server(cli.parse_args([*common, *source]))
        try:
            port = server.start(0)
            stub = ServingStub(f"127.0.0.1:{port}", timeout=CALL_TIMEOUT_S)
            resp = stub.predict(make_predict_request(stack.sample))
            assert resp.code == spb.SERVING_OK, resp.error
            assert resp.model_step == 4
            np.testing.assert_allclose(
                from_tensor_proto(resp.predictions),
                stack.reference(4, stack.sample), rtol=STEP_TOL,
                atol=STEP_TOL)
            client = InProcessServingClient(server.servicer)
            health = client.health(spb.HealthRequest())
            assert health.buckets == [2, 4]
            assert health.compile_count <= 2
            stub.close()
        finally:
            server.stop()
    with pytest.raises(ValueError, match="exactly one of"):
        build_serving_server(cli.parse_args(common))


def test_stop_drains_in_flight_requests_then_refuses(stack):
    """stop() lets a request already inside the server finish, then the
    socket is gone."""
    server = build_serving_server(cli.parse_args([
        "serve", "--model_def", MODEL, "--model_params", PARAMS,
        "--checkpoint_dir", stack.ckpt_dir, "--feature_spec",
        json.dumps(feature_meta(stack.sample)), "--batch_buckets", "2",
        "--max_batch_latency_ms", "300", "--device", "cpu"]))
    out = {}
    try:
        port = server.start(0)
        stub = ServingStub(f"127.0.0.1:{port}", timeout=CALL_TIMEOUT_S)
        one_row = {k: v[:1] for k, v in stack.sample.items()}
        caller = threading.Thread(target=lambda: out.update(
            resp=stub.predict(make_predict_request(one_row))))
        caller.start()
        # one row of a 2-row bucket waits out the 300 ms batch deadline
        assert stack.wait_for(lambda: server.batcher.queue_depth > 0)
    finally:
        server.stop()
    caller.join(timeout=CALL_TIMEOUT_S)
    assert not caller.is_alive()
    assert out["resp"].code == spb.SERVING_OK
    with pytest.raises(OSError):
        ServingStub(f"127.0.0.1:{port}", timeout=5).health(
            spb.HealthRequest())
