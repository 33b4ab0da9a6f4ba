"""The port's serving stack (elasticdl_tpu_torch/serving) against the JAX
package's, on the CPU: ServingEngine + DynamicBatcher on weights carried
from the JAX BERT zoo model, and the batcher's policies on a fake engine
(the behaviours tests/test_serving_batcher.py pins for the JAX batcher).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.serving import engine as jax_engine_lib
from elasticdl_tpu_torch.common.export import feature_meta
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.model_zoo.bert import bert_finetune as port_bert
from elasticdl_tpu_torch.serving import engine as port_engine_lib
from elasticdl_tpu_torch.serving.batcher import (
    INTERNAL,
    INVALID,
    OK,
    OVERLOADED,
    SHUTTING_DOWN,
    DynamicBatcher,
)
from model_zoo.bert import bert_finetune as jax_bert

torch.set_num_threads(2)

CFG = dict(hidden=64, num_layers=2, heads=4, mlp_dim=128, max_len=128,
           vocab_size=512)
BUCKETS = (1, 4, 8)
# f32 forward, both sides on their plain attention (the JAX engine traces
# under export mode); sums in another order, measured ~1.5e-6.
TOL = 1e-4
# the DeepFM f32 forward against flax's (tests/test_torch_deepfm.py)
F32_TOL = 1e-5


def _requests(rows, seed):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, CFG["vocab_size"],
                                     (rows, CFG["max_len"])).astype(np.int32)}


@pytest.fixture(scope="module")
def engines():
    jax_model = jax_bert.custom_model(**CFG)
    sample = _requests(8, 0)
    variables = jax_model.init(jax.random.PRNGKey(0), sample)
    feature_spec = feature_meta({"input_ids": sample["input_ids"][:1]})
    jax_engine = jax_engine_lib.ServingEngine(
        jax_model, variables, step=5, feature_spec=feature_spec,
        buckets=BUCKETS,
    )
    port_model = port_bert.custom_model(**CFG)
    params = params_from_jax(
        port_model, flatten_params(jax.tree.map(np.asarray,
                                                variables["params"])))
    port_engine = port_engine_lib.ServingEngine(
        port_model, params, step=5, feature_spec=feature_spec,
        buckets=BUCKETS, device="cpu",
    )
    return jax_engine, port_engine


def _jax_predict(jax_engine, x, rows):
    """JAX engine predictions, in chunks of its largest bucket."""
    out = []
    for lo in range(0, rows, BUCKETS[-1]):
        hi = min(rows, lo + BUCKETS[-1])
        chunk = {k: v[lo:hi] for k, v in x.items()}
        out.append(jax_engine.predict(chunk, hi - lo)[0])
    return np.concatenate(out, axis=0)


def test_batcher_predictions_match_jax_engine(engines):
    jax_engine, port_engine = engines
    batcher = DynamicBatcher(port_engine, max_latency_s=0.005)
    requests = {rows: _requests(rows, seed=rows) for rows in (1, 3, 8, 11)}
    futures = {rows: batcher.submit(x) for rows, x in requests.items()}
    for rows, future in futures.items():
        result = future.result(timeout=60)
        assert result.code == OK, result.error
        assert result.model_step == 5
        assert result.predictions.shape == (rows, 2)
        want = _jax_predict(jax_engine, requests[rows], rows)
        np.testing.assert_allclose(result.predictions, want, rtol=TOL,
                                   atol=TOL)
    batcher.shutdown()


@pytest.mark.parametrize("rows", [1, 2, 3, 5, 8])
def test_engine_predict_pads_to_bucket_like_jax(engines, rows):
    jax_engine, port_engine = engines
    x = _requests(rows, seed=100 + rows)
    got, step = port_engine.predict(x, rows)
    want, jax_step = jax_engine.predict(x, rows)
    assert step == jax_step == 5
    assert got.shape == want.shape == (rows, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_compile_counter_equals_buckets_after_warmup(engines):
    _, port_engine = engines
    assert port_engine.buckets == BUCKETS
    assert port_engine.compile_count == len(BUCKETS)
    for rows in (1, 2, 3, 5, 7, 8):
        port_engine.predict(_requests(rows, seed=rows), rows)
    assert port_engine.compile_count == len(BUCKETS)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        port_engine.predict(_requests(9, seed=9), 9)


def test_phase_out_reports_pad_compute_unpack(engines):
    _, port_engine = engines
    phases = {}
    port_engine.predict(_requests(3, seed=3), 3, phase_out=phases)
    assert set(phases) == {"pad", "compute", "unpack"}
    assert all(v >= 0.0 for v in phases.values())


MALFORMED = [
    "not a dict",
    {"token_ids": np.zeros((1, 128), np.int32)},
    {"input_ids": np.zeros((1, 128), np.float32)},
    {"input_ids": np.zeros((1, 64), np.int32)},
    {"input_ids": np.zeros((0, 128), np.int32)},
    {"input_ids": np.zeros((2, 128, 2), np.uint8)},
    {"input_ids": np.zeros((1, 128), np.int32), "extra": np.zeros((2, 1))},
]


@pytest.mark.parametrize("case", range(len(MALFORMED)))
def test_validate_error_strings_match_jax(engines, case):
    jax_engine, port_engine = engines
    features = MALFORMED[case]
    want = jax_engine.validate(features)
    assert want is not None
    assert port_engine.validate(features) == want


def test_validate_accepts_native_and_packed_like_jax(engines):
    jax_engine, port_engine = engines
    for features in ({"input_ids": np.zeros((3, 128), np.int32)},
                     {"input_ids": np.zeros((3, 128, 3), np.uint8)}):
        assert jax_engine.validate(features) is None
        assert port_engine.validate(features) is None


def test_packed_feature_spec_matches_jax(engines):
    jax_engine, port_engine = engines
    assert port_engine.feature_spec == jax_engine.feature_spec
    assert port_engine_lib.packed_feature_spec(port_engine.feature_spec) == \
        jax_engine_lib.packed_feature_spec(jax_engine.feature_spec)
    spec = {"dense": {"shape": [13], "dtype": "float32"},
            "sparse": {"shape": [26], "dtype": "int64"}}
    assert port_engine_lib.packed_feature_spec(spec) == \
        jax_engine_lib.packed_feature_spec(spec)


def test_packed_predict_payload_matches_native():
    """The twin of the JAX engine's packed case (its test
    test_packed_predict_payload_matches_native): a DeepFM engine takes
    the same 3 rows with native int32 ids and uint24-packed, and its
    predictions are equal bit for bit (the ids unpack exactly, and
    everything after the unpack is one computation).  The native
    predictions are the JAX engine's within F32_TOL."""
    from elasticdl_tpu_torch.data.wire import pack_int_to_uint24
    from elasticdl_tpu_torch.model_zoo.deepfm import (
        deepfm_functional_api as port_fm,
    )
    from model_zoo.deepfm import deepfm_functional_api as jax_fm

    cfg = dict(vocab_capacity=4096, embed_dim=4)
    rng = np.random.RandomState(0)
    sample = {"dense": rng.rand(2, 13).astype(np.float32),
              "sparse": rng.randint(0, 1 << 22, (2, 26)).astype(np.int32)}
    jax_model = jax_fm.custom_model(**cfg)
    variables = jax_model.init(jax.random.PRNGKey(0), sample)
    jax_engine = jax_engine_lib.ServingEngine(
        jax_model, variables, step=3, feature_spec=feature_meta(sample),
        buckets=(4,))
    port_model = port_fm.custom_model(**cfg)
    engine = port_engine_lib.ServingEngine(
        port_model, params_from_jax(port_model, flatten_params(
            jax.tree.map(np.asarray, variables["params"]))),
        step=3, feature_spec=feature_meta(sample), buckets=(4,),
        device="cpu")

    pspec = port_engine_lib.packed_feature_spec(engine.feature_spec)
    assert pspec["sparse"] == {"shape": [26, 3], "dtype": "uint8"}
    assert pspec["dense"] == engine.feature_spec["dense"]
    x = {"dense": rng.rand(3, 13).astype(np.float32),
         "sparse": rng.randint(0, 1 << 22, (3, 26)).astype(np.int32)}
    packed = {"dense": x["dense"], "sparse": pack_int_to_uint24(x["sparse"])}
    assert engine.validate(x) is None
    assert engine.validate(packed) is None
    bad = {"dense": x["dense"], "sparse": np.zeros((3, 26, 2), np.uint8)}
    assert "uint24" in engine.validate(bad)

    native, step = engine.predict(x, 3)
    packed_preds, packed_step = engine.predict(packed, 3)
    assert step == packed_step == 3 and native.shape == (3,)
    np.testing.assert_array_equal(native, packed_preds)
    want, _ = jax_engine.predict(x, 3)
    np.testing.assert_allclose(native, np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def _drifted(variables, kind):
    out = dict(variables)
    if kind == "shape":
        out["classifier.bias"] = torch.zeros(3)
    elif kind == "dtype":
        out["classifier.bias"] = out["classifier.bias"].double()
    elif kind == "missing":
        del out["classifier.bias"]
    else:
        out["classifier.extra"] = torch.zeros(2)
    return out


@pytest.mark.parametrize("kind", ["shape", "dtype", "missing", "extra"])
def test_swap_rejects_drift(engines, kind):
    _, port_engine = engines
    step = port_engine.step
    with pytest.raises(ValueError, match="swap rejected"):
        port_engine.swap(_drifted(port_engine.variables, kind), step=99)
    assert port_engine.step == step


def test_swap_changes_outputs_without_new_shapes(engines):
    _, shared = engines
    port_engine = port_engine_lib.ServingEngine(
        port_bert.custom_model(**CFG), shared.variables, step=5,
        feature_spec=shared.feature_spec, buckets=(4,), device="cpu",
    )
    x = _requests(4, seed=7)
    before, _ = port_engine.predict(x, 4)
    compiles = port_engine.compile_count
    doubled = {k: v * 2 for k, v in port_engine.variables.items()}
    port_engine.swap(doubled, step=12, produced_unix_s=123.0)
    after, step = port_engine.predict(x, 4)
    assert step == 12 and port_engine.swap_count == 1
    assert port_engine.produced_unix_s == 123.0
    assert port_engine.compile_count == compiles
    assert not np.allclose(before, after)


def test_engine_runs_on_cuda_unless_told_cpu(engines, monkeypatch):
    _, shared = engines
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_engine_lib.ServingEngine(
            port_bert.custom_model(**CFG), shared.variables, step=0,
            feature_spec=shared.feature_spec, buckets=(1,),
        )


def test_unsigned_ids_widen_before_the_model(engines):
    _, port_engine = engines
    ids = _requests(2, seed=11)["input_ids"]
    tensor = port_engine_lib.to_tensor(ids.astype(np.uint16),
                                      torch.device("cpu"))
    assert tensor.dtype == torch.int64
    np.testing.assert_array_equal(tensor.numpy(), ids)


# ---- batcher policies on a fake engine ----------------------------------


class FakeEngine:
    """ServingEngine's batcher-facing surface: buckets, validate,
    predict.  Predictions echo a running row counter so tests can check
    per-request row alignment through concat/split."""

    def __init__(self, buckets=(4, 8), delay_s=0.0, fail=False):
        self._buckets = tuple(sorted(buckets))
        self.delay_s = delay_s
        self.fail = fail
        self.calls = []
        self.entered = threading.Event()
        self.release = threading.Event()
        self.release.set()
        self._next_row = 0
        self._lock = threading.Lock()

    @property
    def max_bucket(self):
        return self._buckets[-1]

    def bucket_for(self, rows):
        for b in self._buckets:
            if b >= rows:
                return b
        return None

    def validate(self, features):
        if set(features) != {"x"}:
            return f"feature keys {sorted(features)} do not match ['x']"
        if features["x"].shape[0] == 0:
            return "empty request (0 rows)"
        return None

    def predict(self, features, rows):
        self.entered.set()
        self.release.wait(timeout=10)
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail:
            raise RuntimeError("engine exploded")
        with self._lock:
            self.calls.append((rows, self.bucket_for(rows)))
            start = self._next_row
            self._next_row += rows
        return np.arange(start, start + rows, dtype=np.int64), 7


def _req(rows):
    return {"x": np.zeros((rows, 3), np.float32)}


@pytest.fixture
def fake():
    return FakeEngine()


def test_batcher_single_request_dispatches_at_deadline(fake):
    batcher = DynamicBatcher(fake, max_latency_s=0.05)
    t0 = time.monotonic()
    result = batcher.submit(_req(1)).result(timeout=5)
    elapsed = time.monotonic() - t0
    assert result.code == OK and result.model_step == 7
    assert 0.04 <= elapsed < 2.0
    assert fake.calls == [(1, 4)]
    batcher.shutdown()


def test_batcher_full_batch_dispatches_before_deadline(fake):
    fake.release.clear()
    batcher = DynamicBatcher(fake, max_latency_s=30.0, max_batch=8)
    futures = [batcher.submit(_req(2)) for _ in range(4)]
    fake.release.set()
    t0 = time.monotonic()
    results = [f.result(timeout=5) for f in futures]
    assert time.monotonic() - t0 < 5.0
    assert [r.code for r in results] == [OK] * 4
    assert fake.calls == [(8, 8)]
    np.testing.assert_array_equal(
        np.concatenate([r.predictions for r in results]), np.arange(8))
    batcher.shutdown()


def test_batcher_overload_sheds_immediately(fake):
    fake.release.clear()
    batcher = DynamicBatcher(fake, max_latency_s=0.001, max_queue_rows=4)
    admitted = [batcher.submit(_req(2))]
    assert fake.entered.wait(timeout=5)
    admitted += [batcher.submit(_req(2)) for _ in range(2)]
    result = batcher.submit(_req(2)).result(timeout=1)
    assert result.code == OVERLOADED and "queue full" in result.error
    assert batcher.metrics.snapshot()["shed"] == 1.0
    fake.release.set()
    assert [f.result(timeout=5).code for f in admitted] == [OK] * 3
    batcher.shutdown()


def test_batcher_splits_oversized_and_reassembles(fake):
    batcher = DynamicBatcher(fake, max_latency_s=0.005)
    result = batcher.submit(_req(18)).result(timeout=5)
    assert result.code == OK
    np.testing.assert_array_equal(result.predictions, np.arange(18))
    batcher.shutdown()


class SwappingEngine(FakeEngine):
    """A FakeEngine whose step moves to 8 after its first call, as a hot
    swap landing between the chunks of a split request."""

    def predict(self, features, rows):
        preds, _ = super().predict(features, rows)
        return preds, 7 if len(self.calls) == 1 else 8


def test_batcher_reruns_a_split_request_that_straddles_a_swap():
    """One response is one step's forward: the chunks ran on steps 7 and
    8, so the whole request runs again, on step 8."""
    engine = SwappingEngine()
    batcher = DynamicBatcher(engine, max_latency_s=0.005)
    result = batcher.submit(_req(18)).result(timeout=5)
    assert result.code == OK and result.model_step == 8
    # 3 chunks on the first pass, 3 again on the rerun
    assert [rows for rows, _ in engine.calls] == [8, 8, 2] * 2
    np.testing.assert_array_equal(result.predictions, np.arange(18, 36))
    assert batcher.queue_depth == 0
    batcher.shutdown()


class ClockedSwappingEngine(SwappingEngine):
    """A SwappingEngine whose every call takes one second of a fake
    clock, the batcher's clock."""

    def __init__(self):
        super().__init__()
        self.now = 0.0

    def clock(self):
        return self.now

    def predict(self, features, rows):
        out = super().predict(features, rows)
        self.now += 1.0
        return out


def test_batcher_times_a_rerun_request_once_from_its_first_enqueue():
    """A rerun request of 3 chunks adds 3 latency samples, each the
    client's whole wait (6 calls of one second), and counts one rerun."""
    engine = ClockedSwappingEngine()
    batcher = DynamicBatcher(engine, max_latency_s=0.0, clock=engine.clock)
    samples = []
    record = batcher.metrics.latency.record

    def recorded(value):
        samples.append(value)
        record(value)

    batcher.metrics.latency.record = recorded
    result = batcher.submit(_req(18)).result(timeout=5)
    assert result.code == OK and result.model_step == 8
    assert [rows for rows, _ in engine.calls] == [8, 8, 2] * 2
    assert samples == [6.0] * 3
    snap = batcher.metrics.snapshot()
    assert snap["split_reruns"] == 1.0
    assert batcher.metrics.latency.snapshot()["count"] == 3
    batcher.shutdown()


def test_batcher_rejects_oversized_by_policy(fake):
    batcher = DynamicBatcher(fake, max_latency_s=0.005,
                             reject_oversized=True)
    result = batcher.submit(_req(18)).result(timeout=1)
    assert result.code == INVALID
    assert "exceeds the batch limit" in result.error
    assert fake.calls == []
    batcher.shutdown()


def test_batcher_invalid_request_resolves_without_engine(fake):
    batcher = DynamicBatcher(fake, max_latency_s=0.005)
    result = batcher.submit({"y": np.zeros((1, 3))}).result(timeout=1)
    assert result.code == INVALID and "feature keys" in result.error
    assert fake.calls == []
    batcher.shutdown()


def test_batcher_shutdown_drains_then_rejects(fake):
    fake.delay_s = 0.02
    batcher = DynamicBatcher(fake, max_latency_s=0.001, max_batch=4)
    futures = [batcher.submit(_req(3)) for _ in range(5)]
    batcher.shutdown()
    assert [f.result(timeout=1).code for f in futures] == [OK] * 5
    assert batcher.submit(_req(1)).result(timeout=1).code == SHUTTING_DOWN


def test_batcher_engine_failure_fails_batch_not_batcher(fake):
    batcher = DynamicBatcher(fake, max_latency_s=0.005)
    fake.fail = True
    result = batcher.submit(_req(2)).result(timeout=5)
    assert result.code == INTERNAL and "engine exploded" in result.error
    fake.fail = False
    assert batcher.submit(_req(2)).result(timeout=5).code == OK
    assert batcher.metrics.snapshot()["internal"] == 1.0
    batcher.shutdown()


def test_batcher_metrics_fill_ratio_and_latency(fake):
    batcher = DynamicBatcher(fake, max_latency_s=0.01)
    assert batcher.submit(_req(2)).result(timeout=5).code == OK
    snap = batcher.metrics.snapshot()
    assert snap["batches"] == 1.0 and snap["ok_rows"] == 2.0
    assert snap["batch_fill_ratio"] == pytest.approx(0.5)
    assert snap["latency_p99_s"] > 0.0
    assert batcher.queue_depth == 0
    batcher.shutdown()
