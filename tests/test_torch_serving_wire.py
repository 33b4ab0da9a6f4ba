"""The port's serving messages (elasticdl_tpu_torch/proto/serving.py)
against protobuf's generated serving_pb2: for seeded messages of every
type, the port's bytes equal `SerializeToString()` of serving_pb2, and
the port decodes serving_pb2's bytes (and what any protobuf writer may
send: unpacked repeated ints, fields out of order, unknown fields) to
the same fields.  And the wire-tensor decoders' errors
(`from_tensor_proto`, `decode_features`) read as the JAX server's, word
for word, as do the in-band INVALID responses built from them.
"""

import math
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from elasticdl_tpu.proto import serving_pb2 as jspb
from elasticdl_tpu.serving import server as jax_server
from elasticdl_tpu_torch.proto import serving as spb
from elasticdl_tpu_torch.serving import server as port_server

INT64 = st.integers(-(2 ** 63), 2 ** 63 - 1)
TEXT = st.text(max_size=12)
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                    database=None)

tensor_fields = st.fixed_dictionaries({
    "dtype": TEXT,
    "shape": st.lists(INT64, max_size=5),
    "data": st.binary(max_size=48),
})
named_fields = st.fixed_dictionaries({
    "name": TEXT,
    "tensor": st.none() | tensor_fields,
})
request_fields = st.fixed_dictionaries({
    "inputs": st.lists(named_fields, max_size=4),
    "request_id": TEXT,
})
response_fields = st.fixed_dictionaries({
    "code": st.integers(-(2 ** 31), 2 ** 31 - 1),
    "error": TEXT,
    "predictions": st.none() | tensor_fields,
    "model_step": INT64,
    "request_id": TEXT,
})
metric_fields = st.fixed_dictionaries({
    "name": TEXT,
    "value": st.floats(allow_nan=False),
})
health_fields = st.fixed_dictionaries({
    "serving": st.booleans(),
    "model_step": INT64,
    "buckets": st.lists(INT64, max_size=6),
    "queue_depth": INT64,
    "compile_count": INT64,
    "metrics": st.lists(metric_fields, max_size=4),
})


# ---- the same fields, as each side's message ---------------------------------


def _port(cls, f):
    if cls is spb.NamedTensor:
        return spb.NamedTensor(
            name=f["name"],
            tensor=None if f["tensor"] is None else spb.TensorProto(
                **f["tensor"]))
    if cls is spb.PredictRequest:
        return spb.PredictRequest(
            inputs=[_port(spb.NamedTensor, n) for n in f["inputs"]],
            request_id=f["request_id"])
    if cls is spb.PredictResponse:
        f = dict(f)
        if f["predictions"] is not None:
            f["predictions"] = spb.TensorProto(**f["predictions"])
        return spb.PredictResponse(**f)
    if cls is spb.HealthResponse:
        f = dict(f)
        f["metrics"] = [spb.ScalarMetric(**m) for m in f["metrics"]]
        return spb.HealthResponse(**f)
    return cls(**f)


def _pb(cls, f):
    if cls is jspb.NamedTensor:
        msg = jspb.NamedTensor(name=f["name"])
        if f["tensor"] is not None:
            msg.tensor.SetInParent()
            msg.tensor.MergeFrom(jspb.TensorProto(**f["tensor"]))
        return msg
    if cls is jspb.PredictRequest:
        msg = jspb.PredictRequest(request_id=f["request_id"])
        for n in f["inputs"]:
            msg.inputs.add().CopyFrom(_pb(jspb.NamedTensor, n))
        return msg
    if cls is jspb.PredictResponse:
        f = dict(f)
        tensor = f.pop("predictions")
        msg = jspb.PredictResponse(**f)
        if tensor is not None:
            msg.predictions.SetInParent()
            msg.predictions.MergeFrom(jspb.TensorProto(**tensor))
        return msg
    if cls is jspb.HealthResponse:
        f = dict(f)
        metrics = f.pop("metrics")
        msg = jspb.HealthResponse(**f)
        for m in metrics:
            msg.metrics.add(**m)
        return msg
    return cls(**f)


CASES = {
    "TensorProto": (spb.TensorProto, jspb.TensorProto, tensor_fields),
    "NamedTensor": (spb.NamedTensor, jspb.NamedTensor, named_fields),
    "PredictRequest": (spb.PredictRequest, jspb.PredictRequest,
                       request_fields),
    "PredictResponse": (spb.PredictResponse, jspb.PredictResponse,
                        response_fields),
    "HealthRequest": (spb.HealthRequest, jspb.HealthRequest,
                      st.just({})),
    "ScalarMetric": (spb.ScalarMetric, jspb.ScalarMetric, metric_fields),
    "HealthResponse": (spb.HealthResponse, jspb.HealthResponse,
                       health_fields),
}


def test_every_message_type_is_covered():
    assert {c.__name__ for c in spb.MESSAGES} == set(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bytes_equal_serving_pb2_and_decode_back(name):
    port_cls, pb_cls, strategy = CASES[name]

    @SETTINGS
    @given(strategy)
    def check(f):
        port, pb = _port(port_cls, f), _pb(pb_cls, f)
        wire = pb.SerializeToString()
        assert port.SerializeToString() == wire
        assert port_cls.FromString(wire) == port
        # and protobuf reads the port's bytes back to the same message
        assert pb_cls.FromString(port.SerializeToString()) == pb

    check()


@pytest.mark.parametrize("value", [0.0, -0.0, float("nan"), float("inf"),
                                   -float("inf"), 5e-324, 1.5])
def test_scalar_metric_doubles_as_protobuf_writes_them(value):
    """-0.0 is written (its bits are not zero), 0.0 is not; NaN and the
    infinities travel as their bits."""
    port = spb.ScalarMetric(name="m", value=value)
    wire = jspb.ScalarMetric(name="m", value=value).SerializeToString()
    assert port.SerializeToString() == wire
    back = spb.ScalarMetric.FromString(wire).value
    assert struct.pack("<d", back) == struct.pack("<d", value) or (
        math.isnan(back) and math.isnan(value))


def test_the_reader_takes_what_any_protobuf_writer_may_send():
    # an unpacked repeated int64, fields out of order, an unknown field
    # of each wire type, a sub-message given twice (merged)
    wire = (b"\x1a\x02ab"                 # data
            b"\x10\x05" b"\x10\x7f"       # shape, unpacked
            b"\x12\x01\x03"               # shape, packed
            b"\x0a\x07float32"            # dtype
            b"\x20\x01" b"\x29" + bytes(8) + b"\x35" + bytes(4)
            + b"\x3a\x00"                 # unknown 4 (varint), 5, 6, 7
            b"\x08\x01")                 # dtype with another wire type
    want = jspb.TensorProto.FromString(wire)
    got = spb.TensorProto.FromString(wire)
    assert (got.dtype, got.shape, got.data) == (
        want.dtype, list(want.shape), want.data) == ("float32", [5, 127, 3],
                                                     b"ab")
    twice = (b"\x1a\x04\x0a\x02f4" b"\x1a\x03\x1a\x01z")
    want = jspb.PredictResponse.FromString(twice)
    got = spb.PredictResponse.FromString(twice)
    assert got.predictions == spb.TensorProto(
        dtype=want.predictions.dtype, data=want.predictions.data)


@pytest.mark.parametrize("wire", [
    b"\x0a\x05abc",          # length past the end
    b"\x10",                 # truncated varint
    b"\x0a\x01\xff",         # a string that is not UTF-8
    b"\x0b",                 # a group (wire type 3)
    b"\x00\x01",             # field number 0
])
def test_malformed_bytes_raise_decode_error_like_protobuf(wire):
    from google.protobuf.message import DecodeError as PbDecodeError

    with pytest.raises(PbDecodeError):
        jspb.TensorProto.FromString(wire)
    with pytest.raises(spb.DecodeError):
        spb.TensorProto.FromString(wire)


def test_serving_codes_equal_the_proto_enum():
    for code in spb.ServingCode:
        assert jspb.ServingCode.Value(code.name) == int(code)
    assert len(spb.ServingCode) == len(jspb.ServingCode.keys())


# ---- the decoders' client-facing errors --------------------------------------


def _tensor_cases():
    ok = np.arange(6, dtype=np.float32).reshape(2, 3)
    return {
        "bad dtype": dict(dtype="float99", shape=[2], data=bytes(8)),
        "empty dtype": dict(dtype="", shape=[1], data=bytes(8)),
        "object dtype": dict(dtype="object", shape=[1], data=bytes(8)),
        "negative dim": dict(dtype="int32", shape=[2, -1], data=b""),
        "short data": dict(dtype="float32", shape=[2, 3], data=b"short"),
        "long data": dict(dtype="int8", shape=[2], data=b"abc"),
        "ok": dict(dtype="float32", shape=[2, 3], data=ok.tobytes()),
        "scalar": dict(dtype="float64", shape=[], data=bytes(8)),
    }


@pytest.mark.parametrize("case", sorted(_tensor_cases()))
def test_from_tensor_proto_errors_match_jax(case):
    f = _tensor_cases()[case]

    def outcome(module, proto):
        try:
            arr = module.from_tensor_proto(proto(**f))
        except ValueError as exc:
            return ("error", str(exc))
        return ("ok", arr.dtype, arr.shape, arr.tobytes())

    assert outcome(port_server, spb.TensorProto) == \
        outcome(jax_server, jspb.TensorProto)


_GOOD = dict(dtype="int32", shape=[1, 2], data=bytes(8))
REQUEST_CASES = {
    "no inputs": [],
    "empty name": [("", _GOOD)],
    "duplicate names": [("a", _GOOD), ("a", _GOOD)],
    "bad tensor": [("a", _GOOD), ("b", dict(dtype="int32", shape=[3],
                                            data=b""))],
    "unset tensor": [("a", None)],
    "two good": [("a", _GOOD), ("b", _GOOD)],
}


def _request_fields(case, request_id="rid"):
    return {"inputs": [{"name": n, "tensor": t}
                       for n, t in REQUEST_CASES[case]],
            "request_id": request_id}


@pytest.mark.parametrize("case", sorted(REQUEST_CASES))
def test_decode_features_errors_match_jax(case):
    f = _request_fields(case)

    def outcome(module, msg):
        try:
            feats = module.decode_features(msg)
        except ValueError as exc:
            return ("error", str(exc))
        return ("ok", {k: (v.dtype, v.shape) for k, v in feats.items()})

    assert outcome(port_server, _port(spb.PredictRequest, f)) == \
        outcome(jax_server, _pb(jspb.PredictRequest, f))


@pytest.mark.parametrize("case", sorted(c for c in REQUEST_CASES
                                        if c not in ("two good",
                                                     "unset tensor")))
def test_in_band_invalid_responses_are_the_jax_servicers_bytes(case):
    """A request that does not decode is answered before the engine:
    the port's response bytes equal the JAX servicer's."""
    f = _request_fields(case)
    port = port_server.ServingServicer(None, None).predict(
        _port(spb.PredictRequest, f), None)
    jax = jax_server.ServingServicer(None, None).predict(
        _pb(jspb.PredictRequest, f), None)
    assert port.code == spb.SERVING_INVALID
    assert port.SerializeToString() == jax.SerializeToString()


def test_make_predict_request_matches_jax():
    feats = {"dense": np.ones((3, 13), np.float32),
             "sparse": np.arange(78, dtype=np.int32).reshape(3, 26)}
    for x in (feats, feats["dense"]):
        assert port_server.make_predict_request(x).SerializeToString() == \
            jax_server.make_predict_request(x).SerializeToString()
