"""The online-serving messages: the port's counterpart of the JAX
package's proto/serving.proto and its generated serving_pb2.py.

The card's machine has no protobuf runtime, so each message is a
dataclass whose `SerializeToString()` and `FromString()` write and read
protobuf's wire format by hand, for the field numbers of serving.proto:

- varint fields (int64, enum, bool), negative values as ten-byte two's
  complement;
- length-delimited fields (string, bytes, sub-messages, packed
  `repeated int64`);
- the one fixed-width field, `ScalarMetric.value` (a little-endian
  double);
- proto3 defaults left out: a zero number, an empty string or bytes, an
  empty repeated field.  A sub-message field is written whenever it is
  set (not None), even when empty, as protobuf does once a field is set.

Fields go out in field-number order, as protobuf writes them, so the
bytes equal `serving_pb2`'s for the same fields.  The reader takes what
any protobuf writer may send: fields in any order, a repeated int64
packed or not, a singular sub-message given twice (merged), and unknown
fields (skipped; so is a known field number with another wire type, as
protobuf does).  A malformed message raises `DecodeError`.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field, fields
from typing import List, Optional

_U64 = (1 << 64) - 1

# wire types
_VARINT = 0
_FIXED64 = 1
_LEN = 2
_FIXED32 = 5


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


class ServingCode(enum.IntEnum):
    """In-band serving status (serving.proto `ServingCode`)."""

    SERVING_OK = 0
    SERVING_OVERLOADED = 1      # queue full: request shed at admission
    SERVING_SHUTTING_DOWN = 2   # server draining; client should re-resolve
    SERVING_INVALID = 3         # malformed request (bad keys/shapes/dtype)
    SERVING_INTERNAL = 4        # execution failed; error carries detail


SERVING_OK = ServingCode.SERVING_OK
SERVING_OVERLOADED = ServingCode.SERVING_OVERLOADED
SERVING_SHUTTING_DOWN = ServingCode.SERVING_SHUTTING_DOWN
SERVING_INVALID = ServingCode.SERVING_INVALID
SERVING_INTERNAL = ServingCode.SERVING_INTERNAL


# ---- encoding -------------------------------------------------------------


def _varint(value: int) -> bytes:
    value &= _U64
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _key(number: int, wire_type: int) -> bytes:
    return _varint((number << 3) | wire_type)


def _delimited(number: int, payload: bytes) -> bytes:
    return _key(number, _LEN) + _varint(len(payload)) + payload


# ---- decoding -------------------------------------------------------------


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result & _U64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


def _fields_of(buf: bytes):
    """(number, wire type, value) per field; `value` is an int for
    varints, 8 or 4 raw bytes for fixed widths, the payload for
    length-delimited fields."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire_type = key >> 3, key & 7
        if number == 0:
            raise DecodeError("field number 0")
        if wire_type == _VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire_type == _LEN:
            size, pos = _read_varint(buf, pos)
            if pos + size > len(buf):
                raise DecodeError("truncated length-delimited field")
            value, pos = buf[pos:pos + size], pos + size
        elif wire_type in (_FIXED64, _FIXED32):
            width = 8 if wire_type == _FIXED64 else 4
            if pos + width > len(buf):
                raise DecodeError("truncated fixed-width field")
            value, pos = buf[pos:pos + width], pos + width
        else:
            raise DecodeError(f"unsupported wire type {wire_type}")
        yield number, wire_type, value


def _packed_varints(payload: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(payload):
        value, pos = _read_varint(payload, pos)
        out.append(_signed64(value))
    return out


def _utf8(payload: bytes) -> str:
    try:
        return payload.decode("utf-8")
    except UnicodeDecodeError as exc:
        raise DecodeError(f"string field is not valid UTF-8: {exc}")


# ---- messages -------------------------------------------------------------
#
# Each message declares `_FIELDS`: (number, attribute, kind, message
# class or None) in field-number order.  Kinds: string, bytes, int64,
# enum, bool, double, packed_int64, message, repeated_message.


class _Message:
    _FIELDS: tuple = ()

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf API)
        parts = []
        for number, name, kind, _ in self._FIELDS:
            value = getattr(self, name)
            if kind == "string":
                if value:
                    parts.append(_delimited(number, value.encode("utf-8")))
            elif kind == "bytes":
                if value:
                    parts.append(_delimited(number, bytes(value)))
            elif kind in ("int64", "enum", "bool"):
                if value:
                    parts.append(_key(number, _VARINT) + _varint(int(value)))
            elif kind == "double":
                raw = struct.pack("<d", float(value))
                if raw != bytes(8):      # -0.0 is written, as protobuf does
                    parts.append(_key(number, _FIXED64) + raw)
            elif kind == "packed_int64":
                if value:
                    parts.append(_delimited(
                        number, b"".join(_varint(int(v)) for v in value)))
            elif kind == "message":
                if value is not None:
                    parts.append(_delimited(number,
                                            value.SerializeToString()))
            else:   # repeated_message
                for item in value:
                    parts.append(_delimited(number,
                                            item.SerializeToString()))
        return b"".join(parts)

    @classmethod
    def FromString(cls, data: bytes):  # noqa: N802 (protobuf API)
        spec = {number: (name, kind, sub)
                for number, name, kind, sub in cls._FIELDS}
        values = {}
        messages = {}    # singular sub-messages: payloads merge in order
        for number, wire_type, value in _fields_of(bytes(data)):
            if number not in spec:
                continue
            name, kind, sub = spec[number]
            want = {"double": _FIXED64, "int64": _VARINT, "enum": _VARINT,
                    "bool": _VARINT}.get(kind, _LEN)
            if kind == "packed_int64" and wire_type == _VARINT:
                values.setdefault(name, []).append(_signed64(value))
                continue
            if wire_type != want:
                continue   # protobuf keeps it as an unknown field
            if kind == "string":
                values[name] = _utf8(value)
            elif kind == "bytes":
                values[name] = bytes(value)
            elif kind == "int64":
                values[name] = _signed64(value)
            elif kind == "enum":
                code = _signed64(value)
                try:
                    values[name] = ServingCode(code)
                except ValueError:
                    values[name] = code   # proto3 enums are open
            elif kind == "bool":
                values[name] = value != 0
            elif kind == "double":
                values[name] = struct.unpack("<d", value)[0]
            elif kind == "packed_int64":
                values.setdefault(name, []).extend(_packed_varints(value))
            elif kind == "message":
                _, payload = messages.get(name, (sub, b""))
                messages[name] = (sub, payload + value)
            else:
                values.setdefault(name, []).append(sub.FromString(value))
        for name, (sub, payload) in messages.items():
            values[name] = sub.FromString(payload)
        return cls(**values)

    def ByteSize(self) -> int:  # noqa: N802 (protobuf API)
        return len(self.SerializeToString())


@dataclass
class TensorProto(_Message):
    """A dense tensor: numpy dtype name + shape + raw little-endian
    C-order bytes."""

    dtype: str = ""
    shape: List[int] = field(default_factory=list)
    data: bytes = b""


TensorProto._FIELDS = (
    (1, "dtype", "string", None),
    (2, "shape", "packed_int64", None),
    (3, "data", "bytes", None),
)


@dataclass
class NamedTensor(_Message):
    name: str = ""
    tensor: Optional[TensorProto] = None


NamedTensor._FIELDS = (
    (1, "name", "string", None),
    (2, "tensor", "message", TensorProto),
)


@dataclass
class PredictRequest(_Message):
    """One entry per feature key; models whose feed yields a single array
    use the reserved name "features".  `request_id` is the trace context
    (empty = untraced); the server echoes it back."""

    inputs: List[NamedTensor] = field(default_factory=list)
    request_id: str = ""


PredictRequest._FIELDS = (
    (1, "inputs", "repeated_message", NamedTensor),
    (2, "request_id", "string", None),
)


@dataclass
class PredictResponse(_Message):
    code: int = SERVING_OK
    error: str = ""                          # empty unless code != OK
    predictions: Optional[TensorProto] = None  # rows align with request
    model_step: int = 0                      # step that produced them
    request_id: str = ""                     # echo of the request's


PredictResponse._FIELDS = (
    (1, "code", "enum", None),
    (2, "error", "string", None),
    (3, "predictions", "message", TensorProto),
    (4, "model_step", "int64", None),
    (5, "request_id", "string", None),
)


@dataclass
class HealthRequest(_Message):
    pass


HealthRequest._FIELDS = ()


@dataclass
class ScalarMetric(_Message):
    name: str = ""
    value: float = 0.0


ScalarMetric._FIELDS = (
    (1, "name", "string", None),
    (2, "value", "double", None),
)


@dataclass
class HealthResponse(_Message):
    serving: bool = False
    model_step: int = 0
    buckets: List[int] = field(default_factory=list)   # ascending
    queue_depth: int = 0          # rows queued in the batcher
    compile_count: int = 0        # distinct batch shapes run so far
    metrics: List[ScalarMetric] = field(default_factory=list)


HealthResponse._FIELDS = (
    (1, "serving", "bool", None),
    (2, "model_step", "int64", None),
    (3, "buckets", "packed_int64", None),
    (4, "queue_depth", "int64", None),
    (5, "compile_count", "int64", None),
    (6, "metrics", "repeated_message", ScalarMetric),
)

MESSAGES = (TensorProto, NamedTensor, PredictRequest, PredictResponse,
            HealthRequest, ScalarMetric, HealthResponse)

# every message declares each of its dataclass fields on the wire
for _cls in MESSAGES:
    assert [f.name for f in fields(_cls)] == \
        [name for _, name, _, _ in _cls._FIELDS], _cls
del _cls
