"""The control-plane messages as plain dataclasses (the port's copy of
the JAX package's proto/elasticdl.proto, cluster messages included).

In the Local runner master and workers share one process, so a message
is a Python object handed from the caller to the servicer.  A cluster
job's workers reach the master over a socket (master/server.py,
`MasterStub` in proto/service.py): every message then travels as
protobuf's wire format for elasticdl.proto's field numbers, written and
read by hand (`SerializeToString`, `FromString`) with the helpers of
proto/serving.py, since the card's machine has no protobuf runtime.
Field kinds beyond serving.proto's: int32 (negative values as ten-byte
two's complement, as protobuf writes them), `map<string, int64>` and
`map<string, float>` (one entry message per key, key and value both
written), and `repeated float` packed (a float32 numpy array on this
side).  Fields go out in field-number order; a sub-message is always
written, so the bytes equal protobuf's wherever the JAX sender sets the
sub-message too.  The conventions stay those of the proto:

- a task with `task_id == -1` (type WAIT) means "no task right now";
- an empty `err_message` in a ReportTaskResultRequest means success.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from elasticdl_tpu_torch.proto.serving import (
    _FIXED32,
    _LEN,
    _VARINT,
    DecodeError,  # noqa: F401  (raised by FromString; callers catch it)
    _delimited,
    _fields_of,
    _key,
    _signed64,
    _utf8,
    _varint,
)


class TaskType(enum.IntEnum):
    TRAINING = 0
    EVALUATION = 1
    PREDICTION = 2
    WAIT = 3        # no task available right now; retry after backoff
    SAVE_MODEL = 4  # a worker saves (and exports) the final model


TRAINING = TaskType.TRAINING
EVALUATION = TaskType.EVALUATION
PREDICTION = TaskType.PREDICTION
WAIT = TaskType.WAIT
SAVE_MODEL = TaskType.SAVE_MODEL


# ---- the wire format --------------------------------------------------
#
# Each message declares `_FIELDS`: (number, attribute, kind, extra) in
# field-number order.  Kinds: int (int32/int64 varints), bool, string,
# enum (extra: the IntEnum), message (extra: the class),
# repeated_message (extra: the class), map_int64 (map<string, int64>),
# map_float (map<string, float>), packed_float (repeated float, a
# float32 ndarray or None).


def _encode_field(number: int, kind: str, value) -> bytes:
    if kind in ("int", "enum", "bool"):
        return _key(number, _VARINT) + _varint(int(value)) if value else b""
    if kind == "string":
        return _delimited(number, value.encode("utf-8")) if value else b""
    if kind == "message":
        return _delimited(number, value.SerializeToString())
    if kind == "repeated_message":
        return b"".join(_delimited(number, item.SerializeToString())
                        for item in value)
    if kind == "map_int64":
        return b"".join(
            _delimited(number, _delimited(1, k.encode("utf-8"))
                       + _key(2, _VARINT) + _varint(int(v)))
            for k, v in value.items())
    if kind == "map_float":
        return b"".join(
            _delimited(number, _delimited(1, k.encode("utf-8"))
                       + _key(2, _FIXED32) + struct.pack("<f", float(v)))
            for k, v in value.items())
    # packed_float
    if value is None or len(value) == 0:
        return b""
    return _delimited(number,
                      np.ascontiguousarray(value, "<f4").tobytes())


def _map_entry(payload: bytes, value_kind: str):
    key, value = "", 0 if value_kind == "map_int64" else 0.0
    for number, wire_type, raw in _fields_of(payload):
        if number == 1 and wire_type == _LEN:
            key = _utf8(raw)
        elif number == 2 and value_kind == "map_int64" \
                and wire_type == _VARINT:
            value = _signed64(raw)
        elif number == 2 and value_kind == "map_float" \
                and wire_type == _FIXED32:
            value = struct.unpack("<f", raw)[0]
    return key, value


class _Wire:
    """protobuf's wire format for a dataclass with a `_FIELDS` table."""

    _FIELDS: tuple = ()

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf API)
        return b"".join(_encode_field(number, kind, getattr(self, name))
                        for number, name, kind, _ in self._FIELDS)

    @classmethod
    def FromString(cls, data: bytes):  # noqa: N802 (protobuf API)
        spec = {number: (name, kind, extra)
                for number, name, kind, extra in cls._FIELDS}
        values, messages = {}, {}
        for number, wire_type, raw in _fields_of(bytes(data)):
            if number not in spec:
                continue
            name, kind, extra = spec[number]
            want = _VARINT if kind in ("int", "enum", "bool") else _LEN
            if kind == "packed_float" and wire_type == _FIXED32:
                # an unpacked repeated float: one element
                values.setdefault(name, []).append(
                    np.frombuffer(raw, "<f4"))
                continue
            if wire_type != want:
                continue   # protobuf keeps it as an unknown field
            if kind == "int":
                values[name] = _signed64(raw)
            elif kind == "bool":
                values[name] = raw != 0
            elif kind == "enum":
                code = _signed64(raw)
                try:
                    values[name] = extra(code)
                except ValueError:
                    values[name] = code   # proto3 enums are open
            elif kind == "string":
                values[name] = _utf8(raw)
            elif kind == "message":
                messages[name] = (extra,
                                  messages.get(name, (None, b""))[1] + raw)
            elif kind == "repeated_message":
                values.setdefault(name, []).append(extra.FromString(raw))
            elif kind in ("map_int64", "map_float"):
                key, value = _map_entry(raw, kind)
                values.setdefault(name, {})[key] = value
            else:   # packed_float
                if len(raw) % 4:
                    raise DecodeError("packed float field of "
                                      f"{len(raw)} bytes")
                values.setdefault(name, []).append(
                    np.frombuffer(raw, "<f4"))
        for name, (sub, payload) in messages.items():
            values[name] = sub.FromString(payload)
        for _, name, kind, _ in cls._FIELDS:
            if kind == "packed_float" and name in values:
                values[name] = np.concatenate(values[name]).astype(
                    np.float32)
        return cls(**values)


@dataclass
class Shard(_Wire):
    """A named data source plus a half-open record range [start, end)."""

    name: str = ""
    start: int = 0
    end: int = 0


@dataclass
class Task(_Wire):
    task_id: int = 0            # -1 means "no task"
    shard: Shard = field(default_factory=Shard)
    type: TaskType = TaskType.TRAINING
    model_version: int = 0      # eval tasks: the version being evaluated
    extended_config: str = ""   # free-form JSON rider


@dataclass
class GetTaskRequest(_Wire):
    worker_id: int = 0
    task_type: TaskType = TaskType.TRAINING
    # must be set for task_type to act as a filter
    filter_by_type: bool = False


@dataclass
class GetTaskResponse(_Wire):
    task: Task = field(default_factory=Task)
    job_finished: bool = False


@dataclass
class ReportTaskResultRequest(_Wire):
    task_id: int = 0
    err_message: str = ""       # empty means success
    worker_id: int = 0
    exec_counters: Dict[str, int] = field(default_factory=dict)
    # re-queue without charging a retry (the worker cannot serve the
    # task yet; the task itself is fine)
    transient: bool = False


@dataclass
class ReportEvaluationMetricsRequest(_Wire):
    """Per-shard scalar metrics plus the raw (label, prediction) samples,
    so the master recomputes rank metrics exactly over the merged set.
    Samples ride as float32 numpy arrays (predictions of width
    `pred_width` flattened row-major); continuation chunks set
    `samples_only`.  On the wire the metrics are float32, as in the
    proto."""

    worker_id: int = 0
    model_version: int = 0
    metrics: Dict[str, float] = field(default_factory=dict)
    num_examples: int = 0
    eval_labels: Optional[np.ndarray] = None
    eval_preds: Optional[np.ndarray] = None
    pred_width: int = 0
    samples_only: bool = False
    # task_id + 1 (0 = unkeyed); a re-delivery under the same key
    # replaces its earlier contribution
    eval_task_key: int = 0
    final_chunk: bool = False

    @property
    def num_samples(self) -> int:
        return 0 if self.eval_labels is None else len(self.eval_labels)


@dataclass
class ReportVersionRequest(_Wire):
    worker_id: int = 0
    model_version: int = 0


@dataclass
class Empty(_Wire):
    pass


# ---- the elastic rendezvous and SPMD group leasing -------------------


@dataclass
class GetClusterSpecRequest(_Wire):
    worker_id: int = 0
    # the caller's current epoch, for cheap polling
    known_rendezvous_id: int = 0
    # the confirmation barrier: a worker ready to form the group for
    # epoch E sends confirm_epoch=E from its main thread (0: none; real
    # epochs start at 1), so a rank wedged in a collective never confirms
    confirm_epoch: int = 0


@dataclass
class WorkerSpec(_Wire):
    worker_id: int = 0
    address: str = ""
    rank: int = 0


@dataclass
class ClusterSpec(_Wire):
    rendezvous_id: int = 0      # bumped on every membership change
    world_size: int = 0
    workers: List[WorkerSpec] = field(default_factory=list)
    # rank 0's host and the coordinator port: where the group's
    # torch.distributed store listens for this epoch
    coordinator_address: str = ""
    # the pod manager's membership target; workers form a group only
    # when world_size equals it
    expected_world_size: int = 0
    # every current member confirmed this rendezvous_id
    all_confirmed: bool = False


@dataclass
class GetSpmdTaskRequest(_Wire):
    worker_id: int = 0          # the asking rank (liveness, logging)
    rendezvous_id: int = 0      # the epoch the rank believes current
    seq: int = 0                # per-epoch assignment sequence number


@dataclass
class SpmdTaskResponse(_Wire):
    task: Task = field(default_factory=Task)
    job_finished: bool = False
    # the caller's epoch is no longer current: restart for the new
    # topology, restore, resume at seq 0
    epoch_stale: bool = False


@dataclass
class KeepAliveRequest(_Wire):
    worker_id: int = 0
    timestamp_ms: int = 0
    # the worker's own reachable address (closes the gap when the pod
    # watch reports Running before the address is known)
    address: str = ""


Shard._FIELDS = ((1, "name", "string", None), (2, "start", "int", None),
                 (3, "end", "int", None))
Task._FIELDS = ((1, "task_id", "int", None), (2, "shard", "message", Shard),
                (3, "type", "enum", TaskType),
                (4, "model_version", "int", None),
                (5, "extended_config", "string", None))
GetTaskRequest._FIELDS = ((1, "worker_id", "int", None),
                          (2, "task_type", "enum", TaskType),
                          (3, "filter_by_type", "bool", None))
GetTaskResponse._FIELDS = ((1, "task", "message", Task),
                           (2, "job_finished", "bool", None))
ReportTaskResultRequest._FIELDS = (
    (1, "task_id", "int", None), (2, "err_message", "string", None),
    (3, "worker_id", "int", None),
    (4, "exec_counters", "map_int64", None),
    (5, "transient", "bool", None))
ReportEvaluationMetricsRequest._FIELDS = (
    (1, "worker_id", "int", None), (2, "model_version", "int", None),
    (3, "metrics", "map_float", None), (4, "num_examples", "int", None),
    (5, "eval_labels", "packed_float", None),
    (6, "eval_preds", "packed_float", None),
    (7, "pred_width", "int", None), (8, "samples_only", "bool", None),
    (9, "eval_task_key", "int", None), (10, "final_chunk", "bool", None))
ReportVersionRequest._FIELDS = ((1, "worker_id", "int", None),
                                (2, "model_version", "int", None))
GetClusterSpecRequest._FIELDS = ((1, "worker_id", "int", None),
                                 (2, "known_rendezvous_id", "int", None),
                                 (3, "confirm_epoch", "int", None))
WorkerSpec._FIELDS = ((1, "worker_id", "int", None),
                      (2, "address", "string", None),
                      (3, "rank", "int", None))
ClusterSpec._FIELDS = (
    (1, "rendezvous_id", "int", None), (2, "world_size", "int", None),
    (3, "workers", "repeated_message", WorkerSpec),
    (4, "coordinator_address", "string", None),
    (5, "expected_world_size", "int", None),
    (6, "all_confirmed", "bool", None))
GetSpmdTaskRequest._FIELDS = ((1, "worker_id", "int", None),
                              (2, "rendezvous_id", "int", None),
                              (3, "seq", "int", None))
SpmdTaskResponse._FIELDS = ((1, "task", "message", Task),
                            (2, "job_finished", "bool", None),
                            (3, "epoch_stale", "bool", None))
KeepAliveRequest._FIELDS = ((1, "worker_id", "int", None),
                            (2, "timestamp_ms", "int", None),
                            (3, "address", "string", None))
