"""The control-plane messages as plain dataclasses (the port's copy of
the field names in the JAX package's proto/elasticdl.proto).

No protobuf and no gRPC: master and workers share one process in the
Local runner, so a message is a Python object handed from the caller to
the servicer.  The wire conventions stay those of the proto:

- a task with `task_id == -1` (type WAIT) means "no task right now";
- an empty `err_message` in a ReportTaskResultRequest means success.

The cluster-only messages (cluster spec, SPMD task leasing, keep-alive)
wait for the gRPC slice of the port.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


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


@dataclass
class Shard:
    """A named data source plus a half-open record range [start, end)."""

    name: str = ""
    start: int = 0
    end: int = 0


@dataclass
class Task:
    task_id: int = 0            # -1 means "no task"
    shard: Shard = field(default_factory=Shard)
    type: TaskType = TaskType.TRAINING
    model_version: int = 0      # eval tasks: the version being evaluated
    extended_config: str = ""   # free-form JSON rider


@dataclass
class GetTaskRequest:
    worker_id: int = 0
    task_type: TaskType = TaskType.TRAINING
    # must be set for task_type to act as a filter
    filter_by_type: bool = False


@dataclass
class GetTaskResponse:
    task: Task = field(default_factory=Task)
    job_finished: bool = False


@dataclass
class ReportTaskResultRequest:
    task_id: int = 0
    err_message: str = ""       # empty means success
    worker_id: int = 0
    exec_counters: Dict[str, int] = field(default_factory=dict)
    # re-queue without charging a retry (the worker cannot serve the
    # task yet; the task itself is fine)
    transient: bool = False


@dataclass
class ReportEvaluationMetricsRequest:
    """Per-shard scalar metrics plus the raw (label, prediction) samples,
    so the master recomputes rank metrics exactly over the merged set.
    Samples ride as float32 numpy arrays (predictions of width
    `pred_width` flattened row-major); continuation chunks set
    `samples_only`."""

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
class ReportVersionRequest:
    worker_id: int = 0
    model_version: int = 0


@dataclass
class Empty:
    pass
