"""Reader factory (the port's copy of `create_data_reader` in the JAX
package's data/reader/__init__.py, for paths and `tfrecord://` origins).

The CSV, table (sqlite), stream and grain readers, and the registry that
plugs third-party schemes in, wait for their slice of the port: an
origin that names one raises NotImplementedError.
"""

import os

from elasticdl_tpu_torch.data.reader.base import AbstractDataReader  # noqa: F401,E501
from elasticdl_tpu_torch.data.reader.tfrecord_reader import (  # noqa: F401
    TFRecordDataReader,
)

_WAITING = ("csv", "sqlite", "grain", "stream")


def _waits(kind: str):
    return NotImplementedError(
        f"the {kind} data reader waits for its slice of the port "
        "(ROADMAP.md queue 1, item 3: the other readers)")


def create_data_reader(data_origin: str, **kwargs) -> AbstractDataReader:
    """`tfrecord://path` or a plain path (a file or a directory of
    .tfrecord files) -> TFRecordDataReader."""
    if "://" in data_origin:
        scheme, rest = data_origin.split("://", 1)
        if scheme == "tfrecord":
            return TFRecordDataReader(data_dir=rest, **kwargs)
        if scheme in _WAITING:
            raise _waits(scheme)
        raise ValueError(
            f"no data reader registered for scheme {scheme!r} "
            "(registered: ['tfrecord'])")
    if data_origin.endswith(".csv"):
        raise _waits("csv")
    if os.path.isdir(data_origin):
        entries = os.listdir(data_origin)
        if entries and all(e.endswith(".csv") for e in entries):
            raise _waits("csv")
    return TFRecordDataReader(data_dir=data_origin, **kwargs)
