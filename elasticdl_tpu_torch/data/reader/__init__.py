"""Reader factory and pluggable registry (the port's copy of the JAX
package's data/reader/__init__.py).

A zoo module plugs a source in by registration: it calls
`register_data_reader("myscheme", MyReader)` at import time, and any
`--training_data myscheme://...` origin dispatches to it.  Built in:
`csv`, `tfrecord` and `sqlite` (`sqlite:///path.db?table=NAME`).

`ClickStreamSource` and `StreamReader` (stream_reader.py) turn an
unbounded source into shard-addressable windows for a perpetual task
manager.  As in the JAX package, no scheme is registered for them: a
caller builds the reader itself, so `stream://x` raises the registry's
ValueError.  `grain://module:factory` origins read any random-access
dataset a factory returns (grain_reader.py), with no grain package.
"""

import os
from typing import Dict, Type

from elasticdl_tpu_torch.data.reader.base import AbstractDataReader  # noqa: F401,E501
from elasticdl_tpu_torch.data.reader.csv_reader import (  # noqa: F401
    CSVDataReader,
)
from elasticdl_tpu_torch.data.reader.grain_reader import (  # noqa: F401
    GrainDataReader,
)
from elasticdl_tpu_torch.data.reader.memory_reader import (  # noqa: F401
    MemoryDataReader,
)
from elasticdl_tpu_torch.data.reader.stream_reader import (  # noqa: F401
    ClickStreamSource,
    StreamReader,
)
from elasticdl_tpu_torch.data.reader.table_reader import (  # noqa: F401
    TableDataReader,
)
from elasticdl_tpu_torch.data.reader.tfrecord_reader import (  # noqa: F401
    TFRecordDataReader,
)

_REGISTRY: Dict[str, Type[AbstractDataReader]] = {}


def register_data_reader(scheme: str, reader_cls=None):
    """Register a reader class for a `scheme://` origin prefix (or a
    `reader_type=scheme` kwarg).  Usable as a call or a decorator:

        @register_data_reader("odps")
        class ODPSReader(AbstractDataReader): ...
    """
    def _register(cls):
        if not issubclass(cls, AbstractDataReader):
            raise TypeError(
                f"{cls!r} must subclass AbstractDataReader to register"
            )
        _REGISTRY[scheme] = cls
        return cls

    if reader_cls is not None:
        return _register(reader_cls)
    return _register


register_data_reader("csv", CSVDataReader)
register_data_reader("tfrecord", TFRecordDataReader)
register_data_reader("sqlite", TableDataReader)
register_data_reader("grain", GrainDataReader)


def _registered(scheme: str, what: str) -> Type[AbstractDataReader]:
    if scheme not in _REGISTRY:
        raise ValueError(
            f"no data reader registered for {what} {scheme!r} "
            f"(registered: {sorted(_REGISTRY)})"
        )
    return _REGISTRY[scheme]


def create_data_reader(data_origin: str, **kwargs) -> AbstractDataReader:
    """Dispatch on the origin:

    1. `scheme://rest` -> the reader registered for `scheme`, with `rest`
       as its data_dir.
    2. a `reader_type=<scheme>` kwarg -> the same registry, with the
       origin passed whole.
    3. a `.csv` file, or a directory of only `.csv` files -> CSV; anything
       else -> TFRecord.
    """
    if "://" in data_origin:
        scheme, rest = data_origin.split("://", 1)
        return _registered(scheme, "scheme")(data_dir=rest, **kwargs)
    reader_type = kwargs.pop("reader_type", "")
    if reader_type:
        return _registered(reader_type, "reader_type")(
            data_dir=data_origin, **kwargs)
    if data_origin.endswith(".csv"):
        return CSVDataReader(data_dir=data_origin, **kwargs)
    if os.path.isdir(data_origin):
        entries = os.listdir(data_origin)
        if entries and all(e.endswith(".csv") for e in entries):
            return CSVDataReader(data_dir=data_origin, **kwargs)
    return TFRecordDataReader(data_dir=data_origin, **kwargs)
