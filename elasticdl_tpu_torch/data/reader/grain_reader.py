"""Random-access dataset adapter (the port's copy of the JAX package's
data/reader/grain_reader.py): any object with grain's random-access
contract, `len(ds)` and `ds[i]`, becomes shard-addressable.

The reader never needs the grain package: a factory may return a grain
`MapDataset` where grain is installed, or any plain sequence (the port's
`mnist.data:grain_dataset` returns a list of the same 785-byte records
the TFRecord pipeline holds).  As in the JAX package, the master's task
queue owns elasticity, so the adapter only reads index ranges.

Origin format:  grain://dotted.module:factory[?k=v&k2=v2]

The factory module resolves in the port's own zoo first
(`elasticdl_tpu_torch.model_zoo.<module>`, as `--model_zoo` resolves it,
common/model_handler.py), then as given on `sys.path` (a user zoo the
CLI put there, or any importable module).  It is called with the query's
keyword arguments, each `ast.literal_eval`'d (literals only, never
code), and must return a random-access dataset.
"""

from __future__ import annotations

import ast
import importlib
from typing import Iterator, List, Tuple
from urllib.parse import parse_qsl, urlparse

from elasticdl_tpu_torch.data.reader.base import AbstractDataReader

_ZOO_PACKAGE = "elasticdl_tpu_torch.model_zoo"


def _import(module_path: str):
    try:
        return importlib.import_module(f"{_ZOO_PACKAGE}.{module_path}")
    except ModuleNotFoundError as exc:
        if exc.name is None or not f"{_ZOO_PACKAGE}.{module_path}" \
                .startswith(exc.name):
            raise
    return importlib.import_module(module_path)


def _resolve(origin: str):
    if not origin.startswith("grain://"):
        origin = "grain://" + origin
    parsed = urlparse(origin)
    target = (parsed.netloc + parsed.path).strip("/")
    module_path, _, fn_name = target.partition(":")
    if not fn_name:
        raise ValueError(
            f"grain origin must be grain://module.path:factory, got "
            f"{origin!r}")
    factory = getattr(_import(module_path), fn_name)
    kwargs = {}
    for key, value in parse_qsl(parsed.query):
        try:
            kwargs[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            kwargs[key] = value  # raw string
    return factory(**kwargs)


class GrainDataReader(AbstractDataReader):
    """Shard-addressable reader over a random-access dataset factory."""

    def __init__(self, data_dir: str = "", records_per_shard: int = 0,
                 **kwargs):
        # data_dir: the origin with or without the grain:// prefix (the
        # registry strips the scheme before construction)
        super().__init__(**kwargs)
        self._origin = data_dir
        self._records_per_shard = records_per_shard
        self._dataset = None

    @property
    def dataset(self):
        if self._dataset is None:
            self._dataset = _resolve(self._origin)
        return self._dataset

    def read_records(self, task) -> Iterator:
        ds = self.dataset
        end = min(task.shard.end, len(ds))
        for i in range(task.shard.start, end):
            yield ds[i]

    def create_shards(self) -> List[Tuple[str, int, int]]:
        n = len(self.dataset)
        per = self._records_per_shard or n
        return [(self._origin, start, min(start + per, n))
                for start in range(0, n, per)]
