"""Read one zarr array out of a key-value store (common/ocdbt.py): the
format orbax stores each leaf of a checkpoint in.

orbax writes zarr v2 by default (`_METADATA`'s `use_zarr3` is false):
`<name>/.zarray` holds the shape, the chunk shape, the dtype, the
compressor (zstd or none), the fill value and the memory order, and
each chunk lives at `<name>/<i>.<j>...` (a 0-d array's at `<name>/0`),
a whole chunk even at the array's edge.  With `use_zarr3` it writes
zarr v3: `<name>/zarr.json` with `data_type`, a regular chunk grid, a
chunk key encoding (`c/<i>/<j>` by default) and a codec chain of
`transpose`, `bytes` (with its endianness) and `zstd`.  Both are read
here; any other codec, compressor or filter raises.

A missing chunk takes the fill value.  `bfloat16` has no numpy dtype
here (no ml_dtypes on the card): its bits are read as uint16 and the
array comes back as a `torch.bfloat16` tensor through `.view`; every
other dtype comes back as a numpy array.
"""

from __future__ import annotations

import itertools
import json
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from elasticdl_tpu_torch.common import zstd

# zarr v3 data types -> numpy dtype (little-endian; `bytes` may swap)
_V3_DTYPES = {
    "bool": "|b1", "int8": "|i1", "uint8": "|u1", "int16": "<i2",
    "uint16": "<u2", "int32": "<i4", "uint32": "<u4", "int64": "<i8",
    "uint64": "<u8", "float16": "<f2", "float32": "<f4", "float64": "<f8",
    "bfloat16": "<u2", "complex64": "<c8", "complex128": "<c16",
}


class ZarrError(ValueError):
    """A zarr array this reader cannot read, or a corrupt chunk."""


def _metadata(store, name: str):
    for key, version in ((f"{name}/.zarray", 2), (f"{name}/zarr.json", 3)):
        raw = store.read(key)
        if raw is not None:
            try:
                return json.loads(raw), version
            except ValueError as exc:
                raise ZarrError(f"{key}: {exc}") from exc
    raise ZarrError(f"no zarr array named {name!r}")


def _v2_dtype(text: str):
    """(numpy dtype of the stored bits, whether it is bfloat16)."""
    if text == "bfloat16":
        return np.dtype("<u2"), True
    try:
        return np.dtype(text), False
    except TypeError as exc:
        raise ZarrError(f"zarr dtype {text!r}: {exc}") from exc


def _fill(value: Any, dtype: np.dtype, bf16: bool):
    if value is None:
        return 0
    if bf16 and isinstance(value, (int, float)) and value != 0:
        bits = np.asarray(value, np.float32).view(np.uint32) >> 16
        return int(bits)
    if isinstance(value, str):   # "NaN", "Infinity", hex bit patterns
        if value.startswith("0x"):
            return np.frombuffer(int(value, 16).to_bytes(
                dtype.itemsize, "little"), dtype)[0]
        return float(value)
    return value


class _Spec:
    """What reading one array needs, from either zarr version."""

    def __init__(self, meta: dict, version: int, name: str):
        self.name = name
        self.shape = tuple(int(d) for d in meta["shape"])
        self.transpose: Optional[List[int]] = None
        self.compressed = False
        if version == 2:
            if meta.get("filters"):
                raise ZarrError(f"{name}: zarr filters are not supported")
            comp = meta.get("compressor")
            if comp is not None:
                if comp.get("id") != "zstd":
                    raise ZarrError(f"{name}: compressor {comp.get('id')!r}"
                                    " is not supported")
                self.compressed = True
            self.dtype, self.bf16 = _v2_dtype(meta["dtype"])
            self.chunks = tuple(int(d) for d in meta["chunks"])
            self.order = meta.get("order", "C")
            sep = meta.get("dimension_separator", ".")
            self.key = lambda idx: f"{name}/" + (
                sep.join(map(str, idx)) if idx else "0")
            self.fill = _fill(meta.get("fill_value"), self.dtype, self.bf16)
            return
        if meta.get("node_type", "array") != "array":
            raise ZarrError(f"{name} is a zarr group, not an array")
        data_type = meta["data_type"]
        if data_type not in _V3_DTYPES:
            raise ZarrError(f"{name}: zarr data type {data_type!r}")
        self.dtype = np.dtype(_V3_DTYPES[data_type])
        self.bf16 = data_type == "bfloat16"
        grid = meta["chunk_grid"]
        if grid.get("name") != "regular":
            raise ZarrError(f"{name}: chunk grid {grid.get('name')!r}")
        self.chunks = tuple(int(d) for d in
                            grid["configuration"]["chunk_shape"])
        self.order = "C"
        for codec in meta.get("codecs", []):
            kind = codec.get("name")
            conf = codec.get("configuration") or {}
            if kind == "transpose":
                self.transpose = [int(a) for a in conf["order"]]
            elif kind == "bytes":
                if conf.get("endian", "little") == "big":
                    self.dtype = self.dtype.newbyteorder(">")
            elif kind == "zstd":
                self.compressed = True
            else:
                raise ZarrError(f"{name}: zarr codec {kind!r} is not "
                                "supported")
        encoding = meta.get("chunk_key_encoding", {"name": "default"})
        conf = encoding.get("configuration") or {}
        if encoding.get("name") == "v2":
            sep = conf.get("separator", ".")
            self.key = lambda idx: f"{name}/" + (
                sep.join(map(str, idx)) if idx else "0")
        else:
            sep = conf.get("separator", "/")
            self.key = lambda idx: f"{name}/c" + "".join(
                sep + str(i) for i in idx)
        self.fill = _fill(meta.get("fill_value"), self.dtype, self.bf16)

    def decode(self, raw: bytes) -> np.ndarray:
        if self.compressed:
            try:
                raw = zstd.decompress(raw)
            except zstd.ZstdError as exc:
                raise ZarrError(f"{self.name}: {exc}") from exc
        stored = self.chunks
        if self.transpose is not None:
            stored = tuple(self.chunks[a] for a in self.transpose)
        count = int(np.prod(stored, dtype=np.int64))
        if len(raw) != count * self.dtype.itemsize:
            raise ZarrError(f"{self.name}: chunk of {len(raw)} bytes, want "
                            f"{count * self.dtype.itemsize}")
        chunk = np.frombuffer(raw, self.dtype).reshape(
            stored, order=self.order)
        if self.transpose is not None:
            chunk = chunk.transpose(np.argsort(self.transpose))
        return chunk


def read_array(store, name: str):
    """The array `name` of `store` (an object with `read(key) -> bytes or
    None`): a numpy array, or a torch.bfloat16 tensor for bfloat16."""
    meta, version = _metadata(store, name)
    spec = _Spec(meta, version, name)
    shape, chunks = spec.shape, spec.chunks
    if len(chunks) != len(shape):
        raise ZarrError(f"{name}: chunk rank {len(chunks)} for shape "
                        f"{shape}")
    out = np.full(shape, spec.fill, dtype=spec.dtype.newbyteorder("="))
    grid: Sequence[range] = [range(-(-s // c)) if c else range(0)
                             for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        raw = store.read(spec.key(idx))
        if raw is None:
            continue
        chunk = spec.decode(raw)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    if spec.bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out
