"""A read-only OCDBT key-value store: the database that orbax writes
each checkpoint step into (`<step>/default/manifest.ocdbt`), read with
no tensorstore.

The layout, as tensorstore writes it:

- `manifest.ocdbt`: the database's config (uuid, inline limit, node
  limit, version-tree arity, node compression) and its version tree:
  the newest versions inline, each with its generation, the root of its
  B+tree (data file, offset, length), its height and statistics, then
  references to the version-tree nodes of older generations;
- B+tree nodes inside `d/<hex>` data files: interior nodes hold each
  child's first key, the prefix that all of the child's keys share
  (stripped from the keys stored in the child) and the child's
  location; leaf nodes hold keys and values, each value inline or a
  reference (data file, offset, length) into a data file.

Every node and manifest is framed: a big-endian magic, the framed size
as a little-endian u64, a format version and a compression method
(varints: 0 raw, 1 zstd), the payload, and a CRC32C of all that comes
before it.  Keys and paths are stored with the prefix they share with
the one before.  A data file is named by a base path and a relative
path; orbax's top-level database names files under `ocdbt.process_<n>/`,
where each process wrote its own database, so a value is read from
there and `list`/`read` see one key space.

`OcdbtStore(path).list(prefix)` gives the keys of the newest version,
sorted; `read(key)` gives a value's bytes.  A corrupt node, manifest or
value reference raises `OcdbtError` (a ValueError).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common import zstd
from elasticdl_tpu_torch.data.record_io import crc32c

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_FILE = "manifest.ocdbt"


class OcdbtError(ValueError):
    """A missing, truncated or corrupt part of an OCDBT database."""


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def varint(self) -> int:
        value = shift = 0
        data = self.data
        while True:
            if self.pos >= len(data):
                raise OcdbtError("truncated varint")
            b = data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError("varint over 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError("truncated payload")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def bytes_list(self, n: int) -> List[int]:
        return list(self.take(n))


def unframe(data: bytes, magic: int, what: str) -> bytes:
    """The payload of a framed manifest or node, checked and
    decompressed."""
    if len(data) < 18:
        raise OcdbtError(f"{what}: {len(data)} bytes is too short")
    got_magic, length = struct.unpack_from(">I", data)[0], \
        struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, want "
                         f"{magic:#010x}")
    if length != len(data):
        raise OcdbtError(f"{what}: framed size {length}, read {len(data)}")
    want_crc = struct.unpack_from("<I", data, len(data) - 4)[0]
    if crc32c(data[:-4]) != want_crc:
        raise OcdbtError(f"{what}: CRC32C mismatch")
    reader = _Reader(data[12:-4])
    version = reader.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    method = reader.varint()
    body = data[12 + reader.pos:-4]
    if method == 0:
        return body
    if method == 1:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as exc:
            raise OcdbtError(f"{what}: {exc}") from exc
    raise OcdbtError(f"{what}: compression method {method}")


def _keys(reader: _Reader, n: int, interior: bool):
    """A node's n keys, each stored as (the length it shares with the
    one before, its suffix); an interior node's lengths of the prefix
    each subtree shares come between the lengths and the key bytes.
    Returns (keys, subtree prefix lengths or None)."""
    if n == 0:
        return [], []
    shared = [0] + reader.varints(n - 1)
    sizes = reader.varints(n)
    common = reader.varints(n) if interior else None
    out: List[bytes] = []
    prev = b""
    for i in range(n):
        if shared[i] > len(prev):
            raise OcdbtError("shared prefix longer than the previous key")
        prev = prev[:shared[i]] + reader.take(sizes[i])
        out.append(prev)
    return out, common


def _file_table(reader: _Reader) -> List[str]:
    """The node's data files, as paths relative to the database."""
    n = reader.varint()
    if n == 0:
        return []
    shared = [0] + reader.varints(n - 1)
    sizes = reader.varints(n)
    base_sizes = reader.varints(n)
    out = []
    prev = b""
    for i in range(n):
        if shared[i] > len(prev):
            raise OcdbtError("corrupt data file table")
        prev = prev[:shared[i]] + reader.take(sizes[i])
        if base_sizes[i] > len(prev):
            raise OcdbtError("corrupt data file table")
        out.append(prev.decode())
    return out


def _refs(reader: _Reader, files: List[str], n: int):
    ids = reader.varints(n)
    offsets = reader.varints(n)
    lengths = reader.varints(n)
    for i in ids:
        if i >= len(files):
            raise OcdbtError(f"data file index {i} of {len(files)}")
    return [(files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


class Manifest:
    """The parsed `manifest.ocdbt`: config, inline versions and the
    references to older version-tree nodes."""

    def __init__(self, payload: bytes):
        r = _Reader(payload)
        self.uuid = r.take(16).hex()
        self.manifest_kind = r.varint()
        if self.manifest_kind != 0:
            raise OcdbtError("numbered manifests are not supported (orbax "
                             "writes single-file manifests)")
        self.max_inline_value_bytes = r.varint()
        self.max_decoded_node_bytes = r.varint()
        self.version_tree_arity_log2 = r.byte()
        self.compression = r.varint()
        self.zstd_level = None
        if self.compression == 1:
            self.zstd_level = struct.unpack("<i", r.take(4))[0]
        elif self.compression != 0:
            raise OcdbtError(f"node compression {self.compression}")
        files = _file_table(r)
        n = r.varint()
        generations = r.varints(n)
        heights = r.bytes_list(n)
        roots = _refs(r, files, n)
        num_keys = r.varints(n)
        tree_bytes = r.varints(n)
        indirect_bytes = r.varints(n)
        times = [struct.unpack("<Q", r.take(8))[0] for _ in range(n)]
        self.versions = [
            {"generation": g, "root_height": h, "root": root,
             "num_keys": k, "num_tree_bytes": t,
             "num_indirect_value_bytes": v, "commit_time": c}
            for g, h, root, k, t, v, c in zip(generations, heights, roots,
                                              num_keys, tree_bytes,
                                              indirect_bytes, times)]
        m = r.varint()
        node_generations = r.varints(m)
        node_refs = _refs(r, files, m)
        node_counts = r.varints(m)
        node_times = [struct.unpack("<Q", r.take(8))[0] for _ in range(m)]
        node_heights = r.bytes_list(m)
        self.version_tree_nodes = [
            {"generation": g, "location": ref, "num_generations": c,
             "commit_time": t, "height": h}
            for g, ref, c, t, h in zip(node_generations, node_refs,
                                       node_counts, node_times,
                                       node_heights)]
        if r.pos != len(payload):
            raise OcdbtError("bytes after the manifest's version tree")
        if not self.versions:
            raise OcdbtError("manifest holds no version")

    @property
    def latest(self) -> dict:
        return max(self.versions, key=lambda v: v["generation"])


class OcdbtStore:
    """The newest version of the OCDBT database at `path`: its keys
    (`list`) and values (`read`), parsed at construction."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self.manifest = Manifest(unframe(
            self._file(MANIFEST_FILE), MANIFEST_MAGIC,
            os.path.join(self.path, MANIFEST_FILE)))
        self._values: Dict[bytes, Tuple] = {}
        latest = self.manifest.latest
        if latest["num_keys"]:
            self._walk(latest["root"], latest["root_height"], b"")
        self._keys = sorted(self._values)
        if len(self._keys) != latest["num_keys"]:
            raise OcdbtError(f"{self.path}: {len(self._keys)} keys, the "
                             f"manifest says {latest['num_keys']}")

    def _file(self, rel: str) -> bytes:
        return self._slice((rel, 0, None))

    def _slice(self, ref) -> bytes:
        """The bytes [offset, offset + length) of a data file (the whole
        file when length is None)."""
        rel, offset, length = ref
        full = os.path.join(self.path, rel)
        try:
            with open(full, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                if length is None:
                    length = size
                if offset + length > size:
                    raise OcdbtError(f"{full}: [{offset}, {offset + length})"
                                     f" past its {size} bytes")
                f.seek(offset)
                data = f.read(length)
        except OSError as exc:
            raise OcdbtError(f"cannot read {full}: {exc}") from exc
        if len(data) != length:
            raise OcdbtError(f"{full}: short read")
        return data

    def _walk(self, ref, height: int, prefix: bytes) -> None:
        what = f"{self.path}: node {ref[0]}:{ref[1]}:{ref[2]}"
        payload = unframe(self._slice(ref), NODE_MAGIC, what)
        if len(payload) > self.manifest.max_decoded_node_bytes:
            raise OcdbtError(f"{what}: decodes past the node limit")
        r = _Reader(payload)
        if r.byte() != height:
            raise OcdbtError(f"{what}: height differs from its parent's")
        files = _file_table(r)
        n = r.varint()
        keys, shared = _keys(r, n, interior=height > 0)
        if height == 0:
            lengths = r.varints(n)
            kinds = r.varints(n)
            if any(k > 1 for k in kinds):
                raise OcdbtError(f"{what}: unknown value kind")
            m = sum(kinds)
            ids = r.varints(m)
            offsets = r.varints(m)
            indirect = iter(zip(ids, offsets))
            for key, length, kind in zip(keys, lengths, kinds):
                full = prefix + key
                if kind:
                    fid, offset = next(indirect)
                    if fid >= len(files):
                        raise OcdbtError(f"{what}: data file index {fid}")
                    self._values[full] = (files[fid], offset, length)
                else:
                    self._values[full] = (r.take(length),)
            if r.pos != len(payload):
                raise OcdbtError(f"{what}: bytes after its values")
            return
        children = _refs(r, files, n)
        r.varints(3 * n)   # each child's statistics
        if r.pos != len(payload):
            raise OcdbtError(f"{what}: bytes after its children")
        for key, common, child in zip(keys, shared, children):
            if common > len(key):
                raise OcdbtError(f"{what}: subtree prefix past its key")
            self._walk(child, height - 1, prefix + key[:common])

    def list(self, prefix: bytes = b"") -> List[bytes]:
        """The keys that start with `prefix`, sorted."""
        prefix = prefix.encode() if isinstance(prefix, str) else prefix
        return [k for k in self._keys if k.startswith(prefix)]

    def read(self, key) -> Optional[bytes]:
        """A value's bytes; None when the key is absent."""
        key = key.encode() if isinstance(key, str) else key
        ref = self._values.get(key)
        if ref is None:
            return None
        if len(ref) == 1:
            return ref[0]
        return self._slice(ref)
