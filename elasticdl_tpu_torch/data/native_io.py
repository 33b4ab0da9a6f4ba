"""ctypes bindings of the native TFRecord scanner (the port's copy of the
JAX package's data/native_io.py over its own copy of the C++ source,
`hostsrc/recordio.cc`).

The library is built with g++ at first use, once per process
(`ops/_build.py::build_host`, cached by the source's hash in the kernel
cache directory: `build/elasticdl_tpu_torch/` unless
`--compilation_cache_dir` moves it); nothing is built at import.  When
it cannot be built or loaded, `available()` is False and
data/record_io.py builds indexes and writes in Python, as the JAX
package does: this is host code, not a device kernel, and both paths
give the same bytes.
record_io counts which path served each call (`record_io.served()`), so
a caller can see it.  record_io's readers do not call `read_records` /
`read_records_np`: its Python `read_bulk` was faster on the H100 host
(PERF.md); they remain the CRC-checking scan of the C++ source,
and chip_smoke.py times them against the Python reads every run.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

SOURCE = "recordio.cc"

# the C functions' negative return codes
_ERRORS = {-1: "cannot open the file",
           -2: "truncated record or corrupt length",
           -3: "header CRC mismatch",
           -4: "out of memory",
           -5: "payload CRC mismatch"}

_lock = threading.Lock()
_lib = None
_build_attempted = False
# why the library is not in use, once a build or load failed
unavailable_reason: Optional[str] = None


def _load():
    global _lib, _build_attempted, unavailable_reason
    if _lib is not None or _build_attempted:
        return _lib
    with _lock:
        if _lib is not None or _build_attempted:
            return _lib
        _build_attempted = True
        from elasticdl_tpu_torch.ops import _build

        try:
            lib = ctypes.CDLL(str(_build.build_host(SOURCE)))
        except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
            unavailable_reason = str(exc)
            logger.warning("native TFRecord scanner unavailable (%s); "
                           "record IO runs in Python", exc)
            return None
        lib.recordio_build_index.restype = ctypes.c_int64
        lib.recordio_build_index.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ]
        lib.recordio_read_records.restype = ctypes.c_int64
        lib.recordio_read_records.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ]
        lib.recordio_write_records.restype = ctypes.c_int64
        lib.recordio_write_records.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int,
        ]
        lib.recordio_free.restype = None
        lib.recordio_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native TFRecord scanner unavailable: "
                           f"{unavailable_reason}")
    return lib


def write_records(path: str, buffer: np.ndarray, sizes: np.ndarray,
                  append: bool = False) -> int:
    """Write n records (contiguous uint8 payloads + int64 sizes) with
    TFRecord framing, CRCs computed in C.  Returns bytes written."""
    lib = _library()
    buffer = np.ascontiguousarray(buffer, np.uint8)
    sizes = np.ascontiguousarray(sizes, np.int64)
    rc = lib.recordio_write_records(
        path.encode(),
        buffer.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(sizes), int(append))
    if rc < 0:
        raise IOError(f"native record write failed for {path}: "
                      f"{_ERRORS.get(rc, rc)}")
    return rc


def build_index(path: str) -> np.ndarray:
    """The byte offset of every record, as int64."""
    lib = _library()
    out = ctypes.POINTER(ctypes.c_int64)()
    n = lib.recordio_build_index(path.encode(), ctypes.byref(out))
    if n < 0:
        raise IOError(f"native index build failed for {path}: "
                      f"{_ERRORS.get(n, n)}")
    try:
        if n == 0:
            return np.empty(0, np.int64)
        return np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.recordio_free(out)


def read_records_np(path: str, offsets, start: int, end: int,
                    check_crc: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Records [start, end) as one (uint8 payload buffer, int64 sizes)
    pair, with no per-record split: what `feed_bulk` consumes."""
    lib = _library()
    end = min(end, len(offsets))
    if start >= end:
        return np.empty(0, np.uint8), np.empty(0, np.int64)
    # offsets ride as an int64 pointer: a ctypes array built from a list
    # converts every element
    arr = np.ascontiguousarray(offsets, np.int64)
    data = ctypes.POINTER(ctypes.c_uint8)()
    sizes = ctypes.POINTER(ctypes.c_int64)()
    total = lib.recordio_read_records(
        path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        start, end, int(check_crc), ctypes.byref(data), ctypes.byref(sizes))
    if total < 0:
        raise IOError(f"native record read failed for {path} in records "
                      f"[{start}, {end}): {_ERRORS.get(total, total)}")
    try:
        buf = np.ctypeslib.as_array(data, shape=(total,)).copy() \
            if total else np.empty(0, np.uint8)
        size_arr = np.ctypeslib.as_array(sizes, shape=(end - start,)).copy()
        return buf, size_arr
    finally:
        lib.recordio_free(data)
        lib.recordio_free(sizes)


def read_records(path: str, offsets, start: int, end: int,
                 check_crc: bool = False) -> List[bytes]:
    buf, sizes = read_records_np(path, offsets, start, end, check_crc)
    blob = buf.tobytes()
    result = []
    pos = 0
    for size in sizes:
        result.append(blob[pos:pos + size])
        pos += size
    return result
