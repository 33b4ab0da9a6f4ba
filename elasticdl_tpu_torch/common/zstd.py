"""A zstd decoder (RFC 8878), decode only, with no zstd package.

The JAX package's orbax checkpoints reach the port as zstd frames: the
OCDBT nodes and manifests behind a 14-byte header, and every zarr chunk
(common/ocdbt.py, common/zarr_array.py).  `decompress(data)` decodes one
or more concatenated frames (skippable frames are passed over) into the
bytes they hold.

Two decoders give the same bytes:

- the C++ decoder, `hostsrc/zstd_decode.cc`, built with g++ at first use
  (`ops/_build.py::build_host`, cached in the kernel cache directory)
  and called through ctypes, as data/native_io.py calls the TFRecord
  scanner.  It serves every frame when it builds;
- `decompress_py`, this module's plain version in Python and numpy.  It
  serves only where the library cannot be built or loaded; the tests
  hold the C++ decoder against it and both against the `zstandard`
  package.

`served()` counts which decoder served each frame, so a caller (the
chip script) can assert that the C++ one did.

Covered: raw, RLE and compressed blocks; raw, RLE, Huffman and treeless
literals with one or four streams; sequences in predefined, RLE,
FSE-compressed and repeat modes; repeat offsets; the window; frames with
and without a content size; the xxhash64 content checksum (verified);
concatenated and skippable frames.  A frame that names a dictionary
raises, as does any corrupt or truncated input (`ZstdError`).
"""

from __future__ import annotations

import ctypes
import struct
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common import metrics
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

SOURCE = "zstd_decode.cc"
MAGIC = 0xFD2FB528
_SKIPPABLE_MASK = 0xFFFFFFF0
_SKIPPABLE_MAGIC = 0x184D2A50
_MAX_BLOCK = 1 << 17


class ZstdError(ValueError):
    """Corrupt, truncated or unsupported zstd input."""


# ---- which decoder served ------------------------------------------------

_served = metrics.default_registry().counter(
    "data_zstd_frames_total",
    "zstd frames decoded, by the decoder that served them (native or "
    "python)",
    labelnames=("path",),
)


def served() -> Dict[str, int]:
    """{"native": frames, "python": frames} since `reset_served()`."""
    out = {"native": 0, "python": 0}
    for (path,), value in _served.child_values().items():
        out[path] = int(value)
    return out


def reset_served() -> None:
    _served.reset()


# ---- bit readers ---------------------------------------------------------


class _Backward:
    """A zstd backward bitstream: read from its last bit toward its
    first, the highest set bit of the last byte being the end mark.
    Reads past the start give zero bits and drive `pos` negative."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("bitstream without its end mark")
        self.data = data
        self.pos = len(data) * 8 - 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        pos = self.pos - n
        self.pos = pos
        if pos >= 0:
            lo = pos >> 3
            hi = (pos + n - 1) >> 3
            word = int.from_bytes(self.data[lo:hi + 1], "little")
            return (word >> (pos & 7)) & ((1 << n) - 1)
        top = pos + n
        if top <= 0:
            return 0
        word = int.from_bytes(self.data[:(top + 7) >> 3], "little")
        return (word & ((1 << top) - 1)) << (-pos)


def _highbit(x: int) -> int:
    return x.bit_length() - 1


# ---- FSE -----------------------------------------------------------------


class _Fse:
    """An FSE decoding table: per state its symbol, bit count and base."""

    __slots__ = ("log", "symbol", "nbits", "base")

    def __init__(self, log, symbol, nbits, base):
        self.log, self.symbol, self.nbits, self.base = log, symbol, nbits, \
            base

    @classmethod
    def rle(cls, symbol: int) -> "_Fse":
        return cls(0, [symbol], [0], [0])

    @classmethod
    def build(cls, freqs: List[int], log: int) -> "_Fse":
        size = 1 << log
        symbol = [0] * size
        high = size
        state = [0] * len(freqs)
        for s, f in enumerate(freqs):
            if f == -1:
                high -= 1
                symbol[high] = s
                state[s] = 1
        step = (size >> 1) + (size >> 3) + 3
        mask = size - 1
        pos = 0
        for s, f in enumerate(freqs):
            if f <= 0:
                continue
            state[s] = f
            for _ in range(f):
                symbol[pos] = s
                pos = (pos + step) & mask
                while pos >= high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise ZstdError("FSE table does not fill its states")
        nbits = [0] * size
        base = [0] * size
        for i in range(size):
            s = symbol[i]
            nxt = state[s]
            state[s] += 1
            nbits[i] = log - _highbit(nxt)
            base[i] = (nxt << nbits[i]) - size
        return cls(log, symbol, nbits, base)


def _read_fse_table(data: bytes, pos: int, max_log: int,
                    max_symbol: int) -> Tuple[_Fse, int]:
    """Parse an FSE table description at `data[pos:]`: (table, the
    position after it)."""
    bit = pos * 8
    end = len(data) * 8

    def read(n):
        nonlocal bit
        if bit + n > end:
            raise ZstdError("truncated FSE table description")
        lo = bit >> 3
        word = int.from_bytes(data[lo:lo + 4], "little")
        value = (word >> (bit & 7)) & ((1 << n) - 1)
        bit += n
        return value

    log = read(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} over {max_log}")
    remaining = 1 << log
    freqs: List[int] = []
    while remaining > 0 and len(freqs) <= max_symbol:
        nb = _highbit(remaining + 1) + 1
        value = read(nb)
        lower = (1 << (nb - 1)) - 1
        threshold = (1 << nb) - 1 - (remaining + 1)
        if (value & lower) < threshold:
            bit -= 1
            value &= lower
        elif value > lower:
            value -= threshold
        prob = value - 1
        remaining -= -prob if prob < 0 else prob
        freqs.append(prob)
        if prob == 0:
            while True:
                repeat = read(2)
                freqs.extend([0] * repeat)
                if repeat != 3:
                    break
    if remaining != 0 or len(freqs) > max_symbol + 1:
        raise ZstdError("corrupt FSE table description")
    return _Fse.build(freqs, log), (bit + 7) >> 3


# ---- Huffman literals ----------------------------------------------------


class _Huffman:
    __slots__ = ("log", "symbol", "nbits")

    def __init__(self, weights: List[int]):
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
        total = sum(1 << (w - 1) for w in weights if w)
        if total == 0:
            raise ZstdError("Huffman weights all zero")
        log = _highbit(total) + 1
        if log > 11:
            raise ZstdError("Huffman table over 11 bits")
        rest = (1 << log) - total
        if rest & (rest - 1):
            raise ZstdError("Huffman weights do not sum to a power of 2")
        weights = weights + [_highbit(rest) + 1]
        size = 1 << log
        symbol = [0] * size
        nbits = [0] * size
        pos = 0
        for w in range(1, log + 1):
            span = 1 << (w - 1)
            nb = log + 1 - w
            for s, sw in enumerate(weights):
                if sw == w:
                    symbol[pos:pos + span] = [s] * span
                    nbits[pos:pos + span] = [nb] * span
                    pos += span
        if pos != size:
            raise ZstdError("corrupt Huffman weights")
        self.log, self.symbol, self.nbits = log, symbol, nbits

    def decode(self, stream: bytes, count: int) -> bytes:
        bits = _Backward(stream)
        log, symbol, nbits = self.log, self.symbol, self.nbits
        data = bits.data
        pos = bits.pos
        mask = (1 << log) - 1
        out = bytearray(count)
        for i in range(count):
            low = pos - log
            if low >= 0:
                lo = low >> 3
                word = int.from_bytes(data[lo:lo + 3], "little")
                idx = (word >> (low & 7)) & mask
            else:
                word = int.from_bytes(data[:3], "little")
                idx = (word << -low) & mask
            out[i] = symbol[idx]
            pos -= nbits[idx]
        if pos != 0:
            raise ZstdError("Huffman stream not consumed exactly")
        return bytes(out)


def _read_huffman(data: bytes, pos: int) -> Tuple[_Huffman, int]:
    header = data[pos]
    pos += 1
    if header >= 128:
        n = header - 127
        raw = data[pos:pos + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            raise ZstdError("truncated Huffman weights")
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return _Huffman(weights[:n]), pos + (n + 1) // 2
    end = pos + header
    if end > len(data):
        raise ZstdError("truncated Huffman weights")
    table, start = _read_fse_table(data[:end], pos, 6, 255)
    bits = _Backward(data[start:end])
    s1 = bits.read(table.log)
    s2 = bits.read(table.log)
    weights: List[int] = []
    while True:
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
        weights.append(table.symbol[s1])
        s1 = table.base[s1] + bits.read(table.nbits[s1])
        if bits.pos < 0:
            weights.append(table.symbol[s2])
            break
        weights.append(table.symbol[s2])
        s2 = table.base[s2] + bits.read(table.nbits[s2])
        if bits.pos < 0:
            weights.append(table.symbol[s1])
            break
    return _Huffman(weights), end


# ---- sequences -----------------------------------------------------------

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                                 99, 131, 259, 515, 1027, 2051, 4099,
                                 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                       12, 13, 14, 15, 16]
_LL_DEFAULT = _Fse.build(
    [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2,
     2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = _Fse.build(
    [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     -1, -1, -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = _Fse.build(
    [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, -1, -1, -1, -1, -1], 5)
# (predefined table, largest accuracy log, largest symbol) of LL, OF, ML
_KINDS = ((_LL_DEFAULT, 9, 35), (_OF_DEFAULT, 8, 31), (_ML_DEFAULT, 9, 52))


class _FrameState:
    """What a frame's blocks hand to the next: the last Huffman table,
    the last LL/OF/ML tables and the repeat offsets."""

    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.tables: List[Optional[_Fse]] = [None, None, None]
        self.reps = [1, 4, 8]


def _literals(block: bytes, st: _FrameState) -> Tuple[bytes, int]:
    if not block:
        raise ZstdError("empty compressed block")
    b0 = block[0]
    kind = b0 & 3
    fmt = (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (block[1] << 4), 2
        else:
            size, head = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if head > len(block):
            raise ZstdError("truncated literals header")
        if kind == 0:
            if head + size > len(block):
                raise ZstdError("truncated raw literals")
            return block[head:head + size], head + size
        if head >= len(block):
            raise ZstdError("truncated RLE literals")
        return bytes([block[head]]) * size, head + 1
    head, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    if head > len(block):
        raise ZstdError("truncated literals header")
    value = int.from_bytes(block[:head], "little")
    regen = (value >> 4) & ((1 << bits) - 1)
    comp = value >> (4 + bits)
    if head + comp > len(block) or regen > _MAX_BLOCK:
        raise ZstdError("literals overrun their block")
    body = block[head:head + comp]
    start = 0
    if kind == 2:
        st.huffman, start = _read_huffman(body, 0)
    elif st.huffman is None:
        raise ZstdError("treeless literals before any Huffman table")
    table = st.huffman
    if fmt == 0:
        out = table.decode(body[start:], regen)
    else:
        if start + 6 > len(body):
            raise ZstdError("truncated jump table")
        s1, s2, s3 = struct.unpack_from("<HHH", body, start)
        p = start + 6
        bounds = [p, p + s1, p + s1 + s2, p + s1 + s2 + s3, len(body)]
        if bounds[3] > len(body):
            raise ZstdError("jump table overruns the literals")
        quarter = (regen + 3) // 4
        counts = [quarter, quarter, quarter, regen - 3 * quarter]
        if counts[3] < 0:
            raise ZstdError("too few literals for four streams")
        out = b"".join(table.decode(body[bounds[i]:bounds[i + 1]],
                                    counts[i]) for i in range(4))
    return out, head + comp


def _sequences(block: bytes, pos: int, st: _FrameState):
    """[(literal length, offset value, match length)] of a block."""
    if pos >= len(block):
        raise ZstdError("truncated sequences header")
    b0 = block[pos]
    if b0 == 0:
        if pos + 1 != len(block):
            raise ZstdError("bytes after an empty sequences section")
        return []
    if b0 < 128:
        count, pos = b0, pos + 1
    elif b0 < 255:
        count, pos = ((b0 - 128) << 8) + block[pos + 1], pos + 2
    else:
        count, pos = block[pos + 1] + (block[pos + 2] << 8) + 0x7F00, \
            pos + 3
    if pos >= len(block):
        raise ZstdError("truncated sequences header")
    modes = block[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    for i, shift in enumerate((6, 4, 2)):
        mode = (modes >> shift) & 3
        default, max_log, max_symbol = _KINDS[i]
        if mode == 0:
            st.tables[i] = default
        elif mode == 1:
            if pos >= len(block) or block[pos] > max_symbol:
                raise ZstdError("bad RLE sequence symbol")
            st.tables[i] = _Fse.rle(block[pos])
            pos += 1
        elif mode == 2:
            st.tables[i], pos = _read_fse_table(block, pos, max_log,
                                                max_symbol)
        elif st.tables[i] is None:
            raise ZstdError("repeat mode before any table")
    ll_t, of_t, ml_t = st.tables
    bits = _Backward(block[pos:])
    read = bits.read
    ll_s = read(ll_t.log)
    of_s = read(of_t.log)
    ml_s = read(ml_t.log)
    out = []
    for n in range(count):
        of_code = of_t.symbol[of_s]
        ml_code = ml_t.symbol[ml_s]
        ll_code = ll_t.symbol[ll_s]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            raise ZstdError("sequence code out of range")
        offset = (1 << of_code) + read(of_code)
        match = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        lit = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        out.append((lit, offset, match))
        if n + 1 < count:
            ll_s = ll_t.base[ll_s] + read(ll_t.nbits[ll_s])
            ml_s = ml_t.base[ml_s] + read(ml_t.nbits[ml_s])
            of_s = of_t.base[of_s] + read(of_t.nbits[of_s])
        if bits.pos < 0:
            raise ZstdError("sequences overrun their bitstream")
    if bits.pos != 0:
        raise ZstdError("sequences bitstream not consumed exactly")
    return out


def _execute(out: bytearray, literals: bytes, seqs, st: _FrameState,
             frame_start: int, window: int) -> None:
    reps = st.reps
    lp = 0
    for lit, ofv, match in seqs:
        if lp + lit > len(literals):
            raise ZstdError("sequence takes more literals than exist")
        out += literals[lp:lp + lit]
        lp += lit
        if ofv > 3:
            offset = ofv - 3
            reps[2], reps[1], reps[0] = reps[1], reps[0], offset
        else:
            idx = ofv - 1 if lit else ofv
            if idx == 0:
                offset = reps[0]
            elif idx == 3:
                offset = reps[0] - 1
                if offset == 0:
                    raise ZstdError("repeat offset of zero")
                reps[2], reps[1], reps[0] = reps[1], reps[0], offset
            elif idx == 1:
                offset = reps[1]
                reps[1], reps[0] = reps[0], offset
            else:
                offset = reps[2]
                reps[2], reps[1], reps[0] = reps[1], reps[0], offset
        produced = len(out) - frame_start
        if offset > produced or offset > window:
            raise ZstdError("match offset beyond the window")
        start = len(out) - offset
        if offset >= match:
            out += out[start:start + match]
        else:
            chunk = out[start:]
            reps_needed = -(-match // offset)
            out += (chunk * reps_needed)[:match]
    if lp < len(literals):
        out += literals[lp:]


# ---- xxhash64 (the content checksum) -------------------------------------

_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def _merge(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return (acc * _P1 + _P4) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed
        v4 = (seed - _P1) & _M64
        lanes = np.frombuffer(data, "<u8", count=(n // 32) * 4).tolist()
        for i in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        p = (n // 32) * 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = _merge(h, v)
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        k = _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = ((_rotl(h ^ k, 27) * _P1) + _P4) & _M64
        p += 8
    if p + 4 <= n:
        k = int.from_bytes(data[p:p + 4], "little") * _P1
        h = ((_rotl(h ^ (k & _M64), 23) * _P2) + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ ((data[p] * _P5) & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ---- frames --------------------------------------------------------------


def _frame_header(data: bytes, pos: int):
    """(content size or None, window size, checksum flag, position of
    the first block) of the frame at `data[pos:]` (after its magic)."""
    if pos >= len(data):
        raise ZstdError("truncated frame header")
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, \
        (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    window = None
    if not single:
        if pos >= len(data):
            raise ZstdError("truncated frame header")
        wd = data[pos]
        pos += 1
        log = 10 + (wd >> 3)
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
    dict_size = (0, 1, 2, 4)[dict_flag]
    if dict_size:
        dict_id = int.from_bytes(data[pos:pos + dict_size], "little")
        if dict_id:
            raise ZstdError(f"frame names dictionary {dict_id}; "
                            "dictionaries are not supported")
        pos += dict_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    size = None
    if fcs_size:
        if pos + fcs_size > len(data):
            raise ZstdError("truncated frame content size")
        size = int.from_bytes(data[pos:pos + fcs_size], "little")
        if fcs_size == 2:
            size += 256
        pos += fcs_size
    if window is None:
        window = size
    return size, window, checksum, pos


def _decode_frame(data: bytes, pos: int, out: bytearray) -> int:
    size, window, checksum, pos = _frame_header(data, pos)
    start = len(out)
    st = _FrameState()
    max_block = min(_MAX_BLOCK, window) if window else _MAX_BLOCK
    while True:
        if pos + 3 > len(data):
            raise ZstdError("truncated block header")
        head = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, bsize = head & 1, (head >> 1) & 3, head >> 3
        if kind == 1:
            if pos >= len(data):
                raise ZstdError("truncated RLE block")
            if bsize > max_block:
                raise ZstdError("block over the largest size")
            out += bytes([data[pos]]) * bsize
            pos += 1
        elif kind == 3:
            raise ZstdError("reserved block type")
        else:
            if pos + bsize > len(data):
                raise ZstdError("truncated block")
            if bsize > max_block:
                raise ZstdError("block over the largest size")
            block = data[pos:pos + bsize]
            pos += bsize
            if kind == 0:
                out += block
            else:
                before = len(out)
                literals, lpos = _literals(block, st)
                seqs = _sequences(block, lpos, st)
                _execute(out, literals, seqs, st, start,
                         window if window else 1 << 62)
                if len(out) - before > _MAX_BLOCK:
                    raise ZstdError("block decodes past the largest size")
        if last:
            break
    if size is not None and len(out) - start != size:
        raise ZstdError(f"frame holds {len(out) - start} bytes, its header "
                        f"says {size}")
    if checksum:
        if pos + 4 > len(data):
            raise ZstdError("truncated content checksum")
        want = int.from_bytes(data[pos:pos + 4], "little")
        got = xxh64(bytes(out[start:])) & 0xFFFFFFFF
        if want != got:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return pos


def decompress_py(data) -> bytes:
    """Every frame of `data` decoded in Python (the plain version)."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    frames = 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        if magic & _SKIPPABLE_MASK == _SKIPPABLE_MAGIC:
            if pos + 4 > len(data):
                raise ZstdError("truncated skippable frame")
            pos += 4 + int.from_bytes(data[pos:pos + 4], "little")
            if pos > len(data):
                raise ZstdError("truncated skippable frame")
            continue
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        pos = _decode_frame(data, pos, out)
        frames += 1
    if frames == 0:
        raise ZstdError("no zstd frame in the input")
    _served.labels(path="python").inc(frames)
    return bytes(out)


# ---- the C++ decoder -----------------------------------------------------

_ERRORS = {-1: "corrupt or truncated input", -2: "output buffer too small",
           -3: "frame names a dictionary", -4: "content checksum mismatch",
           -5: "not a zstd frame", -6: "out of memory"}

_lock = threading.Lock()
_lib = None
_build_attempted = False
# why the C++ decoder is not in use, once its build or load failed
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
            logger.warning("C++ zstd decoder unavailable (%s); frames "
                           "decode in Python", exc)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.zstd_content_bound.restype = ctypes.c_int64
        lib.zstd_content_bound.argtypes = [u8p, ctypes.c_int64,
                                           ctypes.POINTER(ctypes.c_int64)]
        lib.zstd_decompress.restype = ctypes.c_int64
        lib.zstd_decompress.argtypes = [u8p, ctypes.c_int64, u8p,
                                        ctypes.c_int64,
                                        ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def decompress_native(data) -> bytes:
    """Every frame of `data` decoded by the C++ decoder (raises when the
    library is unavailable)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"C++ zstd decoder unavailable: "
                           f"{unavailable_reason}")
    src = np.frombuffer(bytes(data), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    src_ptr = src.ctypes.data_as(u8p)
    frames = ctypes.c_int64(0)
    bound = lib.zstd_content_bound(src_ptr, len(src), ctypes.byref(frames))
    if bound < 0:
        raise ZstdError(f"zstd: {_ERRORS.get(bound, bound)}")
    dst = np.empty(max(int(bound), 1), np.uint8)
    n = lib.zstd_decompress(src_ptr, len(src), dst.ctypes.data_as(u8p),
                            int(bound), ctypes.byref(frames))
    if n < 0:
        raise ZstdError(f"zstd: {_ERRORS.get(n, n)}")
    _served.labels(path="native").inc(int(frames.value))
    return dst[:n].tobytes()


def decompress(data) -> bytes:
    """Every frame of `data` decoded: by the C++ decoder when it is
    available, else in Python.  Both give the same bytes."""
    if _load() is not None:
        return decompress_native(data)
    return decompress_py(data)
