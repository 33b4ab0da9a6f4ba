"""Compact host->device wire formats for input batches (the port's copy of
the JAX package's data/wire.py).

Host-side packers (numpy, run on the feed's producer thread) pair with
device-side unpackers (torch, run inside the step on the planes as they
arrived):

- f32 -> bf16 dense features (`pack_f32_to_bf16`: the bf16 bit patterns,
  rounded to nearest even, as a `BF16Bits` uint16 array that the trainer
  moves and views as torch.bfloat16 without a conversion pass);
- int32 ids < 2^24 -> packed uint8 triples ("uint24");
- int32 ids < 2^22 -> "b22": uint16 low halves + a bit-packed high-6
  stream (2.75 bytes/id; DeepFM's compact feed, 99 bytes/example);
- per-field dedup'd pre-hashed table rows (`pack_rows_dedup`,
  `DedupPacker`; DeepFM's dedup feed);
- int labels -> uint8.

The planes cross the link at their wire width: `plane_tensor` moves a
uint16 plane as an int16 view and a uint32 plane as an int32 view, and
the unpackers widen on the device (a 16-bit plane is masked with 0xFFFF
after its int32 cast).  Nothing here imports ml_dtypes: `pack_f32_to_bf16`
rounds in integer arithmetic, bit for bit what ml_dtypes' cast gives.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from elasticdl_tpu_torch.common import metrics as _metrics

UINT24_MAX = (1 << 24) - 1
B22_MAX = (1 << 22) - 1
_MASK16 = 0xFFFF


class BF16Bits(np.ndarray):
    """uint16 bf16 bit patterns; `plane_tensor` views them as
    torch.bfloat16.  numpy has no bf16 dtype without ml_dtypes, so the
    class is the mark that these uint16 values are floats."""


def pack_f32_to_bf16(arr: np.ndarray) -> BF16Bits:
    """Host-side: f32 array -> bf16 bit patterns, same shape, rounded to
    nearest even; a NaN becomes the quiet NaN of its sign (0x7FC0 or
    0xFFC0), as ml_dtypes' cast does."""
    bits = np.ascontiguousarray(arr, np.float32).view(np.uint32)
    lsb = (bits >> 16) & np.uint32(1)
    with np.errstate(over="ignore"):
        rounded = (bits + np.uint32(0x7FFF) + lsb) >> 16
    nan = (bits & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    out = np.where(nan, (bits >> 16) & np.uint32(0x8000) | np.uint32(0x7FC0),
                   rounded)
    return out.astype(np.uint16).view(BF16Bits)


def plane_tensor(arr, device: torch.device) -> torch.Tensor:
    """One wire plane on `device` at its wire width: bf16 bits as
    torch.bfloat16, uint16 as an int16 view, uint32 as an int32 view,
    everything else as it is.  The unpackers widen on the device."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    bf16 = isinstance(arr, BF16Bits)
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    elif arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    if not arr.flags.writeable:
        arr = arr.copy()
    tensor = torch.from_numpy(arr)
    if bf16:
        tensor = tensor.view(torch.bfloat16)
    return tensor.to(device)


def _widen(plane: torch.Tensor) -> torch.Tensor:
    """An integer plane as int32 values: a 16-bit plane (the int16 view of
    uint16 on the wire) is masked back to [0, 65535]."""
    wide = plane.to(torch.int32)
    if plane.element_size() == 2:
        wide = wide & _MASK16
    return wide


def pack_int_to_uint24(ids: np.ndarray) -> np.ndarray:
    """Host-side: (..., F) non-negative ids < 2^24 -> (..., F, 3) uint8
    little-endian triples."""
    ids = np.asarray(ids)
    if ids.size and (ids.min() < 0 or ids.max() > UINT24_MAX):
        raise ValueError(
            f"uint24 packing needs ids in [0, {UINT24_MAX}]; got "
            f"[{ids.min()}, {ids.max()}]"
        )
    le = np.ascontiguousarray(ids.astype("<u4"))
    return le.view(np.uint8).reshape(*ids.shape, 4)[..., :3].copy()


def unpack_uint24(packed: torch.Tensor) -> torch.Tensor:
    """Device-side: (..., F, 3) uint8 -> (..., F) int32."""
    p = packed.to(torch.int32)
    return p[..., 0] | (p[..., 1] << 8) | (p[..., 2] << 16)


def pack_int_to_b22(ids: np.ndarray) -> dict:
    """Host-side: (B, F) non-negative ids < 2^22 -> {"lo16": (B, F)
    uint16, "hi6": (B, ceil(6F/8)) uint8}.  The high 6 bits of each id
    are bit-packed contiguously (little-endian within the hi6 stream)."""
    ids = np.asarray(ids)
    if ids.ndim != 2:
        raise ValueError(f"b22 packing needs (B, F) ids; got {ids.shape}")
    if ids.size and (ids.min() < 0 or ids.max() > B22_MAX):
        raise ValueError(
            f"b22 packing needs ids in [0, {B22_MAX}]; got "
            f"[{ids.min()}, {ids.max()}]"
        )
    b, f = ids.shape
    lo16 = (ids & 0xFFFF).astype(np.uint16)
    hi6 = (ids >> 16).astype(np.uint32)               # 6 significant bits
    nbytes = (6 * f + 7) // 8
    # |= of disjoint bit fields never carries, so the packed buffer can
    # be uint8 directly
    packed = np.zeros((b, nbytes), np.uint8)
    for k in range(f):
        bit = 6 * k
        byte, shift = bit >> 3, bit & 7
        word = (hi6[:, k] << shift).astype(np.uint32)
        packed[:, byte] |= (word & 0xFF).astype(np.uint8)
        if byte + 1 < nbytes:
            packed[:, byte + 1] |= ((word >> 8) & 0xFF).astype(np.uint8)
    return {"lo16": lo16, "hi6": packed}


def unpack_b22(packed: dict) -> torch.Tensor:
    """Device-side: invert pack_int_to_b22 -> (B, F) int32.  The index
    and shift tables are built on the planes' device."""
    lo16 = _widen(packed["lo16"])                      # (B, F)
    hi6 = packed["hi6"].to(torch.int32)                # (B, nbytes)
    f, nbytes = lo16.shape[-1], hi6.shape[-1]
    bits = torch.arange(f, device=hi6.device, dtype=torch.int64) * 6
    byte_idx = bits >> 3
    shifts = (bits & 7).to(torch.int32)
    lo_b = hi6[..., byte_idx]
    has_next = byte_idx + 1 < nbytes
    nxt = torch.clamp(byte_idx + 1, max=nbytes - 1)
    hi_b = torch.where(has_next, hi6[..., nxt], torch.zeros_like(lo_b))
    hi = ((lo_b | (hi_b << 8)) >> shifts) & 0x3F      # (B, F)
    return lo16 | (hi << 16)


def is_packed_b22(obj) -> bool:
    """The b22 compact-id convention: a dict with lo16/hi6 arrays."""
    return isinstance(obj, dict) and set(obj) == {"lo16", "hi6"}


def is_packed_uint24(arr) -> bool:
    """The compact-id convention: a trailing length-3 uint8 axis."""
    dtype = getattr(arr, "dtype", None)
    return (
        dtype is not None
        and dtype in (np.uint8, torch.uint8)
        and arr.ndim >= 2
        and arr.shape[-1] == 3
    )


# ---------------------------------------------------------------------------
# Dedup'd id plane: frequency-ranked uniques + a uint8 inverse (PFOR-style)
# ---------------------------------------------------------------------------
#
#   unique   (U_pad,)  uint32  per-field frequency-ranked unique rows,
#                              concatenated in field order
#   starts   (F,)      int32   field f's offset into `unique`
#   inverse8 (B, F)    uint8   per-field frequency rank; DEDUP_ESCAPE
#                              (255) marks a cold id
#   exc_val  (E_pad,)  uint16/uint32  true ranks of the escaped
#                              positions, in row-major scan order of
#                              (B, F) (uint16 iff B <= 65536)
#
# Escape positions are never shipped: `inverse8 == 255` marks them, and
# the device recovers each escape's index into `exc_val` with an
# exclusive prefix count over the escape mask.  The values in `unique`
# are pre-hashed table rows, so the embeddings consume them directly
# (prehashed=True).  `DedupPacker` pads the variable planes to sticky
# caps, so consecutive batches keep one shape.

DEDUP_ESCAPE = 255
DEDUP_KEYS = frozenset({"unique", "starts", "inverse8", "exc_val"})


def is_packed_dedup(obj) -> bool:
    """The dedup'd compact-id convention (see above)."""
    return isinstance(obj, dict) and set(obj) == DEDUP_KEYS


def is_wire_planes(obj) -> bool:
    """A dict of wire planes (b22 or dedup), which the trainer moves
    plane by plane at wire width."""
    return is_packed_b22(obj) or is_packed_dedup(obj)


def frequency_rank(values: np.ndarray):
    """(uniques in descending-frequency order, matching counts) for a 1-D
    id/row column.  Dense ranges rank by bincount in O(B + range); only
    sparse ranges fall back to np.unique.  Ties break toward the smaller
    value."""
    values = np.asarray(values).reshape(-1)
    if values.size == 0:
        return (
            np.empty(0, values.dtype if values.dtype != bool else np.int64),
            np.empty(0, np.int64),
        )
    if values.min() < 0:
        raise ValueError("frequency_rank needs non-negative ids/rows")
    hi = int(values.max()) + 1
    if hi <= max(4 * values.size, 1 << 20):
        counts = np.bincount(values, minlength=hi)
        uniq = np.nonzero(counts)[0]
        counts = counts[uniq]
    else:
        uniq, counts = np.unique(values, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    return uniq[order], counts[order].astype(np.int64)


def field_disjoint_ids(sparse: np.ndarray) -> np.ndarray:
    """(B, F) per-field ids -> int64 values distinct across fields
    (`id * F + field`)."""
    sparse = np.asarray(sparse, np.int64)
    if sparse.ndim != 2:
        raise ValueError(f"expected (B, F) ids; got {sparse.shape}")
    f = sparse.shape[1]
    if sparse.size and int(sparse.max()) > (
        (np.iinfo(np.int64).max - f) // max(f, 1)
    ):
        raise ValueError(
            "ids too large to field-encode without int64 overflow"
        )
    return sparse * f + np.arange(f, dtype=np.int64)[None, :]


def pack_rows_dedup(
    rows: np.ndarray, unique_pad: int = 0, exc_pad: int = 0,
    return_ranking: bool = False,
):
    """Host-side: (B, F) pre-hashed non-negative table rows -> dedup'd
    struct.  `unique_pad`/`exc_pad` pad the variable-length planes up to
    fixed sizes (0 = exact).  With `return_ranking`, also the batch-global
    `(uniq, counts)`, identical to `frequency_rank(rows.reshape(-1))`."""
    rows = np.asarray(rows)
    if rows.ndim != 2:
        raise ValueError(f"dedup packing needs (B, F) rows; got {rows.shape}")
    if rows.size and rows.min() < 0:
        raise ValueError("dedup packing needs non-negative (hashed) rows")
    b, f = rows.shape
    val_dtype = np.uint16 if b <= (1 << 16) else np.uint32
    uniques, starts = [], np.zeros(f, np.int32)
    all_ranks = np.empty((b, f), np.int32)
    total = 0
    # hashed rows span the table capacity: bincount + a rank LUT rank a
    # column in O(B + capacity) with no sort
    hi = int(rows.max()) + 1 if rows.size else 1
    use_bincount = hi <= max(4 * rows.size, 1 << 20)
    lut = np.empty(hi, np.int32) if use_bincount else None
    field_uniqs, field_counts = [], []
    for k in range(f):
        col = rows[:, k]
        if use_bincount:
            counts = np.bincount(col, minlength=hi)
            uniq = np.nonzero(counts)[0]
            counts = counts[uniq]
            order = np.argsort(-counts, kind="stable")
            uniq_ranked = uniq[order]
            lut[uniq_ranked] = np.arange(len(uniq), dtype=np.int32)
            all_ranks[:, k] = lut[col]
        else:
            uniq, inv, counts = np.unique(
                col, return_inverse=True, return_counts=True
            )
            order = np.argsort(-counts, kind="stable")
            rank_of = np.empty(len(uniq), np.int32)
            rank_of[order] = np.arange(len(uniq), dtype=np.int32)
            all_ranks[:, k] = rank_of[inv]
            uniq_ranked = uniq[order]
        if return_ranking:
            field_uniqs.append(np.asarray(uniq_ranked, np.int64))
            field_counts.append(np.asarray(counts[order], np.int64))
        uniques.append(uniq_ranked.astype(np.uint32))
        starts[k] = total
        total += len(uniq_ranked)
    cold = all_ranks >= DEDUP_ESCAPE               # (B, F)
    inverse8 = np.where(cold, DEDUP_ESCAPE, all_ranks).astype(np.uint8)
    packed = {
        "unique": np.concatenate(uniques),
        "starts": starts,
        "inverse8": inverse8,
        # boolean indexing scans row-major: the order the device's prefix
        # count over (inverse8 == ESCAPE) recovers
        "exc_val": all_ranks[cold].astype(val_dtype),
    }
    if unique_pad or exc_pad:
        packed = pad_dedup(packed, unique_pad, exc_pad)
    if not return_ranking:
        return packed
    # merge the per-field rankings with frequency_rank's tie-break:
    # ascending-unique base order, then a stable descending-count argsort
    if field_uniqs:
        vals = np.concatenate(field_uniqs)
        cnts = np.concatenate(field_counts)
        uniq_all, inverse = np.unique(vals, return_inverse=True)
        totals = np.zeros(len(uniq_all), np.int64)
        np.add.at(totals, inverse, cnts)
        order = np.argsort(-totals, kind="stable")
        ranking = (uniq_all[order], totals[order])
    else:
        ranking = (np.empty(0, np.int64), np.empty(0, np.int64))
    return packed, ranking


def pad_dedup(packed: dict, unique_pad: int, exc_pad: int) -> dict:
    """Pad an exact dedup struct's variable-length planes to fixed sizes.
    Both pads are inert zeros: padded unique rows are never indexed, and
    padded exc_val entries sit past the last escape's index."""
    unique, exc_val = packed["unique"], packed["exc_val"]
    out = dict(packed)
    if unique_pad:
        if len(unique) > unique_pad:
            raise ValueError(
                f"{len(unique)} unique rows exceed unique_pad={unique_pad}"
            )
        out["unique"] = np.concatenate(
            [unique, np.zeros(unique_pad - len(unique), unique.dtype)]
        )
    if exc_pad:
        if len(exc_val) > exc_pad:
            raise ValueError(
                f"{len(exc_val)} exceptions exceed exc_pad={exc_pad}"
            )
        out["exc_val"] = np.concatenate(
            [exc_val, np.zeros(exc_pad - len(exc_val), exc_val.dtype)]
        )
    return out


def unpack_rows_dedup(packed: dict) -> torch.Tensor:
    """Device-side: invert pack_rows_dedup -> (B, F) int32 pre-hashed
    table rows: an exclusive prefix count over the escape mask gives each
    escape's index into exc_val (pack order is the same row-major scan),
    then a gather from exc_val and one from `unique`."""
    inv = packed["inverse8"].to(torch.int32)                # (B, F)
    exc_val = _widen(packed["exc_val"])
    if exc_val.shape[0] == 0:
        # no escapes possible (an exact pack with every rank < 255)
        ranks = inv
    else:
        flat = inv.reshape(-1)
        mask = flat == DEDUP_ESCAPE
        # exclusive prefix count: n-th escape (row-major) -> exc_val[n]
        order = torch.cumsum(mask, dim=0) - 1
        idx = torch.clamp(order, 0, exc_val.shape[0] - 1)
        ranks = torch.where(mask, exc_val[idx], flat).reshape(inv.shape)
    idx2 = packed["starts"].to(torch.int64)[None, :] + ranks
    return packed["unique"].to(torch.int32)[idx2]


def dedup_wire_bytes(packed: dict) -> int:
    """Bytes this struct puts on the host->device link."""
    return sum(np.asarray(v).nbytes for v in packed.values())


# process-wide series for the host->device wire (common/metrics.py)
_pack_bytes_counter = _metrics.default_registry().counter(
    "data_wire_pack_bytes_total",
    "bytes produced by DedupPacker.pack for the host->device link",
)
_pack_examples_counter = _metrics.default_registry().counter(
    "data_wire_examples_rows",
    "example rows packed by DedupPacker.pack",
)


def _round_up(n: int, quantum: int) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


class DedupPacker:
    """pack_rows_dedup with sticky pad caps: the unique and exception
    planes are padded to caps that only grow (headroom-scaled,
    quantum-rounded), so consecutive batches of one shape give identical
    plane shapes, which steps_per_execution's grouping needs.

    Thread-safe: worker threads share one packer, and the caps' growth
    and the padding run under a lock, so a cap one thread raised is
    never lowered by another and every batch fits the caps it is padded
    to.  The per-field ranking (the costly part) runs outside it.

    `pack(rows, return_ranking=True)` also returns the batch-global
    `(uniq, counts)` ranking, the tiered store's admission signal.  The
    JAX packer keeps it in a `last_ranking` attribute instead; with one
    packer shared by threads, an attribute could hand one caller the
    ranking of another's batch, so here it is each call's own return
    value."""

    def __init__(self, quantum: int = 4096, headroom: float = 1.25):
        self.quantum = int(quantum)
        self.headroom = float(headroom)
        self.unique_cap = 0
        self.exc_cap = 0
        self.last_unique = 0
        self.last_exceptions = 0
        self._lock = threading.Lock()

    def pack(self, rows: np.ndarray, return_ranking: bool = False):
        """The padded dedup struct of `rows`; with `return_ranking`,
        `(packed, (uniq, counts))`."""
        if return_ranking:
            exact, ranking = pack_rows_dedup(rows, return_ranking=True)
        else:
            exact = pack_rows_dedup(rows)
        n_unique = int(exact["unique"].shape[0])
        n_exc = int(exact["exc_val"].shape[0])
        with self._lock:
            self.last_unique, self.last_exceptions = n_unique, n_exc
            if n_unique > self.unique_cap:
                self.unique_cap = _round_up(
                    int(n_unique * self.headroom), self.quantum
                )
            if n_exc > self.exc_cap:
                self.exc_cap = _round_up(
                    int(n_exc * self.headroom), self.quantum
                )
            packed = pad_dedup(exact, self.unique_cap, self.exc_cap)
        _pack_bytes_counter.inc(dedup_wire_bytes(packed))
        _pack_examples_counter.inc(int(np.asarray(rows).shape[0]))
        if return_ranking:
            return packed, ranking
        return packed
