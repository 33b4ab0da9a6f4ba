"""Feature-preprocessing layers (the port of the JAX package's
preprocessing/layers.py, with the same layer set and semantics).

String-facing layers (Hashing, IndexLookup, ToNumber on text) run in a
zoo's `feed` on numpy.  The numeric layers take a numpy array or a torch
tensor and answer in kind: numpy in, numpy out (the host path of a
feed); a tensor in, a tensor on its device out (inside a model).  Every
integer output is int32 and equals the JAX layer's bit for bit; the
float arithmetic runs in f32, as the JAX layers run it with x64 off.

Layers: Hashing, IndexLookup, Discretization, ToNumber, RoundIdentity,
LogRound, ConcatenateWithOffset, SparseEmbedding.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def fnv1a_hash(value: str) -> int:
    """Stable 31-bit FNV-1a string hash (Python's hash() is salted per
    process; feature hashing must agree across workers and between
    training and serving)."""
    h = 2166136261
    for byte in str(value).encode():
        h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
    return h & 0x7FFFFFFF


def _is_text(arr: np.ndarray) -> bool:
    return arr.dtype.kind in ("U", "S", "O")


class Hashing:
    """Hash strings or ints into [0, num_bins): FNV-1a for strings, the
    value mod num_bins for ints."""

    def __init__(self, num_bins: int):
        if num_bins <= 0:
            raise ValueError("num_bins must be positive")
        self.num_bins = num_bins

    def __call__(self, x):
        if isinstance(x, torch.Tensor):
            return (x.to(torch.int64) % self.num_bins).to(torch.int32)
        arr = np.asarray(x)
        if _is_text(arr):
            flat = np.array(
                [fnv1a_hash(v) % self.num_bins for v in arr.reshape(-1)],
                dtype=np.int32,
            )
            return flat.reshape(arr.shape)
        return (arr.astype(np.int64) % self.num_bins).astype(np.int32)


class IndexLookup:
    """Vocabulary strings -> indices; an out-of-vocabulary value goes to
    one of `num_oov_indices` buckets after the vocabulary (by its FNV-1a
    hash), so with one bucket the OOV id is len(vocabulary)."""

    def __init__(self, vocabulary: Sequence[str], num_oov_indices: int = 1):
        self.vocabulary = list(vocabulary)
        self.num_oov_indices = max(1, num_oov_indices)
        self._table = {v: i for i, v in enumerate(self.vocabulary)}

    @property
    def vocab_size(self) -> int:
        return len(self.vocabulary) + self.num_oov_indices

    def _lookup(self, value) -> int:
        idx = self._table.get(str(value))
        if idx is not None:
            return idx
        return len(self.vocabulary) + fnv1a_hash(str(value)) \
            % self.num_oov_indices

    def __call__(self, x):
        arr = np.asarray(x)
        flat = np.array([self._lookup(v) for v in arr.reshape(-1)],
                        dtype=np.int32)
        return flat.reshape(arr.shape)


class Discretization:
    """Bucket floats by boundaries: x -> its index in [0, len(bins)]
    (searchsorted, side right, in f32)."""

    def __init__(self, bin_boundaries: Sequence[float]):
        self.bin_boundaries = list(bin_boundaries)

    def __call__(self, x):
        if isinstance(x, torch.Tensor):
            bounds = torch.tensor(self.bin_boundaries, dtype=torch.float32,
                                  device=x.device)
            return torch.searchsorted(
                bounds, x.to(torch.float32).contiguous(),
                right=True).to(torch.int32)
        bounds = np.asarray(self.bin_boundaries, np.float32)
        return np.searchsorted(bounds, np.asarray(x, np.float32),
                               side="right").astype(np.int32)


class ToNumber:
    """Strings -> numbers, with `default_value` for empty or unparseable
    values; numeric input is cast to `out_type`."""

    def __init__(self, out_type=np.float32, default_value=0):
        self.out_type = out_type
        self.default_value = default_value

    def _convert(self, value):
        text = str(value).strip()
        if not text:
            return self.default_value
        try:
            return float(text)
        except ValueError:
            return self.default_value

    def __call__(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.as_tensor(np.empty(0, self.out_type)).dtype)
        arr = np.asarray(x)
        if not _is_text(arr):
            return arr.astype(self.out_type)
        flat = np.array([self._convert(v) for v in arr.reshape(-1)],
                        dtype=self.out_type)
        return flat.reshape(arr.shape)


def _round_clip(x, max_value: int):
    """round half to even, clip to [0, max_value), int32; numpy or
    torch."""
    if isinstance(x, torch.Tensor):
        return torch.clamp(torch.round(x), 0, max_value - 1).to(torch.int32)
    return np.clip(np.round(x), 0, max_value - 1).astype(np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return np.asarray(x, np.float32)


class RoundIdentity:
    """Round a numeric feature to an integer id in [0, max_value)."""

    def __init__(self, max_value: int):
        self.max_value = max_value

    def __call__(self, x):
        return _round_clip(_f32(x), self.max_value)


class LogRound:
    """round(log_base(max(x, 1))) as an id for power-law numerics, clipped
    to [0, max_value)."""

    def __init__(self, max_value: int, base: float = np.e):
        self.max_value = max_value
        self.base = base

    def __call__(self, x):
        x = _f32(x)
        # the divisor in f32, as the JAX layer divides with x64 off
        log_base = np.float32(np.log(self.base))
        if isinstance(x, torch.Tensor):
            ids = torch.log(torch.clamp_min(x, 1.0)) / torch.tensor(
                log_base, device=x.device)
        else:
            ids = np.log(np.maximum(x, np.float32(1.0))) / log_base
        return _round_clip(ids, self.max_value)


class ConcatenateWithOffset:
    """Concatenate id columns, offsetting each so they index disjoint
    ranges of one shared embedding table."""

    def __init__(self, offsets: Sequence[int], axis: int = -1):
        self.offsets = list(offsets)
        self.axis = axis

    def __call__(self, inputs: List):
        if len(inputs) != len(self.offsets):
            raise ValueError(
                f"{len(inputs)} inputs vs {len(self.offsets)} offsets"
            )
        if any(isinstance(x, torch.Tensor) for x in inputs):
            return torch.cat([
                torch.as_tensor(x).to(torch.int32) + offset
                for x, offset in zip(inputs, self.offsets)
            ], dim=self.axis)
        return np.concatenate([
            np.asarray(x).astype(np.int32) + np.int32(offset)
            for x, offset in zip(inputs, self.offsets)
        ], axis=self.axis)


def SparseEmbedding(input_dim: int, output_dim: int, combiner: str = "sum",
                    **kwargs):
    """The reference's `SparseEmbedding`: a bag-combining embedding, an
    alias over layers/embedding.py's DistributedEmbedding."""
    from elasticdl_tpu_torch.layers.embedding import DistributedEmbedding

    return DistributedEmbedding(
        input_dim=input_dim, output_dim=output_dim, combiner=combiner,
        **kwargs,
    )
