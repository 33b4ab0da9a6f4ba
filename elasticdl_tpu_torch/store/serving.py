"""TieredServingEngine: cold-row lookup on Predict and the tiered hot
swap (the port of the JAX package's store/serving.py).

It wraps a `ServingEngine` (serving/engine.py, typically
`from_checkpoint`) over the tiered zoo model, whose signature is {dense,
slots, <overlays>}.  Clients send raw {dense, sparse} features; the
wrapper translates the ids through the sidecar's vocabulary and cache
map:

  resident row    -> its cache slot (the trained device value)
  known cold row  -> slot -1 and its host-tier value in the overlay
  unknown id      -> slot -1 and zeros (a never-trained id serves the
                     model's bias path)

Serving never grows the vocabulary or changes the cache: Predict is
read-only.

Hot swap: `swap(variables, step, ...)` adopts the step's sidecar and
swaps the engine's variables as one generation change under an RLock
that `predict` also holds, so a request sees one (metadata, variables)
generation.  A step without a sidecar raises and the current generation
goes on serving.  The wrapper exposes what the checkpoint reloader reads
(`device`, `step`, `state_template`, `arena_convert`, `swap`), so
`CheckpointReloader` drives it unchanged.  The JAX package's `serve`
command does not wire this engine, and neither does the port's.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.layers.arena import plane_prefixes
from elasticdl_tpu_torch.store import checkpoint as store_ckpt
from elasticdl_tpu_torch.store.host_tier import LazyVocabulary


class TieredServingEngine:
    """`engine` serves the tiered model on the translated signature
    ({dense, slots, <overlays>}).  `overlay_features` maps each store
    plane to the feature its cold values travel under (deepfm_tiered:
    fm_embedding -> cold_fm, fm_linear -> cold_linear)."""

    def __init__(self, engine, checkpoint_dir: str, step: int,
                 overlay_features: Dict[str, str],
                 slots_feature: str = "slots",
                 sparse_feature: str = "sparse"):
        self._engine = engine
        self._dir = checkpoint_dir
        self._overlay_features = dict(overlay_features)
        self._slots_feature = slots_feature
        self._sparse_feature = sparse_feature
        self._lock = threading.RLock()
        self._adopt_sidecar(int(step))

    # ---- tier metadata -------------------------------------------------

    def _engine_is_int8(self) -> bool:
        return bool(plane_prefixes(self._engine.variables))

    def _adopt_sidecar(self, step: int) -> None:
        if not store_ckpt.has_sidecar(self._dir, step):
            raise RuntimeError(
                f"checkpoint step {step} has no tiered sidecar under "
                f"{self._dir}; cannot serve a tiered model without its "
                "vocabulary and cache map")
        sidecar = store_ckpt.load_sidecar(self._dir, step)
        meta = sidecar.meta
        # an int8 cache's sidecar pairs only with a model that has
        # quantized cache planes, and the reverse
        wants_int8 = self._engine_is_int8()
        if (sidecar.cache_dtype == "int8") != wants_int8:
            raise RuntimeError(
                f"tiered sidecar at step {step} holds "
                f"{sidecar.cache_dtype!r} cache values but the serving "
                "model has cache_dtype="
                f"{'int8' if wants_int8 else 'float32'!r}; rebuild the "
                "serving model with the matching cache_dtype")
        vocab = LazyVocabulary.from_arrays(int(meta["num_fields"]),
                                           *sidecar.vocab_arrays())
        n = vocab.size
        # store row -> cache slot (-1 when not resident)
        slot_of_row = np.full(max(n, 1), -1, np.int64)
        resident = (sidecar.row_of >= 0) & (sidecar.row_of < n)
        slot_of_row[sidecar.row_of[resident]] = np.nonzero(resident)[0]
        host_planes = {name: sidecar.host_plane(name)
                       for name in meta["planes"]}
        with self._lock:
            self._vocab = vocab
            self._slot_of_row = slot_of_row
            self._host_planes = host_planes
            self._planes = {name: int(dim)
                            for name, dim in meta["planes"].items()}

    # ---- engine delegation (what the reloader reads) ------------------

    @property
    def device(self):
        return self._engine.device

    @property
    def step(self) -> int:
        return self._engine.step

    @property
    def state_template(self):
        return self._engine.state_template

    @property
    def arena_convert(self) -> bool:
        return getattr(self._engine, "arena_convert", False)

    @property
    def swap_count(self) -> int:
        return self._engine.swap_count

    @property
    def vocab_rows(self) -> int:
        with self._lock:
            return int(self._vocab.size)

    def swap(self, variables, step: int,
             produced_unix_s: Optional[float] = None) -> None:
        """Adopt the step's sidecar, then swap the engine's variables:
        one generation change under the lock.  A missing sidecar raises
        with the current generation still serving (the reloader counts
        the step as rejected)."""
        with self._lock:
            previous = (self._vocab, self._slot_of_row, self._host_planes,
                        self._planes)
            self._adopt_sidecar(int(step))
            try:
                self._engine.swap(variables, step,
                                  produced_unix_s=produced_unix_s)
            except BaseException:
                (self._vocab, self._slot_of_row, self._host_planes,
                 self._planes) = previous
                raise
            vocab_rows = int(self._vocab.size)
        events.emit(events.STORE_TIER_SWAPPED, step=int(step),
                    vocab_rows=vocab_rows)

    # ---- predict -------------------------------------------------------

    def translate(self, sparse: np.ndarray) -> Tuple[np.ndarray, Dict]:
        """(slots, overlay features) for a raw (B, F) id batch, from one
        generation."""
        with self._lock:
            rows = self._vocab.lookup(np.asarray(sparse, np.int64))
            slots = np.full(rows.shape, -1, np.int32)
            known = rows >= 0
            slots[known] = self._slot_of_row[rows[known]]
            cold = known & (slots < 0)
            overlays = {}
            for plane, feat in self._overlay_features.items():
                overlay = np.zeros(rows.shape + (self._planes[plane],),
                                   np.float32)
                if cold.any():
                    overlay[cold] = self._host_planes[plane][rows[cold]]
                overlays[feat] = overlay
            return slots, overlays

    def predict(self, features: Dict[str, np.ndarray], rows: int,
                phase_out: Optional[Dict[str, float]] = None):
        """Raw {dense, sparse} features in; (predictions, step) out.  The
        lock is held throughout, so the slots, the overlays and the
        variables belong to one checkpoint."""
        with self._lock:
            translated = {k: v for k, v in features.items()
                          if k != self._sparse_feature}
            slots, overlays = self.translate(features[self._sparse_feature])
            translated[self._slots_feature] = slots
            translated.update(overlays)
            return self._engine.predict(translated, rows,
                                        phase_out=phase_out)
