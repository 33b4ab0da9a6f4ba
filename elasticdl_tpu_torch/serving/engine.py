"""Bucketed inference engine: the execution layer of online serving (the
port of the JAX package's serving/engine.py).

- **Batch buckets.**  Requests arrive at arbitrary batch sizes; every
  batch is padded up to the nearest configured bucket, so the device
  only ever sees `len(buckets)` distinct batch shapes.  PyTorch runs
  eagerly and traces nothing, so `serving_engine_compiles_total` keeps
  the JAX engine's name and counts the distinct batch shapes executed;
  after `warmup()` it equals `len(buckets)` and stays there.
- **The model's own kernels.**  The JAX engine traces under
  `export_mode()`, which swaps the Pallas flash kernel for the O(L^2)
  reference because jax2tf cannot stage a Pallas call.  The port has no
  such limit: on the card the forward runs the Hopper flash kernel.
- **Atomic hot swap.**  `swap()` validates names, shapes and dtypes
  against the served variables and replaces the dict under a lock.  The
  forward runs `torch.func.functional_call(model, variables, ...)` on
  the dict it read, so in-flight batches keep their reference.
- **Serialized device execution.**  The forward runs under
  `run_device_serialized` (worker/trainer.py) from the batcher's
  dispatch thread.
- **A registered program.**  The forward is `serving_forward` in the
  program registry (common/programs.py), with the bucket count as its
  signature budget: a distinct batch shape beyond the buckets within the
  storm window is a recompile storm.  `pad_to_bucket=False` (a drill's
  seam, as in the JAX engine) runs each request at its own size.

The engine runs on CUDA unless it is given `device="cpu"`.  It loads
from an export (`from_export`, common/export.py) or straight from a
training checkpoint directory (`from_checkpoint`, through
`CheckpointSaver.restore_step`); its variables are the model's whole
`state_dict()`, parameters and buffers, so an int8 arena serves from its
codes and scales.  `from_checkpoint(..., arena_convert=True)` serves a
checkpoint whose arena dtype differs from the configured model's (fp32
into an `arena_dtype="int8"` model, or the reverse), converted on
restore.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common import programs
from elasticdl_tpu_torch.common.export import (
    SINGLE_FEATURE_KEY,
    feature_meta,
    load_exported,
    read_export_meta,
)
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
from elasticdl_tpu_torch.device import resolve_device
from elasticdl_tpu_torch.worker.trainer import (
    TrainState,
    model_has_train_kwarg,
    run_device_serialized,
    to_tensor,
)

logger = get_logger(__name__)

DEFAULT_BUCKETS = (1, 4, 16, 64)


def _zeros_features(feature_spec: Dict[str, dict], rows: int) -> dict:
    return {
        name: np.zeros((rows, *leaf["shape"]), np.dtype(leaf["dtype"]))
        for name, leaf in feature_spec.items()
    }


def packed_leaf_spec(leaf: dict) -> Optional[dict]:
    """The uint24-packed wire variant of an integer id feature leaf, or
    None when the leaf has no packed form.  An int32/int64 feature of
    per-row shape (F,) may instead arrive as (F, 3) uint8 little-endian
    triples — 3 bytes/id on the request payload instead of 4.  Zoo models
    on the CTR record format unpack it themselves, so the engine only
    needs to ACCEPT the shape; it never converts."""
    if np.dtype(leaf["dtype"]) not in (np.dtype(np.int32),
                                       np.dtype(np.int64)):
        return None
    return {"shape": [*leaf["shape"], 3], "dtype": "uint8"}


def packed_feature_spec(feature_spec: Dict[str, dict]) -> Dict[str, dict]:
    """The signature a bandwidth-conscious Predict client should send:
    every integer id feature in its uint24-packed form, everything else
    native."""
    return {
        name: packed_leaf_spec(leaf) or dict(leaf)
        for name, leaf in feature_spec.items()
    }


def _signature(variables: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    return {
        name: (tuple(t.shape), t.dtype) for name, t in variables.items()
    }


class _Served:
    """The served variables as one leaf of the forward's signature:
    `swap` keeps their names, shapes and dtypes, so a request's features
    alone tell one signature from another (and flattening a model's
    hundreds of tensors per request would cost more than a small
    forward)."""

    __slots__ = ("variables",)

    def __init__(self, variables: Dict[str, torch.Tensor]):
        self.variables = variables


class ServingEngine:
    """Executes a model's forward pass over batch buckets.

    `variables` maps the model's parameter (and buffer) names to tensors;
    they are moved to the engine's device once.  `feature_spec` is the
    serving signature ({name: {shape, dtype}}, common/export.py);
    features passed to `predict` are always a dict keyed by it — models
    whose feed yields a bare array use the single reserved key
    (SINGLE_FEATURE_KEY) and the engine unpacks it before the forward.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        variables: Dict[str, torch.Tensor],
        step: int,
        feature_spec: Dict[str, dict],
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        precompile: bool = True,
        produced_unix_s: Optional[float] = None,
        device=None,
        state_template: Optional[TrainState] = None,
        arena_convert: bool = False,
        pad_to_bucket: bool = True,
    ):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive: {buckets}")
        self.device = resolve_device(device)
        # An engine owns its module: `functional_call` swaps the served
        # variables into the module for the duration of a forward, so
        # two engines over one zoo template (a fleet's replicas) would
        # race on its parameters from their batchers' threads.
        self._model = copy.deepcopy(model).eval()
        self._variables = self._place(variables)
        self._step = int(step)
        # wall time the producer stamped into the checkpoint manifest
        # (None when unknown), for end-to-end staleness tracing
        self._produced_unix_s = produced_unix_s
        self._feature_spec = dict(feature_spec)
        self._buckets = tuple(sorted(set(int(b) for b in buckets)))
        self._single = set(self._feature_spec) == {SINGLE_FEATURE_KEY}
        # storm-drill seam: without bucket padding every distinct request
        # size is a new signature of the registered forward
        self._pad_to_bucket = bool(pad_to_bucket)
        self._has_train = model_has_train_kwarg(model)
        self._lock = threading.Lock()
        self._shapes_seen = set()
        # phase-timing clock; public so deterministic tests can inject a
        # fake
        self.clock = time.perf_counter
        # Per-instance registry (common/metrics.py): compile/swap counts
        # live ONLY here; the properties below read the same series.
        self.metrics_registry = metrics_lib.MetricsRegistry()
        self._compiles = self.metrics_registry.counter(
            "serving_engine_compiles_total",
            "distinct batch shapes executed (== buckets after warm-up; "
            "eager PyTorch compiles nothing, the name is the JAX "
            "engine's)",
        )
        self._swaps = self.metrics_registry.counter(
            "serving_engine_swaps_total",
            "hot swaps of the served variables (checkpoint reloads)",
        )
        self.metrics_registry.gauge_fn(
            "serving_model_step", lambda: self.step,
            "training step of the currently served variables",
        )
        # kept for the reloader: the TrainState this engine's checkpoints
        # restore into (None for export-loaded engines), and whether
        # their arena dtype is converted on restore
        self.state_template = state_template
        self.arena_convert = bool(arena_convert)
        # the bucket count IS the declared signature budget
        self._program = programs.registered_jit(
            "serving_forward", self._forward,
            signature_budget=len(self._buckets))
        if precompile:
            self.warmup()

    # ---- construction ---------------------------------------------------

    @classmethod
    def from_export(
        cls,
        export_dir: str,
        spec,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        sample_features: Any = None,
        precompile: bool = True,
        device=None,
    ) -> "ServingEngine":
        """Load a `params.pt` export (common/export.py).

        The serving signature comes from export_meta.json; passing
        `sample_features` additionally cross-checks the export's feature
        keys against the model actually being served (load_exported's
        drift guard)."""
        meta = read_export_meta(export_dir)
        feature_spec = meta.get("features")
        if feature_spec is None:
            if sample_features is None:
                raise ValueError(
                    f"export at {export_dir} predates feature signatures "
                    "(no 'features' in export_meta.json) — pass "
                    "sample_features to describe the model's inputs"
                )
            feature_spec = feature_meta(sample_features)
        elif sample_features is not None:
            load_exported(
                export_dir, expected_features=list(
                    feature_meta(sample_features)),
                check_only=True,
            )
        variables = load_exported(
            export_dir, template=spec.model,
            expected_features=list(feature_spec),
        )
        return cls(
            spec.model, variables, step=int(meta.get("step", 0)),
            feature_spec=feature_spec, buckets=buckets,
            precompile=precompile, device=device,
        )

    @classmethod
    def from_checkpoint(
        cls,
        checkpoint_dir: str,
        spec,
        sample_features: Any,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        step: Optional[int] = None,
        precompile: bool = True,
        arena_convert: bool = False,
        device=None,
    ) -> "ServingEngine":
        """Serve straight from a training checkpoint directory (verified
        against its manifest by CheckpointSaver; the optimizer state is
        restored as part of the TrainState and dropped).

        `arena_convert=True` lets a checkpoint whose arena storage dtype
        differs from the configured model's migrate on restore — serve
        an int8-trained checkpoint through an fp32 config or the reverse;
        without it a mismatch raises `ArenaDtypeMismatch`
        (common/save_utils.py)."""
        device = resolve_device(device)
        template = build_state_template(spec, sample_features, device)
        saver = CheckpointSaver(checkpoint_dir)
        try:
            if step is None:
                step = saver.latest_step()
            if step is None:
                raise ValueError(
                    f"no checkpoints found in {checkpoint_dir}"
                )
            restored = run_device_serialized(
                saver.restore_step, step, template, arena_convert,
                device=device,
            )
            if restored is None:
                raise ValueError(
                    f"checkpoint step {step} in {checkpoint_dir} failed "
                    "integrity verification or does not exist"
                )
            produced = saver.produced_meta(step) or {}
        finally:
            saver.close()
        return cls(
            spec.model, restored.model.state_dict(), step=int(step),
            feature_spec=feature_meta(sample_features), buckets=buckets,
            precompile=precompile, device=device,
            produced_unix_s=produced.get("produced_unix_s"),
            state_template=template, arena_convert=arena_convert,
        )

    def _place(self, variables) -> Dict[str, torch.Tensor]:
        return {
            name: t.detach().to(self.device)
            for name, t in dict(variables).items()
        }

    def _forward(self, served: _Served, feats):
        variables = served.variables
        shape = tuple(
            (name, tuple(feats[name].shape)) for name in sorted(feats)
        )
        with self._lock:
            if shape not in self._shapes_seen:
                self._shapes_seen.add(shape)
                self._compiles.inc()
        tensors = {
            name: to_tensor(arr, self.device) for name, arr in feats.items()
        }
        x = tensors[SINGLE_FEATURE_KEY] if self._single else tensors
        kwargs = {"train": False} if self._has_train else {}
        with torch.inference_mode():
            return functional_call(self._model, variables, (x,), kwargs)

    # ---- introspection --------------------------------------------------

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._buckets

    @property
    def max_bucket(self) -> int:
        return self._buckets[-1]

    @property
    def feature_spec(self) -> Dict[str, dict]:
        return dict(self._feature_spec)

    @property
    def compile_count(self) -> int:
        return int(self._compiles.value())

    @property
    def swap_count(self) -> int:
        return int(self._swaps.value())

    @property
    def step(self) -> int:
        with self._lock:
            return self._step

    @property
    def produced_unix_s(self) -> Optional[float]:
        """Producer wall-time stamp of the served variables, or None."""
        with self._lock:
            return self._produced_unix_s

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        with self._lock:
            return self._variables

    def bucket_for(self, rows: int) -> Optional[int]:
        for b in self._buckets:
            if b >= rows:
                return b
        return None

    def validate(self, features: Dict[str, np.ndarray]) -> Optional[str]:
        """None when `features` matches the serving signature, else a
        client-facing error string (SERVING_INVALID).  Integer id
        features are accepted in EITHER the native form or the
        uint24-packed wire form (`packed_feature_spec`) — per feature,
        so a client may pack only its large id planes."""
        if not isinstance(features, dict):
            return "features must be a dict of named arrays"
        if set(features) != set(self._feature_spec):
            return (
                f"feature keys {sorted(map(str, features))} do not match "
                f"the model signature {sorted(self._feature_spec)}"
            )
        rows = None
        for name, leaf in self._feature_spec.items():
            arr = np.asarray(features[name])
            packed = packed_leaf_spec(leaf)

            def matches(spec):
                return (
                    arr.dtype == np.dtype(spec["dtype"])
                    and arr.ndim == 1 + len(spec["shape"])
                    and list(arr.shape[1:]) == list(spec["shape"])
                )

            if not matches(leaf) and not (packed and matches(packed)):
                accepted = (
                    f"(rows, {', '.join(map(str, leaf['shape']))}) "
                    f"{leaf['dtype']}"
                )
                if packed:
                    accepted += (
                        f" or uint24-packed (rows, "
                        f"{', '.join(map(str, packed['shape']))}) uint8"
                    )
                return (
                    f"feature '{name}' has shape {arr.shape} dtype "
                    f"{arr.dtype}, expected {accepted}"
                )
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                return (
                    "feature row counts disagree: "
                    f"'{name}' has {arr.shape[0]}, others have {rows}"
                )
        if not rows:
            return "empty request (0 rows)"
        return None

    # ---- execution ------------------------------------------------------

    def warmup(self) -> None:
        """Run every bucket once up front, so the first request of each
        size finds the kernels built and the allocator warm."""
        for b in self._buckets:
            self.predict(_zeros_features(self._feature_spec, b), b)
        logger.info(
            "serving engine warm on %s: buckets=%s batch shapes=%d",
            self.device, self._buckets, self.compile_count,
        )

    def predict(
        self, features: Dict[str, np.ndarray], rows: int,
        phase_out: Optional[Dict[str, float]] = None,
    ) -> Tuple[np.ndarray, int]:
        """Run the forward pass on `rows` leading rows of `features`,
        padding up to the nearest bucket; returns (predictions, step).
        When `phase_out` is given it receives the engine-side phase
        durations {"pad", "compute", "unpack"} in seconds.  On CUDA,
        "compute" is the time to queue the kernels and "unpack" includes
        waiting for them: the host copy of the result is the sync.

        Oversized batches are the batcher's job to split; this raises."""
        bucket = self.bucket_for(rows)
        if bucket is None:
            raise ValueError(
                f"batch of {rows} rows exceeds largest bucket "
                f"{self.max_bucket}"
            )
        if not self._pad_to_bucket:
            bucket = rows
        t0 = self.clock()
        padded = {}
        for name, arr in features.items():
            arr = np.asarray(arr)
            if arr.shape[0] != bucket:
                pad = np.zeros(
                    (bucket - arr.shape[0],) + arr.shape[1:], arr.dtype
                )
                arr = np.concatenate([arr, pad], axis=0)
            padded[name] = arr
        with self._lock:
            variables, step = self._variables, self._step
        t1 = self.clock()
        out = run_device_serialized(
            self._program, _Served(variables), padded, device=self.device
        )
        t2 = self.clock()
        # host transfer + row slice: the dequant/unpack leg of the span
        result = out[:rows].float().cpu().numpy()
        if phase_out is not None:
            t3 = self.clock()
            phase_out["pad"] = max(0.0, t1 - t0)
            phase_out["compute"] = max(0.0, t2 - t1)
            phase_out["unpack"] = max(0.0, t3 - t2)
        return result, step

    # ---- hot reload -----------------------------------------------------

    def swap(self, variables: Dict[str, torch.Tensor], step: int,
             produced_unix_s: Optional[float] = None) -> None:
        """Atomically replace the served variables.  The new dict must
        match the current one in names, shapes and dtypes — a mismatch
        would give wrong results, or a new set of batch shapes,
        mid-traffic.  `produced_unix_s` is the producer's stamp
        (freshness tracing); None keeps no stamp for the new generation."""
        placed = self._place(variables)
        new_sig = _signature(placed)
        # check-and-set under one lock hold: two concurrent swaps must
        # not both validate against the same old dict
        with self._lock:
            if _signature(self._variables) != new_sig:
                raise ValueError(
                    "swap rejected: new variables do not match the "
                    "served tree (structure/shape/dtype drift); restart "
                    "serving with the new model instead of hot-swapping"
                )
            self._variables = placed
            self._step = int(step)
            self._produced_unix_s = produced_unix_s
        self._swaps.inc()
        logger.info("serving engine swapped to step %d", step)


def build_state_template(spec, sample_features, device=None) -> TrainState:
    """The TrainState training checkpoints of this model restore into:
    the zoo model copied onto `device` with the zoo optimizer over it —
    the restore target of checkpoint-backed serving and hot reload.  The
    JAX package traces the model on `sample_features` for its shapes; a
    torch module has them from construction, so no forward runs here
    and `sample_features` is not read (so a server's kernel launches
    are those of its warm-up and of the batches it serves)."""
    del sample_features
    device = resolve_device(device)
    model = copy.deepcopy(spec.model).to(device)
    return TrainState(step=0, model=model,
                      optimizer=spec.optimizer(model.parameters()))
