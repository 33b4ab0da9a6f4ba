"""Bucketed inference engine: the execution layer of online serving (the
port of the JAX package's serving/engine.py).

- **Batch buckets.**  Requests arrive at arbitrary batch sizes; every
  batch is padded up to the nearest configured bucket, so the device
  only ever sees `len(buckets)` distinct batch shapes.
- **One captured graph per bucket.**  On CUDA the forward at each batch
  shape runs as a captured CUDA graph (worker/graphs.py), the port of
  the JAX engine's compile: `warmup()` runs each bucket once eagerly and
  captures it on the warming thread, so the batcher's dispatch thread
  only replays.  The padding stays on the host; the padded features are
  copied into the bucket's static inputs before the replay, and the
  result is copied out of the static output before the next replay.
  Dispatch is on `graph_ok`; a failed capture raises, and
  `graphs_lib.eager_loop()` keeps a thread on the eager forward, which
  the CPU always runs.  `serving_engine_compiles_total` keeps the JAX
  engine's name and counts the distinct batch shapes executed: after
  `warmup()` it equals `len(buckets)` and stays there.  With
  `precompile=False`, or `pad_to_bucket=False`, a shape's first call
  runs eagerly and its second captures.
- **The model's own kernels.**  The JAX engine traces under
  `export_mode()`, which swaps the Pallas flash kernel for the O(L^2)
  reference because jax2tf cannot stage a Pallas call.  The port has no
  such limit: on the card the forward runs the Hopper flash kernel,
  inside the graphs.
- **Atomic hot swap.**  The served generation is one set of static
  tensors, the engine's own copies (`_Served`), which the graphs bake
  in.  `swap()` validates names, shapes and dtypes against it and
  copies the new tensors into it in place, capturing nothing.  A
  predict holds the engine's serve lock from reading the step through
  copying out its result, and a swap holds it while it copies and sets
  the new step, so a response's step always names the weights it was
  computed with; both queue their device work on one stream.  At its
  peak a reload holds two generations: the restored tensors and the
  static set.
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

import contextlib
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
from elasticdl_tpu_torch.common.profiler import SPANS, Legs, torch_profiler
from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
from elasticdl_tpu_torch.device import resolve_device
from elasticdl_tpu_torch.worker.trainer import (
    TrainState,
    model_has_train_kwarg,
    run_device_serialized,
    to_tensor,
)
from elasticdl_tpu_torch.worker import graphs as graphs_lib

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


def _served_fingerprint(engine) -> tuple:
    """What a forward's graph bakes in: the served tensors' addresses
    (fixed for an engine's life: a swap copies in place)."""
    return tuple(t.data_ptr() for t in engine.variables.values())


def _signature(variables: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    return {
        name: (tuple(t.shape), t.dtype) for name, t in variables.items()
    }


class _Served:
    """The served generation: one set of static tensors, the engine's own
    copies, which every forward reads and a graph bakes in, and which a
    swap overwrites in place.  One leaf of the forward's signature:
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
        self._served = _Served(self._place(variables))
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
        # one generation at a time: a predict holds it from reading the
        # step to copying out its result, a swap while it copies the new
        # generation in, so their device work queues in lock order on
        # the engine's stream
        self._serve_lock = threading.Lock()
        self._stream = (torch.cuda.default_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._shapes_seen = set()
        # the captured forward per batch shape (worker/graphs.py), over
        # the served generation's static tensors; one memory pool
        self.graphs: Dict[tuple, Any] = {}
        self._graphs = graphs_lib.ProgramGraphs(
            self.device, fingerprint=_served_fingerprint)
        # phase-timing clock; public so deterministic tests can inject a
        # fake
        self.clock = time.perf_counter
        # Per-instance registry (common/metrics.py): compile/swap counts
        # live ONLY here; the properties below read the same series.
        self.metrics_registry = metrics_lib.MetricsRegistry()
        self._compiles = self.metrics_registry.counter(
            "serving_engine_compiles_total",
            "distinct batch shapes executed (== buckets after warm-up; "
            "on CUDA each is one captured graph, the JAX engine's "
            "compile)",
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
        """The engine's own copies of `variables` on its device."""
        return {
            name: t.detach().to(self.device, copy=True)
            for name, t in dict(variables).items()
        }

    def graph_ok(self) -> bool:
        """Whether the forward runs as captured CUDA graphs, one per batch
        shape: a CUDA engine outside `graphs_lib.eager_loop`, whose
        served tensors are real (the engine places them on its device),
        and no capture already under way."""
        return (self.device.type == "cuda" and not graphs_lib.in_eager_loop()
                and not torch.cuda.is_current_stream_capturing())

    def _body(self, served: _Served):
        """The forward's device work over input tensors on the device."""
        kwargs = {"train": False} if self._has_train else {}

        def body(tensors):
            x = tensors[SINGLE_FEATURE_KEY] if self._single else tensors
            with torch.inference_mode():
                return functional_call(self._model, served.variables, (x,),
                                       kwargs)

        return body

    @staticmethod
    def _host(feats) -> Dict[str, torch.Tensor]:
        cpu = torch.device("cpu")
        return {name: to_tensor(arr, cpu) for name, arr in feats.items()}

    def _forward(self, served: _Served, feats):
        """The padded batch's predictions on the device.  On the graph
        path the host copy of the features goes into the shape's static
        inputs, and the result is the static output: the caller reads it
        before the next replay (predict holds `_serve_lock`)."""
        shape = tuple(
            (name, tuple(feats[name].shape)) for name in sorted(feats)
        )
        with self._lock:
            if shape not in self._shapes_seen:
                self._shapes_seen.add(shape)
                self._compiles.inc()
        host = self._host(feats)
        body = self._body(served)
        if not self.graph_ok():
            return body({name: t.to(self.device)
                         for name, t in host.items()})
        return self._graphs.run(
            self, ("serving_forward", graphs_lib.batch_shapes(host)), host,
            body, finish=lambda out: out)

    def _capture(self, bucket: int) -> None:
        """Capture the forward at `bucket` rows ahead of its next call,
        after this thread's eager call (warmup): no forward runs, and the
        registry records no second compile."""
        host = self._host(_zeros_features(self._feature_spec, bucket))
        key = ("serving_forward", graphs_lib.batch_shapes(host))
        with self._serve_lock, self._on_stream():
            self._graphs.capture(self, key, host, self._body(self._served))

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

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
        """The served generation's tensors: the engine's static set,
        which a swap overwrites in place (copy them to keep a
        generation)."""
        return self._served.variables

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
        """Run every bucket once up front and, on the graph path
        (`graph_ok`), capture it on this thread, so that no request pays
        a build or a capture: the dispatch thread then only replays (the
        JAX engine compiles every bucket here)."""
        for b in self._buckets:
            self.predict(_zeros_features(self._feature_spec, b), b)
            if self._pad_to_bucket and self.graph_ok():
                self._capture(b)
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
        While a profiler records, the legs go to the span recorder under
        the thread's parent span (the batcher's batch): `pad`, then on
        the graph path `copy_in` (to the replay), `serve.replay.b<bucket>`
        (the replay's launch, in a range of that name) and `unpack` (from
        the launch's return), else `compute` and `unpack`.

        Oversized batches are the batcher's job to split; this raises."""
        bucket = self.bucket_for(rows)
        if bucket is None:
            raise ValueError(
                f"batch of {rows} rows exceeds largest bucket "
                f"{self.max_bucket}"
            )
        if not self._pad_to_bucket:
            bucket = rows
        traced = torch_profiler._is_profiler_enabled
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
        with self._serve_lock, self._on_stream():
            # the step, the forward and the copy out belong to one
            # generation: a swap waits for the lock
            step = self.step
            t1 = self.clock()
            if traced:
                legs = Legs(f"serve.replay.b{bucket}", self.clock)
                with SPANS.within(SPANS.parent(), legs):
                    out = run_device_serialized(
                        self._program, self._served, padded,
                        device=self.device)
            else:
                out = run_device_serialized(
                    self._program, self._served, padded, device=self.device
                )
            t2 = self.clock()
            # host transfer + row slice: the dequant/unpack leg of the
            # span; on the graph path it reads the static output before
            # the next replay can rewrite it
            result = out[:rows].to("cpu", torch.float32, copy=True).numpy()
            t3 = self.clock()
        if phase_out is not None:
            phase_out["pad"] = max(0.0, t1 - t0)
            phase_out["compute"] = max(0.0, t2 - t1)
            phase_out["unpack"] = max(0.0, t3 - t2)
        if traced:
            _trace_legs(legs, (t0, t1, t2, t3), rows)
        return result, step

    # ---- hot reload -----------------------------------------------------

    def swap(self, variables: Dict[str, torch.Tensor], step: int,
             produced_unix_s: Optional[float] = None) -> None:
        """Atomically replace the served generation: the new tensors are
        copied into the static set in place (a graph bakes in its
        addresses, so nothing is captured again, as the JAX forward takes
        the variables as an argument and a swap compiles nothing).  The
        new dict must match the current one in names, shapes and dtypes
        — a mismatch would give wrong results, or a new set of batch
        shapes, mid-traffic.  A predict sees the old generation whole or
        the new one whole, with its step.  `produced_unix_s` is the
        producer's stamp (freshness tracing); None keeps no stamp for the
        new generation."""
        new = {name: t.detach() for name, t in dict(variables).items()}
        if _signature(self._served.variables) != _signature(new):
            raise ValueError(
                "swap rejected: new variables do not match the "
                "served tree (structure/shape/dtype drift); restart "
                "serving with the new model instead of hot-swapping"
            )
        with self._serve_lock, self._on_stream():
            with torch.no_grad():
                for name, t in self._served.variables.items():
                    t.copy_(new[name])
            if self._stream is not None:
                # the copy has landed before the swap returns (and
                # before the caller frees the new tensors)
                self._stream.synchronize()
            with self._lock:
                self._step = int(step)
                self._produced_unix_s = produced_unix_s
        self._swaps.inc()
        logger.info("serving engine swapped to step %d", step)


def _trace_legs(legs: Legs, times, rows: int) -> None:
    """A predict's legs, from its clock readings `times` (start, forward
    called, forward returned, copied out) and the graph run's marks."""
    t0, t1, t2, t3 = times
    parent = SPANS.parent()
    SPANS.add("pad", t0, t1, parent)
    if len(legs.marks) == 4:
        _load, replay, launched, _finished = legs.marks
        SPANS.add("copy_in", t1, replay, parent)
        SPANS.add(legs.replay, replay, launched, parent,
                  attrs=(("rows", rows),))
        SPANS.add("unpack", launched, t3, parent)
    else:
        SPANS.add("compute", t1, t2, parent)
        SPANS.add("unpack", t2, t3, parent)


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
