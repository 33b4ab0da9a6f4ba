"""Model-zoo contract loading (the port's copy of the JAX package's
common/model_handler.py).

The zoo contract keeps the same function names, with PyTorch bodies:

    custom_model()            -> torch.nn.Module (predictions = forward())
    loss(labels, predictions) -> scalar torch loss
    optimizer(lr=...)         -> callable(params) -> torch.optim.Optimizer
    feed(records, metadata)   -> batch dict {"features":..., "labels":...}
    feed_bulk / feed_bulk_compact / feed_bulk_dedup(buffer, sizes,
                              metadata) -> batch dict (optional;
                              vectorized numpy parses into the plain,
                              compact and dedup wire formats)
    eval_metrics_fn()         -> {name: fn(labels, predictions) -> scalar}

The port's own zoo (`elasticdl_tpu_torch/model_zoo/`) is imported by its
fully qualified name.  Its top-level packages (`bert`, ...) share their
names with the JAX zoo's, so putting its directory on `sys.path` would let
one shadow the other in a process that loads both.  Any other zoo
directory is put on `sys.path` as the JAX package does.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

ZOO_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "model_zoo"
)
_ZOO_PACKAGE = "elasticdl_tpu_torch.model_zoo"


@dataclass
class ModelSpec:
    model: Any
    loss: Callable
    optimizer: Any
    feed: Callable
    feed_bulk: Optional[Callable] = None
    feed_bulk_compact: Optional[Callable] = None
    feed_bulk_dedup: Optional[Callable] = None
    eval_metrics: Dict[str, Callable] = field(default_factory=dict)
    custom_data_reader: Optional[Callable] = None
    callbacks: list = field(default_factory=list)
    # an object with process(predictions, worker_id) invoked on each
    # prediction batch (e.g. streaming rows to a sink)
    prediction_outputs_processor: Any = None
    module: Any = None
    # (parameter name, tensor) -> mesh spec or None: the zoo's
    # `param_sharding`, for Trainer(param_sharding_fn=...)
    param_sharding: Optional[Callable] = None


def resolve_wire_format(spec: ModelSpec, wire_format: str = "",
                        compact_wire: bool = False, log=logger) -> str:
    """The batch wire format a worker runs.

    `--wire_format` wins; empty defers to the legacy `--compact_wire`.
    A requested format the zoo does not implement degrades to the next
    one it does (dedup -> compact -> plain), with a warning, as the JAX
    package does: a job does not die over a missing optional feed."""
    requested = (wire_format or "").strip().lower() or (
        "compact" if compact_wire else "plain")
    if requested not in ("plain", "compact", "dedup"):
        raise ValueError(f"unknown wire format {requested!r}; "
                         "expected plain | compact | dedup")
    resolved = requested
    if resolved == "dedup" and spec.feed_bulk_dedup is None:
        log.warning(
            "--wire_format=dedup requested but the zoo module defines no "
            "feed_bulk_dedup; falling back")
        resolved = "compact"
    if resolved == "compact" and spec.feed_bulk_compact is None:
        if requested == "compact":
            log.warning(
                "--compact_wire requested but the zoo module defines no "
                "feed_bulk_compact; using the standard feed")
        resolved = "plain"
    return resolved


def load_module(model_zoo: str, dotted: str):
    """Resolve `pkg.module.fn` relative to the model_zoo directory; returns
    (module, function).  The port's own zoo resolves by qualified name."""
    module_path, fn_name = dotted.rsplit(".", 1)
    if os.path.abspath(model_zoo) == ZOO_DIR:
        module = importlib.import_module(f"{_ZOO_PACKAGE}.{module_path}")
    else:
        model_zoo = os.path.abspath(model_zoo)
        if model_zoo not in sys.path:
            sys.path.insert(0, model_zoo)
        module = importlib.import_module(module_path)
    return module, getattr(module, fn_name)


def _call_with_params(fn, params: str):
    """Call fn, passing parsed `--model_params`-style 'k=v;k2=v2' kwargs
    that match its signature."""
    kwargs = {}
    if params:
        for item in params.split(";"):
            if not item.strip():
                continue
            key, _, value = item.partition("=")
            try:
                # Literals only (numbers/strings/tuples/dicts/bools) — this
                # string arrives from job submission, so it must never be
                # able to execute code.
                value = ast.literal_eval(value.strip())
            except (ValueError, SyntaxError):
                pass  # keep as raw string
            kwargs[key.strip()] = value
    sig = inspect.signature(fn)
    accepted = {
        k: v for k, v in kwargs.items() if k in sig.parameters
    }
    return fn(**accepted)


def get_model_spec(
    model_zoo: str,
    model_def: str,
    model_params: str = "",
    dataset_fn: str = "feed",
    loss: str = "loss",
    optimizer: str = "optimizer",
    eval_metrics_fn: str = "eval_metrics_fn",
    custom_data_reader: str = "custom_data_reader",
    callbacks: str = "callbacks",
    prediction_outputs_processor: str = "",
    arena_dtype: str = "",
    store_cache_dtype: str = "",
) -> ModelSpec:
    # --arena_dtype and --store_cache_dtype ride into model_params (the
    # latter as the tiered zoos' `cache_dtype`): `_call_with_params`
    # filters kwargs by signature, so zoos without them ignore them.  A
    # value already in model_params wins.
    if arena_dtype and "arena_dtype" not in model_params:
        sep = ";" if model_params else ""
        model_params = f"{model_params}{sep}arena_dtype='{arena_dtype}'"
    if store_cache_dtype and "cache_dtype" not in model_params:
        sep = ";" if model_params else ""
        model_params = \
            f"{model_params}{sep}cache_dtype='{store_cache_dtype}'"
    module, model_fn = load_module(model_zoo, model_def)

    def opt(name, required=True):
        fn = getattr(module, name, None)
        if fn is None and required:
            raise ValueError(
                f"model zoo module {module.__name__} lacks required "
                f"function {name}()"
            )
        return fn

    metrics_factory = opt(eval_metrics_fn, required=False)
    reader_factory = opt(custom_data_reader, required=False)
    callbacks_factory = opt(callbacks, required=False)
    processor = None
    if prediction_outputs_processor:
        processor_cls = getattr(module, prediction_outputs_processor, None)
        if processor_cls is None:
            raise ValueError(
                f"--prediction_outputs_processor "
                f"{prediction_outputs_processor!r} not found in "
                f"{module.__name__}"
            )
        processor = _call_with_params(processor_cls, model_params)
    return ModelSpec(
        model=_call_with_params(model_fn, model_params),
        loss=opt(loss),
        optimizer=_call_with_params(opt(optimizer), model_params),
        feed=opt(dataset_fn),
        feed_bulk=opt("feed_bulk", required=False),
        feed_bulk_compact=opt("feed_bulk_compact", required=False),
        feed_bulk_dedup=opt("feed_bulk_dedup", required=False),
        eval_metrics=metrics_factory() if metrics_factory else {},
        custom_data_reader=reader_factory,
        callbacks=callbacks_factory() if callbacks_factory else [],
        prediction_outputs_processor=processor,
        module=module,
        param_sharding=opt("param_sharding", required=False),
    )
