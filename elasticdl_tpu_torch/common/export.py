"""Final model export (the port of the JAX package's common/export.py),
in the port's own format:

- `params.pt` — `torch.save` of owning host copies of the model's
  `state_dict()`: parameters AND buffers, so an int8 arena's codes and
  scales travel with the carrier.  Loaded with `torch.load(...,
  weights_only=True)` into a freshly constructed zoo model.
- `export_meta.json` — the JAX keys: `step`, `module`, `model_class`,
  `framework` ("elasticdl-tpu-torch"), `features` (the serving
  signature) and, when asked for, `saved_model`.

A JAX export (`params.msgpack`, framework "elasticdl-tpu") is refused
with a ValueError that names it: flax's msgpack cannot be read without
flax.  The JAX package's optional TF SavedModel (`saved_model=True`)
needs TensorFlow and jax2tf; the port records it as unavailable, as the
JAX package does on a machine without TensorFlow, and the weights export
stands.  A torch export in its place waits for its slice (ROADMAP.md
queue 1, item 13).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

# Feature-dict key used when a model's feed yields a single array instead
# of a dict (MNIST); the serving protocol and export meta both use it so
# single-input and dict-input models share one wire shape.
SINGLE_FEATURE_KEY = "features"
FRAMEWORK = "elasticdl-tpu-torch"
PARAMS_FILE = "params.pt"
META_FILE = "export_meta.json"
# what the JAX package writes
JAX_FRAMEWORK = "elasticdl-tpu"
JAX_PARAMS_FILE = "params.msgpack"
SAVED_MODEL_UNAVAILABLE = (
    "unavailable: a TF SavedModel needs TensorFlow and jax2tf; a torch "
    "export in its place waits for its slice of the port (ROADMAP.md "
    "queue 1, item 13)")


def feature_meta(sample_features: Any) -> dict:
    """Per-feature serving signature: {name: {shape: per-row dims, dtype}}.
    The batch dimension is dropped — it is the serving system's to choose."""

    def leaf(v):
        v = np.asarray(v)
        return {
            "shape": [int(d) for d in v.shape[1:]],
            "dtype": str(v.dtype),
        }

    if isinstance(sample_features, dict):
        return {str(k): leaf(v) for k, v in sample_features.items()}
    return {SINGLE_FEATURE_KEY: leaf(sample_features)}


def _refuse_jax_export(output_dir: str, meta: dict) -> None:
    if meta.get("framework") == JAX_FRAMEWORK or os.path.exists(
            os.path.join(output_dir, JAX_PARAMS_FILE)):
        raise ValueError(
            f"export at {output_dir} is the JAX package's "
            f"({JAX_PARAMS_FILE}, framework {JAX_FRAMEWORK!r}); the port "
            f"reads only its own exports ({PARAMS_FILE}, framework "
            f"{FRAMEWORK!r}) — re-export the model with the port")


def read_export_meta(output_dir: str) -> dict:
    with open(os.path.join(output_dir, META_FILE)) as f:
        meta = json.load(f)
    _refuse_jax_export(output_dir, meta)
    return meta


def export_model(
    state,
    spec,
    output_dir: str,
    saved_model: bool = False,
    sample_features: Any = None,
) -> str:
    """Write `state` (a TrainState or a snapshot of one) to `output_dir`;
    returns the params path."""
    os.makedirs(output_dir, exist_ok=True)
    host = {name: t.detach().to("cpu", copy=True)
            for name, t in state.model.state_dict().items()}
    path = os.path.join(output_dir, PARAMS_FILE)
    torch.save(host, path + ".tmp")
    os.replace(path + ".tmp", path)
    meta = {
        "step": int(state.step),
        "module": getattr(spec.module, "__name__", None),
        "model_class": type(spec.model).__name__,
        "framework": FRAMEWORK,
    }
    if sample_features is not None:
        # the export's serving signature: feature keys + per-row
        # shape/dtype; load_exported cross-checks them against the
        # consumer's model, so a zoo-definition drift fails at load
        meta["features"] = feature_meta(sample_features)
    if saved_model:
        if sample_features is None:
            # raise so export_for_task re-queues to a worker that HAS
            # processed a batch, as the JAX package does
            raise RuntimeError(
                "SavedModel export requested but this worker captured no "
                "sample features (no batch ever reached it); re-queueing"
            )
        meta["saved_model"] = SAVED_MODEL_UNAVAILABLE
        logger.error("SavedModel export %s; wrote %s only",
                     SAVED_MODEL_UNAVAILABLE, PARAMS_FILE)
    with open(os.path.join(output_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_exported(
    output_dir: str,
    template=None,
    expected_features: Any = None,
    check_only: bool = False,
) -> Dict[str, torch.Tensor]:
    """The exported {name: tensor} state dict, on the CPU.

    `template`: a module whose `state_dict()` names and shapes the export
    must match exactly (else ValueError listing the differences).
    `expected_features`: the consumer model's input signature — a sample
    feature batch/dict, or an iterable of feature-key names.  When given
    AND the export recorded its own signature, the key sets are
    cross-checked and a mismatch raises ValueError naming both sides.
    Exports without a signature skip the check."""
    meta = {}
    try:
        meta = read_export_meta(output_dir)
    except (OSError, json.JSONDecodeError):
        pass  # meta missing/corrupt: the params load below still governs
    _refuse_jax_export(output_dir, meta)
    if expected_features is not None:
        exported = meta.get("features")
        if exported is not None:
            if isinstance(expected_features, dict):
                expected_keys = {str(k) for k in expected_features}
            elif isinstance(
                expected_features, (list, tuple, set, frozenset)
            ):
                expected_keys = {str(k) for k in expected_features}
            else:  # a single sample array (MNIST-style feed)
                expected_keys = {SINGLE_FEATURE_KEY}
            if set(exported) != expected_keys:
                raise ValueError(
                    f"export at {output_dir} was written for feature keys "
                    f"{sorted(exported)} but the model expects "
                    f"{sorted(expected_keys)}; the model definition has "
                    "drifted since export — re-export the model or load "
                    "it with the matching zoo definition"
                )
    if check_only:
        return None
    state = torch.load(os.path.join(output_dir, PARAMS_FILE),
                       weights_only=True, map_location="cpu")
    if template is not None:
        want = {k: (tuple(v.shape), v.dtype)
                for k, v in template.state_dict().items()}
        got = {k: (tuple(v.shape), v.dtype) for k, v in state.items()}
        if want != got:
            diff = sorted(k for k in set(want) | set(got)
                          if want.get(k) != got.get(k))
            raise ValueError(
                f"export at {output_dir} does not match the model: "
                f"{len(diff)} entries differ in name, shape or dtype "
                f"({diff[:8]})")
    return state
