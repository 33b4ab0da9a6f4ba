"""Final model export (the port of the JAX package's common/export.py),
in the port's own format:

- `params.pt` — `torch.save` of owning host copies of the model's
  `state_dict()`: parameters AND buffers, so an int8 arena's codes and
  scales travel with the carrier.  Loaded with `torch.load(...,
  weights_only=True)` into a freshly constructed zoo model.
- `export_meta.json` — the JAX keys: `step`, `module`, `model_class`,
  `framework` ("elasticdl-tpu-torch"), `features` (the serving
  signature) and, when asked for, `saved_model`.
- `saved_model/model.pt2` (with `saved_model=True`, the JAX package's
  TF SavedModel in the port): a `torch.export` of the zoo model's
  serving forward over the feature dict keyed by the serving signature,
  with a dynamic batch dimension and the parameters embedded.  The hand
  kernels stay in its graph as their custom ops (`elasticdl_torch::...`),
  so on the card the exported BERT launches the flash kernel.  A process
  that loads it imports `KERNEL_OP_MODULES` to register those ops, and
  nothing of the zoo (`load_saved_model`; `serving/run_export.py` runs
exports in a process of their own).  `meta["saved_model"]` is
  "ok", or "failed: ..." when the export raised, as in the JAX package;
  the weights export stands either way.

A state sharded over a mesh (the model, seq, expert or pipe variants)
exports its gathered tree: `export_model` gathers it on every rank (a
collective: every rank calls it) and rank 0 writes, and the trace runs
in the mesh's export mode (parallel/mesh.py `export_mode`): the ring is
of one over the whole sequence, the pipeline sequential and every
expert local, the same parameter tree as on any mesh.

A JAX export (`params.msgpack`, framework "elasticdl-tpu") is refused
with a ValueError that names it: flax's msgpack cannot be read without
flax.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.ops import KERNEL_OP_MODULES
from elasticdl_tpu_torch.parallel.mesh import export_mode

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
SAVED_MODEL_DIR = "saved_model"
SAVED_MODEL_FILE = "model.pt2"
# the kernels' launch grid bounds the batch (ops/flash_attention.py)
MAX_EXPORT_BATCH = 65535


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
    returns the params path.  A sharded state is gathered first (every
    rank calls this; only rank 0 writes, the others return None)."""
    from elasticdl_tpu_torch.common.save_utils import gathered_state, \
        is_sharded

    if is_sharded(state):
        rank = state.mesh.rank
        state = gathered_state(state)
        if rank != 0:
            return None
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
        try:
            export_saved_model(state,
                               os.path.join(output_dir, SAVED_MODEL_DIR),
                               sample_features)
            meta["saved_model"] = "ok"
        except Exception as exc:   # recorded in the meta; params.pt stands
            meta["saved_model"] = f"failed: {exc}"
            logger.error("torch export failed (%s); wrote %s only", exc,
                         PARAMS_FILE)
    with open(os.path.join(output_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return path


class ServingForward(torch.nn.Module):
    """The zoo model's serving forward over the feature dict keyed by the
    serving signature (a single-array model reads its one key), as the
    serving engine calls it."""

    def __init__(self, model: torch.nn.Module, single: bool):
        super().__init__()
        from elasticdl_tpu_torch.worker.trainer import model_has_train_kwarg

        self.model = model
        self.single = single
        self.kwargs = {"train": False} if model_has_train_kwarg(model) \
            else {}

    def forward(self, features: Dict[str, torch.Tensor]):
        x = features[SINGLE_FEATURE_KEY] if self.single else features
        return self.model(x, **self.kwargs)


def export_saved_model(state, out_dir: str, sample_features: Any) -> str:
    """`torch.export` the serving forward of `state`'s model (in eval
    mode for the trace, then back in its own mode; on its device) over
    `sample_features` with a dynamic batch dimension; writes
    `<out_dir>/model.pt2` and returns its path."""
    from elasticdl_tpu_torch.worker.trainer import to_tensor

    for name in KERNEL_OP_MODULES:
        importlib.import_module(name)
    single = not isinstance(sample_features, dict)
    feats = ({SINGLE_FEATURE_KEY: sample_features} if single
             else dict(sample_features))
    model = state.model
    device = next(model.parameters()).device
    example = {}
    for name, value in feats.items():
        value = np.asarray(value)
        if value.shape[0] < 2:
            # an example batch of 1 would specialize the batch dimension
            value = np.concatenate([value] * 2)[:2]
        example[name] = to_tensor(value, device)
    batch = torch.export.Dim("batch", min=1, max=MAX_EXPORT_BATCH)
    training = model.training
    model.eval()
    try:
        with torch.no_grad(), export_mode():
            exported = torch.export.export(
                ServingForward(model, single), (example,),
                dynamic_shapes=({name: {0: batch} for name in example},))
    finally:
        model.train(training)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, SAVED_MODEL_FILE)
    tmp = os.path.join(out_dir, f"model.{os.getpid()}.tmp.pt2")
    torch.export.save(exported, tmp)
    os.replace(tmp, path)
    return path


def load_saved_model(path: str):
    """The exported program at `path` (a `model.pt2` or the directory
    that holds it), after registering the kernels' custom ops; call
    `.module()(features)` on the result.  Imports nothing of the zoo."""
    if os.path.isdir(path):
        path = os.path.join(path, SAVED_MODEL_FILE)
    for name in KERNEL_OP_MODULES:
        importlib.import_module(name)
    return torch.export.load(path)


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
