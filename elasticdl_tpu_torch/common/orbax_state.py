"""The JAX package's TrainState, as an orbax step stores it, in the
port's terms: a model state dict, an optimizer state dict and a step.

The stored tree (common/orbax_read.py) is the flax TrainState:

    {"step": int32 scalar,
     "params": {"params": <the flax parameter tree>},
     "opt_state": <the optax state: a chain's list of states>,
     "model_state": {"batch_stats": ..., "quantized": ...}}

- `params` and the `quantized` (int8 arena planes) and `batch_stats`
  collections go through the naming rules of common/weights.py
  (`state_dict_from_flax`, the rules of `params_from_jax`).
- The optimizer state maps onto the optimizer that the zoo's
  `optimizer()` builds in both packages:
  `optax.adam` and `optax.adamw` (a chain of `scale_by_adam`, whose
  state is {count, mu, nu}, and stateless transforms) -> torch `Adam`
  and `AdamW`: `mu` -> `exp_avg`, `nu` -> `exp_avg_sq`, `count` ->
  `step`; `optax.sgd(lr, momentum)` (a `trace` state) -> torch `SGD`'s
  `momentum_buffer`; a stateless `optax.sgd` -> an SGD without
  momentum, whose state is empty.  Any other optax state, or a torch
  optimizer it does not match, raises `OptimizerStateMismatch`.  Each
  moment takes its parameter's name and layout (a kernel transposed as
  the kernel is).
- The step counter carries across; a GPipe stack stored under its
  legacy name `stack` is renamed `gpipe_stack` when the model names it
  so, as the JAX restore's shim does.

The arena dtype of the result is the checkpoint's; the caller
(common/save_utils.py) reconciles it with the model's as for its own
steps.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from elasticdl_tpu_torch.common import orbax_read
from elasticdl_tpu_torch.common.weights import (
    flatten_params,
    state_dict_from_flax,
)

_COLLECTIONS = ("quantized", "batch_stats")


class OptimizerStateMismatch(ValueError):
    """The checkpoint's optax state has no counterpart in the port's
    optimizer."""


def _optax_state(opt_state) -> Tuple[str, Any]:
    """("adam", {count, mu, nu}), ("trace", {trace}) or ("none", None)
    from an optax chain's stored state."""
    entries = opt_state if isinstance(opt_state, list) else [opt_state]
    found = []
    for entry in entries:
        if entry is None or entry == {} or entry == []:
            continue            # a stateless transform
        if isinstance(entry, dict) and set(entry) == {"count", "mu", "nu"}:
            found.append(("adam", entry))
        elif isinstance(entry, dict) and set(entry) == {"trace"}:
            found.append(("trace", entry))
        else:
            keys = sorted(entry) if isinstance(entry, dict) else \
                type(entry).__name__
            raise OptimizerStateMismatch(
                f"optax state {keys} has no port counterpart (the port "
                "maps optax.adam, optax.adamw and optax.sgd)")
    if len(found) > 1:
        raise OptimizerStateMismatch(
            f"optax chain holds {len(found)} stateful transforms; the port "
            "maps one")
    return found[0] if found else ("none", None)


def _torch_kind(optimizer: torch.optim.Optimizer) -> str:
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        return "adam"
    if isinstance(optimizer, torch.optim.SGD):
        momentum = optimizer.defaults.get("momentum", 0.0)
        return "trace" if momentum else "none"
    raise OptimizerStateMismatch(
        f"{type(optimizer).__name__} has no optax counterpart here (Adam, "
        "AdamW and SGD are mapped)")


def _moments(tree, model_state: Dict[str, torch.Tensor],
             names, what: str) -> Dict[str, torch.Tensor]:
    """{parameter name: moment} of an optax moment tree ({"params":
    ...}, mirroring the parameters), each shaped as its parameter."""
    flat = state_dict_from_flax(flatten_params(tree.get("params", tree)))
    missing = sorted(set(names) - set(flat))
    extra = sorted(set(flat) - set(names))
    if missing or extra:
        raise OptimizerStateMismatch(
            f"optax {what} does not mirror the parameters: missing "
            f"{missing}, unknown {extra}")
    for name in names:
        if tuple(flat[name].shape) != tuple(model_state[name].shape):
            raise OptimizerStateMismatch(
                f"optax {what} of {name} has shape {tuple(flat[name].shape)}"
                f"; the parameter has {tuple(model_state[name].shape)}")
    return flat


def state_from_tree(tree: Dict[str, Any], template
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any], int]:
    """(model state dict, optimizer state dict, step) of a stored JAX
    TrainState, for `template` (a port TrainState: its model's parameter
    order and its optimizer's class and param groups)."""
    for key in ("step", "params", "opt_state"):
        if key not in tree:
            raise orbax_read.OrbaxFormatError(
                f"the stored tree has no {key!r}: not a TrainState")
    names = [name for name, _ in template.model.named_parameters()]
    if any("gpipe_stack" in n.split(".") for n in names) \
            and orbax_read.tree_has_key(tree, "stack") \
            and not orbax_read.tree_has_key(tree, "gpipe_stack"):
        tree = orbax_read.swap_tree_keys(tree, "stack", "gpipe_stack")
    collections = dict(tree.get("model_state") or {})
    unknown = sorted(k for k, v in collections.items()
                     if k not in _COLLECTIONS and v)
    if unknown:
        raise orbax_read.OrbaxFormatError(
            f"model_state collections {unknown} have no port counterpart")
    params = tree["params"]
    model_state = state_dict_from_flax(
        flatten_params(params.get("params", params)),
        quantized=flatten_params(collections.get("quantized") or {}),
        batch_stats=flatten_params(collections.get("batch_stats") or {}))
    missing = sorted(set(names) - set(model_state))
    if missing:
        raise orbax_read.OrbaxFormatError(
            f"the checkpoint holds no leaf for parameters {missing}")

    kind, opt = _optax_state(tree["opt_state"])
    want = _torch_kind(template.optimizer)
    if kind != want:
        raise OptimizerStateMismatch(
            f"the checkpoint's optax state is {kind!r}, the port's "
            f"{type(template.optimizer).__name__} keeps {want!r}")
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    if kind == "adam":
        mu = _moments(opt["mu"], model_state, names, "mu")
        nu = _moments(opt["nu"], model_state, names, "nu")
        count = float(orbax_read.as_numpy(opt["count"]))
        state = {i: {"step": torch.tensor(count, dtype=torch.float32),
                     "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                 for i, n in enumerate(names)}
    elif kind == "trace":
        trace = _moments(opt["trace"], model_state, names, "trace")
        state = {i: {"momentum_buffer": trace[n]}
                 for i, n in enumerate(names)}
    optim_state = {"state": state,
                   "param_groups": template.optimizer.state_dict()[
                       "param_groups"]}
    return model_state, optim_state, int(orbax_read.as_numpy(tree["step"]))


def read_state(step_dir: str, template
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any], int]:
    """`state_from_tree` of the orbax step at `step_dir`."""
    return state_from_tree(orbax_read.read_tree(step_dir), template)
