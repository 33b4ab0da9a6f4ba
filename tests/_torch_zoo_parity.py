"""Shared by the port's zoo parity tests: a JAX Trainer and a port
Trainer on one zoo model, the port's state carried from the JAX init,
and a few steps of both."""

import jax
import numpy as np

from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common import model_handler as port_handler
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.worker import trainer as port_trainer


def trainers(model_def: str, params: str = ""):
    js = jax_spec("model_zoo", model_def, model_params=params)
    ps = port_handler.get_model_spec(port_handler.ZOO_DIR, model_def,
                                     model_params=params)
    return (js, JaxTrainer(js.model, js.optimizer, js.loss),
            ps, port_trainer.Trainer(ps.model, ps.optimizer, ps.loss,
                                     device="cpu"))


def carry(model, params, model_state=None):
    """Load a flax params tree (and its batch_stats) into `model`."""
    flat = flatten_params(jax.tree.map(np.asarray, params))
    stats = None
    if model_state and "batch_stats" in model_state:
        stats = flatten_params(jax.tree.map(np.asarray,
                                            model_state["batch_stats"]))
    model.load_state_dict(params_from_jax(model, flat, batch_stats=stats),
                          strict=True)
    return model


def carried_states(jt, pt, sample):
    jstate = jt.init_state(jax.random.PRNGKey(0), sample)
    pstate = pt.init_state(0, sample)
    carry(pstate.model, jstate.params["params"], jstate.model_state)
    return jstate, pstate


def step_gaps(jt, pt, jstate, pstate, batches):
    """Train both on `batches`; returns (per-step |loss gap|, JAX losses,
    the final states)."""
    gaps, losses = [], []
    for batch in batches:
        jstate, jloss = jt.train_on_batch(jstate, batch)
        pstate, ploss = pt.train_on_batch(pstate, batch)
        gaps.append(abs(float(jloss) - float(ploss)))
        losses.append(float(jloss))
    return gaps, losses, jstate, pstate
