"""GPipe pipeline parallelism over the mesh `pipe` axis (the port of the
JAX package's ops/pipeline.py).

The layer stack is one dict of tensors with a leading layer axis; stage
s of `pipe` holds layers [s*L/P, (s+1)*L/P) (the trainer slices them,
`pipeline_param_sharding`).  The schedule runs the M microbatches of
this rank's batch through the stages: M + P - 1 ticks, stage s working
on microbatch t - s at tick t, each activation sent to the next stage
(`send_to` / `recv_from`, host-staged under gloo).  The last stage's
output then reaches every pipe rank by a broadcast, as the JAX `psum`
of the masked output gives it.

The JAX backward is `jax.grad` through the scan (`ppermute` transposes
to the reverse rotation).  Autograd through blocking send/recv could
deadlock here, so `_GPipe` is one `torch.autograd.Function` with an
explicit backward schedule: each stage keeps its inputs and outputs per
microbatch (only the inputs with `remat`, recomputing the outputs), the
cotangent of the broadcast output is summed over `pipe` at the last
stage, and the microbatches run in reverse, `torch.autograd.backward`
per microbatch, each input's gradient sent to the stage before.

Each stage's output is cast to the input's dtype, in the pipeline and
in `_sequential` alike (the JAX scan carry keeps one dtype).  At pipe =
1, and in export mode, the stack runs as `_sequential`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from elasticdl_tpu_torch.parallel import collectives
from elasticdl_tpu_torch.parallel.mesh import (
    PIPE_AXIS,
    in_export_mode,
)

Stack = Dict[str, torch.Tensor]


def _layers(stack: Stack) -> int:
    return next(iter(stack.values())).shape[0]


def _sequential(apply_fn: Callable, stack: Stack, x: torch.Tensor):
    """Reference semantics: the stack's layers applied in order."""
    h = x
    for i in range(_layers(stack)):
        h = apply_fn({name: leaf[i] for name, leaf in stack.items()},
                     h).to(x.dtype)
    return h


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, *leaves):
        apply_fn, names, mesh, mcount, remat = plan
        stages, stage = mesh.shape[PIPE_AXIS], mesh.coords[PIPE_AXIS]
        prev = mesh.rank_at({PIPE_AXIS: stage - 1}) if stage else None
        nxt = mesh.rank_at({PIPE_AXIS: stage + 1}) \
            if stage < stages - 1 else None
        params = {n: leaf.detach().requires_grad_(leaf.requires_grad)
                  for n, leaf in zip(names, leaves)}
        micro = x.reshape((mcount, x.shape[0] // mcount) + x.shape[1:])
        ins, outs = [], []
        for m in range(mcount):
            h_in = micro[m] if prev is None else collectives.recv_from(
                micro[m], mesh, prev)
            h_in = h_in.detach().requires_grad_(
                prev is not None or x.requires_grad)
            with torch.set_grad_enabled(not remat):
                h_out = _sequential(apply_fn, params, h_in)
            if nxt is not None:
                collectives.send_to(h_out.detach(), mesh, nxt)
            ins.append(h_in)
            outs.append(h_out)
        out = torch.cat([h.detach() for h in outs]) if nxt is None \
            else torch.empty_like(x)
        out = collectives.axis_broadcast(out.reshape(x.shape), mesh,
                                         PIPE_AXIS, stages - 1)
        ctx.plan = plan
        ctx.state = (params, ins, outs, prev, nxt)
        ctx.x_meta = (x.shape, x.requires_grad)
        return out

    @staticmethod
    def backward(ctx, g):
        apply_fn, names, mesh, mcount, remat = ctx.plan
        params, ins, outs, prev, nxt = ctx.state
        shape, wants_dx = ctx.x_meta
        # the broadcast's transpose: every pipe rank's cotangent, summed,
        # at the last stage
        g = collectives.axis_reduce(g.contiguous(), mesh, PIPE_AXIS)
        g_micro = g.reshape((mcount, shape[0] // mcount) + tuple(shape[1:]))
        dx = [None] * mcount
        for m in reversed(range(mcount)):
            h_out = outs[m]
            if remat:
                with torch.enable_grad():
                    h_out = _sequential(apply_fn, params, ins[m])
            dh_out = g_micro[m] if nxt is None else collectives.recv_from(
                h_out.detach(), mesh, nxt)
            with torch.enable_grad():
                torch.autograd.backward(h_out, dh_out.to(h_out.dtype))
            if prev is not None:
                collectives.send_to(ins[m].grad, mesh, prev)
            elif wants_dx:
                dx[m] = ins[m].grad
        ctx.state = None
        grads = [params[n].grad if params[n].grad is not None
                 else torch.zeros_like(params[n]) for n in names]
        dx_full = torch.cat(dx).reshape(shape) \
            if wants_dx and prev is None else None
        return (dx_full, None, *grads)


def gpipe_spmd(apply_fn: Callable, stage_stack: Stack, x: torch.Tensor,
               mesh=None, num_microbatches: int = 8, remat: bool = False,
               num_layers: Optional[int] = None) -> torch.Tensor:
    """Apply a stacked layer dict to x as a pipeline over mesh[`pipe`].

    apply_fn:    (one layer's {name: tensor}, h) -> h, shape-preserving.
    stage_stack: this stage's layers, each leaf (L/P, ...).
    x:           this rank's (B_local, ...) activations.
    num_layers:  the whole stack's L, checked against the stages.

    A pipe axis of 1 (or no mesh, or export mode) is the sequential
    stack."""
    stages = 1 if mesh is None else mesh.shape[PIPE_AXIS]
    if stages == 1 or in_export_mode():
        return _sequential(apply_fn, stage_stack, x)
    total = _layers(stage_stack) * stages if num_layers is None \
        else num_layers
    if total % stages or _layers(stage_stack) != total // stages:
        raise ValueError(
            f"num_layers={total} not divisible by pipe={stages}"
            if total % stages else
            f"a stage holds {_layers(stage_stack)} layers of {total} "
            f"over pipe={stages}")
    local_batch = x.shape[0]
    if local_batch % num_microbatches:
        raise ValueError(
            f"per-data-shard batch {local_batch} not divisible by "
            f"num_microbatches={num_microbatches}")
    names = list(stage_stack)
    plan = (apply_fn, names, mesh, num_microbatches, remat)
    return _GPipe.apply(x, plan, *(stage_stack[n] for n in names))
