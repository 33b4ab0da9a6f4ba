"""A stacked block repeated `num_layers` times and applied as a GPipe
pipeline over the mesh `pipe` axis (the port of the JAX package's
layers/pipeline.py; the schedule is ops/pipeline.py).

The whole stack is one parameter subtree, `gpipe_stack`, mirroring the
block's own tree with a leading layer axis on every leaf (`gpipe_stack.
attention.qkv.weight` is (L, out, in); the flax tree's `gpipe_stack/
attention/qkv/kernel` is (L, in, out)).  So:

- `pipeline_param_sharding` shards every leaf over `pipe` on that axis:
  stage s holds its contiguous slice of layers, and the optimizer state
  mirrors it;
- the parameter tree is the same whatever the mesh: at pipe = 1 the
  stack runs sequentially, so checkpoints move between pipelined and
  flat meshes.

The block runs through `torch.func.functional_call` on a template (one
layer's module, not registered, so its own parameters are never
trained or saved), one layer's slice of the stack at a time.  The block
must be shape-preserving and mesh-free (local attention and a dense
MLP, not ring attention).
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.ops.pipeline import gpipe_spmd
from elasticdl_tpu_torch.parallel.mesh import PIPE_AXIS, get_current_mesh

logger = get_logger(__name__)

STACK = "gpipe_stack"


class _Stack(nn.Module):
    """A bare tree of stacked parameters (no reset_parameters of its
    own: `GPipeBlocks.reset_parameters` draws every layer)."""


def _stacked_tree(block: nn.Module, num_layers: int) -> _Stack:
    root = _Stack()
    for name, param in block.named_parameters():
        *scope, leaf = name.split(".")
        node = root
        for part in scope:
            if not hasattr(node, part):
                node.add_module(part, _Stack())
            node = getattr(node, part)
        node.register_parameter(leaf, nn.Parameter(torch.empty(
            (num_layers,) + tuple(param.shape), dtype=param.dtype)))
    return root


class GPipeBlocks(nn.Module):
    """num_layers x block_factory(), pipelined over `pipe`."""

    def __init__(self, block_factory: Callable[[], nn.Module],
                 num_layers: int, num_microbatches: int = 8,
                 remat: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.num_microbatches = num_microbatches
        self.remat = remat
        # the one-layer template functional_call runs (not a submodule)
        object.__setattr__(self, "_block", block_factory())
        self.gpipe_stack = _stacked_tree(self._block, num_layers)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """Each layer drawn from the block's own initialisers, in layer
        order (flax draws them by a vmapped init)."""
        stack = dict(self.gpipe_stack.named_parameters())
        device = next(iter(stack.values())).device
        layer = copy.deepcopy(self._block).to(device)
        with torch.no_grad():
            for i in range(next(iter(stack.values())).shape[0]):
                for module in layer.modules():
                    if hasattr(module, "reset_parameters"):
                        module.reset_parameters(generator)
                for name, value in layer.named_parameters():
                    stack[name][i].copy_(value)

    def _apply_one(self, params, h):
        return functional_call(self._block, params, (h,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = get_current_mesh()
        stages = mesh.shape[PIPE_AXIS]
        stack = dict(self.gpipe_stack.named_parameters())
        # microbatches divide this data shard's batch
        local = max(x.shape[0], 1)
        mcount = min(self.num_microbatches, local) if stages > 1 else 1
        while local % mcount:
            mcount -= 1
        if stages > 1 and mcount != self.num_microbatches:
            # clamped to a divisor of the local batch; at mcount=1 the
            # schedule runs one stage at a time (bubble (P-1)/P)
            logger.warning(
                "GPipeBlocks: num_microbatches=%d does not divide the "
                "per-data-shard batch %d; running with %d microbatches "
                "(pipeline bubble %.0f%%)", self.num_microbatches, local,
                mcount, 100.0 * (stages - 1) / (mcount + stages - 1))
        return gpipe_spmd(self._apply_one, stack, x, mesh,
                          num_microbatches=mcount, remat=self.remat,
                          num_layers=self.num_layers)


def pipeline_param_sharding(name: str, value):
    """The spec of a GPipeBlocks leaf: layer-sharded over `pipe` on its
    leading axis.  The name is distinctive on purpose: a generic `stack`
    would mis-shard an unrelated parameter."""
    if STACK in name.split("."):
        return (PIPE_AXIS,) + (None,) * (getattr(value, "ndim", 1) - 1)
    return None
