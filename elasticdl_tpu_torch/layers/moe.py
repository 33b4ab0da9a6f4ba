"""Switch Mixture-of-Experts feed-forward with expert parallelism over the
mesh `expert` axis (the port of the JAX package's layers/moe.py).

The JAX layer is traced at global shapes: its capacity comes from the
global token count, and a token's slot from a cumsum over every token of
the global batch in (b, l) order.  Here a rank holds one data shard's
rows (the same tokens on every `expert` position of its data
coordinate), and on a `seq` axis one chunk of their positions, so:

- top-1 router, softmax gates, dense one-hot dispatch and combine with
  static capacity `ceil(tokens * capacity_factor / experts)` over the
  GLOBAL token count, as in JAX;
- a token's slot = its cumsum within the shard plus the counts of its
  expert in the data shards before it: one all_gather over `data` of
  each shard's per-expert counts (and token count) gives that exclusive
  prefix, the global count and the global density of the aux loss;
- on a `seq` axis the tokens before a token (b, l) of a data shard are
  every token of its earlier rows, then the earlier chunks of row b,
  then its own chunk's prefix: one all_gather over `seq` of each
  chunk's per-row, per-expert counts gives the first two, and the
  shard's counts for the exchange over `data`;
- the expert stacks (`expert_w_in` (E, H, F), `expert_b_in`,
  `expert_w_out`, `expert_b_out`) are sharded over `expert` on their
  leading dim (`moe_param_sharding`): a rank runs its E/expert experts
  over their C slots.  A slot holds exactly one token of the global
  batch, so the slots this shard's tokens fill hold the same values in
  this shard's partial `expert_in` as in the global one, and combine
  reads no other slot: no activation crosses `data`;
- combine: each rank adds its experts' outputs for its tokens, and an
  `axis_sum` over `expert` gives every expert's (the exchange the XLA
  partitioner emits in the JAX step);
- the Switch aux loss (coef * E * sum(density * mean gate)) over the
  global tokens: the density from the gathered counts, the mean gate
  through an `axis_sum` over `data` and `seq`.  flax `sow`s it; here the
  layer keeps it in `aux_loss`, and the trainer adds
  `collect_aux_loss(model)` to the objective (JAX worker/trainer.py
  `_sown_aux_loss`).

Overflowing tokens get zeros (standard Switch semantics: callers add
the residual); the global order decides which.  The MoE einsums are
plain products, as in the JAX layer, which XLA compiles outside any
Pallas kernel.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Optional

import torch
from torch import nn

from elasticdl_tpu_torch.layers.linen import Dense, _TRUNC_STD
from elasticdl_tpu_torch.parallel import collectives
from elasticdl_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    SEQ_AXIS,
    get_current_mesh,
)

_EXPERT_PARAMS = ("expert_w_in", "expert_b_in", "expert_w_out",
                  "expert_b_out")


def _lecun_normal_stack_(weight: torch.Tensor, generator=None):
    """flax lecun_normal on an (E, in, out) stack: fan_in = in * E (flax
    counts the leading dim as receptive field), truncated at 2 std."""
    fan_in = weight.shape[-2] * math.prod(weight.shape[:-2])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def expert_capacity(n_tokens, num_experts: int,
                    capacity_factor: float):
    """Slots per expert, max(1, ceil(n_tokens * factor / experts)), in
    integer arithmetic on the factor's exact fraction (the JAX float
    formula's value; an int or a symbolic size alike)."""
    frac = Fraction(capacity_factor)
    cap = -((-n_tokens * frac.numerator)
            // (frac.denominator * num_experts))
    return torch.sym_max(cap, 1) if isinstance(cap, torch.SymInt) \
        else max(cap, 1)


class MoEMLP(nn.Module):
    """Top-1 (Switch) MoE feed-forward block: (..., hidden) -> (...,
    hidden), the parameters of the JAX `MoEMLP` under its names."""

    def __init__(self, hidden: int, num_experts: int, ffn_dim: int,
                 capacity_factor: float = 1.25, aux_loss_coef: float = 0.01,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.aux_loss_coef = aux_loss_coef
        self.compute_dtype = compute_dtype
        self.router = Dense(hidden, num_experts)
        self.expert_w_in = nn.Parameter(
            torch.empty(num_experts, hidden, ffn_dim))
        self.expert_b_in = nn.Parameter(torch.zeros(num_experts, ffn_dim))
        self.expert_w_out = nn.Parameter(
            torch.empty(num_experts, ffn_dim, hidden))
        self.expert_b_out = nn.Parameter(torch.zeros(num_experts, hidden))
        # the last training forward's aux loss (flax's sown value)
        self.aux_loss: Optional[torch.Tensor] = None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _lecun_normal_stack_(self.expert_w_in, generator)
        _lecun_normal_stack_(self.expert_w_out, generator)
        with torch.no_grad():
            self.expert_b_in.zero_()
            self.expert_b_out.zero_()

    def _experts_here(self, mesh):
        """(first expert, count) of the stacks this rank holds."""
        here = self.expert_w_in.shape[0]
        if here == self.num_experts:
            return 0, here
        if here * mesh.shape[EXPERT_AXIS] != self.num_experts:
            raise ValueError(
                f"{here} of {self.num_experts} experts is not a shard over "
                f"'{EXPERT_AXIS}' of size {mesh.shape[EXPERT_AXIS]}")
        return mesh.coords[EXPERT_AXIS] * here, here

    def _seq_positions(self, onehot: torch.Tensor, rows: int, mesh):
        """(inclusive count of each token's expert up to it within this
        data shard (N, E), the shard's per-expert counts (E,)) for tokens
        (rows, chunk) of a `seq` chunk, in the global (b, l) order."""
        per_row = onehot.reshape(rows, -1, onehot.shape[-1])  # (b, l, E)
        row_counts = per_row.sum(dim=1)                       # (b, E)
        chunks = collectives.all_gather(row_counts[None], mesh, SEQ_AXIS)
        row_totals = chunks.sum(dim=0)
        before = (torch.cumsum(row_totals, dim=0) - row_totals
                  + chunks[:mesh.coords[SEQ_AXIS]].sum(dim=0))
        cum = torch.cumsum(per_row, dim=1) + before[:, None, :]
        return cum.reshape(onehot.shape), row_totals.sum(dim=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = get_current_mesh()
        seq_split = mesh.axis_group(SEQ_AXIS) is not None
        if seq_split and x.dim() != 3:
            raise ValueError(
                f"MoEMLP on a '{SEQ_AXIS}' axis takes (batch, sequence "
                f"chunk, hidden) tokens, got shape {tuple(x.shape)}")
        *batch_dims, hidden = x.shape
        experts = self.num_experts
        tokens = x.reshape(-1, hidden)                      # (N, H)
        logits = self.router(tokens.float())                # (N, E)
        probs = torch.softmax(logits, dim=-1)
        expert_idx = probs.argmax(dim=-1)                   # (N,)
        gate = probs.gather(1, expert_idx[:, None])[:, 0]   # (N,)
        onehot = (expert_idx[:, None] == torch.arange(
            experts, device=x.device)).to(torch.int64)      # (N, E)

        # each token's count of its expert so far in this data shard,
        # the shard's counts; then the global token count and, per
        # expert, the counts of the data shards before this one (an
        # exclusive prefix) and of all shards
        if seq_split:
            cum, counts = self._seq_positions(onehot, x.shape[0], mesh)
            n_global = tokens.shape[0] * mesh.shape[SEQ_AXIS]
        else:
            cum, counts = torch.cumsum(onehot, dim=0), onehot.sum(dim=0)
            n_global = tokens.shape[0]
        prefix = 0
        if mesh.axis_group(DATA_AXIS) is not None:
            local = torch.cat([counts, torch.tensor([n_global],
                                                    device=x.device)])
            shards = collectives.all_gather(local[None], mesh, DATA_AXIS)
            prefix = shards[:mesh.coords[DATA_AXIS], :experts].sum(dim=0)
            counts = shards[:, :experts].sum(dim=0)
            n_global = int(shards[:, experts].sum())
        capacity = expert_capacity(n_global, experts, self.capacity_factor)

        position = (cum + prefix) * onehot - 1
        kept = (position >= 0) & (position < capacity)
        slot = torch.clamp(position, 0, capacity - 1)
        dispatch = ((slot[..., None] == torch.arange(
            capacity, device=x.device)) & kept[..., None]).to(tokens.dtype)
        # the gate in the tokens' dtype, as the JAX combine
        combine = (dispatch * gate[:, None, None].to(tokens.dtype)).float()

        first, here = self._experts_here(mesh)
        cd = self.compute_dtype
        expert_in = torch.einsum(
            "nec,nh->ech", dispatch[:, first:first + here].to(cd),
            tokens.to(cd))                                  # (E', C, H)
        h = torch.einsum("ech,ehf->ecf", expert_in,
                         self.expert_w_in.to(cd)) \
            + self.expert_b_in[:, None, :].to(cd)
        h = torch.relu(h)
        expert_out = torch.einsum("ecf,efh->ech", h,
                                  self.expert_w_out.to(cd)) \
            + self.expert_b_out[:, None, :].to(cd)          # (E', C, H)
        out = torch.einsum("nec,ech->nh", combine[:, first:first + here],
                           expert_out.float())
        if here < experts:
            out = collectives.axis_sum(out, mesh, EXPERT_AXIS)

        # Switch load-balancing loss over the global tokens, pre-scaled
        density = counts.float() / n_global
        density_proxy = collectives.axis_sum(
            probs.sum(dim=0), mesh, (DATA_AXIS, SEQ_AXIS)) / n_global
        self.aux_loss = (self.aux_loss_coef * experts
                         * torch.sum(density * density_proxy))
        return out.to(x.dtype).reshape(*batch_dims, hidden)


def collect_aux_loss(model: nn.Module) -> Optional[torch.Tensor]:
    """The sum of every MoE layer's aux loss from the last forward
    (cleared as it is read), or None for a model without MoE layers."""
    total = None
    for module in model.modules():
        if isinstance(module, MoEMLP) and module.aux_loss is not None:
            total = module.aux_loss if total is None \
                else total + module.aux_loss
            module.aux_loss = None
    return total


def moe_param_sharding(name: str, value) -> Optional[tuple]:
    """`param_sharding` helper: the expert stacks shard their leading
    (expert) dim over the mesh `expert` axis."""
    if any(part in _EXPERT_PARAMS for part in name.split(".")):
        ndim = getattr(value, "ndim", 0)
        if ndim >= 1:
            return (EXPERT_AXIS,) + (None,) * (ndim - 1)
    return None
