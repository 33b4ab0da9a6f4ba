"""Self-attention entry point of the BERT zoo, single-device slice.

The JAX package's `ring_self_attention` shards the sequence over the
mesh `seq` axis and rotates K/V blocks around a ring.  This slice ports
the case the single card runs: a seq axis of size 1, where every K/V
block is local.  As in the JAX version it dispatches on an explicit
shape check: shapes the flash kernel takes go to `flash_attention`,
others to the one-block online-softmax body in plain PyTorch.  A mesh
whose seq axis spans more than one device raises NotImplementedError:
the ring over torch.distributed comes with the parallel-layer slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from elasticdl_tpu_torch.ops.flash_attention import (
    _NEG_INF,
    flash_attention,
    flash_attention_reference,
    flash_shapes_ok,
)

SEQ_AXIS = "seq"


def _ring_attention_local(q, k, v, *, causal: bool, scale: float):
    """The ring body at ring size 1: one online-softmax step over the
    local K/V block (B, L, H, D), accumulated in f32."""
    q_len, k_len = q.shape[1], k.shape[1]
    f = torch.float32
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f), k.to(f)) * scale
    if causal:
        mask = (
            torch.arange(q_len, device=q.device)[:, None]
            >= torch.arange(k_len, device=q.device)[None, :]
        )
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    m = torch.clamp_min(logits.amax(dim=-1), _NEG_INF)
    # guard fully-masked rows: keep their weights at zero
    p = torch.exp(logits - m[..., None])
    p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.to(f))
    out = o / torch.clamp_min(l, 1e-30)[..., None]          # (B, H, Lq, D)
    return out.transpose(1, 2).to(q.dtype)                 # (B, Lq, H, D)


def ring_self_attention(
    q, k, v, mesh=None, causal: bool = False, scale: Optional[float] = None,
    seq_axis: str = SEQ_AXIS,
):
    """Attention over (B, L, H, D) q/k/v on one device.

    `mesh` is None or anything with a `shape` mapping of axis sizes; a
    `seq_axis` of size > 1 is the sequence-parallel ring, which this
    slice does not have."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    ring_size = 1 if mesh is None else int(mesh.shape[seq_axis])
    if ring_size != 1:
        raise NotImplementedError(
            f"ring attention over a '{seq_axis}' axis of {ring_size} "
            "devices comes with the parallel-layer slice of the port "
            "(a torch.distributed ring); this slice is single-device"
        )
    # Explicit dispatch on the kernel's own predicate, never a try/except
    # around the kernel call.
    if flash_shapes_ok(q.shape, k.shape):
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return _ring_attention_local(q, k, v, causal=causal, scale=scale)


def full_attention_reference(q, k, v, causal: bool = False,
                             scale: Optional[float] = None):
    """O(L^2) single-device attention — the numerical reference."""
    return flash_attention_reference(q, k, v, causal=causal, scale=scale)[0]
