"""Ring attention: sequence parallelism over the mesh `seq` axis (the
port of the JAX package's ops/ring_attention.py).

Each rank of the `seq` axis holds one chunk of the sequence, in order:
position i holds tokens [i*L, (i+1)*L).  Q stays; K and V rotate around
the ring, `seq` - 1 shifts, and the blocks are merged by an online
softmax.  Dispatch is on explicit predicates, never a caught exception:

- ring size 1: `flash_attention` when `flash_shapes_ok`, else the plain
  body over the one local block;
- ring size > 1 and `flash_shapes_ok`: `_RingFlash`, one
  `torch.autograd.Function`.  Forward: each block runs
  ops/flash_attention.py::flash_attention_forward, which returns (O,
  lse); blocks merge by their lse in f32.  Causal: the diagonal block
  takes `causal=True`, blocks from earlier positions `causal=False`,
  blocks from later positions are skipped: with blocks of one length
  these are the masks of the JAX `_ring_attention_local`.  Backward: the
  same rotation again, `flash_attention_backward(q, k_blk, v_blk, O,
  lse, dO)` from the merged O and lse per block; dK and dV travel with
  their block (in f32) and land back at their owner after `seq` shifts.
  On the card every block is one launch of each kernel; on the CPU the
  custom ops run their plain versions, so this function's own rotation
  and merge run there too;
- ring size > 1 otherwise: the plain body, the JAX einsum body in torch
  (f32 accumulators), whose K/V shifts are `axis_ring_shift` (its
  backward is the reverse shift).

The flash forward returns O in the input dtype, so a bf16 ring merges
rounded partial outputs where the JAX body accumulates every block in
f32.  In export mode the ring is of one, on the whole sequence.
"""

from __future__ import annotations

from typing import Optional

import torch

from elasticdl_tpu_torch.ops.flash_attention import (
    _NEG_INF,
    flash_attention,
    flash_attention_backward,
    flash_attention_forward,
    flash_attention_reference,
    flash_shapes_ok,
)
from elasticdl_tpu_torch.parallel.collectives import (
    axis_ring_shift,
    ring_shift,
)
from elasticdl_tpu_torch.parallel.mesh import SEQ_AXIS, in_export_mode


def _ring_attention_local(q, k, v, *, causal: bool, scale: float,
                          mesh=None, axis: str = SEQ_AXIS):
    """The plain ring body: the local (B, L, H, D) Q against every K/V
    block of the ring (one block without a mesh), online softmax
    accumulated in f32, K and V shifted by `axis_ring_shift`."""
    ring = 1 if mesh is None else mesh.shape[axis]
    my = 0 if mesh is None else mesh.coords[axis]
    batch, q_len, heads, dim = q.shape
    k_len = k.shape[1]
    f = torch.float32
    dev = q.device
    q_pos = my * q_len + torch.arange(q_len, device=dev)
    m = torch.full((batch, heads, q_len), _NEG_INF, dtype=f, device=dev)
    l = torch.zeros((batch, heads, q_len), dtype=f, device=dev)
    o = torch.zeros((batch, heads, q_len, dim), dtype=f, device=dev)
    k_cur, v_cur = k, v
    for step in range(ring):
        # the block held now arrived from position (my - step) mod ring
        src = (my - step) % ring
        logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f),
                              k_cur.to(f)) * scale
        if causal:
            k_pos = src * k_len + torch.arange(k_len, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask, logits,
                                 torch.full_like(logits, _NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # guard fully-masked rows: keep their weights at zero
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
        correction = torch.exp(m - m_new)
        l = l * correction + p.sum(dim=-1)
        o = o * correction[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v_cur.to(f))
        m = m_new
        if step < ring - 1:
            k_cur = axis_ring_shift(k_cur, mesh, axis)
            v_cur = axis_ring_shift(v_cur, mesh, axis)
    out = o / torch.clamp_min(l, 1e-30)[..., None]         # (B, H, Lq, D)
    return out.transpose(1, 2).to(q.dtype)                 # (B, Lq, H, D)


def _merge(out, lse, block_out, block_lse):
    """Fold one block's (O, lse) into the running f32 (O, lse)."""
    block_out = block_out.float()
    if out is None:
        return block_out, block_lse
    new = torch.logaddexp(lse, block_lse)
    return (out * torch.exp(lse - new)[..., None]
            + block_out * torch.exp(block_lse - new)[..., None]), new


def _shift_pair(a, b, mesh, axis):
    """Shift two tensors of one shape and dtype in one message."""
    both = ring_shift(torch.stack([a, b]), mesh, axis)
    return both[0], both[1]


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        ring, my = mesh.shape[axis], mesh.coords[axis]
        out = lse = None
        k_cur, v_cur = k, v
        for step in range(ring):
            src = (my - step) % ring
            if not (causal and src > my):
                block = flash_attention_forward(
                    q, k_cur, v_cur, causal and src == my, scale)
                out, lse = _merge(out, lse, *block)
            if step < ring - 1:
                k_cur, v_cur = _shift_pair(k_cur, v_cur, mesh, axis)
        out = out.to(q.dtype)
        lse = lse.contiguous()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal, scale = ctx.args
        ring, my = mesh.shape[axis], mesh.coords[axis]
        f = torch.float32
        dq = torch.zeros(q.shape, dtype=f, device=q.device)
        dk = torch.zeros(k.shape, dtype=f, device=k.device)
        dv = torch.zeros(v.shape, dtype=f, device=v.device)
        k_cur, v_cur = k, v
        for step in range(ring):
            src = (my - step) % ring
            if not (causal and src > my):
                dq_b, dk_b, dv_b = flash_attention_backward(
                    q, k_cur, v_cur, out, lse, g, causal and src == my,
                    scale)
                dq += dq_b.float()
                dk += dk_b.float()
                dv += dv_b.float()
            if step < ring - 1:
                k_cur, v_cur = _shift_pair(k_cur, v_cur, mesh, axis)
            # dK and dV ride with their block: `ring` shifts bring them
            # home
            dk, dv = _shift_pair(dk, dv, mesh, axis)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_self_attention(
    q, k, v, mesh=None, causal: bool = False, scale: Optional[float] = None,
    seq_axis: str = SEQ_AXIS,
):
    """Sequence-parallel attention over `mesh`'s `seq_axis`.

    q/k/v: this rank's (B, L_local, H, D) chunks; returns its chunk of
    the output.  `mesh` is None or a ProcessMesh (anything with `shape`
    and `coords` mappings); a ring of one is plain one-device
    attention."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    ring = 1 if mesh is None or in_export_mode() \
        else int(mesh.shape[seq_axis])
    if ring == 1:
        if flash_shapes_ok(q.shape, k.shape):
            return flash_attention(q, k, v, causal=causal, scale=scale)
        return _ring_attention_local(q, k, v, causal=causal, scale=scale)
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal ring attention needs Q and K chunks of one length; "
            f"got {q.shape[1]} and {k.shape[1]}")
    if flash_shapes_ok(q.shape, k.shape):
        return _RingFlash.apply(q, k, v, mesh, seq_axis, causal, scale)
    return _ring_attention_local(q, k, v, causal=causal, scale=scale,
                                 mesh=mesh, axis=seq_axis)


def full_attention_reference(q, k, v, causal: bool = False,
                             scale: Optional[float] = None):
    """O(L^2) single-device attention — the numerical reference."""
    return flash_attention_reference(q, k, v, causal=causal, scale=scale)[0]
