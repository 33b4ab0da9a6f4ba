"""Flash attention for one device: the Hopper kernels, their plain
version, and the autograd Function around them.

Two kernels replace the Pallas TPU kernel `_fwd_kernel` of
elasticdl_tpu/ops/flash_attention.py.  Both compute the same function:
per head, softmax(Q K^T * scale) V by an online softmax (running max,
normaliser, f32 accumulator), with O in the input type and the
log-sum-exp in f32.  q/k/v stay in the model's (B, L, H, D) layout, read
in place with their own batch and row strides.

- `sm90_wgmma` (`csrc/flash_attention_fwd_sm90.cu`): TMA loads and wgmma
  on the tensor cores, for the inputs `tensor_core_ok` accepts (bf16,
  D = 64 or 128, 16-byte aligned pointers and strides).
- `cuda_core` (`csrc/flash_attention_fwd.cu`): f32 FMAs on the CUDA cores,
  for every other input the shapes allow (f32, other D, unaligned views).

The choice is the explicit predicate `tensor_core_ok`, never a caught
exception: a kernel that fails to build or launch raises.  Each source
says what bounds it and how it is laid out.

`flash_attention_forward` is the wrapper: on a CUDA tensor it launches
one of the kernels (or raises), and counts the launch in
`flash_attention.launches` and, per variant, in
`flash_attention.launches_by_kernel`; on a CPU tensor it takes
`flash_attention_reference`, the plain O(L^2) version, which returns the
same (out, lse).  Nothing falls back from the card to the plain version.

The backward (`flash_attention_backward`, under `_Flash.backward`) is a
recompute from the saved log-sum-exp, the function of the JAX package's
`_flash_bwd` (jnp there, compiled by XLA).  On a CUDA tensor it runs a
hand kernel (three launches: a delta pass, dK/dV, dQ; no atomics, so the
same bits from run to run) in one of two variants, picked by the
predicate `backward_wgmma_ok`:

- `sm90_wgmma` (`csrc/flash_attention_bwd_sm90.cu`): TMA loads and wgmma
  on the tensor cores, for bf16 at D = 64 or 128 where q, k, v, O and dO
  all meet the forward's TMA rules;
- `cuda_core` (`csrc/flash_attention_bwd.cu`): f32 FMAs, for every other
  input the shapes allow.

It counts each call in `flash_attention.backward_launches` and, per
variant, `flash_attention.backward_launches_by_kernel`.  On a CPU tensor
it takes the plain `_flash_bwd`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from elasticdl_tpu_torch.ops import _build

_NEG_INF = -1e30
SOURCE = "flash_attention_fwd.cu"
SOURCE_SM90 = "flash_attention_fwd_sm90.cu"
SOURCE_BWD = "flash_attention_bwd.cu"
SOURCE_BWD_SM90 = "flash_attention_bwd_sm90.cu"
CUDA_CORE = "cuda_core"
SM90_WGMMA = "sm90_wgmma"
MAX_HEAD_DIM = 128
TENSOR_CORE_HEAD_DIMS = (64, 128)
_MAX_GRID_YZ = 65535  # heads and batch are the grid's y and z
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIB_LOCK = threading.Lock()
_LIBS = {}


def _library(variant: str = CUDA_CORE):
    """The loaded library of one variant, built first if needed.  The
    CUDA-core entry takes a dtype code; the wgmma entry does not."""
    with _LIB_LOCK:
        lib = _LIBS.get(variant)
        if lib is None:
            if variant == CUDA_CORE:
                lib = _build.load_library(SOURCE)
                fn = lib.flash_attention_fwd
                ints = 6
            else:
                lib = _build.load_library(SOURCE_SM90)
                fn = lib.flash_attention_fwd_sm90
                ints = 5
            fn.argtypes = (
                [ctypes.c_void_p] * 5
                + [ctypes.c_int] * ints
                + [ctypes.c_longlong] * 6
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            _LIBS[variant] = lib
        return lib


# backward variant -> (source, C entry, pointers, ints): the CUDA-core
# entry takes a dtype code and no lse2 scratch, the wgmma entry the reverse
_BWD_ENTRIES = {
    CUDA_CORE: (SOURCE_BWD, "flash_attention_bwd", 10, 6),
    SM90_WGMMA: (SOURCE_BWD_SM90, "flash_attention_bwd_sm90", 11, 5),
}


def _backward_library(variant: str = CUDA_CORE):
    """The loaded backward library of one variant, built first if
    needed."""
    source, entry, pointers, ints = _BWD_ENTRIES[variant]
    with _LIB_LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = _build.load_library(source)
            fn = getattr(lib, entry)
            fn.argtypes = (
                [ctypes.c_void_p] * pointers
                + [ctypes.c_int] * ints
                + [ctypes.c_longlong] * 10
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            _LIBS[source] = lib
        return lib


def _hd_contiguous(x) -> bool:
    """Whether a (B, L, H, D) tensor's (H, D) dims are contiguous."""
    return x.stride(3) == 1 and x.stride(2) == x.shape[3]


def _bf16_rows_aligned(x, dim: int) -> bool:
    """Whether x is a bf16 (B, L, H, dim) tensor with contiguous (H, D)
    dims, a 16-byte aligned base pointer, and row and batch strides that
    are multiples of 16 bytes (8 elements)."""
    return (x.dtype == torch.bfloat16 and x.dim() == 4
            and x.shape[3] == dim and _hd_contiguous(x)
            and x.data_ptr() % 16 == 0
            and x.stride(1) % 8 == 0 and x.stride(0) % 8 == 0)


def _tma_ok(x, dim: int) -> bool:
    """Whether TMA can describe x as a bf16 (B, L, H, dim) tensor map:
    `_bf16_rows_aligned`, rows that do not overlap and, at B > 1,
    batches that do not either."""
    if not _bf16_rows_aligned(x, dim):
        return False
    batch, length, heads, _ = x.shape
    return (x.stride(1) >= heads * dim
            and (batch == 1 or x.stride(0) >= length * x.stride(1)))


def tensor_core_ok(q, k, v) -> bool:
    """Whether the wgmma kernel takes these (B, L, H, D) tensors: bf16
    throughout, D in TENSOR_CORE_HEAD_DIMS, the (H, D) dims contiguous,
    and what TMA needs of a tensor map: a 16-byte aligned base pointer and
    row and batch strides that are multiples of 16 bytes (8 elements),
    rows that do not overlap and, at B > 1, batches that do not either.
    Reads only metadata, so it answers for CPU tensors too."""
    return (q.dim() == 4 and q.shape[-1] in TENSOR_CORE_HEAD_DIMS
            and all(_tma_ok(x, q.shape[3]) for x in (q, k, v)))


def backward_wgmma_ok(q, k, v, out, g) -> bool:
    """Whether the wgmma backward takes these (B, L, H, D) tensors:
    `tensor_core_ok(q, k, v)` and the same TMA rules on the forward's
    output and its gradient.  Reads only metadata, so it answers for CPU
    tensors too."""
    return (tensor_core_ok(q, k, v)
            and all(_tma_ok(x, q.shape[3]) for x in (out, g)))


def flash_shapes_ok(q_shape, k_shape) -> bool:
    """Whether (B, L, H, D) q/k shapes are within the Hopper kernel's
    limits: Lq and Lk multiples of 8 (the kernel masks the ragged last
    64-row tile), 1 <= D <= 128 (its register tile), matching batch and
    head counts, and B and H within the launch grid.  Unlike the JAX
    predicate there is no K/V residency ceiling: K and V stream through
    shared memory one 64-row tile at a time, whatever L is."""
    batch, q_len, heads, dim = q_shape
    return (
        len(k_shape) == 4
        and k_shape[0] == batch
        and tuple(k_shape[2:]) == (heads, dim)
        and q_len > 0 and q_len % 8 == 0
        and k_shape[1] > 0 and k_shape[1] % 8 == 0
        and 0 < dim <= MAX_HEAD_DIM
        and 0 < batch <= _MAX_GRID_YZ
        and 0 < heads <= _MAX_GRID_YZ
    )


def flash_attention_reference(
    q, k, v, causal: bool = False, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain O(L^2) attention returning the kernel's (out, lse): out
    (B, Lq, H, D) in q's dtype, lse (B, Lq, H) in f32.  Products take
    f32 operands, as the JAX reference's preferred_element_type=f32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_len, k_len = q.shape[1], k.shape[1]
        mask = (
            torch.arange(q_len, device=q.device)[:, None]
            >= torch.arange(k_len, device=q.device)[None, :]
        )
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    lse = torch.logsumexp(logits, dim=-1)                  # (B, H, Lq)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    return out.to(q.dtype), lse.transpose(1, 2).contiguous()


def _check_shapes(q, k, v) -> None:
    # The SAME predicate callers dispatch on; a separate inline copy here
    # could drift from flash_shapes_ok.
    if (q.dim() != 4 or not flash_shapes_ok(q.shape, k.shape)
            or k.shape != v.shape):
        raise ValueError(
            f"flash_attention needs (B, L, H, D) q and k/v with L a "
            f"multiple of 8 for BOTH q and k/v, k.shape == v.shape, "
            f"matching B and H, and D <= {MAX_HEAD_DIM}; got "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )


def _kernel_forward(q, k, v, causal: bool, scale: float):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(
                "flash_attention needs q, k and v on one device with one "
                f"dtype; {name} is {x.dtype} on {x.device}, q is "
                f"{q.dtype} on {q.device}"
            )
        if not _hd_contiguous(x):
            raise ValueError(
                f"flash_attention needs the (H, D) dims of {name} "
                f"contiguous; got strides {tuple(x.stride())}"
            )
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"flash_attention kernel takes float32 or bfloat16, not "
            f"{q.dtype}"
        )
    batch, q_len, heads, dim = q.shape
    k_len = k.shape[1]
    out = torch.empty((batch, q_len, heads, dim), dtype=q.dtype,
                      device=q.device)
    lse = torch.empty((batch, q_len, heads), dtype=torch.float32,
                      device=q.device)
    variant = SM90_WGMMA if tensor_core_ok(q, k, v) else CUDA_CORE
    lib = _library(variant)
    if variant == SM90_WGMMA:
        fn, dtype_arg = lib.flash_attention_fwd_sm90, ()
    else:
        fn, dtype_arg = lib.flash_attention_fwd, (_DTYPE_CODES[q.dtype],)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            *dtype_arg, batch, heads, q_len, k_len, dim,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1),
            float(scale), int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention {variant} kernel launch failed with error "
            f"{err} for q {tuple(q.shape)} {q.dtype}"
        )
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[variant] += 1
    return out, lse


def flash_attention_forward(
    q, k, v, causal: bool = False, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) for (B, L, H, D) q/k/v: the Hopper kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _kernel_forward(q, k, v, causal, scale)


def _flash_bwd(causal: bool, scale: float, residuals, g):
    """Flash backward by recompute: probabilities are rebuilt from the
    saved log-sum-exp, so nothing O(L^2) was saved.  Operands are cast
    to the input dtype where the JAX version casts, and every product
    takes f32 operands (preferred_element_type=f32 there)."""
    q, k, v, out, lse = residuals               # lse: (B, Lq, H)
    g = g.to(q.dtype)
    f = torch.float32
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f), k.to(f)) * scale
    if causal:
        q_len, k_len = q.shape[1], k.shape[1]
        mask = (
            torch.arange(q_len, device=q.device)[:, None]
            >= torch.arange(k_len, device=q.device)[None, :]
        )
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    p = torch.exp(logits - lse.transpose(1, 2)[..., None])
    pc = p.to(q.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", pc.to(f), g.to(f))
    dp = torch.einsum("bqhd,bkhd->bhqk", g.to(f), v.to(f))
    delta = (g.to(f) * out.to(f)).sum(-1).transpose(1, 2)[..., None]
    ds = (p * (dp - delta) * scale).to(q.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(f), k.to(f))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(f), q.to(f))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_backward(q, k, v, out, lse, g, causal: bool, scale: float):
    # O and dO are read with their own strides but need their (H, D)
    # dims contiguous; q, k and v are the caller's views and must be so
    g = g.to(q.dtype)
    if not _hd_contiguous(g):
        g = g.contiguous()
    if not _hd_contiguous(out):
        out = out.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out), ("g", g)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(
                "flash_attention backward needs q, k, v, out and g on one "
                f"device with one dtype; {name} is {x.dtype} on "
                f"{x.device}, q is {q.dtype} on {q.device}")
        if not _hd_contiguous(x):
            raise ValueError(
                f"flash_attention backward needs the (H, D) dims of {name} "
                f"contiguous; got strides {tuple(x.stride())}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"flash_attention backward kernel takes float32 or bfloat16, "
            f"not {q.dtype}")
    batch, q_len, heads, dim = q.shape
    k_len = k.shape[1]
    if (tuple(out.shape) != tuple(q.shape)
            or tuple(g.shape) != tuple(q.shape)
            or tuple(lse.shape) != (batch, q_len, heads)
            or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(
            f"flash_attention backward needs out and g shaped like q "
            f"{tuple(q.shape)} and a contiguous f32 lse of "
            f"{(batch, q_len, heads)}; got out {tuple(out.shape)}, g "
            f"{tuple(g.shape)}, lse {tuple(lse.shape)} {lse.dtype}")
    dq = torch.empty((batch, q_len, heads, dim), dtype=q.dtype,
                     device=q.device)
    dk = torch.empty((batch, k_len, heads, dim), dtype=q.dtype,
                     device=q.device)
    dv = torch.empty_like(dk)
    # (B, H, Lq) f32 scratch: delta and, for the wgmma kernel, lse *
    # log2(e) in a layout TMA can describe
    delta = torch.empty((batch, heads, q_len), dtype=torch.float32,
                        device=q.device)
    variant = SM90_WGMMA if backward_wgmma_ok(q, k, v, out, g) else CUDA_CORE
    lib = _backward_library(variant)
    if variant == SM90_WGMMA:
        fn, dtype_arg = lib.flash_attention_bwd_sm90, ()
        scratch = (delta, torch.empty_like(delta))
    else:
        fn, dtype_arg = lib.flash_attention_bwd, (_DTYPE_CODES[q.dtype],)
        scratch = (delta,)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), *(t.data_ptr() for t in scratch),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *dtype_arg, batch, heads, q_len, k_len, dim,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            g.stride(0), g.stride(1),
            float(scale), int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention backward {variant} kernel launch failed with "
            f"error {err} for q {tuple(q.shape)} {q.dtype}")
    flash_attention.backward_launches += 1
    flash_attention.backward_launches_by_kernel[variant] += 1
    return dq, dk, dv


def flash_attention_backward(
    q, k, v, out, lse, g, causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention from the forward's residuals
    (q, k, v, out, lse) and the output gradient g: the Hopper kernel for
    CUDA tensors, the plain `_flash_bwd` for CPU tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return _flash_bwd(causal, scale, (q, k, v, out, lse), g)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _kernel_backward(q, k, v, out, lse, g, causal, scale)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        # under a non-reentrant checkpoint this runs again in the
        # backward, and the recompute's out and lse are the ones saved
        out, lse = flash_attention_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, g,
                                              ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q, k, v, causal: bool = False, scale: Optional[float] = None
) -> torch.Tensor:
    """Single-device flash attention; q/k/v: (B, L, H, D) -> (B, L, H, D).

    Differentiable (flash recompute backward).  Sequence lengths must be
    multiples of 8 and D <= 128 (`flash_shapes_ok`).  On a CUDA tensor
    the forward and the backward are Hopper kernels (`tensor_core_ok` and
    `backward_wgmma_ok` pick the variants);
    `flash_attention.launches` and `flash_attention.backward_launches`
    count the calls, and the `..._by_kernel` dicts split them by variant.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Flash.apply(q, k, v, causal, scale)


flash_attention.launches = 0
flash_attention.launches_by_kernel = {SM90_WGMMA: 0, CUDA_CORE: 0}
flash_attention.backward_launches = 0
flash_attention.backward_launches_by_kernel = {SM90_WGMMA: 0, CUDA_CORE: 0}


def reset_launch_counts() -> None:
    """Sets the forward's and the backward's totals and every
    per-variant launch count to 0."""
    flash_attention.launches = 0
    flash_attention.backward_launches = 0
    for counts in (flash_attention.launches_by_kernel,
                   flash_attention.backward_launches_by_kernel):
        for variant in counts:
            counts[variant] = 0
