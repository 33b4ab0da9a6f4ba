"""The port's flash attention (elasticdl_tpu_torch/ops) against the JAX
package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode (off-TPU default),
the port its plain version: on a CPU tensor the wrapper never launches the
Hopper kernel.  Inputs come from numpy with a seed.  Tolerances are the
JAX tests' own: 2e-4 in f32 (two f32 accumulations in different order),
3e-2 in bf16 (the Pallas kernel rounds the probabilities to bf16 before
the PV product, the port's plain version keeps them in f32), 2e-3 for
gradients.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import flash_attention as jax_flash
from elasticdl_tpu.ops import ring_attention as jax_ring
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu_torch.ops import flash_attention as port_flash
from elasticdl_tpu_torch.ops import ring_attention as port_ring

torch.set_num_threads(2)

TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _qkv(batch=2, length=256, heads=4, dim=32, seed=0):
    rng = np.random.RandomState(seed)
    shape = (batch, length, heads, dim)
    return tuple(rng.randn(*shape).astype(np.float32) * 0.3
                 for _ in range(3))


def _both(arrays, dtype):
    jx = tuple(jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays)
    pt = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    return jx, pt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [64, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_out_and_lse_match_jax(causal, length, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(length=length), dtype)
    scale = 32 ** -0.5
    out_j, residuals = jax_flash._flash_fwd(jq, jk, jv, causal, scale)
    lse_j = residuals[4]
    out_t, lse_t = port_flash.flash_attention_forward(
        tq, tk, tv, causal=causal)
    assert out_t.dtype == tq.dtype and lse_t.dtype == torch.float32
    assert tuple(lse_t.shape) == tuple(lse_j.shape)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), rtol=tol, atol=tol)
    # the public entry returns the same output
    np.testing.assert_array_equal(
        _np(port_flash.flash_attention(tq, tk, tv, causal=causal)),
        _np(out_t))


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax(causal):
    arrays = _qkv(batch=1, length=128, heads=2, dim=16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")

    def loss(q, k, v):
        return (jax_flash.flash_attention(q, k, v, causal=causal) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    (port_flash.flash_attention(*leaves, causal=causal) ** 2).sum().backward()
    for leaf, ref in zip(leaves, want):
        np.testing.assert_allclose(_np(leaf.grad), _np(ref),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_reference_matches_jax(causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(length=72), "float32")
    np.testing.assert_allclose(
        _np(port_ring.full_attention_reference(tq, tk, tv, causal=causal)),
        _np(jax_ring.full_attention_reference(jq, jk, jv, causal=causal)),
        rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("length", [128, 100])
def test_seq1_ring_self_attention_matches_jax(length):
    """Seq axis of size 1: the JAX entry runs the Pallas kernel under
    shard_map (L=128) or the fused-lax ring body (L=100, which neither
    kernel takes); the port dispatches the same way on one device."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        _qkv(batch=8, length=length, heads=2, dim=16), "float32")
    mesh = mesh_lib.create_mesh()
    assert mesh.shape["seq"] == 1
    want = jax_ring.ring_self_attention(jq, jk, jv, mesh, causal=True)
    got = port_ring.ring_self_attention(tq, tk, tv, mesh=None, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    # a mesh object whose seq axis is 1 is the same single-device path
    seq1 = types.SimpleNamespace(shape={"data": 1, "seq": 1})
    np.testing.assert_array_equal(
        _np(port_ring.ring_self_attention(tq, tk, tv, mesh=seq1,
                                          causal=True)),
        _np(got))


# (q shape, k shape, port predicate, JAX predicate)
PREDICATE_CASES = [
    ((64, 512, 12, 64), (64, 512, 12, 64), True, True),   # the slice
    ((32, 1024, 12, 64), (32, 1024, 12, 64), True, True),
    ((8, 64, 4, 64), (8, 64, 4, 64), True, True),         # one short tile
    ((8, 512, 4, 256), (8, 512, 4, 256), False, False),   # D > 128
    ((8, 100, 4, 64), (8, 100, 4, 64), False, False),     # L % 8
    ((8, 128, 4, 64), (8, 100, 4, 64), False, False),     # Lk % 8
    # where they differ: the Hopper kernel masks a ragged last tile, and
    # streams K/V through shared memory with no residency ceiling
    ((8, 520, 4, 64), (8, 520, 4, 64), True, False),      # L % 128
    ((2, 136, 4, 32), (2, 136, 4, 32), True, False),
    ((16, 2048, 12, 64), (16, 2048, 12, 64), True, False),  # TPU VMEM cap
]


@pytest.mark.parametrize("q_shape,k_shape,port_ok,jax_ok", PREDICATE_CASES)
def test_flash_shapes_ok_cases(q_shape, k_shape, port_ok, jax_ok):
    assert port_flash.flash_shapes_ok(q_shape, k_shape) is port_ok
    assert jax_flash.flash_shapes_ok(q_shape, k_shape) is jax_ok


def test_shape_validation():
    _, (tq, tk, tv) = _both(_qkv(length=100), "float32")
    with pytest.raises(ValueError, match="multiple of 8"):
        port_flash.flash_attention(tq, tk, tv)
    _, (sq, _, _) = _both(_qkv(length=128), "float32")
    with pytest.raises(ValueError, match="BOTH q and k"):
        port_flash.flash_attention_forward(sq, tk, tv)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    _, (tq, tk, tv) = _both(_qkv(length=64), "bfloat16")
    before = port_flash.flash_attention.launches
    out, lse = port_flash.flash_attention_forward(tq, tk, tv, causal=True)
    ref_out, ref_lse = port_flash.flash_attention_reference(
        tq, tk, tv, causal=True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    port_flash.flash_attention(tq, tk, tv)
    assert port_flash.flash_attention.launches == before


def test_fused_qkv_views_match_contiguous_inputs():
    """The model hands q/k/v as column views of one QKV product (row
    stride 3*H*D); the wrapper takes them as they are."""
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(2, 64, 3 * 4 * 16).astype(np.float32))
    q, k, v = (t.unflatten(-1, (4, 16)) for t in qkv.split(64, dim=-1))
    assert q.stride(1) == 3 * 64
    out, lse = port_flash.flash_attention_forward(q, k, v)
    ref, ref_lse = port_flash.flash_attention_forward(
        q.contiguous(), k.contiguous(), v.contiguous())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-6,
                               atol=1e-6)


def _bf16_views(batch=2, length=64, heads=4, dim=64, extra=0, offset=0,
                dtype=torch.bfloat16):
    """q/k/v as column views of one fused QKV buffer whose rows are
    3*H*D + extra elements wide, starting `offset` elements in."""
    width = 3 * heads * dim + extra
    flat = torch.zeros(batch * length * width + offset, dtype=dtype)
    qkv = flat[offset:].view(batch, length, width)
    return tuple(qkv[..., i * heads * dim:(i + 1) * heads * dim]
                 .unflatten(-1, (heads, dim)) for i in range(3))


# (case, q/k/v builder, the wgmma kernel takes them)
TENSOR_CORE_CASES = [
    ("bf16-d64-contiguous",
     lambda: tuple(torch.zeros(2, 64, 4, 64, dtype=torch.bfloat16)
                   for _ in range(3)), True),
    ("bf16-d128-contiguous",
     lambda: tuple(torch.zeros(2, 72, 4, 128, dtype=torch.bfloat16)
                   for _ in range(3)), True),
    ("bf16-d64-fused-qkv-views", lambda: _bf16_views(), True),
    ("bf16-d128-fused-qkv-views", lambda: _bf16_views(dim=128), True),
    ("bf16-d64-batch-1", lambda: _bf16_views(batch=1), True),
    ("f32-d64", lambda: _bf16_views(dtype=torch.float32), False),
    ("bf16-d32", lambda: _bf16_views(dim=32), False),
    ("bf16-d16", lambda: _bf16_views(dim=16), False),
    ("bf16-d96", lambda: _bf16_views(dim=96), False),
    # a row stride of 3*H*D + 4 elements is 8 bytes off a 16-byte multiple
    ("bf16-misaligned-row-stride", lambda: _bf16_views(extra=4), False),
    ("bf16-aligned-padded-row-stride", lambda: _bf16_views(extra=8), True),
    # a base pointer 2 bytes past a 16-byte boundary
    ("bf16-misaligned-pointer", lambda: _bf16_views(offset=1), False),
    ("bf16-q-f32-kv", lambda: (torch.zeros(2, 64, 4, 64),)
     + _bf16_views()[1:], False),
    ("bf16-heads-not-contiguous",
     lambda: tuple(torch.zeros(2, 4, 64, 64, dtype=torch.bfloat16)
                   .transpose(1, 2) for _ in range(3)), False),
]


@pytest.mark.parametrize("case,build,want", TENSOR_CORE_CASES,
                         ids=[c[0] for c in TENSOR_CORE_CASES])
def test_tensor_core_ok_cases(case, build, want):
    q, k, v = build()
    assert port_flash.tensor_core_ok(q, k, v) is want


class _FakeKernel:
    def __init__(self, err=0):
        self.calls = 0
        self.err = err

    def __call__(self, *args):
        self.calls += 1
        self.last_args = args
        return self.err


@pytest.fixture
def fake_libraries(monkeypatch):
    """Both variants' C entries replaced by recorders, and the CUDA
    device/stream lookups by stand-ins, so the dispatch runs on CPU
    tensors without a card."""
    import contextlib
    import types as _types

    libs = {
        port_flash.SM90_WGMMA: _types.SimpleNamespace(
            flash_attention_fwd_sm90=_FakeKernel()),
        port_flash.CUDA_CORE: _types.SimpleNamespace(
            flash_attention_fwd=_FakeKernel()),
    }
    monkeypatch.setattr(port_flash, "_library", lambda variant: libs[variant])
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _types.SimpleNamespace(
                            cuda_stream=0))
    port_flash.reset_launch_counts()
    yield libs
    port_flash.reset_launch_counts()


@pytest.mark.parametrize("build,variant", [
    (lambda: _bf16_views(), "sm90_wgmma"),
    (lambda: _bf16_views(dim=128), "sm90_wgmma"),
    (lambda: _bf16_views(dtype=torch.float32), "cuda_core"),
    (lambda: _bf16_views(dim=32), "cuda_core"),
    (lambda: _bf16_views(extra=4), "cuda_core"),
])
def test_kernel_dispatch_follows_the_predicate(fake_libraries, build,
                                               variant):
    q, k, v = build()
    out, lse = port_flash._kernel_forward(q, k, v, False, 0.125)
    assert out.shape == q.shape and lse.shape == q.shape[:3]
    assert port_flash.flash_attention.launches == 1
    assert port_flash.flash_attention.launches_by_kernel == {
        "sm90_wgmma": int(variant == "sm90_wgmma"),
        "cuda_core": int(variant == "cuda_core")}
    sm90 = fake_libraries["sm90_wgmma"].flash_attention_fwd_sm90
    core = fake_libraries["cuda_core"].flash_attention_fwd
    assert (sm90.calls, core.calls) == (
        (1, 0) if variant == "sm90_wgmma" else (0, 1))


def test_a_failed_launch_raises_and_nothing_gives_way(fake_libraries):
    """A wgmma launch that returns an error raises; the CUDA-core kernel
    is not tried and no launch is counted."""
    sm90 = fake_libraries["sm90_wgmma"].flash_attention_fwd_sm90
    sm90.err = 10001
    with pytest.raises(RuntimeError, match="sm90_wgmma"):
        port_flash._kernel_forward(*_bf16_views(), False, 0.125)
    assert fake_libraries["cuda_core"].flash_attention_fwd.calls == 0
    assert port_flash.flash_attention.launches == 0
    assert sum(port_flash.flash_attention.launches_by_kernel.values()) == 0


def test_reset_launch_counts_zeroes_every_count():
    port_flash.flash_attention.launches = 3
    port_flash.flash_attention.launches_by_kernel["cuda_core"] = 3
    port_flash.reset_launch_counts()
    assert port_flash.flash_attention.launches == 0
    assert port_flash.flash_attention.launches_by_kernel == {
        "sm90_wgmma": 0, "cuda_core": 0}


def test_kernel_sources_name_the_tpu_kernel_and_their_bound():
    from elasticdl_tpu_torch.ops import _build

    assert {port_flash.SOURCE, port_flash.SOURCE_SM90} <= set(
        _build.sources())
    text = (_build.CSRC_DIR / port_flash.SOURCE_SM90).read_text()
    assert "`_fwd_kernel`" in text
    assert "elasticdl_tpu/ops/flash_attention.py:48" in text
    assert "60.6 us" in text and "wgmma" in text and "TMA" in text


# ---- the backward ---------------------------------------------------------

# Plain backward vs the JAX `_flash_bwd` on the same residuals: the same
# algorithm with sums in another order (f32: measured 4.8e-7 at a gradient
# scale of 3.7); in bf16 both round P, dS and the outputs to bf16 at the
# same places, so they differ by at most about one rounding step of an
# output (2^-8 relative; measured 4.9e-4 at a scale of 0.36).
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _bwd_inputs(dtype, length, causal, fused, batch=2, heads=4, dim=32,
                seed=0):
    """q/k/v (column views of one fused QKV buffer when `fused`), the
    port's plain forward residuals, and dO, for both packages."""
    rng = np.random.RandomState(seed)
    tdtype = getattr(torch, dtype)
    if fused:
        qkv = rng.randn(batch, length, 3 * heads * dim).astype(
            np.float32) * 0.5
        arrays = [qkv[..., i * heads * dim:(i + 1) * heads * dim]
                  .reshape(batch, length, heads, dim) for i in range(3)]
        views = [t.unflatten(-1, (heads, dim)) for t in
                 torch.from_numpy(qkv).to(tdtype).split(heads * dim, -1)]
    else:
        arrays = [rng.randn(batch, length, heads, dim).astype(np.float32)
                  * 0.5 for _ in range(3)]
        views = [torch.from_numpy(a).to(tdtype) for a in arrays]
    g = rng.randn(batch, length, heads, dim).astype(np.float32)
    scale = dim ** -0.5
    out, lse = port_flash.flash_attention_reference(*views, causal=causal,
                                                    scale=scale)
    jdtype = jnp.dtype(dtype)
    jax_res = tuple(jnp.asarray(a).astype(jdtype) for a in arrays) + (
        jnp.asarray(_np(out)).astype(jdtype), jnp.asarray(lse.numpy()))
    port_res = tuple(views) + (out, lse)
    return (jax_res, jnp.asarray(g).astype(jdtype)), (
        port_res, torch.from_numpy(g).to(tdtype)), scale


@pytest.mark.parametrize("fused", [False, True], ids=["contiguous",
                                                      "fused-qkv"])
@pytest.mark.parametrize("length", [72, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_flash_bwd(dtype, causal, length, fused):
    (jres, jg), (pres, pg), scale = _bwd_inputs(dtype, length, causal,
                                                fused)
    want = jax_flash._flash_bwd(causal, scale, jres, jg)
    got = port_flash._flash_bwd(causal, scale, pres, pg)
    tol = BWD_TOL[dtype]
    for g_port, g_jax, q in zip(got, want, pres[:3]):
        assert g_port.dtype == q.dtype and g_port.shape == q.shape
        np.testing.assert_allclose(_np(g_port), _np(g_jax), rtol=tol,
                                   atol=tol)
    # the CPU wrapper is the plain version, and launches nothing
    port_flash.reset_launch_counts()
    again = port_flash.flash_attention_backward(*pres, pg, causal, scale)
    for a, b in zip(again, got):
        assert torch.equal(a, b)
    assert port_flash.flash_attention.backward_launches == 0


def test_autograd_backward_goes_through_the_backward_wrapper(monkeypatch):
    calls = []
    real = port_flash.flash_attention_backward

    def spy(*args):
        calls.append(args[6])
        return real(*args)

    monkeypatch.setattr(port_flash, "flash_attention_backward", spy)
    _, (tq, tk, tv) = _both(_qkv(length=64), "float32")
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    port_flash.flash_attention(*leaves, causal=True).sum().backward()
    assert calls == [True]
    assert all(leaf.grad is not None for leaf in leaves)


def _overlapping(rows=False, batches=False, dim=64):
    """bf16 (2, 64, 4, dim) views whose rows (stride(1) < H*D) or batches
    (stride(0) < L*stride(1)) overlap, with every stride still a multiple
    of 8 elements: the old 16-byte-load predicate took them, TMA cannot."""
    heads, length = 4, 64
    row = dim if rows else heads * dim
    batch = 8 * row if batches else length * row
    flat = torch.zeros(batch + length * row + heads * dim,
                       dtype=torch.bfloat16)
    return tuple(flat.as_strided((2, length, heads, dim),
                                 (batch, row, dim, 1)) for _ in range(3))


# (case, q/k/v builder, the wgmma backward takes them)
BACKWARD_TENSOR_CORE_CASES = [
    ("bf16-d64-fused-qkv-views", lambda: _bf16_views(), True),
    ("bf16-d128-fused-qkv-views", lambda: _bf16_views(dim=128), True),
    ("bf16-d64-contiguous",
     lambda: tuple(torch.zeros(2, 72, 4, 64, dtype=torch.bfloat16)
                   for _ in range(3)), True),
    ("f32-d64", lambda: _bf16_views(dtype=torch.float32), False),
    ("bf16-d16", lambda: _bf16_views(dim=16), False),
    ("bf16-d32", lambda: _bf16_views(dim=32), False),
    ("bf16-misaligned-row-stride", lambda: _bf16_views(extra=4), False),
    ("bf16-misaligned-pointer", lambda: _bf16_views(offset=1), False),
    ("bf16-heads-not-contiguous",
     lambda: tuple(torch.zeros(2, 4, 64, 64, dtype=torch.bfloat16)
                   .transpose(1, 2) for _ in range(3)), False),
    ("bf16-overlapping-rows", lambda: _overlapping(rows=True), False),
    ("bf16-overlapping-batches", lambda: _overlapping(batches=True), False),
    ("bf16-d128-overlapping-rows",
     lambda: _overlapping(rows=True, dim=128), False),
]


def _out_and_grad(q, dtype=None):
    dtype = dtype or q.dtype
    return (torch.zeros(q.shape, dtype=dtype),
            torch.zeros(q.shape, dtype=dtype))


@pytest.mark.parametrize("case,build,want", BACKWARD_TENSOR_CORE_CASES,
                         ids=[c[0] for c in BACKWARD_TENSOR_CORE_CASES])
def test_backward_tensor_core_ok_cases(case, build, want):
    q, k, v = build()
    out, g = _out_and_grad(q)
    assert port_flash.backward_wgmma_ok(q, k, v, out, g) is want
    # the backward's rules on q, k and v are the forward's
    assert port_flash.tensor_core_ok(q, k, v) is want


def test_backward_tensor_core_ok_reads_out_and_grad_too():
    q, k, v = _bf16_views()
    out, g = _out_and_grad(q)
    assert port_flash.backward_wgmma_ok(q, k, v, out, g)
    # an output gradient in f32, or one 2 bytes off a 16-byte boundary
    assert not port_flash.backward_wgmma_ok(q, k, v, out, g.float())
    flat = torch.zeros(g.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(g.shape)
    assert not port_flash.backward_wgmma_ok(q, k, v, out, shifted)
    # an output whose rows are 3*H*D + 4 elements apart (8 bytes off a
    # 16-byte multiple), or an output gradient whose rows overlap
    strided = _bf16_views(extra=4)[0]
    assert not port_flash.backward_wgmma_ok(q, k, v, strided, g)
    assert not port_flash.backward_wgmma_ok(
        q, k, v, out, _overlapping(rows=True)[0])
    # an output that is a column view of a wider buffer, aligned, is taken
    assert port_flash.backward_wgmma_ok(q, k, v, _bf16_views(extra=8)[0], g)


@pytest.fixture
def fake_backward_library(monkeypatch):
    """Both backward variants' C entries replaced by recorders, and the
    CUDA device/stream lookups by stand-ins, so the dispatch runs on CPU
    tensors without a card.  Yields {variant: recorder}."""
    import contextlib
    import types as _types

    kernels = {port_flash.SM90_WGMMA: _FakeKernel(),
               port_flash.CUDA_CORE: _FakeKernel()}
    libs = {
        port_flash.SM90_WGMMA: _types.SimpleNamespace(
            flash_attention_bwd_sm90=kernels[port_flash.SM90_WGMMA]),
        port_flash.CUDA_CORE: _types.SimpleNamespace(
            flash_attention_bwd=kernels[port_flash.CUDA_CORE]),
    }
    monkeypatch.setattr(port_flash, "_backward_library",
                        lambda variant: libs[variant])
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _types.SimpleNamespace(
                            cuda_stream=0))
    port_flash.reset_launch_counts()
    yield kernels
    port_flash.reset_launch_counts()


def _residuals(q):
    batch, length, heads, _ = q.shape
    out, g = _out_and_grad(q)
    return out, torch.zeros(batch, length, heads), g


@pytest.mark.parametrize("build,variant", [
    (lambda: _bf16_views(), "sm90_wgmma"),
    (lambda: _bf16_views(dim=128), "sm90_wgmma"),
    (lambda: _bf16_views(dtype=torch.float32), "cuda_core"),
    (lambda: _bf16_views(dim=16), "cuda_core"),
    (lambda: _bf16_views(extra=4), "cuda_core"),
    (lambda: _overlapping(rows=True), "cuda_core"),
])
def test_backward_dispatch_follows_the_predicate(fake_backward_library,
                                                 build, variant):
    q, k, v = build()
    out, lse, g = _residuals(q)
    dq, dk, dv = port_flash._kernel_backward(q, k, v, out, lse, g, True,
                                             0.125)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert dq.is_contiguous() and dq.dtype == q.dtype
    assert {name: k.calls for name, k in fake_backward_library.items()} == {
        "sm90_wgmma": int(variant == "sm90_wgmma"),
        "cuda_core": int(variant == "cuda_core")}
    # the wgmma entry takes an lse2 scratch and no dtype code: one pointer
    # more and one int fewer, the same count of arguments
    args = fake_backward_library[variant].last_args
    assert len(args) == 29
    assert port_flash.flash_attention.backward_launches == 1
    assert port_flash.flash_attention.backward_launches_by_kernel == {
        "sm90_wgmma": int(variant == "sm90_wgmma"),
        "cuda_core": int(variant == "cuda_core")}
    # the forward's counts are the forward's alone
    assert port_flash.flash_attention.launches == 0


def test_a_failed_backward_launch_raises_and_counts_nothing(
        fake_backward_library):
    """A wgmma launch that returns an error raises; the CUDA-core kernel
    is not tried and no launch is counted."""
    fake_backward_library["sm90_wgmma"].err = 10001
    q, k, v = _bf16_views()
    out, lse, g = _residuals(q)
    with pytest.raises(RuntimeError, match="backward sm90_wgmma"):
        port_flash._kernel_backward(q, k, v, out, lse, g, False, 0.125)
    assert fake_backward_library["sm90_wgmma"].calls == 1
    assert fake_backward_library["cuda_core"].calls == 0
    assert port_flash.flash_attention.backward_launches == 0
    assert sum(port_flash.flash_attention.backward_launches_by_kernel
               .values()) == 0


def test_backward_validates_its_residuals(fake_backward_library):
    q, k, v = _bf16_views()
    out, lse, g = _residuals(q)
    with pytest.raises(ValueError, match="lse"):
        port_flash._kernel_backward(q, k, v, out, lse[:, :8], g, False,
                                    0.125)
    with pytest.raises(ValueError, match="one dtype"):
        port_flash._kernel_backward(q, k, v, out.float(), lse, g, False,
                                    0.125)
    assert sum(k.calls for k in fake_backward_library.values()) == 0


def test_backward_makes_a_strided_grad_contiguous(fake_backward_library):
    q, k, v = _bf16_views()
    out, lse, _ = _residuals(q)
    # (B, H, L, D) storage seen as (B, L, H, D): heads not contiguous
    g = torch.zeros(q.shape[0], q.shape[2], q.shape[1], q.shape[3],
                    dtype=q.dtype).transpose(1, 2)
    port_flash._kernel_backward(q, k, v, out, lse, g, False, 0.125)
    assert port_flash.flash_attention.backward_launches_by_kernel[
        "sm90_wgmma"] == 1


def test_reset_launch_counts_zeroes_the_backward_counts():
    port_flash.flash_attention.backward_launches = 2
    port_flash.flash_attention.backward_launches_by_kernel["sm90_wgmma"] = 2
    port_flash.reset_launch_counts()
    assert port_flash.flash_attention.backward_launches == 0
    assert port_flash.flash_attention.backward_launches_by_kernel == {
        "sm90_wgmma": 0, "cuda_core": 0}


def test_backward_source_names_the_reference_and_its_bound():
    from elasticdl_tpu_torch.ops import _build

    assert {port_flash.SOURCE_BWD, port_flash.SOURCE_BWD_SM90} <= set(
        _build.sources())
    for source in (port_flash.SOURCE_BWD, port_flash.SOURCE_BWD_SM90):
        text = (_build.CSRC_DIR / source).read_text()
        assert "`_flash_bwd`" in text
        assert "elasticdl_tpu/ops/flash_attention.py:208" in text
        assert "128.8 GFLOP" in text and "0.130 ms" in text
        assert "no atomics" in text
        assert "mma.sync" not in text
    text = (_build.CSRC_DIR / port_flash.SOURCE_BWD_SM90).read_text()
    assert "wgmma.mma_async" in text and "cp.async.bulk.tensor" in text
    # the forward's source is not included: the primitives are copied
    assert "#include \"flash_attention_fwd" not in text


@pytest.mark.parametrize("variant,entry,pointers", [
    ("sm90_wgmma", "flash_attention_bwd_sm90", 11),
    ("cuda_core", "flash_attention_bwd", 10),
])
def test_backward_library_declares_pointers_and_stream_as_void_p(
        monkeypatch, variant, entry, pointers):
    """ctypes passes an undeclared int as 32 bits and would cut a
    pointer: every pointer and the stream are c_void_p, the strides
    c_longlong."""
    import ctypes
    import types as _types

    from elasticdl_tpu_torch.ops import _build

    loaded = []

    def fake_load(source):
        loaded.append(source)
        return _types.SimpleNamespace(**{entry: _types.SimpleNamespace()})

    monkeypatch.setattr(_build, "load_library", fake_load)
    monkeypatch.setattr(port_flash, "_LIBS", {})
    fn = getattr(port_flash._backward_library(variant), entry)
    assert loaded == [port_flash._BWD_ENTRIES[variant][0]]
    types_ = list(fn.argtypes)
    assert len(types_) == 29 and fn.restype is ctypes.c_int
    assert types_[:pointers] == [ctypes.c_void_p] * pointers
    assert types_[-1] is ctypes.c_void_p          # the stream
    assert types_[-3:-1] == [ctypes.c_float, ctypes.c_int]
    assert types_[-13:-3] == [ctypes.c_longlong] * 10
    assert ctypes.c_void_p not in types_[pointers:-1]
    # loaded once
    port_flash._backward_library(variant)
    assert len(loaded) == 1
