"""Ring attention over a seq axis of 4 (ops/ring_attention.py): one
world of 4 gloo ranks, each holding a quarter of the sequence, against
the JAX package's `ring_self_attention` on its 8-device CPU mesh
(data=2, seq=4) and its `full_attention_reference`.

- `flash` cases: chunks of 16 rows pass `flash_shapes_ok`, so the ring
  is `_RingFlash`: per block the flash custom ops (their plain versions
  on the CPU) and this module's own rotation, lse merge and dK/dV
  return trip;
- `plain` cases: chunks of 9 rows fail the predicate, so the ring is the
  plain einsum body with `axis_ring_shift`.

Tolerance: f32 on both sides, the same online softmax summed in another
order; outputs within 2e-5, gradients within 1e-4 (measured about 1e-6
and 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_world import run_world
from elasticdl_tpu.ops import ring_attention as jax_ring
from elasticdl_tpu.parallel import mesh as jax_mesh

torch.set_num_threads(2)

OUT_TOL = 2e-5
GRAD_TOL = 1e-4
CASES = {f"{kind}_{'causal' if causal else 'bidirectional'}":
         (length, causal)
         for kind, length in (("flash", 64), ("plain", 36))
         for causal in (False, True)}


def _inputs(length, seed):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(2, length, 2, 16).astype(np.float32)
                  for _ in range(4))
    return q, k, v, w


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    cases = {name: _inputs(length, i) + (causal,)
             for i, (name, (length, causal)) in enumerate(CASES.items())}
    got, want = run_world(4, "_torch_parallel_ranks:ring_attention",
                          (cases,), tmp_path_factory.mktemp("ring_world"),
                          meanwhile=lambda: _jax_references(cases))
    return cases, got, want


def _gathered(got, name, key):
    return np.concatenate([r[name][key].numpy() for r in got], axis=1)


def _jax(q, k, v, w, causal, ring_fn):
    def loss(q, k, v):
        out = ring_fn(q, k, v, causal)
        return (out * w).sum(), out

    grads, out = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
        q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _jax_references(cases):
    """{case: [JAX ring's (out, dq, dk, dv), the full reference's]}."""
    mesh = jax_mesh.create_mesh(jax.devices(), data=2, seq=4)
    fns = (lambda a, b, c, cz: jax_ring.ring_self_attention(
               a, b, c, mesh, causal=cz),
           lambda a, b, c, cz: jax_ring.full_attention_reference(
               a, b, c, causal=cz))
    out = {}
    for name, (q, k, v, w, causal) in cases.items():
        qj, kj, vj, wj = (jnp.asarray(a) for a in (q, k, v, w))
        out[name] = [_jax(qj, kj, vj, wj, causal, fn) for fn in fns]
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_jax_ring_and_full_attention(ring, name):
    _, got, references = ring
    port = [_gathered(got, name, key) for key in ("out", "dq", "dk", "dv")]
    for want in references[name]:
        np.testing.assert_allclose(port[0], want[0], atol=OUT_TOL,
                                   rtol=OUT_TOL)
        for a, b in zip(port[1:], want[1:]):
            np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_blocks_per_rank(ring, name):
    """The flash ring runs one forward and one backward per block it
    does not skip: 4 per rank bidirectional, rank i's i + 1 causal; the
    plain body runs none."""
    cases, got, _ = ring
    causal = cases[name][4]
    for rank, result in enumerate(got):
        blocks = result[name]["blocks"]
        want = 0 if name.startswith("plain") else (
            rank + 1 if causal else 4)
        assert blocks == {"fwd": want, "bwd": want}, (rank, blocks)
