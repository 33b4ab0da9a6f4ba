"""Flash attention's backward: reads q, k, v, O, dO and the float32
log-sum-exp once, writes dQ, dK and dV once; five products (QK^T, dO
V^T, P^T dO, dS K, dS^T Q)."""

from benchmark.costs.flash_fwd import _pairs


def cost(batch: int, q_len: int, k_len: int, heads: int, dim: int,
         elem_bytes: int, causal: bool = False):
    q = batch * q_len * heads * dim
    k = batch * k_len * heads * dim
    nbytes = (4 * q + 4 * k) * elem_bytes + batch * q_len * heads * 4
    return 2.0 * 5 * batch * heads * _pairs(q_len, k_len, causal) * dim, \
        float(nbytes)
