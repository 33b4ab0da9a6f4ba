"""Flash attention's forward at (B, L, H, D) queries and (B, Lk, H, D)
keys and values: QK^T and PV, each input read once (q, k, v) and each
output written once (O and the float32 log-sum-exp)."""


def cost(batch: int, q_len: int, k_len: int, heads: int, dim: int,
         elem_bytes: int, causal: bool = False):
    q = batch * q_len * heads * dim
    k = batch * k_len * heads * dim
    nbytes = (2 * q + 2 * k) * elem_bytes + batch * q_len * heads * 4
    return 2.0 * 2 * batch * heads * _pairs(q_len, k_len, causal) * dim, \
        float(nbytes)


def _pairs(q_len: int, k_len: int, causal: bool) -> int:
    if not causal:
        return q_len * k_len
    if q_len <= k_len:
        return q_len * (q_len + 1) // 2
    return k_len * (k_len + 1) // 2 + (q_len - k_len) * k_len
