from elasticdl_tpu_torch.preprocessing.layers import (  # noqa: F401
    ConcatenateWithOffset,
    Discretization,
    Hashing,
    IndexLookup,
    LogRound,
    RoundIdentity,
    SparseEmbedding,
    ToNumber,
    fnv1a_hash,
)
