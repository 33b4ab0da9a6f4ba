"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit)."""

FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "f32": 67e12,
         "fp8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the dtype's peak and the bytes over the HBM bandwidth."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
