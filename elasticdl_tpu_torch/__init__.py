"""PyTorch/CUDA port of `elasticdl_tpu`, for one NVIDIA H100.

The JAX package beside this one is the reference.  Module paths mirror
it (`elasticdl_tpu/serving/engine.py` <-> `elasticdl_tpu_torch/serving/
engine.py`), and each TPU kernel of the reference has a hand-written
Hopper kernel here (`csrc/`, built by `ops/_build.py`).  Nothing here
imports jax, flax, optax, orbax, `elasticdl_tpu` or `model_zoo`.

Entry points run on CUDA unless the caller passes `device="cpu"`
(`device.resolve_device`); without a GPU they raise.
"""

from elasticdl_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
