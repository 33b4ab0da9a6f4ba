"""Device selection for the port's entry points.

There is no "cuda if present, else cpu": an entry point runs on the card
unless its caller asks for the CPU by name, and raises when no card is
there.  A run that quietly fell back to the CPU would report CPU numbers
under a GPU's name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def pin_float32_precision() -> None:
    """Float32 products run in full float32, never in TF32.  Matmuls
    already default to that; cuDNN convolutions do not.  Both are set
    here explicitly so a reference computed on the card means float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


pin_float32_precision()


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """`cuda:0` by default; the CPU only when the caller passes "cpu".

    Raises RuntimeError when a CUDA device is wanted (by default or by
    name) and PyTorch sees none."""
    pin_float32_precision()
    if device is None:
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU "
                "unless the caller passes device='cpu' explicitly"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(
            f"unsupported device {device}; expected 'cuda' or 'cpu'"
        )
    return device
