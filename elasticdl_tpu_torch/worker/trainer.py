"""Device-execution helpers shared by training and serving (the port's
copy of `run_device_serialized` and `model_has_train_kwarg` from the JAX
package's worker/trainer.py; the Trainer itself waits for the training
slice)."""

from __future__ import annotations

import inspect
import threading

import torch

# Process-wide execution lock for the CPU.  CPU work runs synchronously
# on the calling thread and spreads over PyTorch's intra-op threads;
# serializing it keeps concurrent callers from oversubscribing those
# threads, as the JAX package serializes its CPU backend.  A CUDA device
# executes in stream order, so there the call goes straight through.
_CPU_EXEC_LOCK = threading.Lock()


def run_device_serialized(fn, *args, device: torch.device):
    """Call fn(*args).  On the CPU, hold the process-wide execution lock;
    CPU ops return only when done, so the result is ready when the lock
    is released.  On CUDA, call through: the kernels are queued on the
    current stream and the caller's host copy of the result waits for
    them."""
    if torch.device(device).type != "cpu":
        return fn(*args)
    with _CPU_EXEC_LOCK:
        return fn(*args)


def model_has_train_kwarg(model) -> bool:
    """Whether the model's forward takes the zoo contract's `train`
    kwarg (BatchNorm/dropout models).  Shared by training and serving
    so train-time eval and serving stay in lockstep."""
    try:
        return "train" in inspect.signature(type(model).forward).parameters
    except (TypeError, ValueError, AttributeError):
        return False
