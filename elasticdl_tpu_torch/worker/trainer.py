"""The training engine (the port of the JAX package's
worker/trainer.py) and the device-execution helpers that training and
serving share.

One `Trainer` owns forward, loss, backward and optimizer step for one
model on one device.  Where the JAX step is one jitted function over
immutable state, this one runs eagerly and updates its state in place:
`TrainState` holds the model (its own copy, on the device) and the
optimizer, and `train_on_batch` returns the same object one step on.
After each optimizer step the int8 arenas fold their carrier's delta
into their codes (`fold_quantized_updates`; a no-op without them).

Batches move to the device at their wire width: the b22 and dedup plane
dicts and bf16 dense features (data/wire.py) go plane by plane through
`plane_tensor`, and the model's decoders widen them on the device.
The tiered store, the mesh, sharding and elastic prewarm wait for their
slices of the port.
"""

from __future__ import annotations

import copy
import inspect
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.data.wire import (
    BF16Bits,
    is_wire_planes,
    plane_tensor,
)
from elasticdl_tpu_torch.device import resolve_device
from elasticdl_tpu_torch.layers.arena import fold_quantized_updates
from elasticdl_tpu_torch.layers.linen import init_parameters

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


def to_tensor(arr, device: torch.device) -> torch.Tensor:
    """A numpy array (or tensor) as a tensor on `device`.  Wide unsigned
    ids become int64 in numpy first: torch's uint16/32/64 support few
    ops, and the models cast ids at entry anyway.  bf16 bit patterns
    (`BF16Bits`) arrive as torch.bfloat16."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    if isinstance(arr, BF16Bits):
        return plane_tensor(arr, device)
    arr = np.asarray(arr)
    if arr.dtype.kind == "u" and arr.dtype != np.uint8:
        arr = arr.astype(np.int64)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr).to(device)


def _to_device(tree, device: torch.device):
    """`to_tensor` over nested dicts; a dict of wire planes moves plane
    by plane at its wire width."""
    if is_wire_planes(tree):
        return {k: plane_tensor(v, device) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return to_tensor(tree, device)


def _batch_key(tree):
    """The leaf shapes and dtypes of a batch of tensors."""
    if isinstance(tree, dict):
        return tuple((k, _batch_key(v)) for k, v in sorted(tree.items()))
    return (tuple(tree.shape), str(tree.dtype))


def _floating_to_bf16(tree):
    if isinstance(tree, dict):
        return {k: _floating_to_bf16(v) for k, v in tree.items()}
    if tree.is_floating_point():
        return tree.to(torch.bfloat16)
    return tree


@dataclass
class TrainState:
    """One training run: the step count, the model (the state's own copy,
    on the trainer's device) and its optimizer.  Mutable: a step updates
    the parameters and the moments in place rather than keeping a second
    copy of every table, so two runs need two states."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


class Trainer:
    """Forward, loss, backward and optimizer step for one model.

    model:     the zoo's `custom_model()`: a template that `init_state`
               copies onto the device.
    optimizer: the zoo's `optimizer()`: a callable(params) -> optimizer.
    loss_fn:   (labels, predictions) -> scalar, the zoo's `loss`.
    use_bf16:  cast floating features to bf16 before the model, as the
               JAX `_cast` does.
    device:    CUDA by default; the CPU only when the caller passes "cpu".
    """

    # Step-phase attribution (common/profiler.PhaseTimer), set by the
    # worker: h2d_stage covers stage_batch, compute covers the step
    # calls.  On CUDA a step returns once its kernels are queued, so
    # compute is launch time; a copy that waits on the stream lands in
    # whichever phase issues it.
    phase_timer = None

    def __init__(self, model: nn.Module, optimizer: Callable,
                 loss_fn: Callable, use_bf16: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.use_bf16 = use_bf16
        self._has_train_kwarg = model_has_train_kwarg(model)
        # batch shapes timed_steps_per_sec has warmed up
        self._timing_warmed = set()

    # ---- state ---------------------------------------------------------

    def init_state(self, rng: Union[int, torch.Generator],
                   sample_features) -> TrainState:
        """A fresh state: the model copied to the device, its parameters
        drawn from the flax initialisers with `rng` (a seed, or a
        generator on the trainer's device), a new optimizer.  One forward
        on `sample_features` checks that the model takes them."""
        return run_device_serialized(self._init_state_impl, rng,
                                     sample_features, device=self.device)

    def _init_state_impl(self, rng, sample_features) -> TrainState:
        if isinstance(rng, torch.Generator):
            generator = rng
        else:
            generator = torch.Generator(device=self.device).manual_seed(
                int(rng))
        model = copy.deepcopy(self.model).to(self.device)
        init_parameters(model, generator)
        with torch.no_grad():
            self._forward(model, _to_device(sample_features, self.device),
                          train=False)
        return TrainState(step=0, model=model,
                          optimizer=self.optimizer(model.parameters()))

    def _cast(self, features):
        if not self.use_bf16:
            return features
        return _floating_to_bf16(features)

    def _forward(self, model, features, train: bool):
        kwargs = {"train": train} if self._has_train_kwarg else {}
        model.train(train)
        return model(self._cast(features), **kwargs)

    def _timed(self, phase_name: str, fn, *args):
        timer = self.phase_timer
        if timer is None:
            return fn(*args)
        start = time.perf_counter()
        try:
            return fn(*args)
        finally:
            timer.add(phase_name, time.perf_counter() - start)

    # ---- steps ---------------------------------------------------------

    def _train_step(self, state: TrainState, batch) -> torch.Tensor:
        preds = self._forward(state.model, batch["features"], train=True)
        loss = self.loss_fn(batch["labels"], preds.float()).float()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        # int8 arenas: fold the carrier's delta into the codes, keyed on
        # the step before the increment, as the JAX step does
        fold_quantized_updates(state.model, state.step)
        state.step += 1
        return loss.detach()

    def stage_batch(self, batch):
        """`batch`'s tensors on the device now, for a later
        train_on_batch (which leaves tensors already there as they
        are)."""
        return self._timed("h2d_stage", lambda: run_device_serialized(
            _to_device, batch, self.device, device=self.device))

    def train_on_batch(self, state: TrainState, batch):
        """One step; returns (state, loss), the loss a 0-d f32 tensor on
        the device."""
        def _step():
            return self._train_step(state, _to_device(batch, self.device))

        loss = self._timed("compute", lambda: run_device_serialized(
            _step, device=self.device))
        return state, loss

    def train_on_batch_stack(self, state: TrainState, batches):
        """len(batches) steps, one after another; returns (state, losses
        (K,)).  The same step as train_on_batch, so K steps here and K
        calls there give the same parameters bit for bit.  Batches of any
        wire format (plain, b22, dedup) go through as they are; the
        worker groups only batches of one shape."""
        def _steps():
            return torch.stack([
                self._train_step(state, _to_device(b, self.device))
                for b in batches
            ])

        losses = self._timed("compute", lambda: run_device_serialized(
            _steps, device=self.device))
        return state, losses

    def timed_steps_per_sec(self, state: TrainState, batch,
                            iters: int = 40) -> float:
        """Steps per second over `iters` serially dependent train steps
        on one staged batch: the counterpart of the JAX Trainer's
        `timed_steps_per_sec_fused`, which runs them as one program.
        The first call for a batch shape warms up with one step (the
        kernels' build and first launch, the allocator's first blocks).
        On CUDA the steps are timed with CUDA events and the timing ends
        on a value read from the final parameters, so no step is left
        queued.  The state trains on: it advances by the warm-up and
        `iters` steps."""
        staged = self.stage_batch(batch)
        key = _batch_key(staged)
        if key not in self._timing_warmed:
            self.train_on_batch(state, staged)
            self._timing_warmed.add(key)

        def steps():
            for _ in range(iters):
                self.train_on_batch(state, staged)

        def anchor():
            # one element of every parameter: the last step's update of
            # each must have run before it is read
            return float(sum(p.detach().reshape(-1)[0].float()
                             for p in state.model.parameters()))

        if self.device.type != "cuda":
            t0 = time.perf_counter()
            steps()
            anchor()
            return iters / (time.perf_counter() - t0)
        torch.cuda.synchronize(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        steps()
        end.record()
        anchor()
        return iters * 1e3 / start.elapsed_time(end)

    def predict_on_batch(self, state: TrainState, features) -> np.ndarray:
        """f32 predictions as numpy."""
        def _predict():
            with torch.no_grad():
                preds = self._forward(
                    state.model, _to_device(features, self.device),
                    train=False)
            return preds.float().cpu().numpy()

        return run_device_serialized(_predict, device=self.device)
