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

With a tiered store (`Trainer.tiered_store`, store/tiered.py) a batch
may carry host bookkeeping beside its data: an admission plan under
`__store_plan__` (eager planning; applied before the step) or the raw
sparse ids under `__store_sparse__` (deferred planning; prepared and
applied here, inside the step-serialized region, in step order).
`stage_batch` passes both through untouched.

A cluster job's ranks train one model over a `ProcessMesh`
(parallel/mesh.py): `init_state_global` gives every rank rank 0's
initial state and, with a `param_sharding_fn` (the zoo's
`param_sharding`), keeps only this rank's shard of each parameter it
names (`common/weights.py::shard_tree`; AdamW and Adam then run on the
shards unchanged).  `train_on_global_batch` runs the step of the JAX
package's one program over the global batch.  Each rank computes the
zoo's loss (a mean over its rows); the loss is the same on every rank
of a data coordinate (the model's collectives make it so), so each
rank's backward is weighted by its data share over the number of ranks
that share it (`objective_weight`), and the axis collectives' backwards
are exact transposes (parallel/collectives.py).  A parameter's gradient
is then the sum over the ranks that hold the same values of it: over
every axis of size > 1 except those its spec shards it on.  The step's
loss is the mean over every row of the global batch, and every rank
holding a parameter applies the same summed gradient, so the shards of
a parameter stay one parameter bit for bit.  An MoE model's aux loss
(`layers.moe.collect_aux_loss`) joins the objective, as the JAX step
adds the sown values; it is the same on every rank and weighted by
1/world there.

The port's compile.  On CUDA, for a world of one, `worker_train_step`,
`worker_train_step_many`, `worker_timed_fused` and `worker_eval_step`
run as captured CUDA graphs (worker/graphs.py), one per state and batch
shapes, dispatched on the explicit predicates `graph_ok` and
`eval_graph_ok`: the first call at a signature runs eagerly (the
registry's counted call), the next captures and replays, later ones
replay.  The eager loop is the graphs' plain version: the CPU runs it,
and `graphs_lib.eager_loop()` keeps a CUDA thread on it.  Host
bookkeeping stays outside the graph (`state.step += K`; the losses and
the predictions are copied out of the static output), and the device
work inside reads the step from a device counter
(`TrainState.fold_counter`, the int8 fold's key).  On CUDA a world of
one's Adam and AdamW are capturable with float64 step counts
(`graphs_lib.capturable_adam`), so eager and graph steps are the same
arithmetic, and each update plain Adam's to an ulp; a cluster rank's
state keeps plain Adam, as its data-parallel step stays eager
(`graph_ok` says why).
`prewarm_for_device_counts` is the JAX trainer's prewarm: for the world
sizes a failure would leave, it runs
the train step's abstract compile (`aot_compile` on a fake state and a
fake batch of that world's local rows), which records its cost and
builds the kernel libraries that step loads into the library cache.

The trainer's device entry points are registered programs
(common/programs.py) under the JAX trainer's names: `worker_train_step`,
`worker_train_step_many`, `worker_eval_step` and `worker_timed_fused`
(one timed run of steps; its cost is counted on the one-step warm-up,
the first call at a batch shape).  The first call at a new signature is
timed and its flops and bytes counted on that call; every call runs the
same arithmetic as an unregistered one.  `init_state` is the JAX
trainer's unregistered `init_state`; the registered `worker_init_state`
is the cluster's `init_state_global`, as in the JAX trainer.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from elasticdl_tpu_torch.common import programs
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.profiler import SPANS, Legs, torch_profiler
from elasticdl_tpu_torch.data.wire import (
    BF16Bits,
    is_wire_planes,
    plane_tensor,
)
from elasticdl_tpu_torch.device import resolve_device
from elasticdl_tpu_torch.layers.arena import (
    PLANE_KEYS,
    fold_quantized_updates,
    has_int8_arena,
    plane_key,
    plane_prefixes,
)
from elasticdl_tpu_torch.layers.linen import init_parameters
from elasticdl_tpu_torch.layers.moe import collect_aux_loss
from elasticdl_tpu_torch.parallel import collectives
from elasticdl_tpu_torch.parallel import mesh as mesh_lib
from elasticdl_tpu_torch.worker import graphs as graphs_lib

logger = get_logger(__name__)

# Process-wide execution lock for the CPU.  CPU work runs synchronously
# on the calling thread and spreads over PyTorch's intra-op threads;
# serializing it keeps concurrent callers from oversubscribing those
# threads, as the JAX package serializes its CPU backend.  A CUDA device
# executes in stream order, so there the call goes straight through.
_CPU_EXEC_LOCK = threading.Lock()

# host bookkeeping a tiered-store batch carries (store/tiered.py): an
# admission plan, the raw sparse batch of deferred planning, and the
# feed's ranking of the batch's ids (consumed by TieredStore.attach)
STORE_PLAN_KEY = "__store_plan__"
STORE_SPARSE_KEY = "__store_sparse__"
RANKING_KEY = "__dedup_ranking__"
STORE_KEYS = (STORE_PLAN_KEY, STORE_SPARSE_KEY)


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
    by plane at its wire width.  A tiered store's bookkeeping keys stay
    as they are."""
    if is_wire_planes(tree):
        return {k: plane_tensor(v, device) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: v if k in STORE_KEYS else _to_device(v, device)
                for k, v in tree.items()}
    return to_tensor(tree, device)


def _with_slots(batch, slots):
    """`batch` with its features' `slots` replaced."""
    features = dict(batch["features"])
    features["slots"] = slots
    out = dict(batch)
    out["features"] = features
    return out


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
    # {parameter name: spec} of the parameters this rank holds a shard
    # of (a tuple of mesh axis names or None per dim), and their mesh
    shardings: Dict[str, tuple] = field(default_factory=dict)
    mesh: Optional[object] = None
    # the step on the device, for the int8 fold's key (None: not made
    # yet; False: the model has no int8 arena)
    fold_counter: Any = field(default=None, init=False, repr=False,
                              compare=False)
    # the captured programs over this state's tensors (worker/graphs.py):
    # train steps, the eval forward and the store seam's, by program and
    # input shapes
    graphs: Dict[tuple, Any] = field(default_factory=dict, init=False,
                                     repr=False, compare=False)

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
    # the TieredStore whose plans this trainer's batches carry (set by
    # the Local runner)
    tiered_store = None

    def __init__(self, model: nn.Module, optimizer: Callable,
                 loss_fn: Callable, use_bf16: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 param_sharding_fn: Optional[Callable] = None):
        self.device = resolve_device(device)
        # the captured train steps and eval forwards of this trainer's
        # states (one memory pool: a new batch shape does not hold a
        # second step's activations); several threads may train one
        # state in turn (the Local runner's workers share one model)
        self._graphs = graphs_lib.ProgramGraphs(self.device)
        self.model = model
        # (parameter name, tensor) -> spec or None: the zoo's
        # `param_sharding`, applied by init_state_global
        self.param_sharding_fn = param_sharding_fn
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.use_bf16 = use_bf16
        self._has_train_kwarg = model_has_train_kwarg(model)
        # batch shapes timed_steps_per_sec has warmed up
        self._timing_warmed = set()
        self.train_step = programs.registered_jit(
            "worker_train_step", self._train_step_program)
        self.train_step_many = programs.registered_jit(
            "worker_train_step_many", self._train_steps)
        self.eval_step = programs.registered_jit(
            "worker_eval_step", self._eval_step)
        self._timed_fused = programs.registered_jit(
            "worker_timed_fused", self._timed_steps)
        self._init_global = programs.registered_jit(
            "worker_init_state", self._init_state_global)
        self.train_step_global = programs.registered_jit(
            "worker_train_step", self._train_step_global)

    # ---- state ---------------------------------------------------------

    def init_state(self, rng: Union[int, torch.Generator],
                   sample_features) -> TrainState:
        """A fresh state: the model copied to the device, its parameters
        drawn from the flax initialisers with `rng` (a seed, or a
        generator on the trainer's device), a new optimizer.  One forward
        on `sample_features` checks that the model takes them."""
        return run_device_serialized(self._init_state_impl, rng,
                                     sample_features, True,
                                     device=self.device)

    def _init_state_impl(self, rng, sample_features,
                         graphable: bool) -> TrainState:
        if isinstance(rng, torch.Generator):
            generator = rng
        else:
            generator = torch.Generator(device=self.device).manual_seed(
                int(rng))
        model = copy.deepcopy(self.model).to(self.device)
        init_parameters(model, generator)
        # the whole model, checked on one device
        with torch.no_grad(), mesh_lib.using_mesh(mesh_lib.ProcessMesh()):
            self._forward(model, _to_device(sample_features, self.device),
                          train=False)
        return TrainState(step=0, model=model, optimizer=self._new_optimizer(
            model.parameters(), graphable))

    def _new_optimizer(self, params, graphable: bool = True
                       ) -> torch.optim.Optimizer:
        """The zoo's optimizer over `params`.  For a state whose programs
        may run as graphs (`graphable`: a world of one's) on CUDA, Adam
        and AdamW are built as a graph holds them
        (`graphs_lib.capturable_adam`: capturable, float64 step counts),
        so eager and captured steps are the same arithmetic, and each
        update plain Adam's to an ulp (`chip_smoke.py`'s adam_vs_plain
        holds the two).  A cluster rank's state, whose data-parallel
        step never runs as a graph (`graph_ok`), keeps the plain
        setting, and so does the CPU (PyTorch refuses capturable for CPU
        parameters)."""
        opt = self.optimizer(list(params))
        if graphable and self.device.type == "cuda":
            opt = graphs_lib.capturable_adam(opt)
        return opt

    def abstract_state(self, device=None) -> TrainState:
        """A fake TrainState of this trainer's model on `device` (the
        trainer's by default): fake parameters and buffers shaped like
        the template's, a new optimizer over them.  No data is drawn or
        copied; it is what `aot_compile` runs a train step on (the
        counterpart of the JAX prewarm's `jax.eval_shape` of init)."""
        device = self.device if device is None else torch.device(device)
        model = programs.abstract_like(self.model, device)
        with programs.in_abstract_mode():
            optimizer = self._new_optimizer(model.parameters())
        if device.type == "cuda":
            # PyTorch picks the foreach implementation for real CUDA
            # parameters by their type, which a fake tensor does not
            # pass; make the same choice here
            for group in optimizer.param_groups:
                if group.get("foreach", False) is None:
                    group["foreach"] = True
        return TrainState(step=0, model=model, optimizer=optimizer)

    def init_state_global(self, rng: Union[int, torch.Generator],
                          sample_features, mesh) -> TrainState:
        """A cluster rank's fresh state: `init_state` on this rank, then
        rank 0's parameters and buffers broadcast to every rank, so the
        group starts from one state (the JAX trainer gets the same from
        one init program over the global mesh); with a
        `param_sharding_fn` each rank then keeps its shards.  Its
        optimizer keeps the plain setting (`_new_optimizer`)."""
        return run_device_serialized(self._init_global, rng,
                                     sample_features, mesh,
                                     device=self.device)

    def _init_state_global(self, rng, sample_features, mesh) -> TrainState:
        state = self._init_state_impl(rng, sample_features, False)
        with torch.no_grad():
            collectives.broadcast_(
                [t for t in state.model.state_dict().values()
                 if t.is_floating_point() or t.dtype in
                 (torch.int8, torch.int32, torch.int64, torch.uint8)],
                mesh)
        if self.param_sharding_fn is not None:
            shard_state(state, self.param_sharding_fn, mesh)
            if self.tiered_store is not None:
                # the cache tables are row-sharded with the others: plans
                # carry each block's sub-plan
                self.tiered_store.set_mesh_shards(
                    mesh.shape[mesh_lib.MODEL_AXIS])
        return state

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

    def _fold_counter(self, state: TrainState) -> Optional[torch.Tensor]:
        """The state's step on the device, set to `state.step` now (a
        launch, no sync), for the int8 fold's key; None for a model
        without an int8 arena."""
        counter = state.fold_counter
        if counter is None:
            counter = state.fold_counter = (
                torch.zeros((), dtype=torch.int64,
                            device=next(state.model.parameters()).device)
                if has_int8_arena(state.model) else False)
        if counter is False:
            return None
        counter.fill_(state.step)
        return counter

    def _step_body(self, state: TrainState, batch, counter) -> torch.Tensor:
        """One step's device work: forward, loss, backward, optimizer
        step and, with int8 arenas, the fold keyed on `counter` (the
        step before the increment, as the JAX step does), which then
        advances.  No host bookkeeping: a graph captures this."""
        preds = self._forward(state.model, batch["features"], train=True)
        loss = self.loss_fn(batch["labels"], preds.float()).float()
        aux = collect_aux_loss(state.model)
        if aux is not None:
            loss = loss + aux
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        if counter is not None:
            # int8 arenas: fold the carrier's delta into the codes
            fold_quantized_updates(state.model, counter)
            counter.add_(1)
        return loss.detach()

    def _train_step(self, state: TrainState, batch) -> torch.Tensor:
        """One eager step (the graphs' plain version)."""
        loss = self._step_body(state, batch, self._fold_counter(state))
        state.step += 1
        return loss

    def graph_ok(self, state: TrainState, batches: Sequence) -> bool:
        """Whether a train program over `batches` runs as a captured CUDA
        graph: a CUDA trainer outside `graphs_lib.eager_loop`, a state of
        one rank (a data-parallel step runs its collectives through gloo
        on the host when ranks share the card, and a capture over NCCL is
        not done) whose optimizer keeps any step count on the device
        (`graphs_lib.graphs_ok_for`), real tensors (an abstract compile's
        fakes run the eager body), batches of tensors on the card only,
        and no capture already under way."""
        if self.device.type != "cuda" or graphs_lib.in_eager_loop():
            return False
        if state.mesh is not None and state.mesh.world_size > 1:
            return False
        if not graphs_lib.graphs_ok_for(state.optimizer):
            return False
        leaves = pytree.tree_leaves(list(batches))
        if not leaves or not all(
                isinstance(x, torch.Tensor) and x.device.type == "cuda"
                and not programs.is_abstract(x) for x in leaves):
            return False
        if programs.is_abstract(next(state.model.parameters())):
            return False
        return not torch.cuda.is_current_stream_capturing()

    def _run_steps(self, name: str, state: TrainState, batches,
                   repeat: int = 1) -> torch.Tensor:
        """`repeat` x len(batches) steps; the last run's losses (K,).
        As a graph where `graph_ok`, else the eager loop."""
        if not self.graph_ok(state, batches):
            _check_abstract_device(state)
            for _ in range(repeat):
                losses = torch.stack([self._train_step(state, b)
                                      for b in batches])
            return losses
        losses = self._graphs.run(
            state, (name, graphs_lib.batch_shapes(batches)), batches,
            self._steps_body(state), repeat=repeat)
        state.step += repeat * len(batches)
        return losses

    def _steps_body(self, state: TrainState):
        """The device work of K steps over K batches, with the fold
        counter set to `state.step` first (outside any capture)."""
        counter = self._fold_counter(state)
        return lambda batches: torch.stack(
            [self._step_body(state, b, counter) for b in batches])

    def _train_step_program(self, state: TrainState, batch) -> torch.Tensor:
        return self._run_steps("step", state, [batch])[0]

    def stage_batch(self, batch):
        """`batch`'s tensors on the device now, for a later
        train_on_batch (which leaves tensors already there as they
        are); a `train.stage` span while a profiler records."""
        traced = torch_profiler._is_profiler_enabled
        start = time.perf_counter() if traced else 0.0
        staged = self._timed("h2d_stage", lambda: run_device_serialized(
            _to_device, batch, self.device, device=self.device))
        if traced:
            SPANS.add("train.stage", start, time.perf_counter(),
                      SPANS.parent())
        return staged

    def _store(self):
        if self.tiered_store is None:
            raise ValueError(
                "the batch carries tiered-store bookkeeping but the "
                "trainer has no tiered_store")
        return self.tiered_store

    def _apply_store(self, state: TrainState, batch):
        """Execute a tiered batch's plan (eager) or prepare and apply it
        here (deferred); returns the batch without the store keys."""
        plan = batch.get(STORE_PLAN_KEY)
        pending = batch.get(STORE_SPARSE_KEY)
        if plan is None and pending is None:
            return batch
        batch = {k: v for k, v in batch.items() if k not in STORE_KEYS}
        store = self._store()
        if pending is not None:
            sparse, ranked = pending
            slots, plan = store.prepare(sparse, ranked=ranked)
            batch = _with_slots(batch, slots)
        store.apply_plan(state, plan)
        return batch

    def train_on_batch(self, state: TrainState, batch):
        """One step; returns (state, loss), the loss a 0-d f32 tensor on
        the device.  A tiered batch's admissions run first (every slot
        the step gathers must be resident, and evicted rows are read out
        before their slots are reused)."""
        batch = self._apply_store(state, batch)

        def _step():
            return self.train_step(state, _to_device(batch, self.device))

        loss = self._timed("compute", lambda: run_device_serialized(
            _step, device=self.device))
        return state, loss

    def _apply_store_block(self, state: TrainState, batches):
        """A tiered block: one admission plan over the union of the K
        batches' rows, applied once before the block.  Eagerly planned
        batches are refused: plan k+1 may evict a row batch k reads,
        with no apply point between the steps of a block."""
        if any(STORE_PLAN_KEY in b for b in batches):
            raise ValueError(
                "eager per-batch store plans cannot cover a fused "
                "multi-step block: use TieredStore.enable_deferred_"
                "prepare() so the raw sparse batches arrive here and "
                "one union plan covers the whole block")
        pendings = [b.get(STORE_SPARSE_KEY) for b in batches]
        if all(p is None for p in pendings):
            return batches
        if any(p is None for p in pendings):
            raise ValueError(
                "mixed store-prepared and raw batches in one fused block")
        slots_list, plan = self._store().prepare_block(
            [sparse for sparse, _ranked in pendings])
        self.tiered_store.apply_plan(state, plan)
        return [
            _with_slots({k: v for k, v in b.items() if k not in STORE_KEYS},
                        slots)
            for b, slots in zip(batches, slots_list)]

    def train_on_batch_stack(self, state: TrainState, batches):
        """len(batches) steps, one after another; returns (state, losses
        (K,)).  The same step as train_on_batch, so K steps here and K
        calls there give the same parameters bit for bit.  Batches of any
        wire format (plain, b22, dedup) go through as they are; the
        worker groups only batches of one shape.  Tiered batches share
        one admission plan over the block (`_apply_store_block`).
        While a profiler records, the call is a `train.call` span and,
        where the steps replay a graph, its legs its children:
        `train.check` (to the load: the graph's key and its owner's
        fingerprint), `train.load` (the copy into the static inputs),
        `train.replay` (the launch, in a range of that name) and
        `train.finish` (the copy of the losses)."""
        traced = torch_profiler._is_profiler_enabled
        start = time.perf_counter() if traced else 0.0
        batches = self._apply_store_block(state, batches)

        def _steps():
            return self.train_step_many(
                state, [_to_device(b, self.device) for b in batches])

        def _call():
            return self._timed("compute", lambda: run_device_serialized(
                _steps, device=self.device))

        if not traced:
            return state, _call()
        call_id, legs = SPANS.new_id(), Legs("train.replay")
        checked = time.perf_counter()
        with SPANS.within(call_id, legs):
            losses = _call()
        _trace_call(call_id, start, checked, time.perf_counter(), legs)
        return state, losses

    def _train_steps(self, state: TrainState, batches) -> torch.Tensor:
        return self._run_steps("steps", state, list(batches))

    def _timed_steps(self, state: TrainState, staged, iters: int) -> None:
        self._run_steps("timed", state, [staged], repeat=iters)

    def timed_steps_per_sec(self, state: TrainState, batch,
                            iters: int = 40) -> float:
        """Steps per second over `iters` serially dependent train steps
        on one staged batch: the counterpart of the JAX Trainer's
        `timed_steps_per_sec_fused`, which runs them as one program.
        The first call for a batch shape warms up with one step (the
        kernels' build and first launch, the allocator's first blocks);
        where `graph_ok`, the step is then captured before the timing
        starts, and the timed steps are `iters` replays of it.  On CUDA
        the steps are timed with CUDA events and the timing ends on a
        value read from the final parameters, so no step is left
        queued.  The state trains on: it advances by the warm-up and
        `iters` steps."""
        staged = self.stage_batch(batch)
        key = _batch_key(staged)
        if key not in self._timing_warmed or not self._capture_ahead(
                "timed", state, staged):
            self._timed_fused(state, staged, 1)
            self._timing_warmed.add(key)
            self._capture_ahead("timed", state, staged)

        def steps():
            self._timed_fused(state, staged, iters)

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

    def _capture_ahead(self, name: str, state: TrainState, staged) -> bool:
        """Capture program `name`'s graph for one staged batch before its
        next call, where `graph_ok` and the key's eager first call has
        run (no step runs).  Returns whether the next call replays or,
        off the graph path, whether no warm-up is owed: False only for a
        graphable key whose eager call has not run."""
        if not self.graph_ok(state, [staged]):
            return True
        key = (name, graphs_lib.batch_shapes([staged]))
        if not self._graphs.warmed(state, key):
            return False
        self._graphs.capture(state, key, [staged], self._steps_body(state))
        return True

    def capture_step(self, state: TrainState, batch) -> bool:
        """Capture `train_on_batch`'s graph for `batch` (host or staged,
        without tiered-store keys) ahead of its next call, so that a
        timed or profiled call replays; no step runs.  False where that
        call will not replay: off the graph path, or before the batch
        shape's eager first call."""
        staged = _to_device(
            {k: v for k, v in batch.items() if k not in STORE_KEYS},
            self.device)
        return self.graph_ok(state, [staged]) and self._capture_ahead(
            "step", state, staged)

    # ---- elastic prewarm ----------------------------------------------

    def prewarm_for_device_counts(self, sample_batch, world_sizes,
                                  block: bool = False):
        """The JAX trainer's prewarm for the world sizes a failure would
        leave: for each, the train step's abstract compile at that
        world's local rows (`aot_compile` on `abstract_state()` and a
        fake batch of rank 0's rows of `sample_batch`, a global batch of
        host arrays).  Nothing runs on the device; the ledger records
        each compile and its cost, and the kernel libraries the step
        loads at those shapes are built into the library cache
        (ops/_build.py, `--compilation_cache_dir`), where a relaunched
        rank of that world loads them without building.  What a
        relaunched process cannot inherit is the captured CUDA graph
        (worker/graphs.py), which lives in the process that captured
        it.

        Runs in a daemon thread unless `block` (tests); a world size
        outside [1, ...) is skipped, and a failure is logged and never
        raised.  On a host of fewer than 4 cores a background prewarm
        would compete with the training loop, so it is skipped there
        unless ELASTICDL_FORCE_PREWARM=1."""
        force = os.environ.get("ELASTICDL_FORCE_PREWARM") == "1"
        if not force and not block and (os.cpu_count() or 1) < 4:
            logger.info(
                "prewarm skipped: %s cores is too few to compile in the "
                "background without starving the training loop",
                os.cpu_count())
            return None

        def work():
            for world in world_sizes:
                try:
                    self._prewarm_one(int(world), sample_batch)
                except Exception as exc:  # advisory path, never fatal
                    logger.info("prewarm for %s-rank world skipped: %s",
                                world, exc)

        if block:
            work()
            return None
        thread = threading.Thread(target=work, daemon=True)
        thread.start()
        return thread

    def _prewarm_one(self, world: int, sample_batch) -> None:
        t0 = time.perf_counter()
        global_rows = len(np.asarray(sample_batch["labels"]))
        if not 0 < world <= global_rows:
            return
        rows = -(-global_rows // world)     # rank 0's rows at that world

        def local(leaf):
            arr = np.asanyarray(leaf)
            return arr[:rows] if arr.ndim and arr.shape[0] == global_rows \
                else arr

        host = _to_device(map_host_batch(local, sample_batch),
                          torch.device("cpu"))
        batch = programs.abstract_like(host, self.device)
        # one rank's step: the thread must not read the group's mesh
        # (a rank's default), whose collectives would run on the fakes
        with mesh_lib.using_mesh(mesh_lib.ProcessMesh()):
            self.train_step.aot_compile(self.abstract_state(), batch)
        logger.info(
            "prewarmed train step for %d-rank world in %.1fs (library "
            "cache populated)", world, time.perf_counter() - t0)

    # ---- data parallel ---------------------------------------------------

    def _train_step_global(self, state: TrainState, shard,
                           mesh) -> torch.Tensor:
        """One step of the group over a global batch; `shard` is this
        rank's rows (a mesh.LocalShard, already on the device)."""
        mesh_lib.set_current_mesh(mesh)
        batch = shard.batch
        preds = self._forward(state.model, batch["features"], train=True)
        loss = self.loss_fn(batch["labels"], preds.float()).float()
        aux = collect_aux_loss(state.model)
        state.optimizer.zero_grad(set_to_none=True)
        objective = loss * objective_weight(shard, mesh)
        if aux is not None:
            objective = objective + aux / mesh.world_size
        objective.backward()
        totals = torch.stack([loss.detach() * shard.rows,
                              torch.tensor(float(shard.rows),
                                           device=loss.device)])
        reduce_gradients(state, mesh, extra=totals)
        state.optimizer.step()
        counter = self._fold_counter(state)
        if counter is not None:
            fold_quantized_updates(state.model, counter)
        state.step += 1
        mean = totals[0] / totals[1]
        return mean if aux is None else mean + aux.detach()

    def _apply_store_global(self, state: TrainState, shard, mesh):
        """A tiered batch on a mesh: its plan (or its raw ids, planned
        here) covers the global batch, so every rank plans alike; the
        store applies this rank's block of the admissions, and the rank
        keeps its rows of the global slots.  Returns the shard without
        the store keys."""
        if not any(k in shard.batch for k in STORE_KEYS):
            return shard
        deferred = STORE_SPARSE_KEY in shard.batch
        batch = self._apply_store(state, shard.batch)
        if deferred:
            start, stop = mesh_lib.local_batch_range(mesh, shard.global_rows)
            batch = _with_slots(batch, to_tensor(
                batch["features"]["slots"][start:stop], self.device))
        return dataclasses.replace(shard, batch=batch)

    def train_on_global_batch(self, state: TrainState, shard, mesh):
        """One data-parallel step; returns (state, loss), the loss the
        mean over every row of the global batch (a 0-d f32 tensor on the
        device, the same on every rank).  A tiered batch's admissions
        run first (`_apply_store_global`)."""
        shard = self._apply_store_global(state, shard, mesh)

        def _step():
            return self.train_step_global(state, shard, mesh)

        loss = self._timed("compute", lambda: run_device_serialized(
            _step, device=self.device))
        return state, loss

    def train_on_global_batch_stack(self, state: TrainState, shards, mesh):
        """len(shards) data-parallel steps in order (steps_per_execution);
        returns (state, losses (K,)), the same bits as K single steps."""
        losses = [self.train_on_global_batch(state, shard, mesh)[1]
                  for shard in shards]
        return state, torch.stack(losses)

    def predict_on_global_batch(self, state: TrainState, shard,
                                mesh) -> np.ndarray:
        """Every rank's predictions for the global batch, in row order,
        on every rank (this rank predicts its rows; a gather joins
        them)."""
        def _predict():
            mesh_lib.set_current_mesh(mesh)
            return self.eval_step(state, shard.batch["features"])

        local = run_device_serialized(_predict, device=self.device)
        return collectives.host_allgather(local, mesh)

    def _eval_body(self, state: TrainState):
        """The eval forward's device work over `state` (a graph captures
        this): BatchNorm and dropout models run with train=False."""
        def body(features):
            with torch.no_grad():
                preds = self._forward(state.model, features, train=False)
            return preds.float()

        return body

    def _eval_step(self, state: TrainState, features) -> torch.Tensor:
        """f32 predictions on the device: as a graph of the state where
        `eval_graph_ok`, else eagerly.  A replay's output is copied out
        of the graph under its pool's lock, so a thread's predictions are
        its own."""
        body = self._eval_body(state)
        if not self.eval_graph_ok(state, features):
            return body(features)
        return self._graphs.run(
            state, ("eval", graphs_lib.batch_shapes(features)), features,
            body, fingerprint=graphs_lib.model_fingerprint)

    def eval_graph_ok(self, state: TrainState, features) -> bool:
        """Whether `worker_eval_step` over `features` runs as a captured
        CUDA graph: a CUDA trainer outside `graphs_lib.eager_loop`, a
        world of one (a sharded model's forward runs collectives, ring
        attention on `seq` for one, and a capture over them is not done),
        real tensors, all on the card, and no capture already under
        way."""
        if self.device.type != "cuda" or graphs_lib.in_eager_loop():
            return False
        if any(mesh is not None and mesh.world_size > 1 for mesh in (
                state.mesh, mesh_lib.get_current_mesh())):
            return False
        leaves = pytree.tree_leaves(features)
        if not leaves or not all(
                isinstance(x, torch.Tensor) and x.device.type == "cuda"
                and not programs.is_abstract(x) for x in leaves):
            return False
        first = next(state.model.parameters())
        if programs.is_abstract(first) or first.device.type != "cuda":
            return False
        return not torch.cuda.is_current_stream_capturing()

    def predict_on_batch(self, state: TrainState, features) -> np.ndarray:
        """f32 predictions as numpy."""
        def _predict():
            return self.eval_step(
                state, _to_device(features, self.device)).cpu().numpy()

        return run_device_serialized(_predict, device=self.device)


def _trace_call(call_id: int, start: float, checked: float, end: float,
                legs: Legs) -> None:
    """A traced `train_on_batch_stack` call and, where it replayed a
    graph, its legs (`Legs.marks`: load, replay, launched, finished)."""
    if len(legs.marks) == 4:
        load, replay, launched, finished = legs.marks
        for name, a, b in (("train.check", checked, load),
                           ("train.load", load, replay),
                           ("train.replay", replay, launched),
                           ("train.finish", launched, finished)):
            SPANS.add(name, a, b, call_id)
    SPANS.add("train.call", start, end, SPANS.parent(), span_id=call_id)


def _check_abstract_device(state: TrainState) -> None:
    """An abstract train step on CUDA needs a PyTorch built with CUDA:
    autograd asks the device of each parameter for a stream, and a
    build without CUDA ends the process there.  Raise first."""
    first = next(state.model.parameters())
    if (programs.is_abstract(first) and first.device.type == "cuda"
            and not torch.backends.cuda.is_built()):
        raise RuntimeError(
            "an abstract train step on CUDA needs a CUDA build of "
            "PyTorch (autograd asks the device for a stream); this one "
            "has none")


def map_host_batch(fn, tree):
    """fn over the leaves of a host batch's nested dicts (numpy arrays,
    which a pytree map would take apart no further either)."""
    if isinstance(tree, dict):
        return {k: map_host_batch(fn, v) for k, v in tree.items()}
    return fn(tree)


def objective_weight(shard, mesh) -> float:
    """This rank's weight on its loss (a mean over its rows): its share
    of the global rows, over the number of ranks that hold the same rows
    and so compute the same loss."""
    replicas = mesh.world_size // mesh.shape[mesh_lib.DATA_AXIS]
    return shard.rows / shard.global_rows / replicas


def reduce_gradients(state: TrainState, mesh, extra=None) -> None:
    """Sum each parameter's gradient over the ranks that hold the same
    values of it: every axis of size > 1 but those its spec shards it
    on (a parameter the step did not reach gets a zero gradient, as
    JAX's, so every rank reduces the same layout).  `extra` (the loss
    totals) is summed over `data` with the gradients that reduce there,
    in one buffer."""
    live = tuple(a for a in mesh_lib.AXES if mesh.shape[a] > 1)
    buckets: Dict[tuple, list] = {}
    for name, p in state.model.named_parameters():
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        spec = state.shardings.get(name) or ()
        axes = tuple(a for a in live if a not in spec)
        buckets.setdefault(axes, []).append(p.grad)
    if extra is not None:
        data = (mesh_lib.DATA_AXIS,) if mesh_lib.DATA_AXIS in live else ()
        buckets.setdefault(data, []).append(extra)
    for axes, tensors in buckets.items():
        if axes:
            collectives.all_reduce_sum_(tensors, mesh, axes)


def shard_state(state: TrainState, param_sharding_fn, mesh) -> None:
    """Keep this rank's shard of every parameter `param_sharding_fn`
    gives a spec (before the optimizer has state), and of an int8
    arena's `q8` and `scale` buffers by its carrier's spec (the JAX
    trainer shards the "quantized" collection by the params' rule);
    records the specs and the mesh on `state`."""
    from elasticdl_tpu_torch.common.weights import shard_tensor

    specs = {}
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            spec = param_sharding_fn(name, p)
            if spec is None:
                continue
            specs[name] = tuple(spec)
            p.data = shard_tensor(p.data, specs[name], mesh).clone()
        for prefix in plane_prefixes(dict(state.model.named_buffers())):
            spec = specs.get(plane_key(prefix, "embedding"))
            if spec is None:
                continue
            arena = state.model.get_submodule(prefix)
            for leaf in PLANE_KEYS:
                specs[plane_key(prefix, leaf)] = spec
                setattr(arena, leaf, shard_tensor(
                    getattr(arena, leaf), spec, mesh).clone())
    state.shardings = specs
    state.mesh = mesh
