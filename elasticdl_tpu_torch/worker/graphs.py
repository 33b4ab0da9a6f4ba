"""The port's compile: the registered device programs as captured CUDA
graphs (the counterpart of the JAX package's jitted programs).

What runs as a graph on CUDA:

- a world-of-one Trainer's `worker_train_step`, `worker_train_step_many`
  and `worker_timed_fused` (K train steps over K batches; graphs on the
  state, `TrainState.graphs`) and its `worker_eval_step` (the forward
  with train=False, on the state too: an eval task's snapshot state
  captures its own graph and frees it with itself);
- a `ServingEngine`'s `serving_forward`, one graph per batch shape (a
  bucket), on the engine, over its static served generation;
- the tiered store seam's `store_gather` and `store_admit`
  (store/device.py), one graph per index bucket and cache dtype, on the
  state, for whole cache tables.

What stays eager: `worker_init_state` (one call per state, so a graph
would never replay), the data-parallel `worker_train_step` and every
program on a cache row-sharded over `model` (their collectives run
through gloo on the host), and the CPU, which always runs the eager
version.

A `ProgramGraphs` runs the graphs of the objects that own them.  Per
owner and key (the program and its inputs' shapes):

- the first call on a thread, while the key has no graph, runs eagerly,
  on a side stream: it is the registry's counted call
  (common/programs.py), builds the kernels, sets up the thread's cuBLAS
  handle, which cannot be created inside a capture, and is the
  side-stream warm-up PyTorch asks for before a capture;
- a thread that has made that call captures the program over static
  copies of its inputs (`torch.cuda.graph`, the runner's one memory
  pool; captures are serialized in the process by `CAPTURE_LOCK`), then
  copies its inputs in and replays;
- any thread replays a current graph: its inputs are copied into the
  static inputs (host arrays too: the copy runs before the replay, as a
  pageable copy cannot be captured), and the static output that the
  replay rewrites is read before another replay of the runner's pool:
  the graphs of one pool share its memory, so a capture, and a load,
  its replay and the read of its output, hold the pool's lock.

A capture that fails raises; nothing goes eager in its place, and
dispatch is on an explicit predicate (`Trainer.graph_ok`,
`Trainer.eval_graph_ok`, `ServingEngine.graph_ok`,
`store.device.graph_ok`), never on a caught exception.  A graph bakes in
the addresses of its owner's tensors (`state_fingerprint`,
`model_fingerprint`) and, for a train step, the optimizer's
hyperparameters: when any of them changes (a checkpoint restore loads
new tensors) the key captures anew.  A serving engine's addresses never
change: a hot swap copies the new generation into them.

Hand kernels count their launches in Python (ops/launches.py), and a
replay runs no Python.  A launch made on a capturing stream is recorded,
not run: it goes to the capture's tally, which the graph keeps and each
replay adds, so the counters mean what they meant before.

A train-step graph holds only an optimizer whose step counts live on the
device (`graphs_ok_for`); `capturable_adam` builds Adam and AdamW so,
counting in float64.  `eager_loop()` keeps a thread's programs on the
eager loop, the graphs' plain version, which a check holds them against.

What a process cannot hand on is its graphs: a relaunched rank captures
its own.  What it inherits is the kernel library cache that an abstract
compile (`RegisteredProgram.aot_compile`) fills.
"""

from __future__ import annotations

import contextlib
import inspect
import threading
import weakref
from typing import Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from elasticdl_tpu_torch.common.profiler import SPANS, torch_profiler
from elasticdl_tpu_torch.ops import launches as launches_lib


# ---- the eager loop, for a reference -----------------------------------------

_EAGER = threading.local()


@contextlib.contextmanager
def eager_loop():
    """Run this thread's programs (train, eval, serving, the store seam)
    on the eager loop, the graphs' plain version, inside the block, as
    the CPU runs them: what a check holds a graph against."""
    depth = getattr(_EAGER, "depth", 0)
    _EAGER.depth = depth + 1
    try:
        yield
    finally:
        _EAGER.depth = depth


def in_eager_loop() -> bool:
    """Whether this thread is inside `eager_loop`."""
    return getattr(_EAGER, "depth", 0) > 0


# ---- the optimizer a graph holds -----------------------------------------------


def capturable_adam(opt: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """`opt` as a graph can hold it, where it is Adam or AdamW: rebuilt
    capturable (its step counts on the device, where a replay reads
    them), with those counts in float64.  PyTorch's capturable Adam
    computes the bias corrections 1 - beta**t in the counts' dtype, and
    creates them in float32: beta2 = 0.999 is 0.99900001287 there, so
    1 - beta2**t is 1.3e-5 low and every update 6.4e-6 smaller than
    plain Adam's, whose corrections are Python floats.  In float64 the
    corrections round to plain Adam's, and the two differ only in the
    order of the last multiply and divide (an ulp of an update).  Any
    other optimizer is returned as it is (`graphs_ok_for` says whether a
    graph may hold it)."""
    if not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        return opt
    if not all(group["capturable"] for group in opt.param_groups):
        takes = inspect.signature(type(opt).__init__).parameters
        settings = {k: v for k, v in opt.defaults.items() if k in takes}
        opt = type(opt)([dict(group, capturable=True)
                         for group in opt.param_groups],
                        **dict(settings, capturable=True))
    opt.register_step_pre_hook(_create_float64_state)
    return opt


def _create_float64_state(opt, args, kwargs) -> None:
    """A capturable Adam's state for each parameter that has a gradient
    and no state yet, created as PyTorch creates it but for the step
    count's dtype (float64, `capturable_adam`).  After the first step
    (which a graph never is: its key's first call runs eagerly) this
    finds nothing to do."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None or opt.state.get(p):
                continue
            state = opt.state[p]
            state["step"] = torch.zeros((), dtype=torch.float64,
                                        device=p.device)
            for key in ("exp_avg", "exp_avg_sq") + (
                    ("max_exp_avg_sq",) if group["amsgrad"] else ()):
                state[key] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def float64_step_counts(opt: torch.optim.Optimizer) -> None:
    """Put the step counts of a capturable Adam's state back in float64
    (`Optimizer.load_state_dict` casts a capturable group's to
    float32)."""
    if not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        return
    for group in opt.param_groups:
        if not group["capturable"]:
            continue
        for p in group["params"]:
            state = opt.state.get(p)
            if state and state["step"].dtype != torch.float64:
                state["step"] = state["step"].to(torch.float64)


def graphs_ok_for(opt: torch.optim.Optimizer) -> bool:
    """Whether a graph may hold `opt`'s step: an optimizer that keeps a
    step count keeps it on the device (capturable), else a graph would
    bake in its bias corrections at the captured step."""
    return all(group.get("capturable", True) for group in opt.param_groups)


def model_fingerprint(state) -> tuple:
    """What a forward's graph of `state` bakes in: the address of every
    parameter and buffer of its model."""
    return tuple(t.data_ptr() for t in state.model.parameters()) + tuple(
        t.data_ptr() for t in state.model.buffers())


def state_fingerprint(state) -> tuple:
    """What a train step's graph of `state` bakes in: the address of
    every parameter, buffer and optimizer-state tensor, and the
    optimizer's settings."""
    ptrs = list(model_fingerprint(state))
    for entry in state.optimizer.state.values():
        ptrs += [v.data_ptr() for v in entry.values()
                 if isinstance(v, torch.Tensor)]
    counter = state.fold_counter
    if isinstance(counter, torch.Tensor):
        ptrs.append(counter.data_ptr())
    settings = tuple(
        tuple(sorted((k, repr(v)) for k, v in group.items()
                     if k != "params"))
        for group in state.optimizer.param_groups)
    return tuple(ptrs), settings


# One capture at a time in the process: two threads capturing at once
# (a trainer and a serving engine's warm-up in one process) would share
# PyTorch's capture stream, and the launch tally (ops/launches.py) is
# one.  Replays do not take it.
CAPTURE_LOCK = threading.RLock()


class CudaGraphBackend:
    """The CUDA calls a `ProgramGraphs` makes: a side stream for the
    eager first call, and the capture into a graph over one memory pool
    (a new pool once every graph of the last one has died)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._pool = None
        # the graphs alive in the pool: once the last is gone, PyTorch
        # releases the pool, and a capture into its handle would fail
        self._graphs = weakref.WeakSet()
        self._stream = None

    @contextlib.contextmanager
    def side_stream(self):
        current = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(current)
        try:
            with torch.cuda.stream(self._stream):
                yield
        finally:
            current.wait_stream(self._stream)

    def capture(self, body: Callable[[], torch.Tensor]):
        """Capture body() into a graph, holding the process's capture
        lock; returns replay() -> the static output that each replay
        rewrites."""
        with CAPTURE_LOCK:
            if self._pool is None or not len(self._graphs):
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # only this thread's calls are held to the capture's rules:
            # a serving thread beside the trainer (the online loop) goes
            # on with its own copies and streams
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                out = body()

        def replay():
            graph.replay()
            return out

        # the closure holds the graph, and lives as long as it
        self._graphs.add(replay)
        return replay


class _Captured:
    """One key's graph: its static inputs, its replay, its fingerprint,
    and the launches its capture recorded."""

    def __init__(self, static, replay, fingerprint, launches):
        self.static = static
        self.replay = replay
        self.fingerprint = fingerprint
        self.launches = launches

    def load(self, inputs) -> None:
        """Copy `inputs` (host or device tensors) into the static inputs,
        on the current stream, ahead of a replay."""
        for dst, src in zip(pytree.tree_leaves(self.static),
                            pytree.tree_leaves(inputs)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src, non_blocking=True)


class _KeyGraphs:
    """What an owner holds for one key: the threads whose eager call has
    run there, and the current graph (None before a capture)."""

    def __init__(self):
        self.threads: set = set()
        self.captured: Optional[_Captured] = None


def _own(out):
    """A copy of a replay's output that the next replay leaves alone."""
    return pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, out)


class ProgramGraphs:
    """Captured programs of the objects that own them (an engine, a train
    state): each owner keeps its graphs in its `graphs` dict, by key (the
    program and its inputs' shapes), since a graph bakes in the
    addresses of the owner's tensors.  One memory pool for all the
    graphs made here (`backend`).

    Per owner and key, `run`:

    - replays the current graph where there is one, on any thread:
      `load` copies the inputs into its static inputs, the replay
      rewrites its static output, and `finish` reads that output;
    - else, on a thread whose eager call at the key has run, captures
      the body over static copies of the inputs and replays it;
    - else runs the body eagerly on a side stream: the thread's first
      call, which builds the kernels and sets up what a capture needs on
      this thread (its cuBLAS handle cannot be created inside one), and
      is the side-stream warm-up PyTorch asks for before a capture.

    The graphs of one pool share its memory: a graph's static output may
    lie where another's intermediates go during its replay.  So a
    capture, and a load, its replay and the read of its output, hold the
    pool's lock (`lock`): no other graph of the pool replays in between.
    The eager calls run outside it.

    A graph whose owner's `fingerprint` has changed since its capture (a
    restore put new tensors in the model or the optimizer) is captured
    anew.  A capture that fails raises; nothing goes eager in its
    place."""

    def __init__(self, device: torch.device, backend=None,
                 fingerprint: Callable = state_fingerprint):
        self.device = device
        self.backend = backend or CudaGraphBackend(device)
        self.fingerprint = fingerprint
        self.lock = threading.RLock()
        # captures and replays made here, by program (a key's first item)
        self.captures: Dict[str, int] = {}
        self.replays: Dict[str, int] = {}

    def _entry(self, owner, key) -> _KeyGraphs:
        # dict.setdefault is atomic: two threads get one entry
        return owner.graphs.setdefault(key, _KeyGraphs())

    def warmed(self, owner, key) -> bool:
        """Whether this thread's eager call at `key` has run on `owner`."""
        entry = owner.graphs.get(key)
        return entry is not None and threading.get_ident() in entry.threads

    def captured(self, owner, key, fingerprint=None) -> Optional[_Captured]:
        """`key`'s current graph on `owner`: captured, and its owner's
        fingerprint unchanged since."""
        entry = owner.graphs.get(key)
        if entry is None or entry.captured is None:
            return None
        now = (fingerprint or self.fingerprint)(owner)
        return entry.captured if entry.captured.fingerprint == now else None

    def run(self, owner, key, inputs, body: Callable, repeat: int = 1,
            finish: Callable = _own, fingerprint=None):
        """`repeat` runs of body(inputs) for `key` (see the class), and
        finish(the last run's output): a copy of its own by default.
        While a profiler records, a replay marks the thread's `Legs`
        (common/profiler.py), which it takes, so that a run below it
        finds none."""
        legs = SPANS.take_legs() if torch_profiler._is_profiler_enabled \
            else None
        entry = self._entry(owner, key)
        with self.lock:
            if (self.captured(owner, key, fingerprint) is not None
                    or self.warmed(owner, key)):
                captured = self.capture(owner, key, inputs, body,
                                        fingerprint)
                if legs is not None:
                    legs.mark()
                captured.load(inputs)
                if legs is None:
                    for _ in range(repeat):
                        out = captured.replay()
                        launches_lib.add(captured.launches)
                else:
                    out = self._traced_replays(captured, repeat, legs)
                self.replays[key[0]] = self.replays.get(key[0], 0) + repeat
                out = finish(out)
                if legs is not None:
                    legs.mark()
                return out
        with self.backend.side_stream():
            staged = pytree.tree_map(self._staged, inputs)
            for _ in range(repeat):
                out = body(staged)
        entry.threads.add(threading.get_ident())
        return finish(out)

    @staticmethod
    def _traced_replays(captured: _Captured, repeat: int, legs):
        """The replays inside a range named `legs.replay`, marked at
        their start and at the last one's return."""
        legs.mark()
        with torch_profiler.record_function(legs.replay):
            for _ in range(repeat):
                out = captured.replay()
                launches_lib.add(captured.launches)
        legs.mark()
        return out

    def _staged(self, leaf):
        return leaf.to(self.device) if isinstance(leaf, torch.Tensor) \
            else leaf

    def capture(self, owner, key, inputs, body: Callable,
                fingerprint=None) -> _Captured:
        """`key`'s current graph, captured over static copies of `inputs`
        unless one whose fingerprint still holds exists.  This thread's
        eager call at the key must have run (it creates what the graph
        reads); a failed capture raises."""
        fingerprint = fingerprint or self.fingerprint
        with self.lock:
            current = self.captured(owner, key, fingerprint)
            if current is not None:
                return current
            if not self.warmed(owner, key):
                raise RuntimeError(
                    f"{key[0]}: a graph is captured only after the key's "
                    "eager call on the capturing thread")
            entry = self._entry(owner, key)
            # an old graph of the key goes first: its memory returns to
            # the pool before the new capture draws from it
            entry.captured = None
            static = pytree.tree_map(
                lambda t: t.to(self.device, copy=True)
                if isinstance(t, torch.Tensor) else t, inputs)
            with CAPTURE_LOCK, launches_lib.capturing() as tally:
                replay = self.backend.capture(lambda: body(static))
            entry.captured = _Captured(static, replay, fingerprint(owner),
                                       dict(tally))
            self.captures[key[0]] = self.captures.get(key[0], 0) + 1
            return entry.captured


def batch_shapes(batches) -> tuple:
    """The shapes and dtypes of a tree of tensors (a graph's key)."""
    leaves, spec = pytree.tree_flatten(batches)
    return (str(spec), tuple(
        (tuple(x.shape), str(x.dtype)) if isinstance(x, torch.Tensor)
        else ("py", repr(x)) for x in leaves))
