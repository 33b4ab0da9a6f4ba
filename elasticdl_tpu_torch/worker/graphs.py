"""The world-of-one train programs as captured CUDA graphs: the port's
compile (the counterpart of the JAX trainer's jitted `train_step`,
`train_step_many` and fused timing loop).

A `StepGraphs` holds the graphs of one Trainer.  Each program call names
a key (the program and its batches' shapes) and a body, the device work
of K train steps over K batches, which returns their losses.  Per state
and key:

- the first call runs the body eagerly, on a side stream: it is the
  registry's counted call (common/programs.py), creates the optimizer
  state, builds the kernels and warms the allocator, and is the
  side-stream warm-up PyTorch asks for before a capture (a second
  thread training the same state makes its own first call eagerly);
- the next call captures the body over static copies of the batches
  (`torch.cuda.graph`, the Trainer's one memory pool), then copies its
  batches in and replays;
- every later call copies its batches into the static buffers and
  replays.

A capture that fails raises; nothing goes eager in its place.  A graph
bakes in the addresses of the state's parameters, buffers and optimizer
state and the optimizer's hyperparameters: when any of them changes (a
checkpoint restore loads new optimizer tensors) the key captures anew.

Hand kernels count their launches in Python (ops/), and a replay runs
no Python.  A capture runs each wrapper once and launches nothing, so
its counts are taken back, kept as the graph's `launches`, and each
replay adds them: the counters mean what they meant before.

A graph holds only an optimizer whose step counts live on the device
(`graphs_ok_for`); `capturable_adam` builds Adam and AdamW so, counting
in float64.  `eager_loop()` keeps a thread's programs on the eager loop,
the graphs' plain version, which a check holds them against.

What a process cannot hand on is its graphs: a relaunched rank captures
its own.  What it inherits is the kernel library cache that an abstract
compile (`RegisteredProgram.aot_compile`) fills.
"""

from __future__ import annotations

import contextlib
import inspect
import threading
import weakref
from typing import Callable, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

def _launch_counters():
    """{name: (owner, attribute)} of every plain launch count of the hand
    kernels, and {name: per-variant count dict}."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import scatter_add as sa

    flash = fa.flash_attention
    scalars = {"flash_attention_fwd": (flash, "launches"),
               "flash_attention_bwd": (flash, "backward_launches"),
               "scatter_add": (sa.scatter_add, "launches")}
    dicts = {"flash_attention_fwd": flash.launches_by_kernel,
             "flash_attention_bwd": flash.backward_launches_by_kernel}
    return scalars, dicts


def launch_counts() -> Dict[str, int]:
    """Every hand-kernel launch count, flat ("scatter_add",
    "flash_attention_fwd", "flash_attention_fwd.sm90_wgmma", ...)."""
    scalars, dicts = _launch_counters()
    out = {name: getattr(owner, attr)
           for name, (owner, attr) in scalars.items()}
    for name, counts in dicts.items():
        for variant, n in counts.items():
            out[f"{name}.{variant}"] = n
    return out


def _set_counts(values: Dict[str, int]) -> None:
    scalars, dicts = _launch_counters()
    for name, (owner, attr) in scalars.items():
        setattr(owner, attr, values[name])
    for name, counts in dicts.items():
        for variant in counts:
            counts[variant] = values[f"{name}.{variant}"]


def add_launches(delta: Dict[str, int]) -> None:
    """Add `delta` to the launch counts."""
    now = launch_counts()
    _set_counts({k: v + delta.get(k, 0) for k, v in now.items()})


# ---- the eager loop, for a reference -----------------------------------------

_EAGER = threading.local()


@contextlib.contextmanager
def eager_loop():
    """Run this thread's train programs on the eager loop (the graphs'
    plain version) inside the block, as the CPU runs them: what a check
    holds a graph against."""
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


def state_fingerprint(state) -> tuple:
    """What a graph of `state` bakes in: the address of every parameter,
    buffer and optimizer-state tensor, and the optimizer's settings."""
    ptrs = [t.data_ptr() for t in state.model.parameters()]
    ptrs += [t.data_ptr() for t in state.model.buffers()]
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


class CudaGraphBackend:
    """The CUDA calls a `StepGraphs` makes: a side stream for the eager
    first call, and the capture into a graph over one memory pool (a new
    pool once every graph of the last one has died)."""

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
        """Capture body() into a graph; returns replay() -> the static
        output that each replay rewrites."""
        if self._pool is None or not len(self._graphs):
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # only this thread's calls are held to the capture's rules: a
        # serving thread beside the trainer (the online loop) goes on
        # with its own copies and streams
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
    """One key's graph: its static batches, its replay, its
    fingerprint, and the launches its capture took back."""

    def __init__(self, static, replay, fingerprint, launches):
        self.static = static
        self.replay = replay
        self.fingerprint = fingerprint
        self.launches = launches

    def load(self, batches) -> None:
        for dst, src in zip(pytree.tree_leaves(self.static),
                            pytree.tree_leaves(batches)):
            dst.copy_(src, non_blocking=True)


class _KeyGraphs:
    """What a state holds for one key: the threads whose eager call has
    run there, and the current graph (None before a capture)."""

    def __init__(self):
        self.threads: set = set()
        self.captured: Optional[_Captured] = None


class StepGraphs:
    """The captured train programs of one Trainer (one memory pool for
    all its graphs: a new batch shape does not hold a second step's
    activations).  Graphs live on each state (`TrainState.graphs`), as
    they bake in its tensors.

    Several threads may train one state in turn (the Local runner's
    workers share one model).  A capture runs on the calling thread and
    needs what that thread's eager call sets up (its cuBLAS handle, which
    cannot be created inside a capture), so each thread's first call at
    a key runs eagerly, and a graph is captured by a thread that has
    made one; any thread replays it."""

    def __init__(self, device: torch.device, backend=None):
        self.device = device
        self.backend = backend or CudaGraphBackend(device)

    def warmed(self, state, key) -> bool:
        """Whether this thread's eager call at `key` has run on `state`."""
        entry = state.graphs.get(key)
        return entry is not None and threading.get_ident() in entry.threads

    def run(self, state, key, batches, body: Callable,
            repeat: int = 1) -> Optional[torch.Tensor]:
        """`repeat` runs of body(batches) (K steps each) for `key`: this
        thread's first call at the key eagerly on the side stream, later
        ones by replay (capturing first where the key has no current
        graph).  Returns the last run's losses, a tensor of its own."""
        if not self.warmed(state, key):
            with self.backend.side_stream():
                for _ in range(repeat):
                    out = body(batches)
            state.graphs.setdefault(key, _KeyGraphs()).threads.add(
                threading.get_ident())
            return out
        captured = self.capture(state, key, batches, body)
        captured.load(batches)
        for _ in range(repeat):
            out = captured.replay()
            add_launches(captured.launches)
        return out.clone()

    def captured(self, state, key) -> Optional[_Captured]:
        """`key`'s current graph on `state`, if one was captured."""
        entry = state.graphs.get(key)
        return None if entry is None else entry.captured

    def capture(self, state, key, batches, body: Callable) -> _Captured:
        """`key`'s current graph, captured over static copies of
        `batches` unless one whose fingerprint still holds exists.  This
        thread's eager call at the key must have run (it creates what the
        graph reads); a failed capture raises."""
        if not self.warmed(state, key):
            raise RuntimeError(
                f"{key[0]}: a graph is captured only after the key's "
                "eager call on the capturing thread")
        entry = state.graphs[key]
        fingerprint = state_fingerprint(state)
        if entry.captured is not None and \
                entry.captured.fingerprint == fingerprint:
            return entry.captured
        # an old graph of the key goes first: its memory returns to the
        # pool before the new capture draws from it
        entry.captured = None
        static = pytree.tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
            batches)
        before = launch_counts()
        try:
            replay = self.backend.capture(lambda: body(static))
        finally:
            captured = launch_counts()
            _set_counts(before)
        launches = {k: captured[k] - before[k] for k in before
                    if captured[k] != before[k]}
        entry.captured = _Captured(static, replay,
                                   state_fingerprint(state), launches)
        return entry.captured


def batch_shapes(batches: List) -> tuple:
    """The shapes and dtypes of K batches of tensors (a graph's key)."""
    leaves, spec = pytree.tree_flatten(batches)
    return (str(spec), tuple(
        (tuple(x.shape), str(x.dtype)) if isinstance(x, torch.Tensor)
        else ("py", repr(x)) for x in leaves))
