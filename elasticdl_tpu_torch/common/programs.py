"""Program observatory: a process-wide registry of the port's programs
and kernel builds (the port of the JAX package's common/programs.py).

Every device entry point of the port registers here: the trainer's
steps, the serving forward and the tiered store's seam through
:func:`registered_jit`, and each nvcc build of a hand kernel through
:func:`register_compiled` (ops/_build.py).  The registry records, per
named program and per distinct signature:

- compile wall seconds (``worker_program_compile_seconds{program}``
  histogram, injectable clock so tests replay deterministically);
- compile / retrace counts and the distinct-signature count;
- the program's cost per execution, flops and bytes.

The metric names, the event fields, the storm window and the views
(`ledger`, `summary`, `forensics`) are the reference's, so `/varz`, the
CLIs and incident bundles read alike.

**What a compile is here.**  PyTorch runs eagerly and traces nothing, so
a "compile" of a :class:`RegisteredProgram` is its first dispatch at a
new signature (the pytree structure of its arguments from
`torch.utils._pytree`, plus each leaf's shape, dtype and device).  That
call is timed by the registry's clock, and its cost is counted on that
same call by a `TorchDispatchMode` (:class:`CostCounter`); later calls
at the signature go straight through.  No extra execution ever touches
state, and the arithmetic is the same with the registry as without it.

- flops: `torch.utils.flop_counter`'s formulas, per aten op;
- bytes: each aten op's input and output bytes, which is what an eager
  program moves through HBM (views and allocations move nothing);
- hand kernels, registered as `torch.library` custom ops
  (`elasticdl_torch::...`), by their own analytic formulas
  (:func:`register_kernel_cost`; the same counts `chip_smoke.py` uses
  for their bounds).  The ops they run inside are not counted again.

The autograd engine runs a CUDA backward on its own device thread; it
carries the dispatch mode of the thread that called `backward()`, so the
backward's ops are counted too (`chip_smoke.py` checks it on the card:
the scatter-add runs only in the backward).

**The abstract compile.**  `RegisteredProgram.aot_compile(*args)` is
the reference's AOT path: it takes abstract arguments, fake tensors
made by :func:`abstract_like` (the port's `ShapeDtypeStruct`) and
states built on them, runs the program once under the process's
`FakeTensorMode` with a :class:`CostCounter`, and records one compile
with its wall seconds, flops and bytes.  Nothing is dispatched to a
device and no kernel runs; the state it runs on is a fake copy, so no
real state changes (the counterpart of `jax.eval_shape`).  It builds
into the library cache (ops/_build.py) each hand-kernel library that
the custom ops it reached will need at those shapes, chosen by the same
predicates as the wrappers' (:func:`register_kernel_libraries`).  A
cost that reads the data (the scatter-add's touched rows) takes its
upper bound there, and the ledger marks such an entry `"abstract":
true`.  `cost_for` answers for a signature that has not run through
`aot_compile`, as the reference's does.  What a process cannot hand on
is the CUDA graphs its programs capture (worker/graphs.py): they live in
that process.

**Graphs.**  On CUDA the train steps, `worker_eval_step`,
`serving_forward`, `store_gather` and `store_admit` run as captured CUDA
graphs.  A signature's first call runs eagerly and is its counted call,
as above; a capture records no second compile (a serving engine's
warm-up captures outside the registered call, and a capture inside one
is a later call at a signature already seen); a replay is an execution
of its program at the cost the counted call recorded.

**A difference kept on purpose.**  In the reference, a dispatch-path
compile carries flops 0 and bytes 0 (XLA's cost model comes only from an
AOT query); the port's carry the counted cost.

Joining per-program cost against the worker's step rate
(``bind_step_rate``) gives the live ``worker_program_bytes_per_sec`` /
``worker_mfu_ratio`` / ``worker_hbm_utilization_ratio`` gauges, against
the card's datasheet peaks (:func:`device_peaks`; 0 on any card without
an entry, and on the CPU).

Retrace detection closes the loop: a program whose distinct-signature
count exceeds its declared budget (the serving engine declares its
bucket count) within ``storm_window_s`` emits a ``recompile_storm``
event and fires the ``on_storm`` hook, which the FlightRecorder wires
to capture an incident bundle with a ``programs.json`` ledger section.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common import metrics as metrics_lib

# How long a compile-seconds sample list is kept per program (for the
# ledger's p50/p99; the histogram metric keeps the full distribution).
_COMPILE_SAMPLES_KEPT = 256

# Signature digests shown in events/ledgers are content hashes of the
# signature, NOT Python hash() — byte-stable across processes.
_DIGEST_CHARS = 12

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5 (80 GB HBM3, 700 W):
# dense BF16 Tensor Core 989 TFLOP/s (1,979 is the sparse figure), GPU
# memory bandwidth 3.35 TB/s.
_PEAKS_BY_NAME = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}

_PEAKS_LOCK = threading.Lock()
_PEAKS: Dict[str, Optional[dict]] = {}


def device_peaks() -> Optional[dict]:
    """Datasheet peak numbers of card 0 for the MFU and bandwidth
    rooflines, by `torch.cuda.get_device_name`; None on any card without
    an entry and off CUDA (the ratio gauges then read 0.0)."""
    with _PEAKS_LOCK:
        if "card" not in _PEAKS:
            name = (torch.cuda.get_device_name(0)
                    if torch.cuda.is_available() else "")
            _PEAKS["card"] = _PEAKS_BY_NAME.get(name)
        peaks = _PEAKS["card"]
    return dict(peaks) if peaks else None


def _flops_bytes(cost: dict) -> Tuple[float, float]:
    return (
        float(cost.get("flops", 0.0) or 0.0),
        float(cost.get("bytes accessed", 0.0) or 0.0),
    )


def _quantile(sorted_values: List[float], q: float) -> float:
    if not sorted_values:
        return 0.0
    idx = min(int(q * len(sorted_values)), len(sorted_values) - 1)
    return sorted_values[idx]


def _leaf_key(x):
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype), str(getattr(x, "device", "")))
    return ("py", type(x).__name__)


def signature_of(args) -> tuple:
    """Hashable signature of a call's arguments: pytree structure + per
    leaf (shape, dtype, device).  A leaf that is not an array (a module,
    a state object, a Python number) counts by its type alone."""
    leaves, spec = pytree.tree_flatten(args)
    return (str(spec), tuple(_leaf_key(leaf) for leaf in leaves))


def signature_digest(sig: tuple) -> str:
    return hashlib.sha1(repr(sig).encode()).hexdigest()[:_DIGEST_CHARS]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def describe_avals(args, limit: int = 8) -> str:
    """Human-readable summary ("float32[65536,26], int32[64]")."""
    leaves = pytree.tree_leaves(args)
    parts = []
    for leaf in leaves[:limit]:
        dtype = getattr(leaf, "dtype", None)
        if dtype is not None and hasattr(leaf, "shape"):
            dims = ",".join(str(d) for d in leaf.shape)
            parts.append(f"{_dtype_name(dtype)}[{dims}]")
        else:
            parts.append(type(leaf).__name__)
    if len(leaves) > limit:
        parts.append(f"...+{len(leaves) - limit}")
    return ", ".join(parts)


# ---- cost counting ---------------------------------------------------------

# custom op name ("elasticdl_torch::op") -> cost(*args, **kwargs) ->
# (flops, bytes), registered by the ops modules beside their kernels
_KERNEL_COSTS: Dict[str, Callable[..., Tuple[float, float]]] = {}


def register_kernel_cost(op_name: str,
                         cost: Callable[..., Tuple[float, float]]) -> None:
    """Charge the custom op `op_name` ("namespace::name") by `cost`,
    called with the op's arguments, instead of the aten ops inside it."""
    _KERNEL_COSTS[op_name] = cost


# custom op name -> needs(*args, **kwargs) -> the `csrc/` sources whose
# libraries the op's kernel loads at these arguments (none off CUDA)
_KERNEL_LIBRARIES: Dict[str, Callable[..., Tuple[str, ...]]] = {}


def register_kernel_libraries(op_name: str,
                              needs: Callable[..., Tuple[str, ...]]) -> None:
    """Name the libraries the custom op `op_name` loads for given
    arguments, by the predicates its wrapper dispatches on, so an
    abstract compile builds them ahead."""
    _KERNEL_LIBRARIES[op_name] = needs


def is_abstract(x) -> bool:
    """Whether `x` is a fake tensor: shapes and dtypes, no data."""
    return isinstance(x, FakeTensor)


# ---- abstract arguments ----------------------------------------------------

# one fake mode for the process: fake tensors of two modes cannot meet
# in one program, and the mode's bookkeeping is not thread-safe
_ABSTRACT_LOCK = threading.RLock()
_ABSTRACT_MODE: Optional[FakeTensorMode] = None


def abstract_mode() -> FakeTensorMode:
    """The process's FakeTensorMode, in which every abstract argument is
    made and every abstract compile runs."""
    global _ABSTRACT_MODE
    with _ABSTRACT_LOCK:
        if _ABSTRACT_MODE is None:
            _ABSTRACT_MODE = FakeTensorMode(allow_non_fake_inputs=False)
        return _ABSTRACT_MODE


@contextlib.contextmanager
def in_abstract_mode():
    """Run the block in the process's abstract mode (its lock held)."""
    with _ABSTRACT_LOCK, abstract_mode():
        yield


def _fake_of(x: torch.Tensor, device) -> torch.Tensor:
    """A fake tensor of x's shape, strides and dtype on `device` (x's own
    when None); a parameter stays a parameter.  Called in the mode."""
    fake = torch.empty_strided(
        tuple(x.shape), tuple(x.stride()), dtype=x.dtype,
        device=x.device if device is None else device)
    if isinstance(x, torch.nn.Parameter):
        return torch.nn.Parameter(fake, requires_grad=x.requires_grad)
    return fake


def abstract_like(tree, device=None):
    """`tree` with every tensor replaced by a fake tensor of its shape,
    strides and dtype, on `device` (default: the leaf's own), made in
    the process's abstract mode.  A module is copied with fake
    parameters and buffers (the copy shares nothing with the original,
    whose data is not read).  Making a fake CUDA tensor touches no GPU.
    """
    def fake(leaf):
        if isinstance(leaf, torch.nn.Module):
            return _abstract_module(leaf, device)
        if isinstance(leaf, torch.Tensor) and not (
                is_abstract(leaf) and device is None):
            return _fake_of(leaf, device)
        return leaf

    with in_abstract_mode():
        return pytree.tree_map(fake, tree)


def _abstract_module(module: torch.nn.Module, device) -> torch.nn.Module:
    """A copy of `module` whose parameters and buffers are fake tensors
    (deepcopy with each tensor's fake given in the memo, so no data is
    copied)."""
    import copy

    memo = {}
    for t in list(module.parameters()) + list(module.buffers()):
        if id(t) not in memo:
            memo[id(t)] = _fake_of(t, device)
    return copy.deepcopy(module, memo)


def _tensor_bytes(tree, seen: set) -> int:
    total = 0
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and id(leaf) not in seen:
            seen.add(id(leaf))
            total += leaf.numel() * leaf.element_size()
    return total


_ALLOCATIONS = frozenset({
    "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::new_empty", "aten::new_empty_strided",
})


class CostCounter(TorchDispatchMode):
    """Counts the flops and bytes of every op dispatched while it is
    active, on this thread and on the autograd threads that inherit it.
    It runs each op as it is, so the results are those of a call
    without it."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        # custom op name -> calls charged by its kernel formula
        self.kernel_calls: Dict[str, int] = {}
        self.threads: set = set()
        # the `csrc/` sources the kernels reached load
        self.libraries: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        name = func._schema.name
        kernel = _KERNEL_COSTS.get(name)
        formula = flop_registry.get(func._overloadpacket)
        if kernel is None and formula is None \
                and func is not torch.ops.prim.device.default:
            # a composite op that reaches the mode whole (as under
            # inference mode) runs as its decomposition, which is its
            # only kernel, so each part is counted
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.threads.add(threading.get_ident())
        if kernel is not None:
            flops, nbytes = kernel(*args, **kwargs)
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
            needs = _KERNEL_LIBRARIES.get(name)
            if needs is not None:
                self.libraries.update(needs(*args, **kwargs))
        else:
            flops = (formula(*args, **kwargs, out_val=out)
                     if formula is not None else 0)
            if func.is_view or name in _ALLOCATIONS \
                    or func is torch.ops.prim.device.default:
                # views, allocations and a fake tensor's device query
                # move nothing
                nbytes = 0
            else:
                # an input read once, each output written once (an
                # in-place op's output is its input: read, then written)
                nbytes = _tensor_bytes((args, kwargs), set()) \
                    + _tensor_bytes(out, set())
        self.flops += float(flops)
        self.bytes += float(nbytes)
        return out

    def cost(self) -> dict:
        return {"flops": self.flops, "bytes accessed": self.bytes}


def _new_record() -> dict:
    return {
        "signatures": {},
        "compiles": 0,
        "compile_seconds": [],
        "storms": 0,
        "budget": None,
        "latest": None,
    }


class ProgramRegistry:
    """Process-wide ledger of named programs.

    Thread-safe; counted calls run outside the lock.  The injectable
    ``clock`` times compiles and stamps signature first-seen times for
    storm detection, so the storm tests replay deterministically under a
    fake clock."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        metrics: Optional[metrics_lib.MetricsRegistry] = None,
        storm_window_s: float = 60.0,
        on_storm: Optional[Callable[[dict], None]] = None,
    ):
        self.clock = clock
        self.storm_window_s = float(storm_window_s)
        self._lock = threading.Lock()
        self._programs: Dict[str, dict] = {}
        self._rates: Dict[str, Tuple[Callable[[], float], int]] = {}
        self._on_storm = on_storm
        reg = metrics or metrics_lib.default_registry()
        self._compile_hist = reg.histogram(
            "worker_program_compile_seconds",
            "compile wall seconds per registered program (eager: the "
            "first dispatch at a signature; kernels: the nvcc build)",
            min_value=1e-3, max_value=900.0, labelnames=("program",),
        )
        self._compiles_total = reg.counter(
            "worker_program_compiles_total",
            "compiles (first compile + every retrace) per program",
            labelnames=("program",),
        )
        self._signatures_gauge = reg.gauge(
            "worker_program_signatures_count",
            "distinct signatures seen per registered program",
            labelnames=("program",),
        )
        self._storms_total = reg.counter(
            "worker_program_storms_total",
            "recompile storms (signature budget blown within the window)",
            labelnames=("program",),
        )
        reg.gauge_fn(
            "worker_program_bytes_per_sec",
            lambda: self.live()["bytes_per_sec"],
            "counted bytes/s across rate-bound programs (cost x rate)",
        )
        reg.gauge_fn(
            "worker_mfu_ratio",
            lambda: self.live()["mfu"],
            "counted flops/s over the card's datasheet bf16 peak "
            "(0 without one)",
        )
        reg.gauge_fn(
            "worker_hbm_utilization_ratio",
            lambda: self.live()["hbm_utilization"],
            "counted bytes/s over the card's HBM roof (0 without one)",
        )

    # -- recording ----------------------------------------------------

    def declare(self, name: str, budget: Optional[int] = None) -> None:
        """Ensure a program record exists; optionally (re)declare its
        signature budget (latest declaration wins)."""
        with self._lock:
            rec = self._programs.setdefault(name, _new_record())
            if budget is not None:
                rec["budget"] = int(budget)

    def set_on_storm(self, hook: Optional[Callable[[dict], None]]) -> None:
        with self._lock:
            self._on_storm = hook

    def note_compile(
        self,
        name: str,
        signature: str,
        seconds: float,
        cost: Optional[dict] = None,
        avals: str = "",
    ) -> None:
        """Record one compile of `name` for signature digest
        `signature`: a RegisteredProgram's counted first call, or an
        external build reported through register_compiled."""
        flops, bytes_ = _flops_bytes(cost or {})
        with self._lock:
            rec = self._programs.setdefault(name, _new_record())
            sig = rec["signatures"].setdefault(
                signature,
                {"compiles": 0, "seconds": 0.0, "flops": 0.0,
                 "bytes": 0.0, "avals": ""},
            )
            sig["compiles"] += 1
            sig["seconds"] = round(sig["seconds"] + seconds, 6)
            if cost:
                # never zero a known cost (a kernel build carries none)
                sig["flops"] = flops
                sig["bytes"] = bytes_
                if cost.get("abstract"):
                    sig["abstract"] = True
            if avals:
                sig["avals"] = avals
            rec["compiles"] += 1
            rec["compile_seconds"].append(round(seconds, 6))
            del rec["compile_seconds"][:-_COMPILE_SAMPLES_KEPT]
            rec["latest"] = signature
            n_sigs = len(rec["signatures"])
        self._compile_hist.labels(program=name).record(max(seconds, 1e-9))
        self._compiles_total.labels(program=name).inc()
        self._signatures_gauge.labels(program=name).set(n_sigs)
        events.emit(
            events.PROGRAM_COMPILED,
            program=name,
            signature=signature,
            seconds=round(seconds, 4),
            flops=flops,
            bytes=bytes_,
            signatures=n_sigs,
        )

    def note_storm(self, name: str, signatures: int, budget: int) -> None:
        """A program blew its signature budget within the window: bump
        the ledger, emit the closed-vocab event, fire the hook (the
        FlightRecorder's immediate pend+flush)."""
        with self._lock:
            rec = self._programs.setdefault(name, _new_record())
            rec["storms"] += 1
            hook = self._on_storm
        record = {
            "program": name,
            "signatures": int(signatures),
            "budget": int(budget),
        }
        self._storms_total.labels(program=name).inc()
        events.emit(events.RECOMPILE_STORM, **record)
        if hook is not None:
            try:
                hook(dict(record))
            except Exception:   # a hook never breaks the dispatching call
                pass

    def bind_step_rate(
        self,
        name: str,
        rate_fn: Callable[[], float],
        steps_per_execution: int = 1,
    ) -> None:
        """Join a program's per-execution cost against a live step rate
        (optimizer steps/sec).  `steps_per_execution` scales programs
        whose one execution advances K steps."""
        with self._lock:
            self._rates[name] = (rate_fn, max(int(steps_per_execution), 1))

    # -- views --------------------------------------------------------

    def live(self) -> dict:
        """Live cost x rate attribution across rate-bound programs."""
        with self._lock:
            bound = list(self._rates.items())
            latest: Dict[str, dict] = {}
            for name, _ in bound:
                rec = self._programs.get(name)
                if rec and rec["latest"] is not None:
                    latest[name] = dict(rec["signatures"][rec["latest"]])
        flops_rate = bytes_rate = 0.0
        for name, (rate_fn, spe) in bound:
            cost = latest.get(name)
            if not cost:
                continue
            try:
                rate = float(rate_fn() or 0.0)
            except Exception:   # a dead rate source reads as idle
                rate = 0.0
            flops_rate += cost["flops"] * rate / spe
            bytes_rate += cost["bytes"] * rate / spe
        peaks = device_peaks()
        return {
            "flops_per_sec": flops_rate,
            "bytes_per_sec": bytes_rate,
            "mfu": flops_rate / peaks["bf16_flops"] if peaks else 0.0,
            "hbm_utilization": (
                bytes_rate / peaks["hbm_bytes_per_s"] if peaks else 0.0
            ),
        }

    def ledger(self) -> dict:
        """Per-program ledger: compiles, signatures, budget, storms,
        compile-time quantiles, latest-signature cost."""
        with self._lock:
            out = {}
            for name in sorted(self._programs):
                rec = self._programs[name]
                times = sorted(rec["compile_seconds"])
                latest = (
                    rec["signatures"][rec["latest"]]
                    if rec["latest"] is not None else {}
                )
                out[name] = {
                    "compiles": rec["compiles"],
                    "signatures": len(rec["signatures"]),
                    "budget": rec["budget"],
                    "storms": rec["storms"],
                    "compile_seconds_total": round(sum(times), 6),
                    "compile_seconds_p50": _quantile(times, 0.5),
                    "compile_seconds_p99": _quantile(times, 0.99),
                    "flops_per_execution": latest.get("flops", 0.0),
                    "bytes_per_execution": latest.get("bytes", 0.0),
                    "avals": latest.get("avals", ""),
                }
                if latest.get("abstract"):
                    # counted by an abstract compile: a data-dependent
                    # term is at its upper bound
                    out[name]["abstract"] = True
        return out

    def summary(self) -> dict:
        """The /varz "programs" payload: headline totals + live rates +
        the full ledger (what `programs` renders)."""
        led = self.ledger()
        live = self.live()
        return {
            "programs": len(led),
            "compiles_total": sum(p["compiles"] for p in led.values()),
            "signatures_total": sum(p["signatures"] for p in led.values()),
            "storms_total": sum(p["storms"] for p in led.values()),
            "mfu": round(live["mfu"], 6),
            "bytes_per_sec": round(live["bytes_per_sec"], 1),
            "hbm_utilization": round(live["hbm_utilization"], 6),
            "ledger": led,
        }

    def forensics(self) -> dict:
        """The incident-bundle `programs.json` section: the ledger minus
        live rates and compile wall-time quantiles, both of which mix in
        wall-clock state (bundles must be byte-identical across
        same-seed runs)."""
        led = self.ledger()
        return {"ledger": {
            name: {
                k: v for k, v in rec.items()
                if not k.startswith("compile_seconds")
            }
            for name, rec in led.items()
        }}


class RegisteredProgram:
    """An eager callable whose compiles (first dispatches at a new
    signature) are timed, counted and reported to the ProgramRegistry.

    The counted call is the caller's own call: it runs once, under a
    :class:`CostCounter`, and returns its result.  Concurrent first
    calls at one signature count once (the others go straight through).
    A first call made inside another program's counted call is counted
    too, and charged to both: dispatch modes stack, so a later call at
    either signature runs uncounted (a timed loop's warm-up covers the
    steps inside it)."""

    def __init__(
        self,
        name: str,
        fn: Callable,
        registry: ProgramRegistry,
        signature_budget: Optional[int] = None,
    ):
        self.name = name
        self._fn = fn
        self._registry = registry
        self._budget = signature_budget
        self._lock = threading.Lock()
        self._sig_times: List[float] = []
        self._seen: Dict[tuple, bool] = {}
        self._pending: set = set()
        self._costs: Dict[tuple, dict] = {}
        # signature -> what its abstract compile found
        self._aot: Dict[tuple, dict] = {}
        self._stormed = False
        # signature digest -> what the counted call saw (flops, bytes,
        # kernel calls, threads): the card's check that the backward's
        # ops were counted
        self.counted: Dict[str, dict] = {}
        registry.declare(name, signature_budget)

    @property
    def signature_count(self) -> int:
        with self._lock:
            return len(self._seen)

    def __call__(self, *args, **kwargs):
        sig = signature_of((args, kwargs))
        with self._lock:
            claimed = sig not in self._seen and sig not in self._pending
            if claimed:
                self._pending.add(sig)
        if not claimed:
            return self._fn(*args, **kwargs)
        clock = self._registry.clock
        counter = CostCounter()
        try:
            start = clock()
            with counter:
                out = self._fn(*args, **kwargs)
            seconds = max(clock() - start, 0.0)
        finally:
            with self._lock:
                self._pending.discard(sig)
        cost = counter.cost()
        digest = signature_digest(sig)
        with self._lock:
            self._costs[sig] = cost
            self.counted[digest] = {
                "flops": counter.flops, "bytes": counter.bytes,
                "kernel_calls": dict(counter.kernel_calls),
                "threads": len(counter.threads)}
        self._record(sig, seconds, describe_avals((args, kwargs)), cost)
        return out

    def aot_compile(self, *args, **kwargs) -> dict:
        """The abstract compile at this signature, once: run the program
        on abstract arguments (fake tensors from `abstract_like`, and
        states built on them) under the process's fake mode and a
        CostCounter, record one compile with its wall seconds, flops and
        bytes, and build the hand-kernel libraries the custom ops it
        reached load at these shapes.  Nothing is dispatched and no
        kernel runs.  Returns {"cost", "libraries", "seconds",
        "kernel_calls"}; a real call at the signature afterwards records
        no second compile.  Real tensors among the arguments are replaced
        by their fakes first."""
        sig = signature_of((args, kwargs))
        with self._lock:
            if sig in self._aot:
                return dict(self._aot[sig])
        # real tensors and modules among the arguments take their fakes
        # (a state object must be built abstract by its owner)
        args, kwargs = abstract_like((args, kwargs))
        clock = self._registry.clock
        counter = CostCounter()
        start = clock()
        with in_abstract_mode(), counter:
            self._fn(*args, **kwargs)
        libraries = sorted(counter.libraries)
        if libraries:
            from elasticdl_tpu_torch.ops import _build

            _build.ensure_built(libraries)
        seconds = max(clock() - start, 0.0)
        cost = dict(counter.cost(), abstract=True)
        entry = {"cost": cost, "libraries": libraries, "seconds": seconds,
                 "kernel_calls": dict(counter.kernel_calls)}
        with self._lock:
            self._aot[sig] = entry
            self._costs.setdefault(sig, cost)
        self._record(sig, seconds, describe_avals((args, kwargs)), cost)
        return dict(entry)

    def cost_for(self, *args, **kwargs) -> dict:
        """The {"flops", "bytes accessed"} of this signature: the cost
        counted on its first call, or, for a signature that has not run,
        its abstract compile's (`aot_compile`, once, recorded; marked
        "abstract": true).  Abstract arguments are what an unrun
        signature takes."""
        sig = signature_of((args, kwargs))
        with self._lock:
            cost = self._costs.get(sig)
        if cost is None:
            cost = self.aot_compile(*args, **kwargs)["cost"]
        return dict(cost)

    def _record(self, sig, seconds, avals, cost) -> None:
        now = self._registry.clock()
        with self._lock:
            new_sig = sig not in self._seen
            if new_sig:
                self._seen[sig] = True
                self._sig_times.append(now)
            window = self._registry.storm_window_s
            recent = [t for t in self._sig_times if now - t <= window]
            storm = (
                new_sig
                and self._budget is not None
                and len(recent) > self._budget
                and not self._stormed
            )
            if storm:
                self._stormed = True
            churn = len(self._sig_times)
        self._registry.note_compile(
            self.name, signature_digest(sig), seconds,
            cost=cost, avals=avals,
        )
        if storm:
            self._registry.note_storm(self.name, churn, self._budget)


_DEFAULT_LOCK = threading.Lock()
_default: Optional[ProgramRegistry] = None


def default_program_registry() -> ProgramRegistry:
    global _default
    with _DEFAULT_LOCK:
        if _default is None:
            _default = ProgramRegistry()
        return _default


def registered_jit(
    name: str,
    fn: Callable,
    registry: Optional[ProgramRegistry] = None,
    signature_budget: Optional[int] = None,
) -> RegisteredProgram:
    """The normal registration path: wrap `fn` as a named registered
    program (the reference's name, so call sites read alike; nothing is
    compiled)."""
    return RegisteredProgram(
        name,
        fn,
        registry or default_program_registry(),
        signature_budget=signature_budget,
    )


def register_compiled(
    name: str,
    compiled: Any,
    seconds: float = 0.0,
    registry: Optional[ProgramRegistry] = None,
    signature: str = "external",
    avals: str = "",
    cost: Optional[dict] = None,
):
    """Report a build made outside registered_jit (the nvcc build of a
    hand kernel).  Returns `compiled` unchanged."""
    reg = registry or default_program_registry()
    reg.note_compile(name, signature, seconds, cost=cost, avals=avals)
    return compiled
