"""Checkpoint save and restore without orbax (the port's copy of
`CheckpointSaver` from the JAX package's common/save_utils.py).

Layout, one directory per saved step:

    <checkpoint_dir>/<step>/state.pt        torch.save of {"step",
                                            "model", "optimizer"}
    <checkpoint_dir>/.manifests/<step>.json size and sha256 per file of
                                            the step, plus the
                                            `produced` stamp

Both are written to a temporary name and moved into place with
`os.replace`, so a reader never sees half a file; the manifest lands
first, so every listed step can be verified.  A step directory without
`state.pt` is a torn save and is not a step.

- Restore: `torch.load(..., weights_only=True, map_location=<the
  template's device>)`.  `verify_step` checks a step against its
  manifest; `maybe_restore` falls back past a torn or corrupt step.
  `restorable_step` is the step it lands on, found before any model
  exists: the newest step that passes its manifest check and whose
  `state.pt` loads.  A relaunched job's task journal is trusted up to
  that step (master/main.py), so a step with no manifest whose state
  does not load moves the cutoff back with the restore, where the JAX
  master keeps trusting it.
- Rotation: keep the newest `keep_max` steps, except those pinned with
  `pin_step` (a reader mid-restore).
- Async save: `save` takes owning host copies of the parameters, the
  buffers and the optimizer's moments at once, on the caller's thread
  (which holds the owner's lock, so no optimizer step runs in between);
  a background thread writes them.  A `state_dict()` tensor aliases the
  live parameter, which the next `optimizer.step()` rewrites in place:
  handing it to the writer would save step N+1's values as step N.
  `wait_until_finished` joins the writer and re-raises its failures.

- Sharded states (a TrainState with `shardings` over a live mesh,
  worker/trainer.py `shard_state`): `save` is called on every rank; the
  sharded leaves, the parameters and their optimizer moments, are
  gathered over their axes to the whole tree (`host_state`), and rank 0
  writes it.  The checkpoint is so the same on every mesh.  A restore
  loads the whole tree and slices this rank's shards for the
  template's mesh and specs, so a step saved on one layout restores on
  one rank or on another layout.  The manifest and sha256 rules are
  unchanged.

- Fault point `checkpoint.write` (common/faults.py), fired at the top of
  every `save`: an injected fault skips that save with a warning and
  the next crossing saves again, as in the JAX package.  Only injected
  faults take that path; a real write error still fails the save.

- int8 arenas: the manifest's `arena` entry records the arena dtype and
  each plane's path, rows and dim.  A restore whose checkpoint and
  template differ in arena dtype raises `ArenaDtypeMismatch`, unless
  `arena_convert=True` migrates it (fp32 -> int8 quantizes each table,
  int8 -> fp32 dequantizes it; the carrier keeps the table's name and
  shape, so Adam's moments carry over either way).

- Tiered store (`attach_tiered_store`): each save also writes the
  store's sidecar, `<checkpoint_dir>/.tiered/<step>/` (store/checkpoint.py).
  It is captured in the same locked region as the state's host copy and
  written by the writer thread before `state.pt` lands, and the
  manifest's `tiered` entry records its layout.  A failed sidecar write
  fails the save as a failed state write does (the JAX package logs it
  and goes on).  The sweep removes a step's sidecar with the step, so
  every kept step, pinned ones included, keeps its own.  `maybe_restore`
  loads the restored step's sidecar into the store; a step without one,
  or a store with plans not yet applied, raises (no fallback to an
  older step).  `restore_step` (a separate state for an eval at a
  version) leaves the live store as it is.

- The JAX package's orbax steps: a step directory that holds
  `_CHECKPOINT_METADATA` was written by the JAX package's
  `CheckpointSaver`.  It is listed beside the port's own steps
  (`committed_steps`), checked against the JAX manifest at the same
  `.manifests/<step>.json` path (`verify_step`: the same size and sha256
  per file of the step), and restored through common/orbax_read.py and
  common/orbax_state.py: the stored TrainState read with no orbax,
  tensorstore or zstd package and mapped onto the port's model and
  optimizer, then through the same arena, shard and load path as a
  `state.pt`.  A step that fails its manifest check or does not read
  falls back to the step before, as the JAX `maybe_restore` does.  The
  port writes into no orbax step and deletes none: its saves skip a
  step number an orbax step holds, and the keep-last-K sweep counts and
  removes only `state.pt` steps (`port_steps`).
"""

from __future__ import annotations

import concurrent.futures
import copy
import hashlib
import inspect
import json
import os
import pickle
import shutil
import threading
import time
from typing import Any, Dict, FrozenSet, List, Optional

import torch

from elasticdl_tpu_torch.common import events, faults, orbax_read, \
    orbax_state
from elasticdl_tpu_torch.common.weights import gather_tensor, shard_tensor
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.layers.arena import (
    dequantize_arena_tree,
    plane_key,
    plane_path,
    plane_prefixes,
    quantize_arena_tree,
)
from elasticdl_tpu_torch.store import checkpoint as store_ckpt
from elasticdl_tpu_torch.worker import graphs as graphs_lib
from elasticdl_tpu_torch.worker.trainer import TrainState

logger = get_logger(__name__)

STATE_FILE = "state.pt"
# what a state.pt that does not load raises: a truncated or foreign file,
# a missing key, a shape the template refuses
LOAD_ERRORS = (RuntimeError, OSError, KeyError, ValueError, EOFError,
               pickle.UnpicklingError)


class ArenaDtypeMismatch(ValueError):
    """A checkpoint's arena storage dtype differs from the configured
    model's and no conversion was requested."""


def arena_dtype_of(model_state: Dict[str, Any]) -> str:
    """"int8" when a model state dict holds int8 arena planes, else
    "float32"."""
    return "int8" if plane_prefixes(model_state) else "float32"


def arena_meta(model_state: Dict[str, Any]) -> Dict[str, Any]:
    """The manifest's `arena` entry: the dtype and, in int8 mode, each
    plane's flax path with its rows, dim and scale shape."""
    planes = {}
    for prefix in plane_prefixes(model_state):
        q8 = model_state[plane_key(prefix, "q8")]
        scale = model_state[plane_key(prefix, "scale")]
        planes["/".join(plane_path(prefix))] = {
            "rows": int(q8.shape[0]), "dim": int(q8.shape[1]),
            "scale_shape": [int(d) for d in scale.shape]}
    return {"arena_dtype": arena_dtype_of(model_state), "planes": planes}


# ---- step pinning ---------------------------------------------------------
#
# A process-wide pin registry keyed by the checkpoint directory: a reader
# pins the step it restores, and the keep-last-K sweep skips pinned steps
# (they rotate out on the first sweep after unpin).  Refcounted.

_PIN_LOCK = threading.Lock()
_PINNED: Dict[str, Dict[int, int]] = {}   # abs dir -> step -> refcount


def pin_step(checkpoint_dir: str, step: int) -> None:
    """Protect `step` from the keep-last-K sweep until unpinned."""
    key = os.path.abspath(checkpoint_dir)
    with _PIN_LOCK:
        dir_pins = _PINNED.setdefault(key, {})
        dir_pins[int(step)] = dir_pins.get(int(step), 0) + 1


def unpin_step(checkpoint_dir: str, step: int) -> None:
    key = os.path.abspath(checkpoint_dir)
    step = int(step)
    with _PIN_LOCK:
        dir_pins = _PINNED.get(key)
        if not dir_pins or step not in dir_pins:
            return
        dir_pins[step] -= 1
        if dir_pins[step] <= 0:
            del dir_pins[step]
        if not dir_pins:
            del _PINNED[key]


def pinned_steps(checkpoint_dir: str) -> FrozenSet[int]:
    with _PIN_LOCK:
        return frozenset(_PINNED.get(os.path.abspath(checkpoint_dir), ()))


def _file_digest(path: str) -> Dict[str, Any]:
    sha = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha.update(chunk)
            size += len(chunk)
    return {"sha256": sha.hexdigest(), "size": size}


def _host_copy(tree):
    """Owning CPU copies of every tensor in a nested dict/list of a
    state dict (a CUDA tensor's copy waits for its stream)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return copy.deepcopy(tree)


def is_sharded(state: TrainState) -> bool:
    """Whether `state` holds shards over a live mesh (its save and
    export gather)."""
    mesh = getattr(state, "mesh", None)
    return bool(getattr(state, "shardings", None)) and mesh is not None \
        and mesh.distributed


def _moment_specs(state: TrainState) -> Dict[int, tuple]:
    """{optimizer state index: spec} of the sharded parameters (the
    optimizer was built over `model.parameters()`, in that order)."""
    return {i: state.shardings[name] for i, (name, _) in
            enumerate(state.model.named_parameters())
            if name in state.shardings}


def _map_moments(opt_state, specs, fn):
    """The optimizer state dict with fn(tensor, spec) applied to every
    per-parameter tensor of a sharded parameter."""
    out = dict(opt_state)
    out["state"] = {
        idx: {k: fn(v, specs[idx]) if idx in specs and isinstance(
            v, torch.Tensor) and v.dim() > 0 else v
            for k, v in entry.items()}
        for idx, entry in opt_state["state"].items()}
    return out


def host_state(state: TrainState) -> Dict[str, Any]:
    """{"step", "model", "optimizer"}: owning host copies of a state,
    its sharded leaves gathered to the whole tree (a collective on a
    sharded state: every rank calls it)."""
    model = state.model.state_dict()
    optim = state.optimizer.state_dict()
    if is_sharded(state):
        def gather(value, spec):
            return gather_tensor(value, spec, state.mesh)

        model = {k: gather(v, state.shardings[k]) if k in state.shardings
                 else v for k, v in model.items()}
        optim = _map_moments(optim, _moment_specs(state), gather)
    return {
        "step": int(state.step),
        "model": _host_copy(model),
        "optimizer": _host_copy(optim),
    }


def load_optimizer_state(optimizer, optim_state) -> None:
    """`optimizer.load_state_dict(optim_state)`, keeping the live
    optimizer's `capturable` setting: a CUDA trainer builds Adam and
    AdamW capturable (worker/trainer.py) and the CPU cannot run them so,
    so a checkpoint from either side restores on the other.  PyTorch
    moves each `step` count to its parameter's device when the group is
    capturable (cast to float32, which `graphs_lib.float64_step_counts`
    takes back to the float64 the graphs' Adam counts in) and leaves it
    on the host otherwise."""
    groups = optimizer.param_groups
    saved = optim_state["param_groups"]
    if len(groups) == len(saved) and any("capturable" in g for g in groups):
        optim_state = dict(optim_state)
        optim_state["param_groups"] = [
            dict(ng, capturable=g.get("capturable", False))
            if "capturable" in g else ng for g, ng in zip(groups, saved)]
    optimizer.load_state_dict(optim_state)
    graphs_lib.float64_step_counts(optimizer)


def shard_blob(state: TrainState, model_state, optim_state):
    """A whole checkpoint's (model, optimizer) state sliced to `state`'s
    shards (as they are when `state` holds no shards)."""
    if not getattr(state, "shardings", None) or state.mesh is None:
        return model_state, optim_state

    def cut(value, spec):
        return shard_tensor(value, spec, state.mesh).contiguous()

    model_state = {k: cut(v, state.shardings[k]) if k in state.shardings
                   else v for k, v in model_state.items()}
    return model_state, _map_moments(optim_state, _moment_specs(state), cut)


def gathered_state(state: TrainState) -> TrainState:
    """A one-device TrainState of the whole model (a collective on a
    sharded state): a copy of the model with every sharded parameter
    gathered, for an export or a predict on one rank.  `state` itself
    when it holds no shards."""
    if not is_sharded(state):
        return state
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in state.shardings:
                p.data = gather_tensor(p.data, state.shardings[name],
                                       state.mesh)
        # an int8 arena's q8 and scale, sharded with their carrier
        for name, b in list(model.named_buffers()):
            if name in state.shardings:
                owner, _, leaf = name.rpartition(".")
                setattr(model.get_submodule(owner), leaf, gather_tensor(
                    b, state.shardings[name], state.mesh))
    return TrainState(step=state.step, model=model,
                      optimizer=state.optimizer)


def empty_like(template: TrainState) -> TrainState:
    """A separate TrainState shaped like `template`: its own copy of the
    model and a new optimizer of the same class and settings.  Only the
    settings the class's constructor takes are passed: `defaults` may
    hold more (AdamW's holds `decoupled_weight_decay`, which AdamW sets
    itself and does not take)."""
    model = copy.deepcopy(template.model)
    opt = template.optimizer
    takes = inspect.signature(type(opt).__init__).parameters
    settings = {k: v for k, v in opt.defaults.items() if k in takes}
    return TrainState(step=template.step, model=model,
                      optimizer=type(opt)(model.parameters(), **settings),
                      shardings=dict(template.shardings),
                      mesh=template.mesh)


def read_produced_meta(checkpoint_dir: str,
                       step: int) -> Optional[Dict[str, Any]]:
    """A manifest's producer stamp {model_step, produced_unix_s}."""
    path = os.path.join(os.path.abspath(checkpoint_dir), ".manifests",
                        f"{int(step)}.json")
    try:
        with open(path) as f:
            return json.load(f).get("produced")
    except (OSError, ValueError):
        return None


def _step_kinds(checkpoint_dir: str) -> Dict[int, str]:
    """{step: "port" or "orbax"} of the finalized steps: a port step's
    state.pt is in place, an orbax step holds the file orbax writes as it
    finalizes one."""
    if not os.path.isdir(checkpoint_dir):
        return {}
    kinds = {}
    for name in os.listdir(checkpoint_dir):
        step_dir = os.path.join(checkpoint_dir, name)
        if not (name.isdigit() and os.path.isdir(step_dir)):
            continue
        if orbax_read.is_orbax_step(step_dir):
            kinds[int(name)] = "orbax"
        elif os.path.isfile(os.path.join(step_dir, STATE_FILE)):
            kinds[int(name)] = "port"
    return kinds


def committed_steps(checkpoint_dir: str) -> List[int]:
    """The finalized steps under `checkpoint_dir`, the port's (state.pt
    in place) and the JAX package's orbax steps alike, sorted; [] for a
    directory that does not exist."""
    return sorted(_step_kinds(checkpoint_dir))


def port_steps(checkpoint_dir: str) -> List[int]:
    """The port's own finalized steps (state.pt in place), sorted: the
    steps its keep-last-K sweep counts and may remove."""
    return sorted(step for step, kind in _step_kinds(checkpoint_dir).items()
                  if kind == "port")


def verify_step(checkpoint_dir: str, step: int) -> bool:
    """Check a step's files against its manifest: True when intact or
    when no manifest exists, False on any missing, truncated or altered
    file."""
    checkpoint_dir = os.path.abspath(checkpoint_dir)
    path = os.path.join(checkpoint_dir, ".manifests", f"{int(step)}.json")
    if not os.path.exists(path):
        return True
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return True  # unreadable manifest != corrupt checkpoint
    step_dir = os.path.join(checkpoint_dir, str(int(step)))
    for rel, want in manifest.get("files", {}).items():
        full = os.path.join(step_dir, rel)
        if not os.path.isfile(full):
            logger.warning("checkpoint step %d: missing file %s",
                           step, rel)
            return False
        got = _file_digest(full)
        if got["size"] != want.get("size") \
                or got["sha256"] != want.get("sha256"):
            logger.warning(
                "checkpoint step %d: checksum mismatch in %s (%d bytes "
                "vs %d expected)", step, rel, got["size"],
                want.get("size", -1))
            return False
    return True


def intact_steps(checkpoint_dir: str) -> List[int]:
    """The committed steps that pass their manifest check, sorted: the
    steps `CheckpointSaver.maybe_restore` tries, newest first.  The
    newest of them is the step a relaunch restores, and the cutoff up to
    which a task journal is trusted."""
    return [step for step in committed_steps(checkpoint_dir)
            if verify_step(checkpoint_dir, step)]


def _state_loads(checkpoint_dir: str, step: int) -> bool:
    """True when the step's state.pt loads (on the CPU), or, for an
    orbax step, when its stored tree reads and is a TrainState."""
    step_dir = os.path.join(os.path.abspath(checkpoint_dir), str(int(step)))
    if orbax_read.is_orbax_step(step_dir):
        try:
            tree = orbax_read.read_tree(step_dir)
        except LOAD_ERRORS as exc:
            logger.warning("orbax checkpoint step %d does not read (%s)",
                           step, exc)
            return False
        return isinstance(tree, dict) and {"step", "params", "opt_state"} \
            <= set(tree)
    path = os.path.join(step_dir, STATE_FILE)
    try:
        blob = torch.load(path, weights_only=True, map_location="cpu")
    except LOAD_ERRORS as exc:
        logger.warning("checkpoint step %d does not load (%s)", step, exc)
        return False
    return isinstance(blob, dict) and {"step", "model", "optimizer"} \
        <= set(blob)


def restorable_step(checkpoint_dir: str) -> Optional[int]:
    """The step `CheckpointSaver.maybe_restore` restores: the newest
    intact step whose state.pt loads (or whose orbax tree reads); None
    when there is none."""
    for step in reversed(intact_steps(checkpoint_dir)):
        if _state_loads(checkpoint_dir, step):
            return step
    return None


class CheckpointSaver:
    def __init__(self, checkpoint_dir: str, keep_max: int = 3,
                 clock=time.time):
        self._clock = clock
        self._dir = os.path.abspath(checkpoint_dir)
        self._manifest_dir = os.path.join(self._dir, ".manifests")
        os.makedirs(self._manifest_dir, exist_ok=True)
        self._keep_max = int(keep_max) if keep_max else None
        self._lock = threading.Lock()
        self._pending: Dict[int, concurrent.futures.Future] = {}
        self._writer = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="checkpoint-writer")
        self._tiered_store = None

    def attach_tiered_store(self, store) -> None:
        """Save `store`'s sidecar with every step, and load it back into
        the store on `maybe_restore`."""
        self._tiered_store = store

    # ---- steps ---------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._manifest_dir, f"{int(step)}.json")

    @property
    def checkpoint_dir(self) -> str:
        return self._dir

    def all_steps(self) -> List[int]:
        """Finalized steps, the port's and the JAX package's orbax steps,
        sorted."""
        return committed_steps(self._dir)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---- save ----------------------------------------------------------

    def save(self, state: TrainState) -> bool:
        """Start saving `state` at its step (the write runs on the
        writer thread); False when that step is already saved or being
        saved, or when an injected `checkpoint.write` fault skipped it.
        A sharded state is gathered first on every rank (every rank
        calls this), and rank 0 writes it; the others return False."""
        gathered = None
        if is_sharded(state):
            gathered = host_state(state)
            if state.mesh.rank != 0:
                return False
        try:
            faults.fire(faults.POINT_CHECKPOINT_WRITE)
        except faults.InjectedFault as exc:
            # survivable by design: the next crossing saves again and a
            # restore falls back to the last committed step
            logger.warning("checkpoint save skipped (%s)", exc)
            return False
        self._raise_failed_writes()
        step = int(state.step)
        if orbax_read.is_orbax_step(self._step_dir(step)):
            # the JAX package's step of the same number is never written
            # into
            logger.info("checkpoint step %d is an orbax step of the JAX "
                        "package; not saving over it", step)
            return False
        with self._lock:
            if step in self._pending or os.path.isfile(
                    os.path.join(self._step_dir(step), STATE_FILE)):
                return False
            start = time.perf_counter()
            blob = gathered if gathered is not None else host_state(state)
            # the store's sidecar beside the state, from the same point
            # between two steps
            sidecar = None if self._tiered_store is None else \
                store_ckpt.capture_sidecar(self._tiered_store,
                                            blob["model"], step)
            capture_s = time.perf_counter() - start
            produced = {"model_step": step,
                        "produced_unix_s": round(float(self._clock()), 6)}
            self._pending[step] = self._writer.submit(
                self._write, step, blob, produced, capture_s, sidecar)
        return True

    def _write(self, step: int, blob, produced, capture_s: float,
               sidecar=None) -> None:
        start = time.perf_counter()
        step_dir = self._step_dir(step)
        os.makedirs(step_dir, exist_ok=True)
        path = os.path.join(step_dir, STATE_FILE)
        torch.save(blob, path + ".tmp")
        if sidecar is not None:
            # before state.pt lands: a listed step has its sidecar
            store_ckpt.write_sidecar(self._dir, step, *sidecar)
        # the manifest lands before state.pt: a step is listed only once
        # its state.pt is in place, so a reader (the serving reloader)
        # never finds one it cannot verify
        manifest = {
            "step": step,
            "files": {STATE_FILE: _file_digest(path + ".tmp")},
            "produced": produced,
            "arena": arena_meta(blob["model"]),
        }
        if sidecar is not None:
            manifest["tiered"] = {k: v for k, v in sidecar[1].items()
                                  if k != "step"}
        tmp = self._manifest_path(step) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path(step))
        os.replace(path + ".tmp", path)
        logger.info("Checkpoint saved at step %d", step)
        # capture_s: the host copy on the caller's thread (under the
        # owner's lock); write_s: serialize, write and hash, off it
        events.emit(events.CHECKPOINT_SAVED, step=step,
                    bytes=manifest["files"][STATE_FILE]["size"],
                    capture_s=round(capture_s, 6),
                    write_s=round(time.perf_counter() - start, 6))
        self._sweep_old_steps()

    def _sweep_old_steps(self) -> None:
        """Keep-last-K over the port's finalized steps, skipping pinned
        ones; the JAX package's orbax steps are neither counted nor
        removed."""
        if self._keep_max is None:
            return
        excess = port_steps(self._dir)[:-self._keep_max]
        pinned = pinned_steps(self._dir)
        for step in excess:
            if step in pinned:
                logger.info("keep-last-%d sweep deferring pinned step %d",
                            self._keep_max, step)
                continue
            shutil.rmtree(self._step_dir(step))
            if os.path.exists(self._manifest_path(step)):
                os.remove(self._manifest_path(step))
        # sidecars move in lockstep with their steps
        store_ckpt.prune_sidecars(self._dir, self.all_steps())

    def _raise_failed_writes(self) -> None:
        with self._lock:
            done = [s for s, f in self._pending.items() if f.done()]
            futures = [self._pending.pop(s) for s in done]
        for future in futures:
            future.result()

    def wait_until_finished(self) -> None:
        """Join every pending write; re-raise the first failure."""
        with self._lock:
            futures = list(self._pending.values())
            self._pending.clear()
        for future in futures:
            future.result()

    def close(self) -> None:
        self.wait_until_finished()
        self._writer.shutdown(wait=True)

    # ---- integrity -----------------------------------------------------

    def verify_step(self, step: int) -> bool:
        return verify_step(self._dir, step)

    def produced_meta(self, step: int) -> Optional[Dict[str, Any]]:
        return read_produced_meta(self._dir, step)

    # ---- restore -------------------------------------------------------

    def _read_blob(self, state: TrainState, step: int) -> Dict[str, Any]:
        """{"step", "model", "optimizer"} of a step: its state.pt, or
        the JAX TrainState of an orbax step mapped onto `state`."""
        step_dir = self._step_dir(step)
        if orbax_read.is_orbax_step(step_dir):
            model, optim, saved = orbax_state.read_state(step_dir, state)
            return {"step": saved, "model": model, "optimizer": optim}
        device = next(state.model.parameters()).device
        return torch.load(os.path.join(step_dir, STATE_FILE),
                          weights_only=True, map_location=device)

    def _load_into(self, state: TrainState, step: int,
                   arena_convert: bool = False) -> TrainState:
        blob = self._read_blob(state, step)
        model_state = self._arena_compat(step, blob["model"], state,
                                         arena_convert)
        model_state, optim_state = shard_blob(state, model_state,
                                              blob["optimizer"])
        state.model.load_state_dict(model_state, strict=True)
        load_optimizer_state(state.optimizer, optim_state)
        state.step = int(blob["step"])
        events.emit(events.CHECKPOINT_RESTORED, step=state.step)
        return state

    def _load_sidecar(self, step: int):
        """The step's sidecar (a step without one raises
        FileNotFoundError)."""
        if not store_ckpt.has_sidecar(self._dir, step):
            raise FileNotFoundError(
                f"checkpoint step {step} has no tiered sidecar under "
                f"{self._dir}: its store state cannot be restored")
        return store_ckpt.load_sidecar(self._dir, step)

    def _adopt_sidecar(self, sidecar) -> None:
        # convert=True: an arena dtype change of the cache values was
        # migrated with the TrainState (arena_convert), so the map
        # carries over
        self._tiered_store.load_sidecar_state(
            sidecar.host_state, sidecar.row_of, sidecar.score,
            cache_dtype=sidecar.cache_dtype, convert=True)
        logger.info("tiered store sidecar restored for step %d "
                    "(vocab_rows=%d cache_dtype=%s)", sidecar.meta["step"],
                    sidecar.meta["vocab_rows"], sidecar.cache_dtype)

    def _arena_compat(self, step: int, model_state, template: TrainState,
                      arena_convert: bool):
        """The checkpoint's model state in the template's arena dtype:
        as it is when the dtypes agree, migrated when `arena_convert`,
        else ArenaDtypeMismatch."""
        want_sd = template.model.state_dict()
        want, have = arena_dtype_of(want_sd), arena_dtype_of(model_state)
        if have == want:
            return model_state
        if not arena_convert:
            raise ArenaDtypeMismatch(
                f"checkpoint step {step} stores {have} arena rows but the "
                f"configured model expects {want}: pass arena_convert=True "
                f"to migrate on restore, or set --arena_dtype {have} to "
                "match the checkpoint")
        if have == "float32":
            logger.info("checkpoint step %d: quantized fp32 arena rows to "
                        "int8 on restore", step)
            return quantize_arena_tree(model_state, plane_prefixes(want_sd))
        logger.info("checkpoint step %d: dequantized int8 arena rows to "
                    "fp32 on restore", step)
        return dequantize_arena_tree(model_state)

    def load_step_into(self, template: TrainState,
                       step: int) -> TrainState:
        """Load committed `step` into `template` in place (a cluster
        rank's restore of the step its group agreed on).  A load error
        raises; a later load of another step overwrites every tensor."""
        restored = self._load_into(template, step)
        logger.info("Restored checkpoint step %d", step)
        return restored

    def restore_step(self, step: int, template: TrainState,
                     arena_convert: bool = False) -> Optional[TrainState]:
        """A separate TrainState holding checkpointed `step` (eval at a
        version), or None when the step is absent or fails its check.
        `template` is not modified.  An arena dtype that differs from the
        template's raises ArenaDtypeMismatch unless `arena_convert`."""
        if step not in self.all_steps():
            return None
        if not self.verify_step(step):
            logger.warning("checkpoint step %d failed integrity check; "
                           "not restoring", step)
            return None
        restored = self._load_into(empty_like(template), step,
                                   arena_convert)
        logger.info("Restored checkpoint step %d (eval-at-version)", step)
        return restored

    def maybe_restore(self, template: TrainState,
                      arena_convert: bool = False) -> Optional[TrainState]:
        """Restore the newest intact step into `template` (in place; it
        is returned), or None when there is no step.  A step that fails
        its manifest check or fails to load falls back to the previous
        one; when every step fails, the last load error re-raises (never
        train from scratch over broken checkpoints).  With a tiered store
        attached, the restored step's sidecar is loaded into it; a step
        without one raises FileNotFoundError.  An arena dtype
        mismatch raises ArenaDtypeMismatch at once (older steps would
        mismatch alike) unless `arena_convert` migrates it."""
        last_exc: Optional[Exception] = None
        for step in reversed(intact_steps(self._dir)):
            try:
                restored = self._load_into(template, step, arena_convert)
            except ArenaDtypeMismatch:
                raise
            except LOAD_ERRORS as exc:
                last_exc = exc
                logger.warning("checkpoint step %d failed to restore (%s); "
                               "falling back to the previous good step",
                               step, exc)
                continue
            if self._tiered_store is not None:
                # outside the fallback: a restored step's sidecar that is
                # missing or refused (plans not yet applied) is a fault
                # to raise, not a damaged step to skip
                self._adopt_sidecar(self._load_sidecar(step))
            logger.info("Restored checkpoint step %d", step)
            return restored
        if last_exc is not None:
            raise last_exc
        return None
