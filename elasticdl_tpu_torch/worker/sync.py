"""Model ownership inside one process (the port's copy of the JAX
package's worker/sync.py).

A single `ModelOwner` (one Trainer, one TrainState, one update lock)
serves every worker thread, so N workers train one model: each computes
its step against the parameters as of its own start and applies it
under the lock, the reference's async parameter server with staleness
bounded by the number of threads.

The port's TrainState is updated in place (`optimizer.step()` rewrites
the parameters), where the JAX state is immutable and donated.  So a
state that must stay put while training goes on (an eval task's, an
export's) is an owning copy taken under the lock: `snapshot_state`.
A cluster job has no shared owner: each rank holds its own copy of one
model and restarts its process for a new topology (worker/spmd.py).
"""

from __future__ import annotations

import copy
import threading
from typing import Optional

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.worker.trainer import TrainState

logger = get_logger(__name__)

# the seed of a job's initial parameters (the JAX owner's PRNGKey(0))
INIT_SEED = 0


def first_rows(tree):
    """One host row of each leaf (a sample for export signatures)."""
    if isinstance(tree, dict):
        return {k: first_rows(v) for k, v in tree.items()}
    return np.asarray(tree[:1])


class ModelOwner:
    """Owns one model replica: trainer, state, update lock, checkpoints.
    Workers never touch the TrainState directly."""

    def __init__(self, trainer, checkpoint_saver=None,
                 checkpoint_steps: int = 0):
        self.trainer = trainer
        self.lock = threading.RLock()
        self.state: Optional[TrainState] = None
        self.sample_features = None
        self.checkpoint_saver = checkpoint_saver
        self.checkpoint_steps = checkpoint_steps

    # ---- state lifecycle ----------------------------------------------

    def ensure_state(self, batch) -> None:
        """Initialize (and restore from the saver's newest intact step)
        on the first batch; a state installed beforehand is kept.  The
        state is installed only once the restore succeeded (the JAX
        owner installs the random init first, so a retry after a failed
        restore goes on from it)."""
        with self.lock:
            if self.sample_features is None:
                # one host row, kept for export signatures
                self.sample_features = first_rows(batch["features"])
            if self.state is not None:
                return
            state = self.trainer.init_state(INIT_SEED, batch["features"])
            if self.checkpoint_saver is not None:
                # a restore that raises installs nothing: the next call
                # tries again rather than going on from the random init
                restored = self.checkpoint_saver.maybe_restore(state)
                if restored is not None:
                    state = restored
                    logger.info("Restored state from checkpoint")
            self.state = state

    def has_trained_state(self) -> bool:
        """True if the owner holds (or can restore) non-random params."""
        with self.lock:
            if self.state is not None and self.state.step > 0:
                return True
            return (self.checkpoint_saver is not None
                    and self.checkpoint_saver.latest_step() is not None)

    @property
    def step(self) -> int:
        with self.lock:
            return 0 if self.state is None else int(self.state.step)

    # ---- serialized model operations ----------------------------------

    def train_batch(self, batch):
        with self.lock:
            self.ensure_state(batch)
            self.state, loss = self.trainer.train_on_batch(self.state, batch)
            self._maybe_checkpoint()
            return loss

    def train_batch_stack(self, batches):
        """steps_per_execution: len(batches) steps in one call; returns
        the per-step losses."""
        with self.lock:
            self.ensure_state(batches[0])
            self.state, losses = self.trainer.train_on_batch_stack(
                self.state, batches)
            self._maybe_checkpoint(stride=len(batches))
            return losses

    def stage_batch(self, batch):
        """The batch's tensors on the device for a later train_batch;
        ensure_state runs first, on the host batch."""
        with self.lock:
            self.ensure_state(batch)
            return self.trainer.stage_batch(batch)

    def predict_batch(self, batch, state=None):
        """Forward pass; `state` overrides the owner's current state (an
        eval task's snapshot or restored version)."""
        with self.lock:
            self.ensure_state(batch)
            use = self.state if state is None else state
            return self.trainer.predict_on_batch(use, batch["features"])

    def save(self) -> None:
        with self.lock:
            if self.checkpoint_saver is not None and self.state is not None:
                self.checkpoint_saver.save(self.state)

    def save_and_flush(self) -> None:
        """Synchronous final checkpoint (the drain hook)."""
        self.save()
        if self.checkpoint_saver is not None:
            self.checkpoint_saver.wait_until_finished()

    def _maybe_checkpoint(self, stride: int = 1) -> None:
        """Checkpoint when [step - stride, step] crossed a multiple of
        checkpoint_steps (`stride`: the steps the last call advanced)."""
        if (
            self.checkpoint_saver is not None
            and self.checkpoint_steps
            and self.state is not None
            and self.state.step % self.checkpoint_steps < stride
        ):
            self.checkpoint_saver.save(self.state)

    def snapshot(self) -> Optional[TrainState]:
        """An owning copy of the current state (see snapshot_state)."""
        with self.lock:
            return snapshot_state(self.state)

    def state_for_eval(self, requested_version: int):
        """(state, actual_version) an eval task should score: the
        checkpointed state at the requested version when retrievable,
        else a snapshot of the current one, labelled with its true
        step."""
        with self.lock:
            return state_at_version(self.state, self.checkpoint_saver,
                                    requested_version)


def snapshot_state(state: Optional[TrainState]) -> Optional[TrainState]:
    """A forward-only copy of a TrainState that owns its parameters and
    buffers (a deep copy of the model, on the same device), so it stays
    put while `optimizer.step()` goes on rewriting the live parameters.
    Call it under the owner's lock.  The optimizer is not copied (its
    moments are twice the parameters and eval never reads them): the
    snapshot has none, so it cannot be trained."""
    if state is None:
        return None
    return TrainState(step=state.step, model=copy.deepcopy(state.model),
                      optimizer=None)


def state_at_version(state, checkpoint_saver, requested_version: int):
    """(state, actual_version): `actual_version` is what the metrics must
    be labelled with.  The returned state is safe to hold across batches:
    a separate state restored from the checkpoint, or a snapshot of the
    live one."""
    current = -1 if state is None else int(state.step)
    if requested_version < 0 or requested_version == current:
        return snapshot_state(state), current
    if checkpoint_saver is not None and state is not None:
        restored = checkpoint_saver.restore_step(requested_version, state)
        if restored is not None:
            return restored, requested_version
    logger.info("Eval at version %d not retrievable (current step %d, no "
                "checkpoint); evaluating current state",
                requested_version, current)
    return snapshot_state(state), current
