"""Zero-downtime checkpoint hot-reload for the serving engine (the port
of the JAX package's serving/reloader.py).

A trainer keeps writing steps into its checkpoint directory; the
reloader watches that directory and swaps the serving engine onto newer
steps with the double-buffer discipline:

1. pin the candidate step (the trainer's keep-last-K sweep must not
   delete it mid-read) and gate on its integrity manifest
   (`CheckpointSaver.verify_step`) — a truncated or altered checkpoint
   never reaches the engine;
2. restore it into a FRESH TrainState (`restore_step` copies the
   engine's template), under `run_device_serialized`; the served
   variables are untouched, so both generations coexist briefly;
3. `engine.swap()` copies the new generation into the engine's static
   tensors (the ones its CUDA graphs read) under its serve lock, with
   the manifest's producer stamp.  A batch in flight finishes on the
   generation it started on (the swap waits for it), and the next runs
   on the new one with its step, so no request is dropped or served a
   half-loaded state.

Any failure — integrity, a real restore error, or an injected fault at
the `serving.reload` point (common/faults.py, fired at the start of each
attempt, as in the JAX reloader) — leaves the engine on its current
variables and is counted in `rejected_count`; the SAME step is never
retried (a corrupt step stays corrupt; retrying would melt the poll
loop), but newer steps are still considered.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from elasticdl_tpu_torch.common import events, faults
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common import save_utils
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
from elasticdl_tpu_torch.worker.trainer import (
    TrainState,
    run_device_serialized,
)

logger = get_logger(__name__)


class CheckpointReloader:
    def __init__(
        self,
        engine,
        checkpoint_dir: str,
        template: Optional[TrainState] = None,
        poll_interval_s: float = 1.0,
    ):
        template = template if template is not None \
            else engine.state_template
        if template is None:
            raise ValueError(
                "reloader needs the TrainState template the checkpoints "
                "restore into — build the engine with "
                "ServingEngine.from_checkpoint, or pass template= "
                "(serving/engine.py build_state_template)"
            )
        self._engine = engine
        self._template = template
        self._dir = checkpoint_dir
        self._saver = CheckpointSaver(checkpoint_dir)
        self._poll_interval_s = poll_interval_s
        self._rejected_steps = set()
        self.metrics_registry = metrics_lib.MetricsRegistry()
        self._reloads = self.metrics_registry.counter(
            "serving_reloads_total",
            "successful checkpoint hot-swaps onto the serving engine",
        )
        self._rejected = self.metrics_registry.counter(
            "serving_reloads_rejected_total",
            "hot-reload attempts rejected (integrity, restore, injected)",
        )
        self.last_error: Optional[str] = None
        # seconds of the last accepted reload by phase: verify (the
        # manifest's sha256), restore (load into a fresh state), swap
        self.last_reload_s: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_once(self) -> bool:
        """One poll: swap to the newest verified step if it is newer than
        what the engine serves.  True on a successful swap."""
        latest = self._saver.latest_step()
        if latest is None or latest <= self._engine.step \
                or latest in self._rejected_steps:
            return False
        # Pin across the whole verify/restore/swap window: the trainer's
        # keep-last-K sweep must never delete the step this swap is
        # reading, however long the restore takes.
        save_utils.pin_step(self._dir, latest)
        t0 = time.perf_counter()
        try:
            faults.fire(faults.POINT_SERVING_RELOAD)
            if not self._saver.verify_step(latest):
                raise RuntimeError(
                    f"step {latest} failed integrity verification"
                )
            t1 = time.perf_counter()
            restored = run_device_serialized(
                self._saver.restore_step, latest, self._template,
                getattr(self._engine, "arena_convert", False),
                device=self._engine.device,
            )
            if restored is None:
                raise RuntimeError(f"step {latest} could not be restored")
            produced = self._saver.produced_meta(latest) or {}
            t2 = time.perf_counter()
            self._engine.swap(
                restored.model.state_dict(), latest,
                produced_unix_s=produced.get("produced_unix_s"),
            )
            # restore_step verified the manifest a second time
            self.last_reload_s = {"verify": t1 - t0, "restore": t2 - t1,
                                  "swap": time.perf_counter() - t2}
        except Exception as exc:   # rejected: serving goes on as it was
            self._rejected_steps.add(latest)
            self._rejected.inc()
            self.last_error = str(exc)
            logger.warning(
                "hot-reload of step %d rejected (%s); still serving "
                "step %d", latest, exc, self._engine.step,
            )
            return False
        finally:
            save_utils.unpin_step(self._dir, latest)
        self._reloads.inc()
        self.last_error = None
        events.emit(events.SERVING_RELOADED, step=latest)
        return True

    @property
    def reload_count(self) -> int:
        return int(self._reloads.value())

    @property
    def rejected_count(self) -> int:
        return int(self._rejected.value())

    # ---- poll thread ----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="serving-reloader", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._poll_interval_s):
            try:
                self.check_once()
            except Exception:
                # the poll loop must survive anything — serving continues
                # on current variables no matter what the watcher hits
                logger.exception("reloader poll failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        self._saver.close()
