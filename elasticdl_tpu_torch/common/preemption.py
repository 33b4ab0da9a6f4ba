"""Save-on-preemption: checkpoint before the pod dies (the port of the
JAX package's common/preemption.py).

A preemptible VM gets SIGTERM with a grace window before it is
reclaimed; the hook flushes one final checkpoint so the replacement
topology restores from the last step instead of the last periodic save
(a cluster rank only sets its drain flag: see worker/spmd.py).  Elastic
recovery then goes through the epoch bump, and the task queue re-leases
whatever this worker held.

A disruption notice can come before the kill: a file a node watcher
fills (`file_notice_checker`), or the GCE metadata server's `preempted`
and `maintenance-event` entries (`gce_metadata_checker`, which reads as
no notice wherever the server cannot be reached).
`MaintenanceNoticeWatcher` polls a source and fires the drain hook once.
"""

from __future__ import annotations

import signal
import sys
from typing import Callable, Iterable

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)


def install_preemption_hook(
    save_fn: Callable[[], None],
    signals: Iterable[int] = (signal.SIGTERM,),
    exit_after: bool = True,
    exit_code: int = 143,
) -> Callable[[int, object], None]:
    """Register `save_fn` to run on preemption signals.

    exit_after=False is for tests (the handler returns instead of
    exiting).  Returns the handler so tests can invoke it directly.
    """

    def handler(signum, frame):
        logger.warning(
            "Preemption signal %d: flushing final checkpoint", signum
        )
        try:
            save_fn()
        except Exception as exc:  # best effort — never mask the shutdown
            logger.error("Preemption checkpoint failed: %s", exc)
        if exit_after:
            sys.exit(exit_code)

    for sig in signals:
        signal.signal(sig, handler)
    return handler


# ---- maintenance-event / preemption-notice awareness -------------------
#
# Cloud node pools publish upcoming disruption before the kill:
# maintenance events and spot reclaims on the instance metadata server,
# often projected into a file in the pod by a node watcher.  Acting on
# the notice drains at a task boundary and flushes a checkpoint while
# the grace window is still whole.


def file_notice_checker(path: str) -> Callable[[], bool]:
    """Notice = the file exists AND is non-empty.  A downward-API
    projection creates the file at pod start with the (empty) label
    value — existence alone would read as an immediate notice and
    drain-loop the job; content appears only when the node watcher
    writes the event (e.g. TERMINATE_ON_MAINTENANCE)."""
    import os

    def check() -> bool:
        try:
            return os.path.getsize(path) > 0
        except OSError:
            return False

    return check


def gce_metadata_checker(
    kind: str = "preempted",
    timeout_s: float = 1.0,
) -> Callable[[], bool]:
    """Poll the GCE metadata server for a disruption notice.

    kind: "preempted" (spot/preemptible reclaim) or "maintenance-event"
    (host maintenance; value != NONE means a migration is imminent).
    Unreachable metadata (non-GCE hosts, tests) reads as no-notice.
    """
    import urllib.request

    url = (
        "http://metadata.google.internal/computeMetadata/v1/instance/"
        + ("preempted" if kind == "preempted" else "maintenance-event")
    )

    def check() -> bool:
        try:
            req = urllib.request.Request(
                url, headers={"Metadata-Flavor": "Google"}
            )
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                value = resp.read().decode().strip().upper()
            if kind == "preempted":
                return value == "TRUE"
            return value not in ("", "NONE")
        except Exception:
            return False

    return check


def any_notice_checker(*checkers) -> Callable[[], bool]:
    """Notice = ANY source fires.  The GCE wiring watches both the spot
    reclaim ('preempted') and the scheduled host maintenance
    ('maintenance-event') endpoints; a VM that is not spot only ever
    sees the latter."""

    def check() -> bool:
        return any(c() for c in checkers)

    return check


class MaintenanceNoticeWatcher:
    """Daemon thread polling a notice source; fires `on_notice` ONCE when
    the notice appears.  `on_notice` is the same drain hook the SIGTERM
    path uses (stop at the next task boundary + flush checkpoint), so the
    notice simply starts recovery earlier than the kill would."""

    def __init__(
        self,
        check: Callable[[], bool],
        on_notice: Callable[[], None],
        poll_s: float = 5.0,
    ):
        self._check = check
        self._on_notice = on_notice
        self._poll_s = poll_s
        self._fired = False
        self._stop = False
        self._thread = None

    def start(self) -> "MaintenanceNoticeWatcher":
        import threading

        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop = True

    @property
    def fired(self) -> bool:
        return self._fired

    def _run(self) -> None:
        import time

        while not self._stop and not self._fired:
            try:
                notice = self._check()
            except Exception:
                notice = False
            if notice:
                logger.warning(
                    "Maintenance/preemption notice observed: draining at "
                    "the next task boundary and flushing checkpoint "
                    "(ahead of the kill)"
                )
                try:
                    self._on_notice()
                except Exception as exc:
                    logger.error("Notice drain hook failed: %s", exc)
                # published AFTER the drain hook: observers of `fired`
                # may rely on the drain having actually happened
                self._fired = True
                return
            time.sleep(self._poll_s)
