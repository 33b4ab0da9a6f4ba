"""One retry policy for the control plane (the port's copy of the JAX
package's common/resilience.py).

`RetryPolicy` is exponential backoff with full jitter, a per-attempt
timeout, an elapsed-time budget, an attempt cap, a pluggable retryable
classification and a give-up hook.  Exhausting a budget is an outcome of
its own: `RetryBudgetExhausted` is raised and never retried.

The port has no gRPC, so the classification keeps the reference's
non-gRPC rules and maps its gRPC codes onto what the port's transports
raise:

    error                                         retried
    RetryBudgetExhausted                          no
    faults.InjectedFault (and DroppedRequest)     yes
    ConnectionError (refused, reset, aborted)     yes
    socket.timeout / TimeoutError                 yes  (DEADLINE_EXCEEDED)
    HttpRpcError, HTTP 503 (server stopping)      yes  (UNAVAILABLE)
    HttpRpcError, HTTP 504                        yes  (DEADLINE_EXCEEDED)
    HttpRpcError, HTTP 400, 404, 500              no   (INVALID_ARGUMENT,
                                                        UNIMPLEMENTED,
                                                        INTERNAL)
    anything else                                 no

`wait_for_channel_ready` and the gRPC client interceptor have no channel
to wrap here; their counterpart is the retry policy a `ServingStub`
takes (proto/service.py), which fires the method's fault point on every
attempt as the interceptor does.
"""

from __future__ import annotations

import logging
import os
import random
import socket
import time
from typing import Callable, Optional

from elasticdl_tpu_torch.common import faults, metrics

logger = logging.getLogger(__name__)

# Env knobs; explicit overrides to default_policy win.
ENV_MAX_ELAPSED_S = "ELASTICDL_RPC_MAX_ELAPSED_S"
ENV_INITIAL_BACKOFF_S = "ELASTICDL_RPC_INITIAL_BACKOFF_S"
ENV_MAX_BACKOFF_S = "ELASTICDL_RPC_MAX_BACKOFF_S"
ENV_ATTEMPT_TIMEOUT_S = "ELASTICDL_RPC_ATTEMPT_TIMEOUT_S"

# A cluster worker whose master stayed unreachable past the retry budget
# exits with this code: a charged relaunch (master/pod_manager.py)
RETRY_EXHAUSTED_EXIT_CODE = 45

# HTTP statuses of a stub's call that a retry may cure
RETRYABLE_HTTP_STATUSES = frozenset({503, 504})


class RetryBudgetExhausted(Exception):
    """A call gave up: every attempt failed and the elapsed or attempt
    budget ran out.  Carries the last underlying error as __cause__."""

    def __init__(self, description: str, attempts: int, elapsed_s: float,
                 last_error: Optional[BaseException] = None):
        self.description = description
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        self.last_error = last_error
        super().__init__(
            f"{description or 'call'}: gave up after {attempts} attempts "
            f"({elapsed_s:.1f}s elapsed): {last_error!r}"
        )


def is_retryable_error(exc: BaseException) -> bool:
    """Default classification (the module docstring's table): transient
    transport errors retry, application errors and exhausted budgets do
    not."""
    if isinstance(exc, RetryBudgetExhausted):
        return False
    if isinstance(exc, faults.InjectedFault):
        return True
    if isinstance(exc, (ConnectionError, socket.timeout, TimeoutError)):
        return True
    # proto/service imports this module: the reverse import waits
    from elasticdl_tpu_torch.proto.service import HttpRpcError

    if isinstance(exc, HttpRpcError):
        return exc.status in RETRYABLE_HTTP_STATUSES
    return False


# ---- process-wide counters (read by Master.snapshot) --------------------

_retry_counter = metrics.default_registry().counter(
    "rpc_client_retries_total",
    "RPC attempts retried under the shared policy, by call description",
    labelnames=("call",),
)
_giveup_counter = metrics.default_registry().counter(
    "rpc_client_giveups_total",
    "RPC calls that exhausted their retry budget, by call description",
    labelnames=("call",),
)


def _record_retry(description: str) -> None:
    _retry_counter.labels(call=description or "?").inc()


def _record_giveup(description: str) -> None:
    _giveup_counter.labels(call=description or "?").inc()


def _by_call(counter) -> dict:
    return {
        key[0]: int(value)
        for key, value in sorted(counter.child_values().items())
        if value
    }


def stats() -> dict:
    return {
        "retries": int(_retry_counter.value()),
        "giveups": int(_giveup_counter.value()),
        "retries_by_call": _by_call(_retry_counter),
        "giveups_by_call": _by_call(_giveup_counter),
    }


def reset_stats() -> None:
    _retry_counter.reset()
    _giveup_counter.reset()


class RetryPolicy:
    """Exponential backoff with full jitter, bounded by a wall-clock
    budget and/or an attempt count.

    `call(fn)` retries `fn()` while `retryable(exc)` holds and budget
    remains.  Only `Exception` is caught: BaseException control flow
    (KeyboardInterrupt, SystemExit) always propagates.
    """

    def __init__(
        self,
        initial_backoff_s: float = 0.1,
        max_backoff_s: float = 5.0,
        multiplier: float = 2.0,
        attempt_timeout_s: Optional[float] = None,
        max_elapsed_s: Optional[float] = 60.0,
        max_attempts: int = 0,  # 0 = unbounded by count
        retryable: Callable[[BaseException], bool] = is_retryable_error,
        on_give_up: Optional[Callable[..., None]] = None,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.initial_backoff_s = initial_backoff_s
        self.max_backoff_s = max_backoff_s
        self.multiplier = multiplier
        self.attempt_timeout_s = attempt_timeout_s
        self.max_elapsed_s = max_elapsed_s
        self.max_attempts = max_attempts
        self.retryable = retryable
        self.on_give_up = on_give_up
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep
        self._clock = clock

    def backoff_s(self, attempt: int) -> float:
        """Full jitter: uniform in [0, min(cap, initial * mult^attempt)]."""
        ceiling = min(
            self.max_backoff_s,
            self.initial_backoff_s * (self.multiplier ** attempt),
        )
        return self._rng.uniform(0.0, ceiling)

    def with_overrides(self, **kw) -> "RetryPolicy":
        fields = dict(
            initial_backoff_s=self.initial_backoff_s,
            max_backoff_s=self.max_backoff_s,
            multiplier=self.multiplier,
            attempt_timeout_s=self.attempt_timeout_s,
            max_elapsed_s=self.max_elapsed_s,
            max_attempts=self.max_attempts,
            retryable=self.retryable,
            on_give_up=self.on_give_up,
        )
        fields.update(kw)
        return RetryPolicy(
            sleep=self._sleep, clock=self._clock, rng=self._rng, **fields
        )

    def call(self, fn: Callable[[], object], description: str = ""):
        start = self._clock()
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as exc:
                if not self.retryable(exc):
                    raise
                attempt += 1
                elapsed = self._clock() - start
                delay = self.backoff_s(attempt - 1)
                out_of_attempts = (
                    self.max_attempts > 0 and attempt >= self.max_attempts
                )
                out_of_time = (
                    self.max_elapsed_s is not None
                    and elapsed + delay >= self.max_elapsed_s
                )
                if out_of_attempts or out_of_time:
                    _record_giveup(description)
                    if self.on_give_up is not None:
                        try:
                            self.on_give_up(description, attempt, elapsed, exc)
                        except Exception:
                            logger.exception("on_give_up hook failed")
                    raise RetryBudgetExhausted(
                        description, attempt, elapsed, exc
                    ) from exc
                _record_retry(description)
                logger.warning(
                    "%s failed (attempt %d, %.1fs elapsed): %r; "
                    "retrying in %.2fs",
                    description or "call", attempt, elapsed, exc, delay,
                )
                self._sleep(delay)


def default_policy(**overrides) -> RetryPolicy:
    """A policy with env-tunable defaults (the four ELASTICDL_RPC_*
    variables; a value that does not parse keeps the default)."""
    def _env_f(name, default):
        raw = os.environ.get(name, "")
        try:
            return float(raw) if raw else default
        except ValueError:
            return default

    kw = dict(
        initial_backoff_s=_env_f(ENV_INITIAL_BACKOFF_S, 0.1),
        max_backoff_s=_env_f(ENV_MAX_BACKOFF_S, 5.0),
        max_elapsed_s=_env_f(ENV_MAX_ELAPSED_S, 120.0),
        attempt_timeout_s=_env_f(ENV_ATTEMPT_TIMEOUT_S, 20.0),
    )
    kw.update(overrides)
    return RetryPolicy(**kw)
