"""The port's retry policy (elasticdl_tpu_torch/common/resilience.py):
counterparts of tests/test_resilience.py's policy tests on fake clocks
and sleeps (no real waiting), the backoff sequence against the JAX
package's under the same seeded `random.Random`, float for float, the
classification table of the port's transports, and the task data
service's retries (worker/task_data_service.py)."""

import random

import pytest

from elasticdl_tpu.common import resilience as jax_resilience
from elasticdl_tpu_torch.common import faults, resilience
from elasticdl_tpu_torch.common.faults import FaultRegistry, FaultSpec
from elasticdl_tpu_torch.common.resilience import (
    RetryBudgetExhausted,
    RetryPolicy,
    default_policy,
    is_retryable_error,
)
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto.service import ServingRpcError
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService


class FakeTime:
    """Deterministic clock: sleep() advances the clock, nothing blocks."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def clock(self):
        return self.now

    def sleep(self, seconds):
        self.sleeps.append(seconds)
        self.now += seconds


def make_policy(module=resilience, **kw):
    ft = FakeTime()
    defaults = dict(
        initial_backoff_s=0.1,
        max_backoff_s=5.0,
        max_elapsed_s=60.0,
        rng=random.Random(kw.pop("seed", 0)),
        sleep=ft.sleep,
        clock=ft.clock,
    )
    defaults.update(kw)
    return module.RetryPolicy(**defaults), ft


class Flaky:
    """Fails `failures` times with `exc_type`, then returns `value`."""

    def __init__(self, failures, exc_type=ConnectionError, value="ok"):
        self.failures = failures
        self.exc_type = exc_type
        self.value = value
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.failures:
            raise self.exc_type(f"boom #{self.calls}")
        return self.value


# ---- backoff math ---------------------------------------------------------


def test_backoff_is_full_jitter_within_exponential_ceiling():
    policy, _ = make_policy(seed=1234)
    for attempt in range(10):
        ceiling = min(5.0, 0.1 * (2.0 ** attempt))
        for _ in range(20):
            delay = policy.backoff_s(attempt)
            assert 0.0 <= delay <= ceiling


def test_backoff_deterministic_under_seeded_rng():
    a, _ = make_policy(seed=7)
    b, _ = make_policy(seed=7)
    assert [a.backoff_s(i) for i in range(8)] == [
        b.backoff_s(i) for i in range(8)
    ]


@pytest.mark.parametrize("seed,settings", [
    (0, {}),
    (7, {"initial_backoff_s": 0.25, "max_backoff_s": 2.0}),
    (20241017, {"multiplier": 3.0, "max_backoff_s": 30.0}),
    (99, {"initial_backoff_s": 0.001, "max_backoff_s": 0.002}),
])
def test_backoff_sequence_is_the_jax_packages(seed, settings):
    """Under the same seeded random.Random, backoff_s(0..n) is the JAX
    package's sequence, float for float."""
    port, _ = make_policy(seed=seed, **settings)
    ref, _ = make_policy(jax_resilience, seed=seed, **settings)
    got = [port.backoff_s(i) for i in range(16)]
    want = [ref.backoff_s(i) for i in range(16)]
    assert got == want


def test_retry_sleeps_match_the_jax_policy_on_the_same_failures():
    port, pt = make_policy(seed=3)
    ref, rt = make_policy(jax_resilience, seed=3)
    assert port.call(Flaky(5)) == ref.call(Flaky(5)) == "ok"
    assert pt.sleeps == rt.sleeps and len(pt.sleeps) == 5


# ---- call() semantics -----------------------------------------------------


def test_call_retries_transient_then_succeeds():
    policy, ft = make_policy()
    fn = Flaky(failures=3)
    assert policy.call(fn, description="unit") == "ok"
    assert fn.calls == 4
    assert len(ft.sleeps) == 3  # one backoff per failed attempt


def test_non_retryable_error_raises_immediately():
    policy, ft = make_policy()
    fn = Flaky(failures=1, exc_type=ValueError)
    with pytest.raises(ValueError):
        policy.call(fn)
    assert fn.calls == 1
    assert ft.sleeps == []


def test_base_exception_always_propagates():
    class SuddenDeath(BaseException):
        pass

    policy, ft = make_policy()

    def die():
        raise SuddenDeath()

    with pytest.raises(SuddenDeath):
        policy.call(die)
    assert ft.sleeps == []


def test_elapsed_budget_exhaustion_raises_with_cause():
    policy, ft = make_policy(max_elapsed_s=1.0)
    fn = Flaky(failures=10 ** 6)
    with pytest.raises(RetryBudgetExhausted) as info:
        policy.call(fn, description="doomed")
    exc = info.value
    assert exc.description == "doomed"
    assert exc.attempts >= 1
    assert isinstance(exc.last_error, ConnectionError)
    assert isinstance(exc.__cause__, ConnectionError)
    # elapsed + the next delay never overshoots max_elapsed_s
    assert ft.now < 1.0


def test_max_attempts_bounds_retry_count():
    policy, _ = make_policy(max_attempts=3, max_elapsed_s=None)
    fn = Flaky(failures=10 ** 6)
    with pytest.raises(RetryBudgetExhausted) as info:
        policy.call(fn)
    assert fn.calls == 3
    assert info.value.attempts == 3


def test_give_up_hook_fires_once_and_cannot_mask_the_error():
    seen = []

    def hook(description, attempts, elapsed, exc):
        seen.append((description, attempts))
        raise RuntimeError("hook bug")  # must be contained

    policy, _ = make_policy(max_attempts=2, max_elapsed_s=None,
                            on_give_up=hook)
    with pytest.raises(RetryBudgetExhausted):
        policy.call(Flaky(failures=99), description="hooked")
    assert seen == [("hooked", 2)]


def test_budget_exhausted_is_itself_non_retryable():
    inner, _ = make_policy(max_attempts=1, max_elapsed_s=None)
    outer, ft = make_policy()

    def nested():
        return inner.call(Flaky(failures=99), description="inner")

    with pytest.raises(RetryBudgetExhausted):
        outer.call(nested, description="outer")
    assert ft.sleeps == []


def test_with_overrides_preserves_fakes_and_changes_fields():
    policy, ft = make_policy(max_elapsed_s=60.0)
    derived = policy.with_overrides(max_elapsed_s=1.0, max_attempts=2)
    assert derived.max_elapsed_s == 1.0
    assert derived.max_attempts == 2
    assert derived.initial_backoff_s == policy.initial_backoff_s
    with pytest.raises(RetryBudgetExhausted):
        derived.call(Flaky(failures=99))
    assert ft.sleeps  # the derived policy slept through the fake


def test_retry_and_giveup_counters():
    resilience.reset_stats()
    policy, _ = make_policy()
    policy.call(Flaky(failures=2), description="counted")
    with pytest.raises(RetryBudgetExhausted):
        policy.with_overrides(max_attempts=2, max_elapsed_s=None).call(
            Flaky(failures=99), description="counted"
        )
    stats = resilience.stats()
    assert stats["retries"] >= 3
    assert stats["giveups"] == 1
    assert stats["retries_by_call"]["counted"] >= 3
    resilience.reset_stats()
    assert resilience.stats()["retries"] == 0


# ---- classification -------------------------------------------------------


@pytest.mark.parametrize("exc,retried", [
    (ConnectionError("net"), True),
    (ConnectionRefusedError("refused"), True),
    (ConnectionResetError("reset"), True),
    (TimeoutError("socket timeout"), True),
    (faults.InjectedFault("injected"), True),
    (faults.DroppedRequest("dropped"), True),
    (ServingRpcError(503, "server is stopping"), True),
    (ServingRpcError(504, "gateway timeout"), True),
    (ServingRpcError(400, "bad request"), False),
    (ServingRpcError(404, "no such method"), False),
    (ServingRpcError(500, "handler raised"), False),
    (ValueError("app bug"), False),
    (RetryBudgetExhausted("d", 1, 1.0, ConnectionError()), False),
], ids=lambda v: type(v).__name__ if isinstance(v, BaseException)
    else str(v))
def test_is_retryable_error_classification(exc, retried):
    assert is_retryable_error(exc) is retried


def test_non_grpc_rules_agree_with_the_jax_package():
    for exc in (ConnectionError("net"), ValueError("bug"),
                jax_resilience.RetryBudgetExhausted("d", 1, 1.0)):
        port_exc = (RetryBudgetExhausted("d", 1, 1.0)
                    if isinstance(exc, jax_resilience.RetryBudgetExhausted)
                    else exc)
        assert is_retryable_error(port_exc) == \
            jax_resilience.is_retryable_error(exc)


def test_default_policy_reads_env_knobs(monkeypatch):
    monkeypatch.setenv(resilience.ENV_MAX_ELAPSED_S, "7.5")
    monkeypatch.setenv(resilience.ENV_INITIAL_BACKOFF_S, "0.25")
    monkeypatch.setenv(resilience.ENV_MAX_BACKOFF_S, "2.0")
    monkeypatch.setenv(resilience.ENV_ATTEMPT_TIMEOUT_S, "3.0")
    policy = default_policy()
    assert policy.max_elapsed_s == 7.5
    assert policy.initial_backoff_s == 0.25
    assert policy.max_backoff_s == 2.0
    assert policy.attempt_timeout_s == 3.0
    assert default_policy(max_elapsed_s=99.0).max_elapsed_s == 99.0
    monkeypatch.setenv(resilience.ENV_MAX_ELAPSED_S, "not-a-float")
    assert default_policy().max_elapsed_s == 120.0
    # the same four variables, the same names, as the JAX package's
    assert (resilience.ENV_MAX_ELAPSED_S, resilience.ENV_INITIAL_BACKOFF_S,
            resilience.ENV_MAX_BACKOFF_S,
            resilience.ENV_ATTEMPT_TIMEOUT_S) == (
        jax_resilience.ENV_MAX_ELAPSED_S,
        jax_resilience.ENV_INITIAL_BACKOFF_S,
        jax_resilience.ENV_MAX_BACKOFF_S,
        jax_resilience.ENV_ATTEMPT_TIMEOUT_S)


# ---- the task data service ------------------------------------------------


class FlakyMaster:
    """A master client whose calls fire the data service's points and
    count; a fault registry decides which attempts fail."""

    def __init__(self, finished_after=1):
        self.gets = 0
        self.reports = []
        self.finished_after = finished_after

    def get_task(self, req):
        faults.fire(faults.POINT_RPC_GET_TASK)
        self.gets += 1
        if self.gets > self.finished_after:
            return pb.GetTaskResponse(task=pb.Task(task_id=-1, type=pb.WAIT),
                                      job_finished=True)
        return pb.GetTaskResponse(task=pb.Task(
            task_id=7, type=pb.TRAINING,
            shard=pb.Shard(name="f", start=0, end=4)))

    def report_task_result(self, req):
        faults.fire(faults.POINT_RPC_REPORT)
        self.reports.append(req.task_id)
        return pb.Empty()


def _service(master, policy=None):
    ft = FakeTime()
    base = policy or RetryPolicy(rng=random.Random(0), sleep=ft.sleep,
                                 clock=ft.clock)
    return TaskDataService(master, None, 0, rpc_policy=base), ft


def test_data_service_retries_injected_get_and_report_faults():
    master = FlakyMaster()
    svc, ft = _service(master)
    faults.install(FaultRegistry([
        FaultSpec(faults.POINT_RPC_GET_TASK, 0, "raise"),
        FaultSpec(faults.POINT_RPC_GET_TASK, 1, "drop"),
        FaultSpec(faults.POINT_RPC_REPORT, 0, "raise")]))
    try:
        task, finished = svc.get_task()
        assert task.task_id == 7 and not finished
        svc.report_task(task, records=4, model_version=3)
        assert master.reports == [7]
        assert svc.get_task() == (None, True)
        assert faults.get_registry().unfired() == []
    finally:
        faults.uninstall()
    assert len(ft.sleeps) == 3


def test_data_service_gives_up_as_the_jax_one_does():
    """A master lost past the get budget ends the worker (None, True); a
    report that exhausts its budget is logged as lost, not raised;
    application errors propagate at once."""
    master = FlakyMaster()
    svc, _ = _service(master)
    faults.install(FaultRegistry([
        FaultSpec(faults.POINT_RPC_GET_TASK, i, "raise")
        for i in range(10 ** 4)] + [
        FaultSpec(faults.POINT_RPC_REPORT, i, "drop")
        for i in range(10 ** 4)]))
    try:
        assert svc.get_task() == (None, True)
        svc.report_task(pb.Task(task_id=3), records=1)
        assert master.reports == []
    finally:
        faults.uninstall()

    class Broken(FlakyMaster):
        def report_task_result(self, req):
            raise ValueError("application error")

    svc, ft = _service(Broken())
    with pytest.raises(ValueError):
        svc.report_task(pb.Task(task_id=3))
    assert ft.sleeps == []
