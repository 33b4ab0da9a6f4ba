"""The cluster's control plane, the port against the JAX package: the
rendezvous server (tests/test_rendezvous.py), the SPMD assigner
(tests/test_spmd.py), the pod manager's scaling, group restarts and
adoption (tests/test_pod_scaling.py, the non-slow cases of
tests/test_elasticity.py), the recovery clock (tests/test_recovery_clock.py)
and the maintenance-notice watcher (tests/test_maintenance_notice.py).

Each scenario runs once per package, with the same event sequence on a
`FakeK8sClient`, and returns what it observed: cluster specs and SPMD
responses (JAX messages carried into the port's dataclasses through
their wire bytes), snapshots, launched pod specs, groups and relaunch
chains.  The two packages' observations must be equal, exactly; each
scenario also holds the JAX test's own assertions on both."""

import dataclasses
import threading
import time
import types

import pytest

from elasticdl_tpu.common import faults as jax_faults
from elasticdl_tpu.common import k8s_client as jax_k8s
from elasticdl_tpu.common import preemption as jax_preemption
from elasticdl_tpu.common.constants import PodStatus as JaxPodStatus
from elasticdl_tpu.master import pod_manager as jax_pod_manager
from elasticdl_tpu.master import recovery as jax_recovery
from elasticdl_tpu.master import rendezvous_server as jax_rendezvous
from elasticdl_tpu.master import spmd_assigner as jax_assigner
from elasticdl_tpu.master import task_manager as jax_task_manager
from elasticdl_tpu.proto import elasticdl_pb2 as jax_pb
from elasticdl_tpu_torch.common import faults as torch_faults
from elasticdl_tpu_torch.common import k8s_client as torch_k8s
from elasticdl_tpu_torch.common import preemption as torch_preemption
from elasticdl_tpu_torch.common.constants import PodStatus as TorchPodStatus
from elasticdl_tpu_torch.master import pod_manager as torch_pod_manager
from elasticdl_tpu_torch.master import recovery as torch_recovery
from elasticdl_tpu_torch.master import rendezvous_server as torch_rendezvous
from elasticdl_tpu_torch.master import spmd_assigner as torch_assigner
from elasticdl_tpu_torch.master import task_manager as torch_task_manager
from elasticdl_tpu_torch.proto import messages as torch_pb

PKGS = {
    "jax": types.SimpleNamespace(
        pb=jax_pb, Rendezvous=jax_rendezvous.RendezvousServer,
        Assigner=jax_assigner.SpmdAssigner,
        TaskManager=jax_task_manager.TaskManager,
        shards=jax_task_manager.create_shards_from_ranges,
        Fake=jax_k8s.FakeK8sClient, PodManager=jax_pod_manager.PodManager,
        PodStatus=JaxPodStatus, faults=jax_faults,
        RecoveryClock=jax_recovery.RecoveryClock,
        preemption=jax_preemption),
    "torch": types.SimpleNamespace(
        pb=torch_pb, Rendezvous=torch_rendezvous.RendezvousServer,
        Assigner=torch_assigner.SpmdAssigner,
        TaskManager=torch_task_manager.TaskManager,
        shards=torch_task_manager.create_shards_from_ranges,
        Fake=torch_k8s.FakeK8sClient, PodManager=torch_pod_manager.PodManager,
        PodStatus=TorchPodStatus, faults=torch_faults,
        RecoveryClock=torch_recovery.RecoveryClock,
        preemption=torch_preemption),
}


@pytest.fixture(autouse=True)
def _no_fault_registry():
    yield
    jax_faults.uninstall()
    torch_faults.uninstall()


def canon(msg):
    """A message of either package as the port's dataclass, as a dict:
    a JAX message goes through its wire bytes."""
    if not dataclasses.is_dataclass(msg):
        msg = getattr(torch_pb, type(msg).__name__).FromString(
            msg.SerializeToString())
    return dataclasses.asdict(msg)


def both(scenario, *args):
    """Run `scenario` on each package; the observations must be equal."""
    jax_out = scenario(PKGS["jax"], *args)
    torch_out = scenario(PKGS["torch"], *args)
    assert torch_out == jax_out
    return torch_out


# ---- rendezvous (tests/test_rendezvous.py) --------------------------------


def _spec(ns, rdzv, worker_id=0, confirm=0):
    spec = rdzv.cluster_spec(ns.pb.GetClusterSpecRequest(
        worker_id=worker_id, confirm_epoch=confirm))
    return spec


def rdzv_addresses(ns):
    rdzv = ns.Rendezvous(coordinator_port=5555)
    rdzv.add_worker(0, "10.0.0.1")
    rdzv.add_worker(1, "10.0.0.2")
    spec = _spec(ns, rdzv)
    assert [w.address for w in spec.workers] == ["10.0.0.1", "10.0.0.2"]
    assert spec.coordinator_address == "10.0.0.1:5555"
    return [canon(spec)]


def rdzv_empty_readd(ns):
    rdzv = ns.Rendezvous()
    rdzv.add_worker(0, "10.0.0.1")
    epoch = rdzv.rendezvous_id
    rdzv.add_worker(0, "")
    assert rdzv.rendezvous_id == epoch
    spec = _spec(ns, rdzv)
    assert spec.workers[0].address == "10.0.0.1"
    return [canon(spec)]


def rdzv_update_address(ns):
    rdzv = ns.Rendezvous(coordinator_port=5555)
    rdzv.add_worker(0, "")
    epoch = rdzv.rendezvous_id
    rdzv.update_address(99, "10.9.9.9")
    first = _spec(ns, rdzv)
    assert first.world_size == 1
    rdzv.update_address(0, "10.0.0.7")
    assert rdzv.rendezvous_id == epoch + 1
    second = _spec(ns, rdzv)
    assert second.coordinator_address == "10.0.0.7:5555"
    return [canon(first), canon(second)]


def rdzv_expected(ns):
    rdzv = ns.Rendezvous()
    rdzv.add_worker(0)
    rdzv.set_expected(2)
    spec = _spec(ns, rdzv)
    assert spec.expected_world_size == 2
    return [canon(spec)]


def rdzv_barrier(ns):
    rdzv = ns.Rendezvous()
    rdzv.add_worker(0, "a")
    rdzv.add_worker(1, "b")
    epoch = rdzv.rendezvous_id
    seen = [_spec(ns, rdzv), _spec(ns, rdzv, 0, epoch),
            _spec(ns, rdzv, 1, epoch)]
    assert [s.all_confirmed for s in seen] == [False, False, True]
    rdzv.add_worker(2, "c")
    new = rdzv.rendezvous_id
    seen += [_spec(ns, rdzv, w, new) for w in (0, 1, 2)]
    assert [s.all_confirmed for s in seen[3:]] == [False, False, True]
    return [canon(s) for s in seen]


def rdzv_removed_forgotten(ns):
    rdzv = ns.Rendezvous()
    rdzv.add_worker(0, "a")
    rdzv.add_worker(1, "b")
    epoch = rdzv.rendezvous_id
    seen = [_spec(ns, rdzv, 0, epoch), _spec(ns, rdzv, 1, epoch)]
    rdzv.remove_worker(1)
    spec = _spec(ns, rdzv, 0)
    assert not spec.all_confirmed
    again = _spec(ns, rdzv, 0, spec.rendezvous_id)
    assert again.all_confirmed
    return [canon(s) for s in seen + [spec, again]]


def rdzv_stale_confirmation(ns):
    rdzv = ns.Rendezvous()
    rdzv.add_worker(0, "a")
    old = rdzv.rendezvous_id
    rdzv.add_worker(1, "b")
    spec = _spec(ns, rdzv, 0, old)
    assert not spec.all_confirmed
    return [canon(spec)]


@pytest.mark.parametrize("scenario", [
    rdzv_addresses, rdzv_empty_readd, rdzv_update_address, rdzv_expected,
    rdzv_barrier, rdzv_removed_forgotten, rdzv_stale_confirmation,
], ids=lambda f: f.__name__)
def test_rendezvous_matches_the_reference(scenario):
    both(scenario)


# ---- the SPMD assigner (tests/test_spmd.py:58-120) ------------------------


def _tm(ns, n_shards=4):
    return ns.TaskManager(training_shards=ns.shards(
        [("f", 0, 64 * n_shards)], records_per_task=64))


def _req(ns, worker, epoch, seq):
    return ns.pb.GetSpmdTaskRequest(worker_id=worker, rendezvous_id=epoch,
                                    seq=seq)


def assign_same_seq(ns):
    assigner = ns.Assigner(_tm(ns))
    r0 = assigner.get(_req(ns, 0, 0, 0))
    r1 = assigner.get(_req(ns, 1, 0, 0))
    assert r0.task.task_id == r1.task.task_id >= 0
    r2 = assigner.get(_req(ns, 1, 0, 1))
    assert r2.task.task_id != r0.task.task_id
    return [canon(r) for r in (r0, r1, r2)]


def assign_stale_epoch(ns):
    assigner = ns.Assigner(_tm(ns), types.SimpleNamespace(rendezvous_id=3))
    stale = assigner.get(_req(ns, 0, 1, 0))
    assert stale.epoch_stale
    fresh = assigner.get(_req(ns, 0, 3, 0))
    assert not fresh.epoch_stale and fresh.task.task_id >= 0
    return [canon(stale), canon(fresh)]


def assign_epoch_bump(ns):
    rdzv = types.SimpleNamespace(rendezvous_id=0)
    tm = _tm(ns, n_shards=2)
    assigner = ns.Assigner(tm, rdzv)
    r0 = assigner.get(_req(ns, 0, 0, 0))
    assert r0.task.task_id >= 0
    rdzv.rendezvous_id = 1
    resp = assigner.get(_req(ns, 0, 1, 0))
    assert resp.task.task_id >= 0
    assert tm.counters.recovered == 1
    return [canon(r0), canon(resp), tm.counters.recovered]


def assign_finished(ns):
    tm = _tm(ns, n_shards=1)
    assigner = ns.Assigner(tm)
    r = assigner.get(_req(ns, 0, 0, 0))
    tm.report(r.task.task_id, success=True)
    done = [assigner.get(_req(ns, w, 0, 1)) for w in (0, 1)]
    assert all(d.job_finished for d in done)
    return [canon(r)] + [canon(d) for d in done]


@pytest.mark.parametrize("scenario", [
    assign_same_seq, assign_stale_epoch, assign_epoch_bump, assign_finished,
], ids=lambda f: f.__name__)
def test_spmd_assigner_matches_the_reference(scenario):
    both(scenario)


# ---- the pod manager (tests/test_pod_scaling.py, tests/test_elasticity.py)


class StubTaskManager:
    def __init__(self):
        self.recovered = []

    def recover_tasks(self, worker_id):
        self.recovered.append(worker_id)
        return 0


def _pods(ns, k8s, manager, tm=None):
    """What a pod scenario observes: membership, groups, chains, the
    snapshot, every launched pod spec and delete, recovered workers."""
    return {
        "alive": manager.alive_workers(),
        "groups": dict(sorted(manager._group_of.items())),
        "chains": dict(sorted(manager._relaunch_count.items())),
        "snapshot": manager.snapshot(),
        "created": [(s.name, s.pod_type, s.worker_id, s.command,
                     dict(s.labels)) for s in k8s.create_calls],
        "deleted": list(k8s.delete_calls),
        "recovered": list(tm.recovered) if tm is not None else None,
    }


def _manager(ns, num_workers, wpg=1, budget=3, on_abort=None,
             job="scaletest", k8s=None):
    k8s = k8s or ns.Fake()
    tm = StubTaskManager()
    manager = ns.PodManager(
        k8s, task_manager=tm, job_name=job, num_workers=num_workers,
        relaunch_on_worker_failure=budget, workers_per_group=wpg,
        on_job_abort=on_abort)
    manager.start()
    return manager, k8s, tm


def pods_refuse_partial_group(ns):
    manager, k8s, tm = _manager(ns, 6, wpg=2)
    assert manager.scale_down(1) == []
    assert len(manager.alive_workers()) == 6 and k8s.delete_calls == []
    return _pods(ns, k8s, manager, tm)


def pods_newest_group(ns):
    manager, k8s, tm = _manager(ns, 6, wpg=2)
    first = manager.scale_down(2)
    second = manager.scale_down(3)
    assert first == [4, 5] and second == [2, 3]
    assert manager.alive_workers() == [0, 1]
    return [first, second, _pods(ns, k8s, manager, tm)]


def pods_prefer_flagged(ns):
    manager, k8s, tm = _manager(ns, 6, wpg=2)
    removed = manager.scale_down(2, prefer=[2])
    assert removed == [2, 3]
    assert manager.alive_workers() == [0, 1, 4, 5]
    return [removed, _pods(ns, k8s, manager, tm)]


def pods_short_group_first(ns):
    manager, k8s, tm = _manager(ns, 4, wpg=2)
    ns.faults.install(ns.faults.FaultRegistry(
        [ns.faults.FaultSpec(ns.faults.POINT_POD_CREATE, 0, "raise")]))
    k8s.emit("scaletest-worker-0", ns.PodStatus.FAILED, exit_code=1)
    assert manager.snapshot()["launch_failures"] == 1
    before = _pods(ns, k8s, manager, tm)
    groups = {}
    for wid in manager.alive_workers():
        groups.setdefault(manager._group_of[wid], []).append(wid)
    (short,) = [g for g, ws in groups.items() if len(ws) == 1]
    removed = manager.scale_down(2)
    assert removed == groups[short]
    assert len(manager.alive_workers()) == 2
    return [before, removed, _pods(ns, k8s, manager, tm)]


def pods_scale_up_after_exhausted_chain(ns):
    aborts = []
    manager, k8s, tm = _manager(ns, 1, budget=1, on_abort=aborts.append)
    k8s.emit("scaletest-worker-0", ns.PodStatus.FAILED, exit_code=1)
    assert manager.alive_workers() == [1]
    k8s.emit("scaletest-worker-1", ns.PodStatus.FAILED, exit_code=1)
    assert manager.alive_workers() == [] and len(aborts) == 1
    assert manager.scale_up(2) == 2
    assert manager.alive_workers() == [2, 3]
    k8s.emit("scaletest-worker-2", ns.PodStatus.FAILED, exit_code=1)
    assert manager.alive_workers() == [3, 4] and len(aborts) == 1
    return [aborts, _pods(ns, k8s, manager, tm)]


def pods_launch_failure_charges_no_chain(ns):
    manager, k8s, tm = _manager(ns, 2)
    ns.faults.install(ns.faults.FaultRegistry(
        [ns.faults.FaultSpec(ns.faults.POINT_POD_CREATE, 0, "raise")]))
    assert manager.scale_up(1) == 0
    assert manager.alive_workers() == [0, 1]
    assert manager._relaunch_count == {}
    failed = _pods(ns, k8s, manager, tm)
    assert manager.scale_up(1) == 1
    assert manager.alive_workers() == [0, 1, 3] and len(k8s.pods) == 3
    return [failed, _pods(ns, k8s, manager, tm)]


def pods_stop_blocks_scaling(ns):
    manager, k8s, tm = _manager(ns, 2)
    manager.stop()
    creates = len(k8s.create_calls)
    assert manager.scale_up(3) == 0
    assert manager.scale_down(1) == []
    assert manager.evict_worker(0) is False
    assert len(k8s.create_calls) == creates
    return _pods(ns, k8s, manager, tm)


def pods_stop_racing_scale(ns):
    class StopOnCreate(ns.Fake):
        manager = None
        fired = False

        def create_pod(self, spec):
            super().create_pod(spec)
            if not self.fired and spec.worker_id >= 2:
                self.fired = True
                self.manager.stop()

    k8s = StopOnCreate()
    manager = ns.PodManager(k8s, task_manager=StubTaskManager(),
                            job_name="scaletest", num_workers=2,
                            workers_per_group=1)
    k8s.manager = manager
    manager.start()
    launched = manager.scale_up(5)
    assert launched == 1 and manager.alive_workers() == []
    assert manager.stopped and len(k8s.create_calls) == 3
    return [launched, _pods(ns, k8s, manager)]


@pytest.mark.parametrize("scenario", [
    pods_refuse_partial_group, pods_newest_group, pods_prefer_flagged,
    pods_short_group_first, pods_scale_up_after_exhausted_chain,
    pods_launch_failure_charges_no_chain, pods_stop_blocks_scaling,
    pods_stop_racing_scale,
], ids=lambda f: f.__name__)
def test_pod_scaling_matches_the_reference(scenario):
    both(scenario)


def elastic_intentional_codes(ns):
    manager, k8s, tm = _manager(ns, 1, budget=1, job="budget")
    for _ in range(5):
        (wid,) = manager.alive_workers()
        k8s.emit(f"budget-worker-{wid}", "Failed", exit_code=44)
        assert manager.alive_workers()
    (wid,) = manager.alive_workers()
    k8s.emit(f"budget-worker-{wid}", "Failed", exit_code=1)
    (wid,) = manager.alive_workers()
    k8s.emit(f"budget-worker-{wid}", "Failed", exit_code=1)
    assert not manager.alive_workers()
    return _pods(ns, k8s, manager, tm)


def elastic_group_restart(ns):
    manager, k8s, tm = _manager(ns, 4, wpg=2, budget=2, job="slice")
    assert manager._group_of == {0: 0, 1: 0, 2: 1, 3: 1}
    k8s.emit("slice-worker-2", "Failed", exit_code=1)
    alive = manager.alive_workers()
    assert 0 in alive and 1 in alive and 2 not in alive and 3 not in alive
    assert len(alive) == 4 and "slice-worker-3" in k8s.delete_calls
    assert all(manager._group_of[w] == 1 for w in alive if w >= 4)
    restarted = _pods(ns, k8s, manager, tm)
    before = set(manager.alive_workers())
    manager.scale_down(1)
    assert set(manager.alive_workers()) == before
    manager.scale_down(2)
    after = set(manager.alive_workers())
    assert len(before - after) == 2 and len(after) == 2
    return [restarted, _pods(ns, k8s, manager, tm)]


def elastic_group_size_one(ns):
    manager, k8s, tm = _manager(ns, 2, budget=2, job="solo")
    k8s.emit("solo-worker-0", "Failed", exit_code=1)
    alive = manager.alive_workers()
    assert 1 in alive and len(alive) == 2
    assert "solo-worker-1" not in k8s.delete_calls
    return _pods(ns, k8s, manager, tm)


def elastic_adoption_from_labels(ns):
    first, k8s, _ = _manager(ns, 4, wpg=2, job="adopt")
    k8s.emit("adopt-worker-1", "Failed", exit_code=1)
    true_groups = dict(first._group_of)
    second = ns.PodManager(k8s, job_name="adopt", num_workers=4,
                           relaunch_on_worker_failure=3,
                           workers_per_group=2)
    k8s._callback = None
    second.start()
    assert second._group_of == true_groups
    victim = min(w for w, g in true_groups.items() if g == 1)
    peer = max(w for w, g in true_groups.items() if g == 1)
    k8s.emit(f"adopt-worker-{victim}", "Failed", exit_code=1)
    assert f"adopt-worker-{peer}" in k8s.delete_calls
    assert len(second.alive_workers()) == 4
    return [true_groups, _pods(ns, k8s, second)]


def elastic_makeup_fills_vacancy(ns):
    first, k8s, _ = _manager(ns, 4, wpg=2, job="vac")
    k8s._callback = None
    with k8s._lock:
        k8s.phases["vac-worker-1"] = ns.PodStatus.FAILED
    second = ns.PodManager(k8s, job_name="vac", num_workers=4,
                           workers_per_group=2)
    second.start()
    assert len(second.alive_workers()) == 4
    assert sorted(second._group_of.values()) == [0, 0, 1, 1]
    return _pods(ns, k8s, second)


@pytest.mark.parametrize("scenario", [
    elastic_intentional_codes, elastic_group_restart, elastic_group_size_one,
    elastic_adoption_from_labels, elastic_makeup_fills_vacancy,
], ids=lambda f: f.__name__)
def test_elasticity_matches_the_reference(scenario):
    both(scenario)


def test_pod_commands_differ_only_in_the_package_name():
    """The masters' worker commands, built from one argv: the port's
    names its own worker module, and its flags are the JAX flags it
    shares (plus --device), in the same order and with the same
    values."""
    from elasticdl_tpu.common import args as jax_args
    from elasticdl_tpu.master import main as jax_main
    from elasticdl_tpu_torch.common import args as torch_args
    from elasticdl_tpu_torch.master import main as torch_main

    argv = ["--distribution_strategy", "AllReduce", "--num_workers", "2",
            "--job_name", "cmd", "--minibatch_size", "32",
            "--model_def", "mnist.mnist_functional_api.custom_model",
            "--checkpoint_steps", "2", "--wedge_grace_s", "6",
            "--coordinator_port", "5555", "--port", "5000"]
    commands = {}
    for name, args_lib, main in (("jax", jax_args, jax_main),
                                 ("torch", torch_args, torch_main)):
        master = main.Master.__new__(main.Master)
        master.args = args_lib.parse_master_args(argv)
        master.job_type = "train"
        master.bound_port = 5001
        master._k8s = PKGS[name].Fake()
        commands[name] = master._worker_command(7)
    jax_cmd, torch_cmd = commands["jax"], commands["torch"]
    assert jax_cmd[1:3] == ["-m", "elasticdl_tpu.worker.main"]
    assert torch_cmd[1:3] == ["-m", "elasticdl_tpu_torch.worker.main"]

    def flags(cmd):
        return dict(zip(cmd[3::2], cmd[4::2]))

    jax_flags, torch_flags = flags(jax_cmd), flags(torch_cmd)
    for key in ("--master_addr", "--worker_id", "--job_type",
                "--num_workers", "--minibatch_size", "--checkpoint_steps",
                "--wedge_grace_s", "--coordinator_port", "--port",
                "--job_name", "--distribution_strategy"):
        assert torch_flags[key] == jax_flags[key], key
    assert torch_flags["--master_addr"] == "cmd-master:5001"
    assert torch_flags["--worker_id"] == "7"


# ---- the recovery clock and the notice watcher ----------------------------


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def clock_single_loss(ns):
    t = FakeClock()
    clock = ns.RecoveryClock(clock=t)
    assert clock.mark_progress() is None
    clock.mark_loss()
    t.now += 2.5
    assert clock.mark_progress() == 2.5
    snap = clock.snapshot()
    assert snap["recovery_durations_s"] == clock.history
    return snap


def clock_overlapping_losses(ns):
    t = FakeClock()
    clock = ns.RecoveryClock(clock=t)
    clock.mark_loss()
    t.now += 0.75
    clock.mark_loss()
    t.now += 1.0
    assert clock.mark_progress() == 1.75
    assert clock.mark_progress() is None
    return clock.snapshot()


def clock_sequential_outages(ns):
    t = FakeClock()
    clock = ns.RecoveryClock(clock=t)
    for gap in (1.0, 3.0):
        clock.mark_loss()
        assert clock.snapshot()["pending"] is True
        t.now += gap
        clock.mark_progress()
    return clock.snapshot()


def clock_loss_while_pending(ns):
    t = FakeClock()
    clock = ns.RecoveryClock(clock=t)
    clock.mark_loss()
    t.now += 1.0
    clock.mark_progress()
    clock.mark_loss()
    t.now += 0.5
    clock.mark_loss()
    t.now += 0.25
    clock.mark_progress()
    snap = clock.snapshot()
    assert snap["losses"] == 3 and snap["recoveries"] == 2
    return snap


@pytest.mark.parametrize("scenario", [
    clock_single_loss, clock_overlapping_losses, clock_sequential_outages,
    clock_loss_while_pending,
], ids=lambda f: f.__name__)
def test_recovery_clock_matches_the_reference(scenario):
    both(scenario)


def _wait(predicate, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not predicate():
        time.sleep(0.01)
    return predicate()


def watcher_survives_raising_checker(ns):
    reg = ns.faults.FaultRegistry([
        ns.faults.FaultSpec("notice.check", 0, "raise"),
        ns.faults.FaultSpec("notice.check", 1, "raise")])
    drained = threading.Event()

    def checker():
        reg.fire("notice.check")
        return reg.hits("notice.check") >= 3

    watcher = ns.preemption.MaintenanceNoticeWatcher(
        checker, drained.set, poll_s=0.01).start()
    try:
        assert drained.wait(timeout=10.0)
        assert watcher.fired and reg.all_fired()
    finally:
        watcher.stop()
    return [watcher.fired, reg.hits("notice.check")]


def watcher_fires_once(ns):
    fired = []

    def on_notice():
        fired.append(1)
        raise RuntimeError("drain hook bug")

    watcher = ns.preemption.MaintenanceNoticeWatcher(
        lambda: True, on_notice, poll_s=0.01).start()
    assert _wait(lambda: watcher.fired)
    time.sleep(0.05)
    assert fired == [1]
    return [watcher.fired, fired]


def watcher_file_notice(ns, tmp_path):
    notice = tmp_path / f"maintenance-{id(ns)}"
    calls = []
    watcher = ns.preemption.MaintenanceNoticeWatcher(
        ns.preemption.file_notice_checker(str(notice)),
        lambda: calls.append(1), poll_s=0.02).start()
    time.sleep(0.1)
    assert calls == [] and not watcher.fired
    notice.write_text("TERMINATE_ON_MAINTENANCE")
    assert _wait(lambda: watcher.fired)
    time.sleep(0.1)
    assert calls == [1]
    return [watcher.fired, calls]


def watcher_hook_failure(ns, tmp_path):
    notice = tmp_path / f"n-{id(ns)}"
    notice.write_text("x")

    def bad_hook():
        raise RuntimeError("boom")

    watcher = ns.preemption.MaintenanceNoticeWatcher(
        ns.preemption.file_notice_checker(str(notice)), bad_hook,
        poll_s=0.02).start()
    assert _wait(lambda: watcher.fired)
    return [watcher.fired]


@pytest.mark.parametrize("scenario", [
    watcher_survives_raising_checker, watcher_fires_once,
], ids=lambda f: f.__name__)
def test_notice_watcher_matches_the_reference(scenario):
    both(scenario)


@pytest.mark.parametrize("scenario", [
    watcher_file_notice, watcher_hook_failure,
], ids=lambda f: f.__name__)
def test_file_notice_matches_the_reference(scenario, tmp_path):
    both(scenario, tmp_path)


def test_gce_metadata_checker_reads_no_notice_when_unreachable(monkeypatch):
    """Both packages' GCE checker read an unreachable metadata server as
    no notice.  The server is made unreachable here (urlopen raises), so
    the test contacts no host."""
    import urllib.request

    calls = []

    def unreachable(req, timeout=None):
        calls.append((req.full_url, dict(req.header_items()), timeout))
        raise OSError("metadata server unreachable")

    monkeypatch.setattr(urllib.request, "urlopen", unreachable)
    for ns in PKGS.values():
        assert ns.preemption.gce_metadata_checker(timeout_s=0.1)() is False
        assert ns.preemption.gce_metadata_checker(
            "maintenance-event", timeout_s=0.1)() is False
    jax_calls, torch_calls = calls[:2], calls[2:]
    assert torch_calls == jax_calls
    assert jax_calls[0][0].endswith("/instance/preempted")
    assert jax_calls[1][0].endswith("/instance/maintenance-event")


def test_notice_drains_the_spmd_rank_before_the_kill(tmp_path):
    """tests/test_maintenance_notice.py's drill on the port's SPMDWorker:
    the notice flips a rank of several into task-boundary drain mode."""
    from elasticdl_tpu_torch.worker.spmd import SPMDWorker

    worker = SPMDWorker.__new__(SPMDWorker)
    worker.num_processes = 2
    worker.process_id = 0
    worker._saver = None
    worker._preempted = False
    notice = tmp_path / "notice"
    watcher = torch_preemption.MaintenanceNoticeWatcher(
        torch_preemption.file_notice_checker(str(notice)),
        worker.save_checkpoint_and_flush, poll_s=0.02).start()
    notice.write_text("x")
    assert _wait(lambda: worker._preempted)
    watcher.stop()
