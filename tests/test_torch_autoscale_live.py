"""The master's autoscaling loop, live on the CPU: a cluster job that
starts with one worker grows to two through the policy engine alone
(`--min_workers 1 --max_workers 2 --backlog_per_worker 2 --backlog_ticks
2 --scale_hold_ticks 2 --data_wait_share 1.0`, chip_smoke.py's
`autoscale_cluster` flags, at shorter ticks).  No call to `scale_up`
here: the engine's backlog decision launches the second pod, the first
rank restarts for the new topology, and the job ends on a world of two
with every record done.

The loop is held at its own fault point (`policy.tick`, a wedged control
plane: the tick is skipped, streaks and holds freeze) until the first
world has committed a checkpoint step, so the decision lands mid-job;
without the hold it lands before the first worker's process has
started, and the job never runs a world of one.  Each tick's signals
(alive workers, backlog, the workers' phase clocks, stragglers) are
recorded as the port's engine reads them and replayed through the JAX
`PolicyEngine` on tests/test_policy_engine.py's fakes, which gives the
same decisions."""

import copy
import json
import os

from test_policy_engine import FakeClock, StubTaskManager, make_pods
from test_torch_elastic_cluster import (
    JOB_TIMEOUT_S,
    _rank_lines,
    cluster_argv,
    pod_logs,
    process_k8s,
    start_job,
    wait_for_commit,
)

from elasticdl_tpu.common import args as jax_args
from elasticdl_tpu.common import faults as jax_faults
from elasticdl_tpu.master.policy import PolicyConfig as JaxPolicyConfig
from elasticdl_tpu.master.policy import PolicyEngine as JaxPolicyEngine
from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.master import main as master_main
from elasticdl_tpu_torch.master.policy import PolicyEngine
from elasticdl_tpu_torch.model_zoo.mnist.data import write_dataset

# 10 tasks of 2 steps an epoch, 2 epochs: the backlog of the epoch the
# loop is released in stays above 2 a worker
RECORDS = 640
POLICY_FLAGS = ["--num_workers", "1", "--min_workers", "1",
                "--max_workers", "2", "--policy_interval", "0.2",
                "--backlog_per_worker", "2", "--backlog_ticks", "2",
                "--scale_hold_ticks", "2", "--data_wait_share", "1.0"]
# ticks the hold can cover: far more than the job lasts
HOLD_TICKS = 100000


def hold_policy_ticks(faults_module, ticks):
    """A registry that makes each of the first `ticks` policy ticks
    skip (the `policy.tick` fault point)."""
    return faults_module.FaultRegistry([
        faults_module.FaultSpec(faults_module.POINT_POLICY_TICK, hit,
                                "raise") for hit in ticks])


class _Recorder:
    """Wraps one collaborator of the engine; notes what each tick
    read."""

    def __init__(self, target, reads, names):
        self._target, self._reads, self._names = target, reads, names

    def __getattr__(self, name):
        value = getattr(self._target, name)
        if name not in self._names:
            return value

        def read(*args, **kwargs):
            out = value(*args, **kwargs)
            self._reads[-1].setdefault(self._names[name],
                                       copy.deepcopy(out))
            return out
        return read


class RecordingPolicyEngine(PolicyEngine):
    """The port's engine, with each tick's signals noted in `reads`."""

    def __init__(self, task_manager, pod_manager, config,
                 telemetry_fn=None, **kwargs):
        self.reads = []
        telemetry_fn = telemetry_fn or (lambda: {})
        tm = _Recorder(task_manager, self.reads,
                       {"snapshot": "tm_snapshot",
                        "straggler_snapshot": "stragglers"})
        pods = _Recorder(pod_manager, self.reads,
                         {"alive_workers": "alive"})

        def telemetry():
            out = telemetry_fn()
            self.reads[-1].setdefault("telemetry", copy.deepcopy(out))
            return out

        super().__init__(tm, pods, config, telemetry_fn=telemetry,
                         **kwargs)

    def _tick_locked(self):
        self.reads.append({})
        return super()._tick_locked()


class _ReplayPods:
    """The JAX test's pod manager (a FakeK8sClient below it) whose alive
    workers are the ones the live tick read."""

    def __init__(self, pods):
        self.pods = pods
        self.alive = []

    def alive_workers(self):
        return list(self.alive)

    def __getattr__(self, name):
        return getattr(self.pods, name)


def replay_on_jax(argv, reads) -> list:
    """The JAX engine's decisions over the recorded ticks: a skipped
    tick skips at the JAX fault point too."""
    config = JaxPolicyConfig.from_args(jax_args.parse_master_args(argv))
    tm = StubTaskManager()
    pods = _ReplayPods(make_pods(1, tm=tm)[0])
    telemetry = {}
    engine = JaxPolicyEngine(tm, pods, config,
                             telemetry_fn=lambda: telemetry,
                             clock=FakeClock())
    skipped = [i for i, read in enumerate(reads) if "alive" not in read]
    jax_faults.install(hold_policy_ticks(jax_faults, skipped))
    try:
        for read in reads:
            if "alive" in read:
                pods.alive = read["alive"]
                tm.todo = read["tm_snapshot"]["todo"]
                tm.stragglers = read.get("stragglers", {})
                telemetry.clear()
                telemetry.update(read.get("telemetry", {}))
            engine.tick()
    finally:
        jax_faults.uninstall()
    return engine.decisions


def test_the_policy_engine_grows_a_live_job_from_one_worker_to_two(
        tmp_path, monkeypatch):
    train_dir, _ = write_dataset(str(tmp_path / "data"), n_train=RECORDS,
                                 n_val=0)
    ckpt = str(tmp_path / "ckpt")
    monkeypatch.setattr(master_main, "PolicyEngine", RecordingPolicyEngine)
    argv = cluster_argv(train_dir, ckpt, "autoscale", extra=POLICY_FLAGS)
    k8s = process_k8s()
    faults.install(hold_policy_ticks(faults, range(HOLD_TICKS)))
    try:
        thread, held, result = start_job(argv, k8s)
        wait_for_commit(ckpt, thread.is_alive)
        # the first world has trained and committed: release the loop
        faults.uninstall()
        thread.join(JOB_TIMEOUT_S)
        assert not thread.is_alive(), "the job did not end"
    finally:
        faults.uninstall()
        k8s.stop()
    logs = pod_logs(k8s)
    master = held["master"]
    engine = master.policy_engine
    assert result["rc"] == 0, logs
    # one decision, the engine's: a backlog scale-up of one pod
    assert [(d["action"], d["reason"], d["requested"], d["launched"])
            for d in engine.decisions] == [("scale_up", "backlog", 1, 1)]
    assert engine.decisions[0]["alive"] == 1
    # every record of both epochs trained, each shard once an epoch
    assert master.task_manager.snapshot()["training_records_done"] == \
        2 * RECORDS
    with open(os.path.join(ckpt, "task_state.json")) as f:
        journal = json.load(f)
    assert journal["records_done"] == 2 * RECORDS, journal
    # the first pod trained alone, then restarted for the world of two
    lines = _rank_lines(k8s)
    first = [e for e in lines if e["pod"] == "autoscale-worker-0"]
    assert first and first[0]["world"] == 1 and first[0]["step"] > 0, logs
    final = [e for e in lines if "state_sha256" in e]
    assert len(final) == 2 and {e["world"] for e in final} == {2}, logs
    assert len({e["state_sha256"] for e in final}) == 1
    assert "autoscale-worker-1" in {e["pod"] for e in final}
    # the JAX engine, fed the same signals, decides the same
    reads = engine.reads
    assert any("alive" not in r for r in reads)      # the held ticks
    assert sum("alive" in r for r in reads) >= 2
    assert replay_on_jax(argv, reads) == engine.decisions
