"""A cluster job that survives a killed rank, end to end on the CPU
(tests/test_elastic_cluster.py:152 on the port, kill ids [1, 0]): the
real master entry point (master/main.py `main`) with ProcessK8sClient,
two worker processes forming a gloo group from the rendezvous alone,
tiny MNIST, and one rank SIGKILLed once a checkpoint step has committed.
The survivor restarts for the new topology (exit 44), the replacements
restore the committed step, every record of both epochs trains, one
recovery is measured, and the final group's two ranks end on one state.
The job's helpers serve the scale-up, scale-down, master-restart and
fleet cases too (tests/test_torch_elastic_scale_*.py,
tests/test_torch_master_restart.py, tests/test_torch_fleet_live.py).
"""

import json
import os
import socket
import threading
import time

import pytest

import _torch_k8s_stub
from elasticdl_tpu_torch.common.k8s_client import ProcessK8sClient
from elasticdl_tpu_torch.common.save_utils import committed_steps
from elasticdl_tpu_torch.master import main as master_main
from elasticdl_tpu_torch.model_zoo.mnist.data import write_dataset
from elasticdl_tpu_torch.worker.spmd import KERNEL_LAUNCHES_TAG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX test's budget (its 120 s, warm cache); the port measures a
# few seconds here
RECOVERY_BUDGET_S = 120.0
JOB_TIMEOUT_S = 240.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def process_k8s() -> ProcessK8sClient:
    """Worker pods as processes of this checkout, one thread each, with
    quick RPC retries (a restarted master is back within seconds)."""
    return ProcessK8sClient(extra_env={
        "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
        "ELASTICDL_RPC_INITIAL_BACKOFF_S": "0.05",
        "ELASTICDL_RPC_MAX_BACKOFF_S": "0.2"})


def cluster_argv(train_dir: str, ckpt: str, job: str,
                 minibatch_size: int = 32, extra=()) -> list:
    """The JAX cases' job on the port's master: tiny MNIST, two workers,
    two epochs of 64-record tasks, a checkpoint every 2 steps, on the
    CPU."""
    return ["--distribution_strategy", "AllReduce", "--use_process_k8s",
            "true", "--num_workers", "2", "--job_name", job,
            "--training_data", train_dir, "--records_per_task", "64",
            "--num_epochs", "2", "--minibatch_size", str(minibatch_size),
            "--model_def", "mnist.mnist_functional_api.custom_model",
            "--port", str(_free_port()),
            "--coordinator_port", str(_free_port()),
            "--checkpoint_dir", ckpt, "--checkpoint_steps", "2",
            "--wedge_grace_s", "6", "--task_lease_timeout_s", "60",
            "--device", "cpu", "--use_bf16", "false", *extra]


def start_job(argv, k8s):
    """`master.main.main(argv)` on a thread: (thread, held, result), the
    Master in held["master"] once it serves, the exit code in
    result["rc"] when the job ends."""
    held, result = {}, {}

    def run():
        result["rc"] = master_main.main(
            argv, k8s_client=k8s, linger_s=30.0,
            on_started=lambda m: held.setdefault("master", m))

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, held, result


def wait_for_commit(ckpt: str, alive) -> None:
    """Until a checkpoint step has committed; fails when `alive()` turns
    false or the job's time runs out first."""
    deadline = time.time() + JOB_TIMEOUT_S
    while not committed_steps(ckpt):
        assert alive() and time.time() < deadline, \
            "no checkpoint step committed"
        time.sleep(0.05)


def pod_logs(k8s, tail: int = 4000) -> dict:
    return {name: k8s.pod_output(name)[-tail:] for name in k8s.pods}


def _rank_lines(k8s):
    lines = []
    for name in sorted(k8s.pods):
        for line in k8s.pod_output(name).splitlines():
            at = line.find(KERNEL_LAUNCHES_TAG)
            if at >= 0:
                entry = json.loads(line[at + len(KERNEL_LAUNCHES_TAG):])
                entry["pod"] = name
                lines.append(entry)
    return lines


@pytest.mark.parametrize("kill_worker_id", [1, 0])
def test_a_cluster_job_survives_a_killed_rank(tmp_path, kill_worker_id):
    """Rank 1's loss leaves rank 0, which hosts the group's TCPStore;
    rank 0's loss takes the store with it, and the new rank 0 binds the
    same coordinator port on the same host."""
    train_dir, _ = write_dataset(str(tmp_path / "data"), n_train=384,
                                 n_val=0)
    ckpt = str(tmp_path / "ckpt")
    k8s = process_k8s()
    thread, held, result = start_job(
        cluster_argv(train_dir, ckpt, "kill"), k8s)
    try:
        wait_for_commit(ckpt, thread.is_alive)
        k8s.kill_pod(f"kill-worker-{kill_worker_id}")
        thread.join(JOB_TIMEOUT_S)
        assert not thread.is_alive(), "the job did not end"
    finally:
        k8s.stop()
    logs = pod_logs(k8s)
    master = held["master"]
    assert result["rc"] == 0, logs
    # every record of both epochs trained despite the kill
    assert master.task_manager.counters.records_done >= 2 * 384
    # replacements under fresh ids; the survivor's restart was uncharged
    workers = [s.worker_id for s in k8s.create_calls]
    assert workers == [0, 1, 2, 3], workers
    pods = master.pod_manager.snapshot()
    assert pods["losses_seen"] == 2 and pods["relaunches"] == 2
    assert master.pod_manager._relaunch_count == {2: 1, 3: 0}
    # one outage, measured at the master, within the budget
    history = master.recovery_clock.history
    assert len(history) == 1 and history[0] < RECOVERY_BUDGET_S, history
    # the final group's ranks: one epoch, one state
    lines = _rank_lines(k8s)
    final = [e for e in lines if "state_sha256" in e]
    assert len(final) == 2, logs
    assert {e["rank"] for e in final} == {0, 1}
    assert len({e["epoch"] for e in final}) == 1
    assert len({e["state_sha256"] for e in final}) == 1
    assert {e["pod"] for e in final} == {"kill-worker-2", "kill-worker-3"}
    # the survivor logged its launches as it restarted for the topology
    survivor = [e for e in lines
                if e["pod"] == f"kill-worker-{1 - kill_worker_id}"]
    assert len(survivor) == 1 and "state_sha256" not in survivor[0]
    assert "restored checkpoint step" in k8s.pod_output("kill-worker-2")


def test_elasticdl_train_points_a_cluster_job_at_the_master(monkeypatch,
                                                            tmp_path):
    """`elasticdl train` with a cluster strategy submits the master's
    pod, `python -m elasticdl_tpu_torch.master.main` with the job's
    flags, and a Service the workers dial it by, through the real
    Kubernetes client (the default) to the cluster its kubeconfig names;
    with no cluster configured it raises naming KUBECONFIG."""
    from elasticdl_tpu_torch.client import api
    from elasticdl_tpu_torch.client import main as cli
    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.common.k8s_config import K8sConfigError

    argv = ["train", "--distribution_strategy", "ParameterServer",
            "--model_def", "mnist.mnist_functional_api.custom_model",
            "--training_data", "/nonexistent", "--device", "cpu",
            "--job_name", "mnist", "--port", "50123"]
    _torch_k8s_stub.no_cluster(monkeypatch, tmp_path)
    with pytest.raises(K8sConfigError, match="KUBECONFIG"):
        api.train(cli.parse_args(argv))
    with _torch_k8s_stub.stub_cluster(monkeypatch, tmp_path,
                                      kubelet=False) as stub:
        assert cli.main(argv) == 0
    (_, pod), (_, service) = stub.bodies
    assert pod["metadata"]["name"] == "mnist-master"
    command = pod["spec"]["containers"][0]["command"]
    assert command[:3] == ["python", "-m", "elasticdl_tpu_torch.master.main"]
    master = parse_master_args(command[3:])
    assert master.distribution_strategy == "ParameterServer"
    assert master.training_data == "/nonexistent"
    assert master.job_type == "train" and master.port == 50123
    assert service["metadata"]["name"] == "mnist-master"
    assert service["spec"]["ports"] == [{"port": 50123,
                                         "targetPort": 50123}]