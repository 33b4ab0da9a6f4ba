"""A cluster job that survives a killed rank, end to end on the CPU
(tests/test_elastic_cluster.py:153 on the port): the real master entry
point (master/main.py `main`) with ProcessK8sClient, two worker
processes forming a gloo group from the rendezvous alone, tiny MNIST,
and rank 1 SIGKILLed once a checkpoint step has committed.  The
survivor restarts for the new topology (exit 44), the replacements
restore the committed step, every record of both epochs trains, one
recovery is measured, and the final group's two ranks end on one state.
"""

import json
import os
import socket
import threading
import time

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


def test_a_cluster_job_survives_a_killed_rank(tmp_path):
    train_dir, _ = write_dataset(str(tmp_path / "data"), n_train=384,
                                 n_val=0)
    ckpt = str(tmp_path / "ckpt")
    k8s = ProcessK8sClient(extra_env={
        "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
        "ELASTICDL_RPC_INITIAL_BACKOFF_S": "0.05",
        "ELASTICDL_RPC_MAX_BACKOFF_S": "0.2"})
    argv = ["--distribution_strategy", "AllReduce", "--use_process_k8s",
            "true", "--num_workers", "2", "--job_name", "kill",
            "--training_data", train_dir, "--records_per_task", "64",
            "--num_epochs", "2", "--minibatch_size", "32",
            "--model_def", "mnist.mnist_functional_api.custom_model",
            "--port", str(_free_port()),
            "--coordinator_port", str(_free_port()),
            "--checkpoint_dir", ckpt, "--checkpoint_steps", "2",
            "--wedge_grace_s", "6", "--task_lease_timeout_s", "60",
            "--device", "cpu", "--use_bf16", "false"]
    held, result = {}, {}

    def run():
        result["rc"] = master_main.main(
            argv, k8s_client=k8s, linger_s=30.0,
            on_started=lambda m: held.setdefault("master", m))

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        deadline = time.time() + JOB_TIMEOUT_S
        while not committed_steps(ckpt):
            assert thread.is_alive() and time.time() < deadline, \
                "no checkpoint step committed before the kill"
            time.sleep(0.05)
        k8s.kill_pod("kill-worker-1")
        thread.join(JOB_TIMEOUT_S)
        assert not thread.is_alive(), "the job did not end"
    finally:
        k8s.stop()
    logs = {name: k8s.pod_output(name)[-4000:] for name in k8s.pods}
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
    survivor = [e for e in lines if e["pod"] == "kill-worker-0"]
    assert len(survivor) == 1 and "state_sha256" not in survivor[0]
    assert "restored checkpoint step" in k8s.pod_output("kill-worker-2")


def test_elasticdl_train_points_a_cluster_job_at_the_master():
    """`elasticdl train` submits no master pod (that needs the real
    Kubernetes client): its message names the master's entry point."""
    import pytest

    from elasticdl_tpu_torch.client import main as cli

    with pytest.raises(NotImplementedError) as err:
        cli.main(["train", "--distribution_strategy", "ParameterServer",
                  "--model_def", "mnist.mnist_functional_api.custom_model",
                  "--training_data", "/nonexistent", "--device", "cpu"])
    message = str(err.value)
    assert "python -m elasticdl_tpu_torch.master.main" in message
    assert "--use_process_k8s true" in message
    assert "item 12" in message
