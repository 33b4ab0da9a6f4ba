"""A cluster job through the real Kubernetes client, end to end on the
CPU: the CPU twin of chip_smoke.py's `kube_cluster` phase.

`elasticdl train --distribution_strategy AllReduce` submits the master
pod and its Service to the stub API server over TLS (a kubeconfig with
the client certificate of tests/data/k8s_tls/).  The stub's kubelet runs
the master entry point as the pod's process; its default client, the
real `K8sClient`, finds no in-cluster variables, loads the kubeconfig
the stub gives its pods, and creates two worker pods (tiny MNIST,
`--device cpu`).  Once a checkpoint step has committed, the test deletes
worker 1's pod through the API, as a preemption would: SIGTERM, then
MODIFIED with the exit code, then DELETED.  The master sees the pod
fail on its watch, relaunches it, the group restores and finishes;
every training shard is done once (the task journal), the final ranks
end on one state, and the master pod Succeeds on the watch.
"""

import json
import os
import threading
import time

import _torch_k8s_stub
from test_torch_elastic_cluster import _free_port
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common.constants import PodStatus
from elasticdl_tpu_torch.common.k8s_client import K8sClient
from elasticdl_tpu_torch.common.save_utils import committed_steps
from elasticdl_tpu_torch.model_zoo.mnist.data import write_dataset
from elasticdl_tpu_torch.worker.spmd import KERNEL_LAUNCHES_TAG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB = "kube"
NAMESPACE = "elastic"
RECORDS, TASK, BATCH = 768, 64, 32          # 12 tasks of 2 steps
JOB_TIMEOUT_S = 240.0
RECOVERY_BUDGET_S = 120.0   # tests/test_torch_elastic_cluster.py's


def _wait(predicate, what, timeout_s=JOB_TIMEOUT_S):
    deadline = time.time() + timeout_s
    while not predicate():
        assert time.time() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def test_a_kubernetes_job_survives_a_deleted_pod(monkeypatch, tmp_path):
    t0 = time.perf_counter()
    train_dir, _ = write_dataset(str(tmp_path / "data"), n_train=RECORDS,
                                 n_val=0)
    ckpt = str(tmp_path / "ckpt")
    event_log = str(tmp_path / "events.jsonl")
    pod_env = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
               "ELASTICDL_RPC_INITIAL_BACKOFF_S": "0.05",
               "ELASTICDL_RPC_MAX_BACKOFF_S": "0.2"}
    argv = ["train", "--distribution_strategy", "AllReduce",
            "--num_workers", "2", "--job_name", JOB,
            "--namespace", NAMESPACE,
            "--training_data", train_dir, "--records_per_task", str(TASK),
            "--num_epochs", "1", "--minibatch_size", str(BATCH),
            "--model_def", "mnist.mnist_functional_api.custom_model",
            "--port", str(_free_port()),
            "--coordinator_port", str(_free_port()),
            "--checkpoint_dir", ckpt, "--checkpoint_steps", "2",
            "--wedge_grace_s", "6", "--task_lease_timeout_s", "60",
            "--event_log", event_log,
            "--device", "cpu", "--use_bf16", "false"]
    seen = []
    lock = threading.Lock()

    def on_event(*event):
        with lock:
            seen.append(event)

    def phases(pod):
        with lock:
            return [e[1:] for e in seen if e[0] == pod]

    master_pod = f"{JOB}-master"

    def master_ended():
        return any(p[0] in (PodStatus.SUCCEEDED, PodStatus.FAILED)
                   for p in phases(master_pod))

    with _torch_k8s_stub.stub_cluster(monkeypatch, tmp_path,
                                      pod_env=pod_env) as stub:
        watcher = K8sClient(namespace=NAMESPACE, job_name=JOB)
        watcher.start_watch(on_event)
        try:
            assert cli.main(argv) == 0
            _wait(lambda: committed_steps(ckpt) or master_ended(),
                  "a committed checkpoint step")
            assert committed_steps(ckpt), stub.pod_log(master_pod)[-3000:]
            watcher.delete_pod(f"{JOB}-worker-1")
            _wait(master_ended, "the master pod's end")
        finally:
            watcher.stop()
        logs = {name: stub.pod_log(name)[-3000:]
                for name in stub.pod_names()}
        requests = list(stub.requests)
        plumbing = list(stub.plumbing)
    seconds = time.perf_counter() - t0
    # the master pod ran the job to its end
    assert (PodStatus.SUCCEEDED, "127.0.0.1", 0) in phases(master_pod), logs
    # the deleted pod: its deletion while Running, its exit on SIGTERM
    # (the preemption hook's 143, or 137 if the stub's grace ran out),
    # then DELETED
    victim = phases(f"{JOB}-worker-1")
    (at, code), = [(i, p[2]) for i, p in enumerate(victim)
                   if p[0] == PodStatus.FAILED]
    assert code in (143, 137), victim
    assert victim[at - 1][0] == PodStatus.RUNNING
    assert victim[at + 1:] == [(PodStatus.DELETED, "127.0.0.1", code)]
    # the relaunch and the survivor's restart, under fresh ids
    assert stub.pod_names() == [f"{JOB}-master"] + [
        f"{JOB}-worker-{i}" for i in range(4)], logs
    # every training shard done once
    with open(os.path.join(ckpt, "task_state.json")) as f:
        journal = json.load(f)
    shards = sorted((name, start, end)
                    for name, start, end, _ in
                    journal["done_training_shards"])
    assert len(shards) == RECORDS // TASK == len(set(shards))
    assert journal["records_done"] == RECORDS
    # one recovery, within the budget
    with open(event_log) as f:
        recoveries = [e["duration_s"] for e in map(json.loads, f)
                      if e["event"] == events.RECOVERY_DONE]
    assert len(recoveries) == 1 and recoveries[0] < RECOVERY_BUDGET_S
    # the final group's two ranks end on one state
    final = []
    for name in (f"{JOB}-worker-2", f"{JOB}-worker-3"):
        for line in logs[name].splitlines():
            tag = line.find(KERNEL_LAUNCHES_TAG)
            if tag >= 0 and "state_sha256" in line:
                final.append(json.loads(line[tag + len(
                    KERNEL_LAUNCHES_TAG):]))
    assert len(final) == 2 and {e["rank"] for e in final} == {0, 1}, logs
    assert len({e["state_sha256"] for e in final}) == 1
    # every request came with the client certificate, over TLS
    assert requests and all(r["credential"] == "client-certificate"
                            and r["tls"].startswith("TLS")
                            for r in requests)
    pods = f"/api/v1/namespaces/{NAMESPACE}/pods"
    verbs = {(r["verb"], r["path"]) for r in requests}
    assert verbs == {("POST", pods), ("GET", pods),
                     ("POST", f"/api/v1/namespaces/{NAMESPACE}/services"),
                     ("DELETE", f"{pods}/{JOB}-worker-1")}
    # the stub's plumbing: python -> this interpreter, the master's
    # Service name -> loopback in each worker's argv
    assert {p["kind"] for p in plumbing} == {"python", "dns"}
    assert sum(p["kind"] == "dns" for p in plumbing) == 4
    print(f"kube cluster job on the CPU: {seconds:.1f} s, recovery "
          f"{recoveries[0]:.2f} s")
