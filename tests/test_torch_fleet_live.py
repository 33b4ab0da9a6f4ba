"""The master's serving fleet, live on the CPU: a tiny MNIST cluster job
whose master (`Master`, ProcessK8sClient) places one serving replica,
`python -m elasticdl_tpu_torch.client.main serve` over the job's
checkpoint directory on --serving_port.  The replica answers a predict
at 127.0.0.1:--serving_port with a step the job committed, while the
job trains on; the process client serves no Service, so the fleet's
`create_service` is skipped as in the JAX package, and the fleet starts
and stops with the master."""

import threading
import time

import numpy as np
from test_torch_elastic_cluster import (
    JOB_TIMEOUT_S,
    _free_port,
    cluster_argv,
    pod_logs,
    process_k8s,
)

from elasticdl_tpu_torch.common.args import parse_master_args
from elasticdl_tpu_torch.common.constants import PodStatus, PodType
from elasticdl_tpu_torch.common.save_utils import committed_steps
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.model_zoo.mnist.data import write_dataset
from elasticdl_tpu_torch.proto import serving as spb
from elasticdl_tpu_torch.proto.service import ServingStub
from elasticdl_tpu_torch.serving.server import (
    from_tensor_proto,
    make_predict_request,
)

RECORDS = 384
# the replica's start: Python, torch, the model and the newest step
REPLICA_TIMEOUT_S = 60.0


def _delay_serving_pods(k8s, ckpt: str) -> None:
    """Start a serving pod's process once the job has committed a step,
    as a pod scheduled after its trainer's first checkpoint would be:
    `serve` over a checkpoint directory refuses an empty one."""
    create, stop = k8s.create_pod, k8s.stop
    lock = threading.Lock()
    stopped = []

    def create_pod(spec):
        if spec.pod_type != PodType.SERVING:
            return create(spec)

        def later():
            while not committed_steps(ckpt) and not stopped:
                time.sleep(0.05)
            with lock:
                if not stopped:
                    create(spec)

        threading.Thread(target=later, daemon=True).start()

    def stop_all():
        with lock:
            stopped.append(True)
        stop()

    k8s.create_pod, k8s.stop = create_pod, stop_all


def test_a_serving_replica_answers_at_a_committed_step(tmp_path):
    train_dir, _ = write_dataset(str(tmp_path / "data"), n_train=RECORDS,
                                 n_val=0)
    ckpt = str(tmp_path / "ckpt")
    serving_port = _free_port()
    args = parse_master_args(cluster_argv(
        train_dir, ckpt, "fleet", extra=[
            "--serving_replicas", "1",
            "--serving_port", str(serving_port),
            "--num_epochs", "4",
            # every step stays on disk, so the served one can be checked
            "--keep_checkpoint_max", "0"]))
    k8s = process_k8s()
    _delay_serving_pods(k8s, ckpt)
    master = Master(args, k8s_client=k8s)
    sample = np.random.default_rng(0).random((3, 784), np.float32)
    resp = None
    try:
        master.start()
        stub = ServingStub(f"127.0.0.1:{serving_port}", timeout=5.0)
        deadline = time.time() + REPLICA_TIMEOUT_S
        while resp is None:
            assert time.time() < deadline, pod_logs(k8s)
            try:
                resp = stub.predict(make_predict_request(sample))
            except OSError:
                time.sleep(0.2)
        ok = master.wait(timeout=JOB_TIMEOUT_S)
        snapshot = master.snapshot()
        replica_phase = k8s.get_pod_phase("fleet-serving-0-0")
    finally:
        master.stop()
        k8s.stop()
    assert ok, pod_logs(k8s)
    assert resp.code == spb.SERVING_OK, resp.error
    # a step the job committed, then served from its checkpoint
    assert resp.model_step > 0 and resp.model_step in committed_steps(ckpt)
    preds = from_tensor_proto(resp.predictions)
    assert preds.shape == (3, 10) and np.isfinite(preds).all()
    # the fleet the master built: one replica, no Service on this client
    assert replica_phase == PodStatus.RUNNING
    fleet = snapshot["serving_fleet"]
    assert list(fleet["replicas"]) == [0]
    assert fleet["replicas"][0]["pod"] == "fleet-serving-0-0"
    assert fleet["replicas"][0]["addr"] == "fleet-serving-0"
    assert "freshness" in snapshot and "serving_policy" not in snapshot
    assert [s.pod_type for s in k8s.create_calls].count(
        PodType.SERVING) == 1
