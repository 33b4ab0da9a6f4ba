"""The master dies mid-job and a replacement resumes it, on the CPU
(tests/test_elastic_cluster.py:291 on the port): two worker processes
live on while the first master's RPC server goes down with no pod
cleanup; a replacement `Master` with the same flags on the same port
rebuilds its queue from the task journal and the committed checkpoint,
adopts the live workers (`PodManager.start` over
`ProcessK8sClient.list_pods`) without launching more, the workers' RPC
retries reconnect, and the job ends without retraining a journaled
shard: the training records done land exactly on the job's total."""

import os
import time

from test_torch_elastic_cluster import (
    JOB_TIMEOUT_S,
    _free_port,
    cluster_argv,
    pod_logs,
    process_k8s,
    wait_for_commit,
)

from elasticdl_tpu_torch.common.args import parse_master_args
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.model_zoo.mnist.data import write_dataset

RECORDS = 384


def test_a_replacement_master_resumes_the_job(tmp_path):
    train_dir, _ = write_dataset(str(tmp_path / "data"), n_train=RECORDS,
                                 n_val=0)
    ckpt = str(tmp_path / "ckpt")
    port = _free_port()
    args = parse_master_args(cluster_argv(
        train_dir, ckpt, "masterdie", extra=["--wedge_grace_s", "8"]))
    k8s = process_k8s()
    master2 = None
    try:
        master1 = Master(args, k8s_client=k8s)
        master1.start(port=port)
        # durable progress: a committed step and the journal beside it
        journal = os.path.join(ckpt, "task_state.json")
        wait_for_commit(ckpt, lambda: True)
        deadline = time.time() + JOB_TIMEOUT_S
        while not os.path.exists(journal):
            assert time.time() < deadline, "no task journal"
            time.sleep(0.05)
        done_before = len(master1.task_manager._done_training_shards) + \
            len(master1.task_manager._epoch_history)
        # the master "dies": its RPC server goes, the worker pods live on
        master1.rpc_server.stop(grace=0)
        time.sleep(2.0)
        # the replacement: same flags, same port, fresh state; it adopts
        # the job's live worker pods instead of launching new ones
        master2 = Master(args, k8s_client=k8s)
        master2.start(port=port)
        workers = [s for s in k8s.create_calls if s.pod_type == "worker"]
        assert len(workers) == 2, "the replacement master launched workers"
        ok = master2.wait(timeout=JOB_TIMEOUT_S)
        time.sleep(2.0)
    finally:
        k8s.stop()
        if master2 is not None:
            master2.stop()
    assert ok, pod_logs(k8s)
    assert done_before > 0
    # no journaled shard trained again: the journal's records plus those
    # the replacement dispatched are exactly the job's (a retrained shard
    # would overshoot, a dropped one undershoot)
    assert master2.task_manager._training_records_done == 2 * RECORDS, \
        master2.task_manager._training_records_done
