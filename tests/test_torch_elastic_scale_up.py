"""A live two-rank cluster job grows to three mid-job, on the CPU
(tests/test_elastic_cluster.py:187 on the port): `scale_up(1)` once a
checkpoint step has committed bumps the epoch, the running ranks restart
for the new topology at their next task boundary, the confirmation
barrier holds the group until the new pod's process is ready, and the
job finishes on a world of three."""

from test_torch_elastic_cluster import (
    JOB_TIMEOUT_S,
    cluster_argv,
    pod_logs,
    process_k8s,
    start_job,
    wait_for_commit,
)

from elasticdl_tpu_torch.model_zoo.mnist.data import write_dataset

RECORDS = 384


def test_a_cluster_job_scales_up_mid_job(tmp_path):
    train_dir, _ = write_dataset(str(tmp_path / "data"), n_train=RECORDS,
                                 n_val=0)
    ckpt = str(tmp_path / "ckpt")
    k8s = process_k8s()
    # a global batch of 24 splits evenly over two ranks and over three
    thread, held, result = start_job(
        cluster_argv(train_dir, ckpt, "scaleup", minibatch_size=24), k8s)
    try:
        wait_for_commit(ckpt, thread.is_alive)
        assert held["master"].pod_manager.scale_up(1) == 1
        thread.join(JOB_TIMEOUT_S)
        assert not thread.is_alive(), "the job did not end"
    finally:
        k8s.stop()
    logs = pod_logs(k8s)
    master = held["master"]
    assert result["rc"] == 0, logs
    assert master.task_manager.counters.records_done >= 2 * RECORDS
    # at least the third pod was created (ranks that restart for the
    # transition are relaunched on top: elastic behaviour, not an error)
    workers = [s for s in k8s.create_calls if s.pod_type == "worker"]
    assert len(workers) >= 3
    # the group really formed a world of three at some epoch
    joined3 = [log for log in logs.values() if "/3 (addr" in log]
    assert joined3, f"no rank ever joined a world of 3:\n{logs}"
