"""A live two-rank cluster job shrinks to one mid-job, on the CPU
(tests/test_elastic_cluster.py:261 on the port): `scale_down(1)` once a
checkpoint step has committed deletes the newest worker's pod (no
relaunch), the survivor restarts for the new topology, and a world of
one finishes every record."""

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


def test_a_cluster_job_scales_down_mid_job(tmp_path):
    train_dir, _ = write_dataset(str(tmp_path / "data"), n_train=RECORDS,
                                 n_val=0)
    ckpt = str(tmp_path / "ckpt")
    k8s = process_k8s()
    thread, held, result = start_job(
        cluster_argv(train_dir, ckpt, "scaledown", minibatch_size=24), k8s)
    try:
        wait_for_commit(ckpt, thread.is_alive)
        removed = held["master"].pod_manager.scale_down(1)
        thread.join(JOB_TIMEOUT_S)
        assert not thread.is_alive(), "the job did not end"
    finally:
        k8s.stop()
    logs = pod_logs(k8s)
    master = held["master"]
    assert result["rc"] == 0, logs
    assert master.task_manager.counters.records_done >= 2 * RECORDS
    # the removed worker itself is never relaunched under its id (a
    # DELETED pod is not relaunched); a survivor that restarted for the
    # transition is relaunched under a fresh id
    deleted_id = max(s.worker_id for s in k8s.create_calls[:2]
                     if s.pod_type == "worker")
    assert removed == [deleted_id]
    relaunched = [s.worker_id for s in k8s.create_calls[2:]
                  if s.pod_type == "worker"]
    assert deleted_id not in relaunched
    # the job ended on a world of one
    assert any("/1 (addr" in log for log in logs.values()), logs
