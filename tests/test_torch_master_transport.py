"""The master over its socket transport (master/server.py, `MasterStub`):
every method's response equals, byte for byte, the in-process client's
for the same call on an identical master; the method's fault point fires
on each socket attempt; the HTTP statuses follow common/http_rpc.py; and
the wire format is the JAX package's protobuf bytes."""

import numpy as np
import pytest

import _torch_k8s_stub
from elasticdl_tpu.proto import elasticdl_pb2 as jax_pb
from elasticdl_tpu_torch.common import args as args_lib
from elasticdl_tpu_torch.common import faults, resilience
from elasticdl_tpu_torch.common.k8s_client import FakeK8sClient
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.master.server import MasterServer
from elasticdl_tpu_torch.model_zoo.mnist.data import write_dataset
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto.service import (
    MASTER_METHOD_TYPES,
    InProcessMasterClient,
    MasterRpcError,
    MasterStub,
)


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("transport")),
                         n_train=256, n_val=64)


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    faults.uninstall()


def _master(mnist, **extra):
    train_dir, val_dir = mnist
    argv = ["--distribution_strategy", "AllReduce", "--use_fake_k8s",
            "true", "--num_workers", "2", "--job_name", "wire",
            "--training_data", train_dir, "--validation_data", val_dir,
            "--records_per_task", "64", "--minibatch_size", "32",
            "--model_def", "mnist.mnist_functional_api.custom_model",
            "--device", "cpu"]
    for key, value in extra.items():
        argv += [f"--{key}", str(value)]
    args = args_lib.parse_master_args(argv)
    master = Master(args, k8s_client=FakeK8sClient())
    master.pod_manager.start()
    return master


def _calls():
    """One call of every method, in an order that exercises the state
    each depends on (epochs, leases, reports)."""
    report = pb.ReportTaskResultRequest(
        task_id=0, worker_id=1, exec_counters={"records": 64,
                                               "model_version": 2,
                                               "__model_step": 2})
    return [
        ("keep_alive", pb.KeepAliveRequest(worker_id=0, timestamp_ms=12,
                                           address="10.1.1.1")),
        ("get_cluster_spec", pb.GetClusterSpecRequest(worker_id=0)),
        ("get_cluster_spec", pb.GetClusterSpecRequest(
            worker_id=0, confirm_epoch=3)),
        ("get_cluster_spec", pb.GetClusterSpecRequest(
            worker_id=1, confirm_epoch=3)),
        ("get_spmd_task", pb.GetSpmdTaskRequest(worker_id=0,
                                                rendezvous_id=3, seq=0)),
        ("get_spmd_task", pb.GetSpmdTaskRequest(worker_id=1,
                                                rendezvous_id=3, seq=0)),
        ("get_spmd_task", pb.GetSpmdTaskRequest(worker_id=1,
                                                rendezvous_id=2, seq=1)),
        ("get_task", pb.GetTaskRequest(worker_id=5)),
        ("get_task", pb.GetTaskRequest(worker_id=6, filter_by_type=True,
                                       task_type=pb.EVALUATION)),
        ("report_task_result", report),
        ("report_task_result", pb.ReportTaskResultRequest(
            task_id=-1, err_message="lost", worker_id=-3, transient=True)),
        ("report_version", pb.ReportVersionRequest(worker_id=0,
                                                   model_version=2)),
        ("report_evaluation_metrics", pb.ReportEvaluationMetricsRequest(
            worker_id=1, model_version=2, metrics={"accuracy": 0.5},
            num_examples=3, eval_labels=np.array([0, 1, 1], np.float32),
            eval_preds=np.arange(6, dtype=np.float32), pred_width=2,
            eval_task_key=4, final_chunk=True)),
        ("keep_alive", pb.KeepAliveRequest(worker_id=99, timestamp_ms=1)),
        ("get_cluster_spec", pb.GetClusterSpecRequest(
            worker_id=1, known_rendezvous_id=3)),
    ]


def test_every_method_round_trips_byte_equal_to_the_in_process_client(
        mnist):
    over_socket = _master(mnist)
    in_process = _master(mnist)
    port = over_socket.start_rpc(0)
    stub = MasterStub(f"127.0.0.1:{port}", timeout=30)
    client = InProcessMasterClient(in_process.servicer)
    try:
        called = set()
        for name, request in _calls():
            got = getattr(stub, name)(request)
            want = getattr(client, name)(request)
            assert type(got) is MASTER_METHOD_TYPES[name][1]
            assert got.SerializeToString() == want.SerializeToString(), name
            assert got == pb.__dict__[type(want).__name__].FromString(
                want.SerializeToString())
            called.add(name)
        assert called == set(MASTER_METHOD_TYPES)
        # the state behind the calls moved alike on both masters
        assert over_socket.task_manager.snapshot() == \
            in_process.task_manager.snapshot()
        assert over_socket.servicer.max_model_version == 2
        assert over_socket.rendezvous_server.rendezvous_id == \
            in_process.rendezvous_server.rendezvous_id == 3
        assert over_socket.servicer.worker_last_seen(0) is not None
    finally:
        stub.close()
        over_socket.stop()
        in_process.stop()


def test_the_wire_is_the_reference_protobuf(mnist):
    """Requests the JAX package's protobuf writes decode on the port's
    server, and its responses decode as the JAX messages."""
    master = _master(mnist)
    port = master.start_rpc(0)
    import http.client

    def post(method, body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.request("POST", f"/elasticdl_tpu.Master/{method}", body)
            reply = conn.getresponse()
            return reply.status, reply.read()
        finally:
            conn.close()

    try:
        status, body = post("get_cluster_spec", jax_pb.GetClusterSpecRequest(
            worker_id=1, confirm_epoch=2).SerializeToString())
        assert status == 200
        spec = jax_pb.ClusterSpec.FromString(body)
        assert spec.world_size == 2 and spec.rendezvous_id == 2
        assert [w.address for w in spec.workers] == ["10.0.0.1", "10.0.0.2"]
        assert spec.coordinator_address == "10.0.0.1:51001"
        status, body = post("get_spmd_task", jax_pb.GetSpmdTaskRequest(
            worker_id=0, rendezvous_id=2, seq=0).SerializeToString())
        task = jax_pb.SpmdTaskResponse.FromString(body).task
        assert status == 200 and task.task_id >= 0
        assert task.shard.end - task.shard.start == 64
        report = jax_pb.ReportTaskResultRequest(task_id=task.task_id,
                                                worker_id=0)
        report.exec_counters["records"] = 64
        status, body = post("report_task_result",
                            report.SerializeToString())
        assert status == 200 and body == b""
        assert master.task_manager.counters.records_done == 64
        # the method name matches without regard to case
        status, _ = post("Get_Cluster_Spec", b"")
        assert status == 200
    finally:
        master.stop()


def test_fault_points_fire_on_the_socket(mnist):
    master = _master(mnist)
    port = master.start_rpc(0)
    registry = faults.install(faults.FaultRegistry([
        faults.FaultSpec(faults.POINT_RPC_GET_TASK, 0, "raise"),
        faults.FaultSpec(faults.POINT_RENDEZVOUS_JOIN, 0, "raise"),
        faults.FaultSpec(faults.POINT_WORKER_HEARTBEAT, 0, "raise"),
        faults.FaultSpec(faults.POINT_RPC_REPORT, 0, "drop"),
    ]))
    bare = MasterStub(f"127.0.0.1:{port}", timeout=30)
    policy = resilience.default_policy(initial_backoff_s=0.001,
                                       max_backoff_s=0.002,
                                       max_elapsed_s=5.0)
    retrying = MasterStub(f"127.0.0.1:{port}", timeout=30,
                          retry_policy=policy)
    try:
        # no policy: the injected fault reaches the caller, and the
        # request never left
        with pytest.raises(faults.InjectedFault):
            bare.get_task(pb.GetTaskRequest(worker_id=0))
        assert master.task_manager.snapshot()["doing"] == 0
        with pytest.raises(faults.InjectedFault):
            bare.keep_alive(pb.KeepAliveRequest(worker_id=0))
        assert master.servicer.worker_last_seen(0) is None
        # with a policy: one failed attempt, then the call goes through
        spec = retrying.get_cluster_spec(pb.GetClusterSpecRequest(
            worker_id=0))
        assert spec.world_size == 2
        resp = retrying.get_spmd_task(pb.GetSpmdTaskRequest(
            worker_id=0, rendezvous_id=spec.rendezvous_id, seq=0))
        assert resp.task.task_id >= 0
        retrying.report_version(pb.ReportVersionRequest(model_version=7))
        assert master.servicer.max_model_version == 7
        assert registry.hits(faults.POINT_RPC_GET_TASK) == 2
        assert registry.hits(faults.POINT_RENDEZVOUS_JOIN) == 2
        assert registry.hits(faults.POINT_WORKER_HEARTBEAT) == 1
        assert registry.hits(faults.POINT_RPC_REPORT) == 2
        assert registry.all_fired(), registry.unfired()
    finally:
        bare.close()
        retrying.close()
        master.stop()


class _Raising:
    def __getattr__(self, name):
        def handler(request, ctx):
            raise RuntimeError(f"{name} failed")
        return handler


def test_http_statuses():
    server = MasterServer(_Raising(), host="127.0.0.1")
    port = server.start(0)
    stub = MasterStub(f"127.0.0.1:{port}", timeout=30)
    import http.client

    try:
        with pytest.raises(MasterRpcError) as err:
            stub.get_task(pb.GetTaskRequest())
        assert err.value.status == 500
        assert "get_task failed" in err.value.message
        assert not resilience.is_retryable_error(err.value)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/elasticdl_tpu.Master/no_such_method", b"")
        reply = conn.getresponse()
        assert reply.status == 404
        reply.read()
        conn.request("POST", "/elasticdl_tpu.Master/get_task",
                     b"\x0a\x05ab")   # a truncated length-delimited field
        reply = conn.getresponse()
        assert reply.status == 400
        reply.read()
        conn.close()
    finally:
        stub.close()
        server.stop()
    # a stopped server refuses the connection: retryable
    with pytest.raises(ConnectionError) as err:
        MasterStub(f"127.0.0.1:{port}", timeout=5).get_task(
            pb.GetTaskRequest())
    assert resilience.is_retryable_error(err.value)


def test_a_503_from_a_stopping_server_is_retryable():
    assert resilience.is_retryable_error(MasterRpcError(503, "stopping"))
    assert resilience.is_retryable_error(MasterRpcError(504, "deadline"))
    assert not resilience.is_retryable_error(MasterRpcError(400, "bad"))


def test_the_master_entry_point_refuses_the_real_kubernetes_client(
        mnist, monkeypatch, tmp_path):
    """Without --use_process_k8s or --use_fake_k8s, a cluster master asks
    for the real client, which refuses to start without a cluster
    configuration (naming KUBECONFIG) and talks to the cluster a
    kubeconfig names."""
    from elasticdl_tpu_torch.common.k8s_client import K8sClient
    from elasticdl_tpu_torch.common.k8s_config import K8sConfigError
    from elasticdl_tpu_torch.master import main as master_main

    train_dir, _ = mnist
    argv = ["--distribution_strategy", "AllReduce",
            "--training_data", train_dir,
            "--model_def", "mnist.mnist_functional_api.custom_model"]
    _torch_k8s_stub.no_cluster(monkeypatch, tmp_path)
    with pytest.raises(K8sConfigError, match="KUBECONFIG"):
        master_main.main(argv)
    with _torch_k8s_stub.stub_cluster(monkeypatch, tmp_path,
                                      kubelet=False) as stub:
        client = master_main.k8s_client_for(args_lib.parse_master_args(
            argv + ["--job_name", "adopt"]))
        assert isinstance(client, K8sClient)
        assert client.list_pods() == []
    assert [(r["verb"], r["query"], r["credential"])
            for r in stub.requests] == [
        ("GET", {"labelSelector": "elasticdl-job=adopt,"
                                  "elasticdl-type=worker"},
         "client-certificate")]
    args = args_lib.parse_master_args(["--distribution_strategy", "Local"])
    assert master_main.k8s_client_for(args) is None
