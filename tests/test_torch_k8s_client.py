"""The port's real `K8sClient` (REST, common/k8s_client.py) against the
JAX package's (elasticdl_tpu/common/k8s_client.py:380), which runs here
through a stub `kubernetes` package put into `sys.modules` for each
test: loaders that do nothing, `client.V1*` classes that keep their
kwargs, the package's serializer rules, a `CoreV1Api` that records its
calls and answers from the same pod JSON the stub API server holds, and
a `watch.Watch` that replays the stub API server's watch connections
line by line (as the package's `Watch.stream` reads them).

- Bodies: the pods and Services the JAX client sends, serialized as
  `ApiClient.sanitize_for_serialization` does, equal the bodies the stub
  API server receives from the port, dict for dict.
- Reads: list_pods, get_pod_phase and get_pod_labels agree on the same
  pods, with one list request and no read for a cached label.
- The watch: the same callbacks in the same order over ADDED replay,
  MODIFIED, terminated exit codes, DELETED, a clean end reopened from
  the last resourceVersion, and an ERROR 410 followed by a fresh replay.
"""

import json
import sys
import threading
import time
import types

import pytest

from _torch_k8s_stub import stub_cluster
from elasticdl_tpu.client import api as jax_api
from elasticdl_tpu.client import main as jax_cli
from elasticdl_tpu.common import k8s_client as jax_k8s
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.common import k8s_client as port_k8s
from elasticdl_tpu_torch.common import k8s_stub_apiserver as stub_lib
from elasticdl_tpu_torch.common.constants import PodStatus

WAIT_S = 20.0

# the `kubernetes` models' attribute_map entries the JAX client's
# objects use (every other attribute it sets is one word)
TO_JSON = {"volume_mounts": "volumeMounts", "restart_policy": "restartPolicy",
           "priority_class_name": "priorityClassName",
           "persistent_volume_claim": "persistentVolumeClaim",
           "claim_name": "claimName", "host_path": "hostPath",
           "mount_path": "mountPath", "target_port": "targetPort"}
# and the JSON names of what it reads back
FROM_JSON = {"podIP": "pod_ip", "containerStatuses": "container_statuses",
             "exitCode": "exit_code", "resourceVersion": "resource_version"}
# a field the package deserializes as dict(str, str), not as a model
DICT_FIELDS = ("labels",)


class _Model:
    def __init__(self, **kwargs):
        for key in kwargs:
            assert "_" not in key or key in TO_JSON, key
        self.kwargs = kwargs


def sanitize(obj):
    """ApiClient.sanitize_for_serialization: models to dicts of their
    set attributes under the API's names, lists and dicts item by
    item."""
    if isinstance(obj, (list, tuple)):
        return [sanitize(x) for x in obj]
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, _Model):
        return {TO_JSON.get(k, k): sanitize(v)
                for k, v in obj.kwargs.items() if v is not None}
    return obj


class Obj:
    """A deserialized model: JSON keys as snake_case attributes, None
    for what the JSON lacks."""

    def __init__(self, data: dict):
        self._data = data

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        key = next((k for k, v in FROM_JSON.items() if v == name), name)
        return wrap(self._data.get(key), name)


def wrap(value, name=""):
    if isinstance(value, dict):
        return dict(value) if name in DICT_FIELDS else Obj(value)
    if isinstance(value, list):
        return [wrap(v) for v in value]
    return value


class ApiException(Exception):
    def __init__(self, status=0, reason=""):
        super().__init__(f"({status}) {reason}")
        self.status = status


class World:
    """What the stub package answers from: the pods, the recorded calls
    and the stub API server's watch connections to replay."""

    def __init__(self):
        self.pods = {}
        self.calls = []
        self.connections = []
        self.opened = []            # the resourceVersion of each stream


def stub_package(world: World) -> dict:
    kubernetes = types.ModuleType("kubernetes")
    config = types.ModuleType("kubernetes.config")
    config.load_incluster_config = lambda: None
    config.load_kube_config = lambda: None
    client = types.ModuleType("kubernetes.client")
    for name in ("V1Pod", "V1ObjectMeta", "V1PodSpec", "V1Container",
                 "V1ResourceRequirements", "V1Volume", "V1VolumeMount",
                 "V1HostPathVolumeSource",
                 "V1PersistentVolumeClaimVolumeSource", "V1Service",
                 "V1ServiceSpec", "V1ServicePort"):
        setattr(client, name, type(name, (_Model,), {}))

    class CoreV1Api:
        def create_namespaced_pod(self, namespace, body):
            world.calls.append(("create_pod", namespace, sanitize(body)))

        def create_namespaced_service(self, namespace, body):
            world.calls.append(("create_service", namespace,
                                sanitize(body)))

        def delete_namespaced_pod(self, name, namespace):
            world.calls.append(("delete_pod", namespace, name))

        def read_namespaced_pod(self, name, namespace):
            world.calls.append(("read_pod", namespace, name))
            if name not in world.pods:
                raise ApiException(404, "Not Found")
            return Obj(world.pods[name])

        def list_namespaced_pod(self, namespace, label_selector=""):
            world.calls.append(("list_pods", namespace, label_selector))
            selector = stub_lib.parse_selector(label_selector)
            return Obj({"items": [
                pod for _, pod in sorted(world.pods.items())
                if all((pod["metadata"].get("labels") or {}).get(k) == v
                       for k, v in selector.items())]})

    client.CoreV1Api = CoreV1Api
    watch = types.ModuleType("kubernetes.watch")

    class Watch:
        """The package's Watch.stream: the first request carries no
        resourceVersion; a clean end reopens from the last event's; an
        ERROR event raises."""

        def stream(self, func, namespace, label_selector=""):
            version = None
            while True:
                if not world.connections:
                    # nothing more to replay: the JAX thread, a daemon
                    # with no way to stop, waits here for good
                    threading.Event().wait()
                lines, end = world.connections.pop(0)
                world.opened.append(version)
                for line in lines:
                    event = json.loads(line)
                    if event["type"] == "ERROR":
                        raise ApiException(event["object"]["code"],
                                           event["object"]["reason"])
                    version = event["object"]["metadata"]["resourceVersion"]
                    yield {"type": event["type"],
                           "object": Obj(event["object"]),
                           "raw_object": event["object"]}
                if end != "clean" or version is None:
                    return

    watch.Watch = Watch
    kubernetes.config, kubernetes.client, kubernetes.watch = \
        config, client, watch
    return {"kubernetes": kubernetes, "kubernetes.config": config,
            "kubernetes.client": client, "kubernetes.watch": watch}


@pytest.fixture
def world(monkeypatch):
    world = World()
    for name, module in stub_package(world).items():
        monkeypatch.setitem(sys.modules, name, module)
    return world


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The stub API server without a kubelet, and KUBECONFIG at it."""
    with stub_cluster(monkeypatch, tmp_path, kubelet=False) as server:
        yield server


SPECS = [
    port_k8s.PodSpec(name="job-worker-0", pod_type="worker", worker_id=0,
                     image="registry/img:1",
                     command=["python", "-m", "w", "--worker_id", "0"],
                     resources={"cpu": "2", "memory": "4Gi"}),
    port_k8s.PodSpec(name="job-worker-1", pod_type="worker", worker_id=1,
                     command=["python"], priority_class="high",
                     labels={"elasticdl-slice-group": "1", "team": "ads"},
                     volumes=[{"host_path": "/data", "mount_path": "/in"},
                              {"claim_name": "ckpt-pvc",
                               "mount_path": "/ckpt"}]),
    port_k8s.PodSpec(name="job-serving-0", pod_type="serving"),
]


def _jax_spec(spec):
    return jax_k8s.PodSpec(**{f: getattr(spec, f) for f in (
        "name", "pod_type", "worker_id", "image", "command", "resources",
        "priority_class", "labels", "volumes")})


def test_pod_and_service_bodies_are_the_jax_clients(world, stub):
    jax_client = jax_k8s.K8sClient(namespace="default", job_name="job")
    port_client = port_k8s.K8sClient(namespace="default", job_name="job")
    for spec in SPECS:
        jax_client.create_pod(_jax_spec(spec))
        port_client.create_pod(spec)
    selector = {"elasticdl-job": "job", "elasticdl-type": "master"}
    jax_client.create_service("job-master", selector, 50001)
    port_client.create_service("job-master", selector, 50001)
    sent = [(kind.split("_")[1], body) for kind, _, body in world.calls]
    assert sent == stub.bodies
    # what the serializer rules give, spelled out for two of them
    bodies = dict((b["metadata"]["name"], b) for _, b in stub.bodies)
    assert bodies["job-serving-0"] == {
        "metadata": {"name": "job-serving-0", "labels": {
            "elasticdl-job": "job", "elasticdl-type": "serving",
            "elasticdl-worker-id": "-1"}},
        "spec": {"containers": [{"name": "main", "image": "",
                                 "command": [], "resources": {}}],
                 "restartPolicy": "Never"}}
    assert bodies["job-worker-1"]["spec"]["volumes"] == [
        {"name": "vol-0", "hostPath": {"path": "/data",
                                       "type": "DirectoryOrCreate"}},
        {"name": "vol-1", "persistentVolumeClaim": {
            "claimName": "ckpt-pvc"}}]
    assert bodies["job-master"]["spec"]["ports"] == [
        {"port": 50001, "targetPort": 50001}]
    assert all(r["credential"] == "client-certificate"
               for r in stub.requests)


def test_the_submitted_master_pod_and_service_are_the_jax_clients(
        world, stub):
    argv = ["train", "--distribution_strategy", "AllReduce",
            "--model_def", "mnist.mnist_functional_api.custom_model",
            "--training_data", "/data/train", "--job_name", "mnist",
            "--image_name", "registry/mnist:1", "--port", "50123",
            "--volume", "host_path=/a,mount_path=/b"]
    assert jax_api.train(jax_cli._build_parser().parse_args(argv)) == 0
    assert cli.main(argv) == 0
    jax_sent = [(kind.split("_")[1], body) for kind, _, body in world.calls]
    assert [kind for kind, _ in jax_sent] == ["pod", "service"]
    assert [kind for kind, _ in stub.bodies] == ["pod", "service"]
    (_, jpod), (_, jsvc) = jax_sent
    (_, ppod), (_, psvc) = stub.bodies
    assert psvc == jsvc
    # the commands name each package's master (tests/
    # test_torch_client_submit.py holds their flags); all else is equal
    jcmd = jpod["spec"]["containers"][0].pop("command")
    pcmd = ppod["spec"]["containers"][0].pop("command")
    assert jcmd[:3] == ["python", "-m", "elasticdl_tpu.master.main"]
    assert pcmd[:3] == ["python", "-m", "elasticdl_tpu_torch.master.main"]
    assert ppod == jpod


def _pod_json(name, worker_id, phase, ip="", labels=None, statuses=None):
    status = {"phase": phase}
    if ip:
        status["podIP"] = ip
    if statuses is not None:
        status["containerStatuses"] = statuses
    return {"metadata": {"name": name, "labels": {
        "elasticdl-job": "job", "elasticdl-type": "worker",
        "elasticdl-worker-id": str(worker_id), **(labels or {})}},
        "spec": {"containers": [{"name": "main", "image": ""}]},
        "status": status}


def test_reads_agree_and_adoption_lists_once(world, stub):
    for pod in (_pod_json("job-worker-0", 0, "Running", "10.0.0.7",
                          labels={"elasticdl-slice-group": "0"}),
                _pod_json("job-worker-3", 3, "Pending"),
                _pod_json("job-worker-x", "x", "Failed")):
        stub.put_pod(pod)
    master = _pod_json("job-master", -1, "Running", "10.0.0.2")
    master["metadata"]["labels"]["elasticdl-type"] = "master"
    stub.put_pod(master)
    other = _pod_json("other-worker-0", 0, "Running")
    other["metadata"]["labels"]["elasticdl-job"] = "other"
    stub.put_pod(other)
    world.pods = {name: stub.pod(name) for name in (
        "job-worker-0", "job-worker-3", "job-worker-x", "job-master",
        "other-worker-0")}
    jax_client = jax_k8s.K8sClient(namespace="default", job_name="job")
    port_client = port_k8s.K8sClient(namespace="default", job_name="job")
    listed = port_client.list_pods()
    assert listed == jax_client.list_pods() == [
        ("job-worker-0", 0, "Running", "10.0.0.7"),
        ("job-worker-3", 3, "Pending", ""),
        ("job-worker-x", -1, "Failed", "")]
    before = len(stub.requests)
    for name, *_ in listed:
        assert port_client.get_pod_labels(name) == \
            jax_client.get_pod_labels(name)
    # cached labels: no read on either side
    assert len(stub.requests) == before
    assert [c[0] for c in world.calls] == ["list_pods"]
    assert [(r["verb"], r["query"]) for r in stub.requests] == [
        ("GET", {"labelSelector":
                 "elasticdl-job=job,elasticdl-type=worker"})]
    # an unlisted pod is read
    assert port_client.get_pod_labels("job-master") == \
        jax_client.get_pod_labels("job-master")
    assert port_client.get_pod_phase("job-worker-3") == \
        jax_client.get_pod_phase("job-worker-3") == "Pending"
    assert stub.requests[-1]["path"].endswith("/pods/job-worker-3")
    with pytest.raises(port_k8s.K8sApiError) as err:
        port_client.get_pod_phase("job-worker-9")
    assert err.value.status == 404
    # a delete sends no body
    port_client.delete_pod("job-worker-x")
    jax_client.delete_pod("job-worker-x")
    assert stub.requests[-1]["verb"] == "DELETE"
    assert world.calls[-1] == ("delete_pod", "default", "job-worker-x")


def _wait(predicate, what):
    deadline = time.time() + WAIT_S
    while not predicate():
        assert time.time() < deadline, what
        time.sleep(0.02)


def test_the_watch_callbacks_are_the_jax_clients(world, stub):
    stub.put_pod(_pod_json("job-worker-0", 0, "Running", "127.0.0.1"))
    stub.put_pod(_pod_json("job-worker-1", 1, "Pending"))
    port_events = []
    port_client = port_k8s.K8sClient(namespace="default", job_name="job")
    port_client.start_watch(lambda *e: port_events.append(e))
    try:
        _wait(lambda: len(port_events) == 2, "the ADDED replay")
        stub.set_status("job-worker-1", {"phase": "Running",
                                         "podIP": "127.0.0.1"})
        # two containers: the last terminated one's code is the pod's
        stub.set_status("job-worker-0", {
            "phase": "Failed", "containerStatuses": [
                {"name": "a", "state": {"terminated": {"exitCode": 1}}},
                {"name": "b", "state": {"terminated": {"exitCode": 137}}}]})
        _wait(lambda: len(port_events) == 4, "the MODIFIED events")
        stub.end_watches()                      # a clean end: reopen
        _wait(lambda: len(stub.watch_log) == 2, "the reopened watch")
        stub.put_pod(_pod_json("job-worker-2", 2, "Pending"))
        port_client.delete_pod("job-worker-1")
        _wait(lambda: len(port_events) == 7, "ADDED, MODIFIED, DELETED")
        stub.compact()                          # ERROR 410: a fresh watch
        _wait(lambda: len(port_events) == 9, "the fresh replay")
    finally:
        port_client.stop()
    assert port_events[-1][1] != PodStatus.DELETED
    log = stub.watch_log
    assert [w["end"] for w in log[:2]] == ["clean", "gone"]
    assert "resourceVersion" not in log[0]["query"]
    assert "resourceVersion" not in log[2]["query"]
    last = json.loads(log[0]["lines"][-1])["object"]["metadata"]
    assert log[1]["query"]["resourceVersion"] == last["resourceVersion"]
    assert port_events == [
        ("job-worker-0", "Running", "127.0.0.1", None),
        ("job-worker-1", "Pending", "", None),
        ("job-worker-1", "Running", "127.0.0.1", None),
        ("job-worker-0", "Failed", "", 137),
        ("job-worker-2", "Pending", "", None),
        ("job-worker-1", "Running", "127.0.0.1", None),
        ("job-worker-1", PodStatus.DELETED, "127.0.0.1", None),
        ("job-worker-0", "Failed", "", 137),
        ("job-worker-2", "Pending", "", None)]
    # the JAX client on the same lines, stream by stream
    world.connections = [(w["lines"], w["end"]) for w in log[:3]]
    jax_events = []
    jax_client = jax_k8s.K8sClient(namespace="default", job_name="job")
    jax_client.start_watch(lambda *e: jax_events.append(e))
    _wait(lambda: len(jax_events) == len(port_events), "the JAX callbacks")
    assert jax_events == port_events
    assert world.opened == [None, last["resourceVersion"], None]
