"""The Kubernetes client seam, its in-memory fake and a cluster of local
processes (the port's copy of the JAX package's common/k8s_client.py).

The master creates, watches and deletes pods through an
`AbstractK8sClient`.  `FakeK8sClient` records the calls and lets a test
or the online loop (`online/pipeline.py`) inject pod events: a created
pod goes Pending -> Running at once, with a fabricated address, and
`emit` drives a failure or a preemption.  `ProcessK8sClient` runs each
pod's command as a subprocess on this machine (`--use_process_k8s`): a
monitor thread maps a process's exit to the pod's phase, `delete_pod`
terminates it, `kill_pod` SIGKILLs it as a preemption would, and
`pod_output` returns what it printed.  Every pod's address is loopback,
so the master's entry point, the workers' and the rendezvous run as
they would across machines.

The real `K8sClient` does what the JAX package's does through the
`kubernetes` package, over the API server's REST interface with the
standard library: the configuration comes from common/k8s_config.py
(in-cluster, else the kubeconfig), the requests go through
common/k8s_rest.py, and the bodies are the dicts the package would
serialize for the JAX client's objects (`pod_body`, `service_body`).
common/k8s_stub_apiserver.py is a local API server to run it against.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import quote

from elasticdl_tpu_torch.common import k8s_config
from elasticdl_tpu_torch.common.constants import PodStatus, PodType
from elasticdl_tpu_torch.common.k8s_rest import K8sApiError, RestClient
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

# (pod_name, phase, pod_address, exit_code): the address is "" until the
# cluster knows the pod's IP; exit_code is the container's status on a
# terminal phase (None when unknown).
EventCallback = Callable[[str, str, str, Optional[int]], None]


@dataclass
class PodSpec:
    name: str
    pod_type: str  # "worker" | "master" | "serving"
    worker_id: int = -1
    image: str = ""
    command: List[str] = field(default_factory=list)
    resources: Dict[str, str] = field(default_factory=dict)
    priority_class: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    # parsed --volume entries (parse_volumes): each a dict with
    # "mount_path" plus one of "host_path" / "claim_name"
    volumes: List[Dict[str, str]] = field(default_factory=list)


def parse_volumes(volume: str) -> List[Dict[str, str]]:
    """Parse the --volume flag: `host_path=/a,mount_path=/b` or
    `claim_name=pvc,mount_path=/b`, several volumes separated by `;`."""
    out: List[Dict[str, str]] = []
    for part in (volume or "").split(";"):
        part = part.strip()
        if not part:
            continue
        entry: Dict[str, str] = {}
        for kv in part.split(","):
            kv = kv.strip()
            if not kv:
                continue
            if "=" not in kv:
                raise ValueError(
                    f"--volume entry {kv!r} is not key=value "
                    "(expected host_path=/a,mount_path=/b or "
                    "claim_name=pvc,mount_path=/b)"
                )
            key, _, value = kv.partition("=")
            key, value = key.strip(), value.strip()
            if key not in ("host_path", "claim_name", "mount_path"):
                raise ValueError(
                    f"--volume key {key!r} not supported (host_path, "
                    "claim_name, mount_path)"
                )
            if not value:
                raise ValueError(f"--volume key {key!r} has empty value")
            entry[key] = value
        if "host_path" in entry and "claim_name" in entry:
            raise ValueError(
                f"--volume entry {part!r} sets both host_path and "
                "claim_name; pick one source"
            )
        if "mount_path" not in entry or not (
            "host_path" in entry or "claim_name" in entry
        ):
            raise ValueError(
                f"--volume entry {part!r} needs mount_path plus "
                "host_path or claim_name"
            )
        out.append(entry)
    return out


class AbstractK8sClient:
    def create_pod(self, spec: PodSpec) -> None:
        raise NotImplementedError

    def create_service(
        self, name: str, selector: Dict[str, str], port: int
    ) -> None:
        """Expose the pods matching `selector` at DNS name `name`:`port`
        (workers reach the master at `{job_name}-master:{port}`)."""
        raise NotImplementedError

    def delete_pod(self, name: str) -> None:
        raise NotImplementedError

    def get_pod_phase(self, name: str) -> str:
        raise NotImplementedError

    def start_watch(self, callback: EventCallback) -> None:
        raise NotImplementedError

    def list_pods(self) -> List[Tuple[str, int, str, str]]:
        """The job's pods as (pod_name, worker_id, phase, address): a
        replacement master adopts live workers from this list."""
        return []

    def get_pod_labels(self, name: str) -> Dict[str, str]:
        """The labels stamped on the pod at creation ({} when the
        client keeps none)."""
        return {}

    def master_host(self, job_name: str) -> str:
        """The host name worker pods reach the master at."""
        return f"{job_name}-master"


class FakeK8sClient(AbstractK8sClient):
    """In-memory cluster: a created pod goes Pending -> Running; tests
    drive failures and preemptions through `emit`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.pods: Dict[str, PodSpec] = {}
        self.phases: Dict[str, str] = {}
        self.services: Dict[str, dict] = {}
        self.create_calls: List[PodSpec] = []
        self.delete_calls: List[str] = []
        self._callback: Optional[EventCallback] = None

    def create_pod(self, spec: PodSpec) -> None:
        with self._lock:
            self.pods[spec.name] = spec
            self.phases[spec.name] = PodStatus.PENDING
            self.create_calls.append(spec)
        self._emit(spec.name, PodStatus.PENDING)
        with self._lock:
            self.phases[spec.name] = PodStatus.RUNNING
        # a fabricated address, as pod.status.pod_ip would give
        self._emit(spec.name, PodStatus.RUNNING, self._pod_address(spec))

    @staticmethod
    def _pod_address(spec: PodSpec) -> str:
        """One formula for the fabricated pod IP: the create_pod events
        and list_pods (master adoption) must agree on it."""
        return f"10.0.0.{spec.worker_id + 1}"

    def create_service(
        self, name: str, selector: Dict[str, str], port: int
    ) -> None:
        with self._lock:
            self.services[name] = {"selector": selector, "port": port}

    def delete_pod(self, name: str) -> None:
        with self._lock:
            self.delete_calls.append(name)
            if name not in self.pods:
                return
            self.phases[name] = PodStatus.DELETED
        self._emit(name, PodStatus.DELETED)

    def get_pod_phase(self, name: str) -> str:
        with self._lock:
            return self.phases.get(name, PodStatus.UNKNOWN)

    def get_pod_labels(self, name: str):
        with self._lock:
            spec = self.pods.get(name)
            return dict(spec.labels) if spec is not None else {}

    def list_pods(self):
        with self._lock:
            return [
                (
                    name,
                    spec.worker_id,
                    self.phases.get(name, PodStatus.UNKNOWN),
                    self._pod_address(spec),
                )
                for name, spec in self.pods.items()
                if spec.pod_type == PodType.WORKER
            ]

    def start_watch(self, callback: EventCallback) -> None:
        self._callback = callback

    # ---- test hooks ----------------------------------------------------

    def emit(self, pod_name: str, phase: str, address: str = "",
             exit_code=None):
        """Inject a pod event (a preemption is FAILED)."""
        with self._lock:
            self.phases[pod_name] = phase
        self._emit(pod_name, phase, address, exit_code)

    def _emit(self, name: str, phase: str, address: str = "",
              exit_code=None):
        if self._callback is not None:
            self._callback(name, phase, address, exit_code)


class ProcessK8sClient(AbstractK8sClient):
    """A local cluster whose pods are OS subprocesses: `create_pod`
    spawns the pod's command, a monitor thread maps its exit to the
    pod's phase (0 -> Succeeded, else Failed, with the exit code), and
    `delete_pod` terminates it.  `extra_env` is added to every pod's
    environment."""

    # seconds a deleted pod gets to exit on SIGTERM before SIGKILL
    DELETE_GRACE_S = 15.0

    def __init__(self, extra_env: Optional[Dict[str, str]] = None):
        self._lock = threading.Lock()
        self.pods: Dict[str, PodSpec] = {}
        self.procs: Dict[str, subprocess.Popen] = {}
        self.phases: Dict[str, str] = {}
        self.create_calls: List[PodSpec] = []
        self._output: Dict[str, List[bytes]] = {}
        self._extra_env = dict(extra_env or {})
        self._callback: Optional[EventCallback] = None
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    def master_host(self, job_name: str) -> str:
        return "127.0.0.1"

    def create_pod(self, spec: PodSpec) -> None:
        env = dict(os.environ)
        env.update(self._extra_env)
        with self._lock:
            self.pods[spec.name] = spec
            self.create_calls.append(spec)
            self.phases[spec.name] = PodStatus.PENDING
        self._emit(spec.name, PodStatus.PENDING)
        proc = subprocess.Popen(spec.command, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        # drain continuously: a child that fills an unread pipe blocks
        # on write and looks hung
        chunks: List[bytes] = []

        def drain():
            for line in proc.stdout:
                chunks.append(line)

        threading.Thread(target=drain, daemon=True).start()
        with self._lock:
            self.procs[spec.name] = proc
            self._output[spec.name] = chunks
            self.phases[spec.name] = PodStatus.RUNNING
        self._emit(spec.name, PodStatus.RUNNING, "127.0.0.1")

    def delete_pod(self, name: str) -> None:
        with self._lock:
            proc = self.procs.get(name)
            self.phases[name] = PodStatus.DELETED
        if proc is not None and proc.poll() is None:
            proc.terminate()
        # the event goes out as the delete starts, as Kubernetes sends
        # the deletion at once: the epoch bump reaches the other ranks
        # before the condemned process has left
        self._emit(name, PodStatus.DELETED)
        if proc is not None and proc.poll() is None:
            try:
                proc.wait(timeout=self.DELETE_GRACE_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    def kill_pod(self, name: str) -> None:
        """A hard preemption: SIGKILL; the monitor then reports the pod
        Failed, as a spot reclaim would."""
        with self._lock:
            proc = self.procs.get(name)
        if proc is not None and proc.poll() is None:
            proc.kill()

    def get_pod_phase(self, name: str) -> str:
        with self._lock:
            return self.phases.get(name, PodStatus.UNKNOWN)

    def get_pod_labels(self, name: str):
        with self._lock:
            spec = self.pods.get(name)
            return dict(spec.labels) if spec is not None else {}

    def list_pods(self):
        with self._lock:
            return [(name, spec.worker_id,
                     self.phases.get(name, PodStatus.UNKNOWN), "127.0.0.1")
                    for name, spec in self.pods.items()
                    if spec.pod_type == PodType.WORKER]

    def start_watch(self, callback: EventCallback) -> None:
        self._callback = callback
        self._monitor = threading.Thread(target=self._watch_loop,
                                         daemon=True)
        self._monitor.start()

    def stop(self) -> None:
        """Stop the monitor and SIGKILL every pod still running; waits
        for them to exit."""
        self._stop.set()
        with self._lock:
            procs = list(self.procs.values())
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for proc in procs:
            proc.wait()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)

    def pod_output(self, name: str) -> str:
        with self._lock:
            chunks = list(self._output.get(name, ()))
        return b"".join(chunks).decode(errors="replace")

    def _watch_loop(self):
        while not self._stop.is_set():
            with self._lock:
                running = [(name, proc)
                           for name, proc in self.procs.items()
                           if self.phases.get(name) == PodStatus.RUNNING]
            for name, proc in running:
                rc = proc.poll()
                if rc is None:
                    continue
                phase = PodStatus.SUCCEEDED if rc == 0 \
                    else PodStatus.FAILED
                with self._lock:
                    # delete_pod may have won the race: its verdict stays
                    if self.phases.get(name) != PodStatus.RUNNING:
                        continue
                    self.phases[name] = phase
                self._emit(name, phase, exit_code=rc)
            time.sleep(0.1)

    def _emit(self, name: str, phase: str, address: str = "",
              exit_code=None):
        if self._callback is not None:
            self._callback(name, phase, address, exit_code)


def pod_body(spec: PodSpec, job_name: str) -> dict:
    """The pod the JAX client builds from `spec`, as the `kubernetes`
    package serializes it: unset fields dropped (an object with none set
    stays {}), attribute names in the API's camelCase, dict keys as
    given, no apiVersion or kind."""
    volumes, mounts = [], []
    for i, entry in enumerate(spec.volumes):
        name = f"vol-{i}"
        if "claim_name" in entry:
            source = {"persistentVolumeClaim": {
                "claimName": entry["claim_name"]}}
        else:
            source = {"hostPath": {"path": entry["host_path"],
                                   "type": "DirectoryOrCreate"}}
        volumes.append({"name": name, **source})
        mounts.append({"name": name, "mountPath": entry["mount_path"]})
    container = {"name": "main", "image": spec.image,
                 "command": list(spec.command),
                 "resources": ({"requests": dict(spec.resources)}
                               if spec.resources else {})}
    if mounts:
        container["volumeMounts"] = mounts
    pod_spec = {"containers": [container], "restartPolicy": "Never"}
    if spec.priority_class:
        pod_spec["priorityClassName"] = spec.priority_class
    if volumes:
        pod_spec["volumes"] = volumes
    labels = {"elasticdl-job": job_name, "elasticdl-type": spec.pod_type,
              "elasticdl-worker-id": str(spec.worker_id), **spec.labels}
    return {"metadata": {"name": spec.name, "labels": labels},
            "spec": pod_spec}


def service_body(name: str, selector: Dict[str, str], port: int,
                 job_name: str) -> dict:
    """The JAX client's Service, serialized as `pod_body` says."""
    return {"metadata": {"name": name, "labels": {"elasticdl-job": job_name}},
            "spec": {"selector": dict(selector),
                     "ports": [{"port": port, "targetPort": port}]}}


def pod_event(event: dict) -> Tuple[str, str, str, Optional[int]]:
    """A watch event as the callback's (name, phase, podIP or "",
    exit code): DELETED is PodStatus.DELETED, the exit code the last
    container's `state.terminated.exitCode`."""
    pod = event.get("object") or {}
    status = pod.get("status") or {}
    phase = status.get("phase")
    if event.get("type") == "DELETED":
        phase = PodStatus.DELETED
    exit_code = None
    for container in status.get("containerStatuses") or []:
        terminated = (container.get("state") or {}).get("terminated")
        if terminated:
            exit_code = terminated.get("exitCode")
    return ((pod.get("metadata") or {}).get("name"), phase,
            status.get("podIP") or "", exit_code)


class K8sClient(AbstractK8sClient):
    """The real Kubernetes client: pod create, read, list, delete and
    watch, and a Service, in a namespace, over the API server's REST
    interface.  The configuration is the in-cluster one, else the
    kubeconfig (common/k8s_config.py); a missing one raises
    K8sConfigError, and a reply outside 2xx raises K8sApiError."""

    # the JAX loop's reconnect backoff: doubling from 1 s to 60 s
    WATCH_BACKOFF_S = (1.0, 60.0)

    def __init__(self, namespace: str = "default", job_name: str = "job"):
        self._rest = RestClient(k8s_config.load_config())
        self._namespace = namespace
        self._job_name = job_name
        self._callback: Optional[EventCallback] = None
        # the labels of the pods the last list_pods returned: a
        # replacement master adopts its workers with one list, not a
        # read a pod
        self._labels_cache: Dict[str, Dict[str, str]] = {}
        self._stop = threading.Event()
        self._stream_lock = threading.Lock()
        self._stream = None
        self._thread: Optional[threading.Thread] = None

    def _path(self, kind: str, name: str = "") -> str:
        path = f"/api/v1/namespaces/{quote(self._namespace, safe='')}/{kind}"
        return f"{path}/{quote(name, safe='')}" if name else path

    def create_pod(self, spec: PodSpec) -> None:
        self._rest.request("POST", self._path("pods"),
                           body=pod_body(spec, self._job_name))

    def create_service(
        self, name: str, selector: Dict[str, str], port: int
    ) -> None:
        self._rest.request("POST", self._path("services"),
                           body=service_body(name, selector, port,
                                             self._job_name))

    def delete_pod(self, name: str) -> None:
        self._rest.request("DELETE", self._path("pods", name))

    def get_pod_phase(self, name: str) -> str:
        pod = self._rest.request("GET", self._path("pods", name))
        return (pod.get("status") or {}).get("phase")

    def get_pod_labels(self, name: str):
        cached = self._labels_cache.get(name)
        if cached is not None:
            return dict(cached)
        pod = self._rest.request("GET", self._path("pods", name))
        return dict((pod.get("metadata") or {}).get("labels") or {})

    def list_pods(self):
        pods = self._rest.request(
            "GET", self._path("pods"),
            query={"labelSelector": f"elasticdl-job={self._job_name},"
                                    "elasticdl-type=worker"})
        out = []
        labels_cache = {}
        for pod in pods.get("items") or []:
            metadata = pod.get("metadata") or {}
            labels = metadata.get("labels") or {}
            try:
                worker_id = int(labels.get("elasticdl-worker-id", -1))
            except (TypeError, ValueError):
                worker_id = -1
            labels_cache[metadata.get("name")] = dict(labels)
            status = pod.get("status") or {}
            out.append((metadata.get("name"), worker_id,
                        status.get("phase"), status.get("podIP") or ""))
        self._labels_cache = labels_cache
        return out

    def start_watch(self, callback: EventCallback) -> None:
        self._callback = callback
        self._thread = threading.Thread(target=self._watch_loop,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """End the watch thread (the JAX client's is a daemon that never
        ends)."""
        self._stop.set()
        with self._stream_lock:
            stream = self._stream
        if stream is not None:
            stream.close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _watch_once(self, query: dict):
        """One watch request's events, then the resourceVersion a clean
        end reopens from."""
        stream = self._rest.watch(self._path("pods"), query)
        with self._stream_lock:
            self._stream = stream
        if self._stop.is_set():
            stream.close()
        try:
            for event in stream:
                if event.get("type") == "ERROR":
                    status = event.get("object") or {}
                    raise K8sApiError(status.get("code", 0),
                                      status.get("reason", ""),
                                      status.get("message", ""))
                yield event
        finally:
            with self._stream_lock:
                self._stream = None
            stream.close()

    def _watch_loop(self):
        """The `kubernetes` package's Watch.stream under the JAX loop: a
        fresh watch replays the job's pods as ADDED; a stream that ends
        cleanly reopens from the last event's resourceVersion; an ERROR
        event (410 Gone: the version is too old) or any failure waits
        the backoff and opens a fresh watch."""
        first, cap = self.WATCH_BACKOFF_S
        backoff = first
        while not self._stop.is_set():
            try:
                version = None
                while not self._stop.is_set():
                    query = {"labelSelector":
                             f"elasticdl-job={self._job_name}"}
                    if version is not None:
                        query["resourceVersion"] = version
                    for event in self._watch_once(query):
                        backoff = first         # a healthy stream
                        version = ((event.get("object") or {}).get(
                            "metadata") or {}).get("resourceVersion",
                                                   version)
                        self._callback(*pod_event(event))
            except Exception as exc:
                if self._stop.is_set():
                    break
                logger.warning("k8s watch reconnecting in %.0fs after: %s",
                               backoff, exc)
                self._stop.wait(backoff)
                backoff = min(backoff * 2, cap)
