"""A stub Kubernetes API server on this machine: the local cluster behind
the port's REST client (`K8sClient`), for the tests and chip_smoke.py,
as `ProcessK8sClient` is the local cluster behind the client seam.  It
is not a feature of the system: nothing in the package starts one.

The server is a `ThreadingHTTPServer` over TLS (`tls_dir` holds
`ca.crt`, `server.crt` and `server.key`; tests/data/k8s_tls/ has
test-only ones).  Every request must carry a bearer token from `tokens`,
a (user, password) pair from `basic`, or a client certificate that
`ca.crt` verifies; anything else gets 401, and a certificate the CA
does not verify fails the handshake.  It serves, under
`/api/v1/namespaces/{ns}/`:

- `pods`: POST (create; 409 when the name is taken), GET (list, with an
  equality `labelSelector`), GET `?watch=true` (a chunked stream of
  JSON events, one a line: without `resourceVersion` the matching pods
  as ADDED, then every change; with one, the changes after it, or an
  ERROR 410 once `compact` has dropped them);
- `pods/{name}`: GET, DELETE (404 for an unknown pod);
- `services`: POST.

Pods live in memory under a rising `resourceVersion`; every watch has a
queue of its own.  With `kubelet=True` each pod's container command runs
as a process through `ProcessK8sClient`: the pod goes Pending, then
Running with podIP 127.0.0.1, then Succeeded or Failed with the
container's terminated `exitCode`.  DELETE of a running pod sends, in
order: MODIFIED with `deletionTimestamp`, SIGTERM, SIGKILL after
`GRACE_S` seconds, MODIFIED with the exit code, then DELETED.

What a cluster's own plumbing would do, the stub does on this machine,
and logs and records (`plumbing`): a Service name in a pod's argv
(`{service}:{port}`) becomes `127.0.0.1:{port}`, as cluster DNS would
resolve it; the image's `python` runs as this interpreter
(`sys.executable`); and each pod's environment gets `KUBECONFIG` (the
`pod_kubeconfig` file) in place of the in-cluster variables, so a
`K8sClient` in a pod loads the kubeconfig.

`requests` records each request's verb, path, query and credential;
`bodies` the JSON bodies as received; `watch_log` the lines each watch
connection sent and how it ended.  `end_watches` ends the open streams
cleanly, `compact` expires the versions seen so far (open streams get
an ERROR 410), `set_status` changes a pod's status as a kubelet would.
"""

from __future__ import annotations

import base64
import copy
import json
import os
import queue
import re
import socket
import ssl
import subprocess
import sys
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Optional, Tuple

from elasticdl_tpu_torch.common.constants import PodStatus
from elasticdl_tpu_torch.common.k8s_client import PodSpec, ProcessK8sClient
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

# seconds a deleted pod's process has between SIGTERM and SIGKILL
GRACE_S = 5.0
# how long a watch waits for its next event before it checks that the
# server still runs
_WATCH_POLL_S = 0.2
_PODS = re.compile(r"^/api/v1/namespaces/([^/]+)/pods$")
_POD = re.compile(r"^/api/v1/namespaces/([^/]+)/pods/([^/]+)$")
_SERVICES = re.compile(r"^/api/v1/namespaces/([^/]+)/services$")
_END_CLEAN, _END_GONE = object(), object()


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _status(code: int, reason: str, message: str) -> dict:
    return {"kind": "Status", "apiVersion": "v1", "status": "Failure",
            "message": message, "reason": reason, "code": code}


def parse_selector(text: str) -> Dict[str, str]:
    """An equality label selector (`a=b,c==d`); other forms raise
    ValueError."""
    out = {}
    for term in filter(None, (t.strip() for t in text.split(","))):
        key, sep, value = term.partition("==")
        if not sep:
            key, sep, value = term.partition("=")
        if not sep or key.endswith("!") or not key.strip():
            raise ValueError(f"unsupported label selector term {term!r}")
        out[key.strip()] = value.strip()
    return out


def _matches(pod: dict, selector: Dict[str, str]) -> bool:
    labels = pod["metadata"].get("labels") or {}
    return all(labels.get(k) == v for k, v in selector.items())


class _Watch:
    def __init__(self, namespace: str, selector: Dict[str, str]):
        self.namespace = namespace
        self.selector = selector
        self.queue: "queue.Queue" = queue.Queue()

    def offer(self, namespace: str, kind: str, pod: dict) -> None:
        if namespace == self.namespace and _matches(pod, self.selector):
            self.queue.put({"type": kind, "object": pod})


class StubApiServer:
    def __init__(self, tls_dir: str, *, tokens: Iterable[str] = (),
                 basic: Iterable[Tuple[str, str]] = (),
                 kubelet: bool = True, pod_env: Optional[dict] = None,
                 pod_kubeconfig: str = ""):
        self._tls = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self._tls.load_cert_chain(os.path.join(tls_dir, "server.crt"),
                                  os.path.join(tls_dir, "server.key"))
        self._tls.load_verify_locations(os.path.join(tls_dir, "ca.crt"))
        self._tls.verify_mode = ssl.CERT_OPTIONAL
        self._tokens = set(tokens)
        self._basic = set(tuple(pair) for pair in basic)
        self._lock = threading.Lock()
        self._version = 0
        self._compacted = 0
        self._pods: Dict[Tuple[str, str], dict] = {}
        self._services: Dict[Tuple[str, str], dict] = {}
        # the namespace of each pod the kubelet runs (its processes go
        # by pod name)
        self._namespace_of: Dict[str, str] = {}
        # (version, namespace, type, pod) of every change, for watches
        # that resume from a version
        self._events: List[Tuple[int, str, str, dict]] = []
        self._watches: List[_Watch] = []
        self._connections: set = set()
        self.requests: List[dict] = []
        self.bodies: List[Tuple[str, dict]] = []
        self.watch_log: List[dict] = []
        self.plumbing: List[dict] = []
        self.refused_handshakes: List[str] = []
        self._stopping = threading.Event()
        self._kubelet = None
        if kubelet:
            env = dict(pod_env or {})
            if pod_kubeconfig:
                env["KUBECONFIG"] = pod_kubeconfig
            # a pod of this cluster is reached through KUBECONFIG, not
            # through the in-cluster service (empty reads as unset)
            env["KUBERNETES_SERVICE_HOST"] = ""
            env["KUBERNETES_SERVICE_PORT"] = ""
            self._kubelet = ProcessK8sClient(extra_env=env)
            self._kubelet.start_watch(self._on_process)
        self._server = _Server(("127.0.0.1", 0), _Handler, self)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"https://127.0.0.1:{self.port}"

    # ---- lifecycle -----------------------------------------------------

    def stop(self) -> None:
        """End every watch, stop the server and kill every pod process
        still running."""
        self._stopping.set()
        self.end_watches()
        self._server.shutdown()
        self._server.server_close()
        with self._lock:
            connections = list(self._connections)
        for conn in connections:
            try:
                socket.socket.shutdown(conn, socket.SHUT_RDWR)
            except OSError:
                pass
        if self._kubelet is not None:
            self._kubelet.stop()
        self._thread.join(timeout=10.0)

    def pod_log(self, name: str) -> str:
        return self._kubelet.pod_output(name) if self._kubelet else ""

    def pod(self, name: str, namespace: str = "default") -> Optional[dict]:
        with self._lock:
            pod = self._pods.get((namespace, name))
            return copy.deepcopy(pod) if pod is not None else None

    def pod_names(self) -> List[str]:
        """Every pod the kubelet has run, deleted ones included."""
        return sorted(self._kubelet.pods) if self._kubelet else []

    # ---- the store -----------------------------------------------------

    def _bump_locked(self, namespace: str, kind: str, pod: dict) -> None:
        self._version += 1
        pod["metadata"]["resourceVersion"] = str(self._version)
        snapshot = copy.deepcopy(pod)
        self._events.append((self._version, namespace, kind, snapshot))
        for watch in self._watches:
            watch.offer(namespace, kind, snapshot)

    def put_pod(self, pod: dict, namespace: str = "default") -> dict:
        """Store `pod` as a create would, without running it."""
        with self._lock:
            return self._create_pod_locked(namespace, copy.deepcopy(pod))

    def _create_pod_locked(self, namespace: str, pod: dict) -> dict:
        metadata = pod.setdefault("metadata", {})
        metadata.update(namespace=namespace, uid=str(uuid.uuid4()),
                        creationTimestamp=_now())
        pod.setdefault("status", {"phase": PodStatus.PENDING})
        self._pods[(namespace, metadata["name"])] = pod
        self._bump_locked(namespace, "ADDED", pod)
        return copy.deepcopy(pod)

    def set_status(self, name: str, status: dict,
                   namespace: str = "default") -> bool:
        """Replace a pod's status (MODIFIED); False for an unknown pod."""
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                return False
            pod["status"] = copy.deepcopy(status)
            self._bump_locked(namespace, "MODIFIED", pod)
            return True

    def _remove(self, namespace: str, name: str) -> None:
        with self._lock:
            pod = self._pods.pop((namespace, name), None)
            if pod is not None:
                self._bump_locked(namespace, "DELETED", pod)

    def end_watches(self) -> None:
        """End every open watch stream cleanly."""
        with self._lock:
            watches, self._watches = self._watches, []
        for watch in watches:
            watch.queue.put(_END_CLEAN)

    def compact(self) -> None:
        """Forget the changes so far: open watches get an ERROR 410, and
        so does a watch that resumes from a version before now."""
        with self._lock:
            self._compacted = self._version
            self._events.clear()
            watches, self._watches = self._watches, []
        for watch in watches:
            watch.queue.put(_END_GONE)

    # ---- the kubelet ---------------------------------------------------

    def _start(self, namespace: str, pod: dict) -> None:
        """Run the pod's one container as a process."""
        name = pod["metadata"]["name"]
        container = pod["spec"]["containers"][0]
        argv = list(container.get("command") or []) + list(
            container.get("args") or [])
        if argv and argv[0] == "python":
            argv[0] = sys.executable
            self._plumb(name, "python", {"from": "python",
                                         "to": sys.executable})
        with self._lock:
            services = {svc: [p["port"] for p in (body["spec"].get("ports")
                                                   or [])]
                        for (ns, svc), body in self._services.items()
                        if ns == namespace}
        for svc, ports in services.items():
            for port in ports:
                target = f"{svc}:{port}"
                for i, arg in enumerate(argv):
                    if target in arg:
                        argv[i] = arg.replace(target, f"127.0.0.1:{port}")
                        self._plumb(name, "dns", {"from": target,
                                                  "to": f"127.0.0.1:{port}"})
        labels = pod["metadata"].get("labels") or {}
        with self._lock:
            self._namespace_of[name] = namespace
        try:
            worker_id = int(labels.get("elasticdl-worker-id", -1))
        except ValueError:
            worker_id = -1
        try:
            self._kubelet.create_pod(PodSpec(
                name=name, pod_type=labels.get("elasticdl-type", ""),
                worker_id=worker_id, command=argv))
        except (OSError, ValueError) as exc:
            # the container cannot start: the pod fails as a kubelet's
            # would, with the shell's "command not found"
            logger.warning("stub cluster: pod %s cannot start %s: %s",
                           name, argv, exc)
            self._terminated(name, 127)

    def _plumb(self, pod: str, kind: str, detail: dict) -> None:
        record = {"pod": pod, "kind": kind, **detail}
        logger.info("stub cluster plumbing: %s", record)
        with self._lock:
            self.plumbing.append(record)

    def _on_process(self, name: str, phase: str, address: str = "",
                    exit_code=None) -> None:
        if phase == PodStatus.RUNNING:
            self._update(name, lambda status: {
                "phase": PodStatus.RUNNING, "podIP": address,
                "hostIP": address, "startTime": _now(),
                "containerStatuses": [{"name": "main", "ready": True,
                                       "state": {"running": {
                                           "startedAt": _now()}}}]})
        elif phase in (PodStatus.SUCCEEDED, PodStatus.FAILED):
            self._terminated(name, exit_code)

    def _terminated(self, name: str, exit_code: int) -> None:
        """The container exited: the pod's terminal status, once.  A
        process ended by signal N reads 128 + N, as a container
        runtime reports it."""
        if exit_code < 0:
            exit_code = 128 - exit_code

        def status(old):
            if old.get("phase") in (PodStatus.SUCCEEDED, PodStatus.FAILED):
                return None
            return {**old,
                    "phase": (PodStatus.SUCCEEDED if exit_code == 0
                              else PodStatus.FAILED),
                    "containerStatuses": [{"name": "main", "ready": False,
                                           "state": {"terminated": {
                                               "exitCode": exit_code,
                                               "reason": ("Completed"
                                                          if exit_code == 0
                                                          else "Error"),
                                               "finishedAt": _now()}}}]}
        self._update(name, status)

    def _update(self, name: str, fn) -> None:
        with self._lock:
            namespace = self._namespace_of.get(name, "default")
            pod = self._pods.get((namespace, name))
            if pod is None:
                return
            status = fn(pod.get("status") or {})
            if status is not None:
                pod["status"] = status
                self._bump_locked(namespace, "MODIFIED", pod)

    def _delete(self, namespace: str, name: str) -> None:
        """A deleted pod's end, on a thread of its own: SIGTERM, SIGKILL
        after the grace, the exit code, then DELETED."""
        proc = self._kubelet.procs.get(name) if self._kubelet else None
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=GRACE_S)
            except subprocess.TimeoutExpired:
                logger.info("stub cluster: pod %s outlived its %.1f s "
                            "grace; SIGKILL", name, GRACE_S)
                proc.kill()
                proc.wait()
        if proc is not None:
            self._terminated(name, proc.returncode)
        self._remove(namespace, name)

    # ---- requests ------------------------------------------------------

    def _credential(self, handler) -> Optional[str]:
        if handler.connection.getpeercert():
            return "client-certificate"
        auth = handler.headers.get("Authorization", "")
        if auth.startswith("Bearer ") and auth[7:] in self._tokens:
            return "token"
        if auth.startswith("Basic "):
            try:
                user, _, password = base64.b64decode(
                    auth[6:]).decode().partition(":")
            except ValueError:
                return None
            if (user, password) in self._basic:
                return "basic"
        return None

    def handle(self, handler, method: str) -> None:
        url = urllib.parse.urlsplit(handler.path)
        query = dict(urllib.parse.parse_qsl(url.query))
        credential = self._credential(handler)
        record = {"verb": method, "path": url.path, "query": query,
                  "credential": credential,
                  "tls": handler.connection.version()}
        with self._lock:
            self.requests.append(record)
        length = int(handler.headers.get("Content-Length") or 0)
        raw = handler.rfile.read(length) if length else b""
        if credential is None:
            return _reply(handler, 401, _status(401, "Unauthorized",
                                                "no valid credential"))
        body = None
        if raw:
            try:
                body = json.loads(raw)
            except ValueError:
                return _reply(handler, 400, _status(400, "BadRequest",
                                                    "body is not JSON"))
        match = _PODS.match(url.path)
        if match and method == "GET" and query.get("watch") in ("true",
                                                                "1"):
            return self._watch(handler, match.group(1), query)
        if match and method == "GET":
            return self._list(handler, match.group(1), query)
        if match and method == "POST":
            return self._create(handler, match.group(1), body)
        match = _POD.match(url.path)
        if match and method in ("GET", "DELETE"):
            namespace, name = match.group(1), urllib.parse.unquote(
                match.group(2))
            with self._lock:
                pod = self._pods.get((namespace, name))
                if pod is not None and method == "DELETE":
                    pod["metadata"]["deletionTimestamp"] = _now()
                    pod["metadata"]["deletionGracePeriodSeconds"] = int(
                        GRACE_S)
                    self._bump_locked(namespace, "MODIFIED", pod)
                pod = copy.deepcopy(pod)
            if pod is None:
                return _reply(handler, 404, _status(
                    404, "NotFound", f'pods "{name}" not found'))
            if method == "DELETE":
                threading.Thread(target=self._delete,
                                 args=(namespace, name), daemon=True).start()
            return _reply(handler, 200, pod)
        match = _SERVICES.match(url.path)
        if match and method == "POST":
            return self._create_service(handler, match.group(1), body)
        return _reply(handler, 404, _status(404, "NotFound",
                                            f"no route {method} {url.path}"))

    def _list(self, handler, namespace: str, query: dict) -> None:
        try:
            selector = parse_selector(query.get("labelSelector", ""))
        except ValueError as exc:
            return _reply(handler, 400, _status(400, "BadRequest", str(exc)))
        with self._lock:
            items = [copy.deepcopy(pod) for (ns, _), pod in
                     sorted(self._pods.items()) if ns == namespace
                     and _matches(pod, selector)]
            version = str(self._version)
        _reply(handler, 200, {"kind": "PodList", "apiVersion": "v1",
                              "metadata": {"resourceVersion": version},
                              "items": items})

    def _create(self, handler, namespace: str, body) -> None:
        name = ((body or {}).get("metadata") or {}).get("name")
        if not name:
            return _reply(handler, 422, _status(422, "Invalid",
                                                "metadata.name is required"))
        with self._lock:
            self.bodies.append(("pod", copy.deepcopy(body)))
            if (namespace, name) in self._pods:
                return _reply(handler, 409, _status(
                    409, "AlreadyExists", f'pods "{name}" already exists'))
            pod = self._create_pod_locked(namespace, copy.deepcopy(body))
        if self._kubelet is not None:
            self._start(namespace, pod)
        _reply(handler, 201, pod)

    def _create_service(self, handler, namespace: str, body) -> None:
        name = ((body or {}).get("metadata") or {}).get("name")
        if not name:
            return _reply(handler, 422, _status(422, "Invalid",
                                                "metadata.name is required"))
        with self._lock:
            self.bodies.append(("service", copy.deepcopy(body)))
            if (namespace, name) in self._services:
                return _reply(handler, 409, _status(
                    409, "AlreadyExists",
                    f'services "{name}" already exists'))
            self._services[(namespace, name)] = copy.deepcopy(body)
        _reply(handler, 201, body)

    def _watch(self, handler, namespace: str, query: dict) -> None:
        try:
            selector = parse_selector(query.get("labelSelector", ""))
        except ValueError as exc:
            return _reply(handler, 400, _status(400, "BadRequest", str(exc)))
        watch = _Watch(namespace, selector)
        since = query.get("resourceVersion")
        with self._lock:
            if since is None:
                first = [{"type": "ADDED", "object": copy.deepcopy(pod)}
                         for (ns, _), pod in sorted(
                             self._pods.items(),
                             key=lambda kv: int(kv[1]["metadata"][
                                 "resourceVersion"]))
                         if ns == namespace and _matches(pod, selector)]
            elif int(since) < self._compacted:
                first = None
            else:
                first = [{"type": kind, "object": pod}
                         for version, ns, kind, pod in self._events
                         if version > int(since) and ns == namespace
                         and _matches(pod, selector)]
            if first is not None and not self._stopping.is_set():
                self._watches.append(watch)
        log = {"query": query, "lines": [], "end": None}
        with self._lock:
            self.watch_log.append(log)
        handler.send_response(200)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()
        if first is None:
            items = [_END_GONE]
        else:
            items = first
        try:
            while True:
                for item in items:
                    if item is _END_CLEAN:
                        log["end"] = "clean"
                    elif item is _END_GONE:
                        log["end"] = "gone"
                        self._send_event(handler, log, {
                            "type": "ERROR", "object": _status(
                                410, "Expired",
                                "too old resource version")})
                    else:
                        self._send_event(handler, log, item)
                    if log["end"]:
                        handler.wfile.write(b"0\r\n\r\n")
                        handler.wfile.flush()
                        return
                items = []
                try:
                    items = [watch.queue.get(timeout=_WATCH_POLL_S)]
                except queue.Empty:
                    if self._stopping.is_set():
                        items = [_END_CLEAN]
        except OSError:
            log["end"] = "closed"           # the client went away
            handler.close_connection = True
        finally:
            with self._lock:
                if watch in self._watches:
                    self._watches.remove(watch)

    @staticmethod
    def _send_event(handler, log: dict, event: dict) -> None:
        line = json.dumps(event).encode() + b"\n"
        log["lines"].append(line.decode())
        handler.wfile.write(b"%x\r\n%s\r\n" % (len(line), line))
        handler.wfile.flush()


def _reply(handler, code: int, body: dict) -> None:
    data = json.dumps(body).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(data)))
    handler.end_headers()
    handler.wfile.write(data)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        logger.debug("stub apiserver: " + fmt, *args)

    def do_GET(self):
        self.server.stub.handle(self, "GET")

    def do_POST(self):
        self.server.stub.handle(self, "POST")

    def do_DELETE(self):
        self.server.stub.handle(self, "DELETE")


class _Server(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address, handler, stub: StubApiServer):
        self.stub = stub
        super().__init__(address, handler)

    def finish_request(self, request, client_address):
        # the TLS handshake runs on the connection's own thread
        try:
            request.settimeout(30.0)
            conn = self.stub._tls.wrap_socket(request, server_side=True)
            conn.settimeout(None)
        except (ssl.SSLError, OSError) as exc:
            logger.info("stub apiserver: refused a TLS handshake from "
                        "%s: %s", client_address, exc)
            with self.stub._lock:
                self.stub.refused_handshakes.append(str(exc))
            return
        with self.stub._lock:
            self.stub._connections.add(conn)
        try:
            self.RequestHandlerClass(conn, client_address, self)
        finally:
            with self.stub._lock:
                self.stub._connections.discard(conn)
            conn.close()


def write_kubeconfig(path: str, server: str, tls_dir: str) -> str:
    """A JSON kubeconfig for the stub at `server`: the CA and the client
    certificate and key of `tls_dir`, all as inline `-data`."""
    def data(name):
        with open(os.path.join(tls_dir, name), "rb") as f:
            return base64.b64encode(f.read()).decode()

    config = {
        "apiVersion": "v1", "kind": "Config",
        "clusters": [{"name": "stub", "cluster": {
            "server": server,
            "certificate-authority-data": data("ca.crt")}}],
        "users": [{"name": "stub-client", "user": {
            "client-certificate-data": data("client.crt"),
            "client-key-data": data("client.key")}}],
        "contexts": [{"name": "stub", "context": {
            "cluster": "stub", "user": "stub-client"}}],
        "current-context": "stub"}
    with open(path, "w") as f:
        json.dump(config, f, indent=1)
    return path
