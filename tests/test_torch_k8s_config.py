"""The port's Kubernetes configuration loaders (common/k8s_config.py) and
REST transport (common/k8s_rest.py) against the stub API server over
verified TLS, with the test-only PEMs of tests/data/k8s_tls/:

- in-cluster, with the service-account path constants pointed at
  temporary files, and the token read again once it is a minute old;
- kubeconfig in JSON and YAML, and a merged KUBECONFIG list;
- token, tokenFile, client certificate (inline and as files), basic
  auth and an exec credential plugin (cached until it expires);
- a wrong CA refused, insecure-skip-tls-verify honoured only where set
  to true, tls-server-name, a client certificate the cluster's CA did
  not sign refused;
- an auth-provider, YAML without PyYAML, and no configuration at all
  raising with their messages;
- K8sApiError on 401, 404 and 409;
- a kept-alive connection the server reset: a POST it may have carried
  out is not sent again, a GET or DELETE is, and an idle connection the
  server closed is not used;
- RFC 3339 expiry stamps with `Z`, an offset or nine-digit fractions,
  and one with no offset refused.
"""

import base64
import datetime
import json
import os
import shutil
import socket
import ssl
import struct
import sys
import tempfile
import threading
import time

import pytest

from _torch_k8s_stub import TLS
from elasticdl_tpu_torch.common import k8s_config
from elasticdl_tpu_torch.common import k8s_stub_apiserver as stub_lib
from elasticdl_tpu_torch.common.k8s_client import K8sClient, PodSpec
from elasticdl_tpu_torch.common.k8s_config import K8sConfigError
from elasticdl_tpu_torch.common.k8s_rest import K8sApiError, RestClient

PODS = "/api/v1/namespaces/default/pods"


@pytest.fixture
def env(monkeypatch, tmp_path):
    """No in-cluster variables, no KUBECONFIG, HOME at an empty dir."""
    for name in ("KUBERNETES_SERVICE_HOST", "KUBERNETES_SERVICE_PORT",
                 "KUBECONFIG"):
        monkeypatch.delenv(name, raising=False)
    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    return tmp_path


@pytest.fixture
def stub():
    server = stub_lib.StubApiServer(
        TLS, kubelet=False, tokens=("good-token", "exec-token-1",
                                    "exec-token-2"),
        basic=(("alice", "s3cret"),))
    yield server
    server.stop()


def _b64(name: str) -> str:
    with open(os.path.join(TLS, name), "rb") as f:
        return base64.b64encode(f.read()).decode()


def _kubeconfig(server: str, cluster: dict = None, user: dict = None,
                current: str = "stub") -> dict:
    cluster = {"server": server, **(cluster if cluster is not None else {
        "certificate-authority-data": _b64("ca.crt")})}
    return {"apiVersion": "v1", "kind": "Config",
            "clusters": [{"name": "stub", "cluster": cluster}],
            "users": [{"name": "u", "user": user or {}}],
            "contexts": [{"name": "stub", "context": {"cluster": "stub",
                                                      "user": "u"}}],
            "current-context": current}


def _use(monkeypatch, path, doc) -> str:
    with open(path, "w") as f:
        json.dump(doc, f)
    monkeypatch.setenv("KUBECONFIG", str(path))
    return str(path)


def _list(config=None):
    rest = RestClient(config or k8s_config.load_config())
    return rest.request("GET", PODS)


# ---- in-cluster --------------------------------------------------------


def test_in_cluster_token_and_ca(env, stub, monkeypatch):
    token, ca = env / "token", env / "ca.crt"
    token.write_text("good-token\n")
    shutil.copy(os.path.join(TLS, "ca.crt"), ca)
    monkeypatch.setattr(k8s_config, "SERVICE_TOKEN_PATH", str(token))
    monkeypatch.setattr(k8s_config, "SERVICE_CA_PATH", str(ca))
    with pytest.raises(K8sConfigError, match="KUBERNETES_SERVICE_HOST"):
        k8s_config.load_incluster_config()
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", str(stub.port))
    config = k8s_config.load_config()
    assert config.server == f"https://127.0.0.1:{stub.port}"
    assert _list(config)["kind"] == "PodList"
    assert stub.requests[-1]["credential"] == "token"
    # the in-cluster loader wins over a kubeconfig, as in the JAX client
    _use(monkeypatch, env / "kc.json", _kubeconfig("https://127.0.0.1:9"))
    assert k8s_config.load_config().server == config.server
    # an IPv6 service host is bracketed
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "fd00::1")
    assert k8s_config.load_incluster_config().server == \
        f"https://[fd00::1]:{stub.port}"
    # empty variables read as unset; a missing file raises
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "")
    with pytest.raises(K8sConfigError, match="not both set"):
        k8s_config.load_incluster_config()
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
    token.unlink()
    with pytest.raises(K8sConfigError, match="token"):
        k8s_config.load_incluster_config()


def test_a_token_file_is_read_again_once_a_minute(env):
    path = env / "token"
    path.write_text("first")
    now = [100.0]
    token = k8s_config.FileToken(str(path), clock=lambda: now[0])
    path.write_text("second")
    now[0] += k8s_config.TOKEN_REFRESH_S - 1
    assert token.headers() == {"Authorization": "Bearer first"}
    now[0] += 1
    assert token.headers() == {"Authorization": "Bearer second"}
    path.write_text("")
    now[0] += k8s_config.TOKEN_REFRESH_S
    with pytest.raises(K8sConfigError, match="empty"):
        token.headers()


# ---- kubeconfig --------------------------------------------------------


def test_inline_client_certificate_leaves_no_key_on_disk(env, stub,
                                                         monkeypatch):
    scratch = env / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    _use(monkeypatch, env / "kc.json", _kubeconfig(stub.url, user={
        "client-certificate-data": _b64("client.crt"),
        "client-key-data": _b64("client.key")}))
    assert _list()["items"] == []
    assert stub.requests[-1]["credential"] == "client-certificate"
    assert stub.requests[-1]["tls"].startswith("TLS")
    assert os.listdir(scratch) == []


def test_yaml_with_files_relative_to_the_kubeconfig(env, stub, monkeypatch):
    yaml = pytest.importorskip("yaml")
    conf = env / "conf"
    conf.mkdir()
    for name in ("ca.crt", "client.crt", "client.key"):
        shutil.copy(os.path.join(TLS, name), conf / name)
    doc = _kubeconfig(stub.url, cluster={"certificate-authority": "ca.crt"},
                      user={"client-certificate": "client.crt",
                            "client-key": "client.key"})
    path = conf / "config"
    path.write_text(yaml.safe_dump(doc))
    monkeypatch.setenv("KUBECONFIG", str(path))
    assert _list()["kind"] == "PodList"
    assert stub.requests[-1]["credential"] == "client-certificate"
    # the default path when KUBECONFIG is unset
    monkeypatch.delenv("KUBECONFIG")
    (env / "home" / ".kube").mkdir()
    shutil.copy(path, env / "home" / ".kube" / "config")
    with pytest.raises(K8sConfigError, match="ca.crt"):
        k8s_config.load_kube_config()   # relative to ~/.kube now
    for name in ("ca.crt", "client.crt", "client.key"):
        shutil.copy(conf / name, env / "home" / ".kube" / name)
    assert _list()["kind"] == "PodList"
    # YAML without PyYAML names it
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(K8sConfigError, match="PyYAML"):
        k8s_config.load_kube_config()


def test_a_merged_kubeconfig_list_first_wins(env, stub, monkeypatch):
    first = env / "first.json"
    first.write_text(json.dumps({"users": [
        {"name": "u", "user": {"token": "good-token"}}]}))
    second = env / "second.json"
    second.write_text(json.dumps(_kubeconfig(
        stub.url, user={"token": "bad-token"})))
    third = env / "third.json"
    third.write_text(json.dumps(_kubeconfig("https://127.0.0.1:9",
                                            current="other")))
    monkeypatch.setenv("KUBECONFIG", os.pathsep.join(
        [str(env / "missing.json"), str(first), str(second), str(third)]))
    config = k8s_config.load_kube_config()
    assert config.server == stub.url
    assert config.headers() == {"Authorization": "Bearer good-token"}
    _list(config)
    assert stub.requests[-1]["credential"] == "token"


@pytest.mark.parametrize("user,credential", [
    ({"token": "good-token"}, "token"),
    ({"tokenFile": "tok"}, "token"),
    ({"username": "alice", "password": "s3cret"}, "basic"),
])
def test_token_token_file_and_basic_auth(env, stub, monkeypatch, user,
                                         credential):
    (env / "tok").write_text("good-token\n")
    _use(monkeypatch, env / "kc.json", _kubeconfig(stub.url, user=user))
    _list()
    assert stub.requests[-1]["credential"] == credential


PLUGIN = """
import json, os, sys
with open(os.environ["RUNS"], "a") as f:
    f.write("run\\n")
runs = len(open(os.environ["RUNS"]).read().split())
info = json.loads(os.environ["KUBERNETES_EXEC_INFO"])
assert info["kind"] == "ExecCredential", info
status = {}
if os.environ.get("CERT"):
    status["clientCertificateData"] = open(os.environ["CERT"]).read()
    status["clientKeyData"] = open(os.environ["KEY"]).read()
else:
    status["token"] = "exec-token-%d" % min(runs, 2)
    status["expirationTimestamp"] = os.environ["EXPIRES"]
print(json.dumps({"apiVersion": info["apiVersion"],
                  "kind": "ExecCredential", "status": status}))
"""


def _exec_user(env, expires="", cert=False) -> dict:
    plugin = env / "plugin.py"
    plugin.write_text(PLUGIN)
    variables = [{"name": "RUNS", "value": str(env / "runs")},
                 {"name": "EXPIRES", "value": expires}]
    if cert:
        variables += [{"name": "CERT",
                       "value": os.path.join(TLS, "client.crt")},
                      {"name": "KEY",
                       "value": os.path.join(TLS, "client.key")}]
    return {"exec": {"apiVersion": "client.authentication.k8s.io/v1",
                     "command": sys.executable, "args": [str(plugin)],
                     "env": variables}}


def _stamp(seconds: float) -> str:
    at = datetime.datetime.now(datetime.timezone.utc) + \
        datetime.timedelta(seconds=seconds)
    return at.strftime("%Y-%m-%dT%H:%M:%SZ")


def _runs(env) -> int:
    path = env / "runs"
    return len(path.read_text().split()) if path.exists() else 0


def test_an_exec_plugin_token_is_cached_until_it_expires(env, stub,
                                                         monkeypatch):
    _use(monkeypatch, env / "kc.json",
         _kubeconfig(stub.url, user=_exec_user(env, _stamp(3600))))
    rest = RestClient(k8s_config.load_config())
    for _ in range(3):
        rest.request("GET", PODS)
    assert _runs(env) == 1
    assert stub.requests[-1]["credential"] == "token"
    # an expired credential runs the plugin again, once a request
    (env / "runs").unlink()
    _use(monkeypatch, env / "kc.json",
         _kubeconfig(stub.url, user=_exec_user(env, _stamp(-60))))
    config = k8s_config.load_config()
    assert _runs(env) == 1
    assert config.headers() == {"Authorization": "Bearer exec-token-2"}
    RestClient(config).request("GET", PODS)
    assert _runs(env) == 3


def test_an_exec_plugin_token_expires_by_the_injected_clock(env):
    """The credential compares its expiry with the clock it was given:
    a fake wall clock before the stamp keeps the token, one at or past
    it runs the plugin again."""
    expiry = k8s_config._parse_expiry("2031-05-01T12:00:00Z")
    now = [expiry - 10.0]
    plugin = k8s_config.ExecCredential(
        _exec_user(env, "2031-05-01T12:00:00Z")["exec"], str(env),
        clock=lambda: now[0])
    assert _runs(env) == 1
    assert plugin.headers() == {"Authorization": "Bearer exec-token-1"}
    now[0] = expiry - 0.001
    assert plugin.headers() == {"Authorization": "Bearer exec-token-1"}
    assert _runs(env) == 1
    now[0] = expiry
    assert plugin.headers() == {"Authorization": "Bearer exec-token-2"}
    assert _runs(env) == 2
    # the refreshed credential carries the same stamp: every read past it
    # runs the plugin once more, none before it does
    now[0] = expiry + 5.0
    plugin.headers()
    assert _runs(env) == 3
    now[0] = expiry - 1.0
    plugin.headers()
    assert _runs(env) == 3


def test_an_exec_plugin_client_certificate(env, stub, monkeypatch):
    _use(monkeypatch, env / "kc.json",
         _kubeconfig(stub.url, user=_exec_user(env, cert=True)))
    config = k8s_config.load_config()
    assert config.headers() == {}
    RestClient(config).request("GET", PODS)
    assert stub.requests[-1]["credential"] == "client-certificate"
    assert _runs(env) == 1


def test_a_failing_exec_plugin_raises(env, monkeypatch):
    user = _exec_user(env)
    user["exec"]["args"] = ["-c", "import sys; sys.exit(3)"]
    _use(monkeypatch, env / "kc.json", _kubeconfig("https://127.0.0.1:1",
                                                   user=user))
    with pytest.raises(K8sConfigError, match="exited 3"):
        k8s_config.load_config()


# ---- TLS ---------------------------------------------------------------


def test_a_wrong_ca_is_refused(env, stub, monkeypatch):
    _use(monkeypatch, env / "kc.json", _kubeconfig(
        stub.url, cluster={"certificate-authority-data": _b64(
            "other-ca.crt")}, user={"token": "good-token"}))
    with pytest.raises(ssl.SSLCertVerificationError):
        _list()
    # no CA at all: the system's CAs, which do not know the stub's
    _use(monkeypatch, env / "kc.json", _kubeconfig(
        stub.url, cluster={}, user={"token": "good-token"}))
    with pytest.raises(ssl.SSLCertVerificationError):
        _list()
    assert stub.requests == []


@pytest.mark.parametrize("value,verified", [
    (True, False), ("true", True), (False, True), (None, True)])
def test_insecure_skip_tls_verify_only_where_set(env, stub, monkeypatch,
                                                 value, verified):
    cluster = {"certificate-authority-data": _b64("other-ca.crt")}
    if value is not None:
        cluster["insecure-skip-tls-verify"] = value
    _use(monkeypatch, env / "kc.json", _kubeconfig(
        stub.url, cluster=cluster, user={"token": "good-token"}))
    if verified:
        with pytest.raises(ssl.SSLCertVerificationError):
            _list()
    else:
        _list()
        assert stub.requests[-1]["credential"] == "token"


@pytest.mark.parametrize("name,ok", [("localhost", True),
                                     ("stub.example", False)])
def test_tls_server_name(env, stub, monkeypatch, name, ok):
    _use(monkeypatch, env / "kc.json", _kubeconfig(stub.url, cluster={
        "certificate-authority-data": _b64("ca.crt"),
        "tls-server-name": name}, user={"token": "good-token"}))
    if ok:
        _list()
    else:
        with pytest.raises(ssl.SSLCertVerificationError):
            _list()


def test_a_client_certificate_of_another_ca_is_refused(env, stub,
                                                       monkeypatch):
    _use(monkeypatch, env / "kc.json", _kubeconfig(stub.url, user={
        "client-certificate-data": _b64("other-client.crt"),
        "client-key-data": _b64("other-client.key")}))
    with pytest.raises(OSError):
        _list()
    deadline = time.time() + 10.0
    while not stub.refused_handshakes and time.time() < deadline:
        time.sleep(0.01)        # the server logs the refusal on its thread
    assert stub.requests == [] and stub.refused_handshakes


# ---- what raises -------------------------------------------------------


def test_an_auth_provider_is_refused_by_name(env, monkeypatch):
    _use(monkeypatch, env / "kc.json", _kubeconfig(
        "https://127.0.0.1:1", user={"auth-provider": {"name": "oidc"}}))
    with pytest.raises(K8sConfigError, match="auth-provider 'oidc'"):
        k8s_config.load_config()


def test_no_configuration_names_kubeconfig_and_the_in_cluster_variables(
        env, monkeypatch):
    with pytest.raises(K8sConfigError) as err:
        K8sClient(namespace="default", job_name="job")
    message = str(err.value)
    assert "KUBECONFIG" in message and "KUBERNETES_SERVICE_HOST" in message
    monkeypatch.setenv("KUBECONFIG", str(env / "nowhere.json"))
    with pytest.raises(K8sConfigError, match="names no existing file"):
        k8s_config.load_config()
    _use(monkeypatch, env / "kc.json", _kubeconfig("https://127.0.0.1:1",
                                                   current=""))
    with pytest.raises(K8sConfigError, match="no current-context"):
        k8s_config.load_config()
    _use(monkeypatch, env / "kc.json", _kubeconfig("ftp://127.0.0.1:1"))
    with pytest.raises(K8sConfigError, match="neither"):
        k8s_config.load_config()


def test_api_errors_carry_the_status(env, stub, monkeypatch):
    _use(monkeypatch, env / "kc.json", _kubeconfig(stub.url))
    with pytest.raises(K8sApiError) as err:
        _list()                                 # no credential
    assert err.value.status == 401
    _use(monkeypatch, env / "kc.json", _kubeconfig(
        stub.url, user={"token": "good-token"}))
    client = K8sClient(namespace="default", job_name="job")
    spec = PodSpec(name="job-worker-0", pod_type="worker", worker_id=0)
    client.create_pod(spec)
    with pytest.raises(K8sApiError) as err:
        client.create_pod(spec)
    assert err.value.status == 409 and "AlreadyExists" in err.value.body
    with pytest.raises(K8sApiError) as err:
        client.delete_pod("job-worker-7")
    assert err.value.status == 404 and "not found" in str(err.value)
    assert client.get_pod_phase("job-worker-0") == "Pending"


# ---- the transport's second send ---------------------------------------


class _KeepAliveServer:
    """Plain HTTP on a socket, one connection at a time, answering `{}`
    with keep-alive.  After the first request of the first connection it
    either resets the connection when the next request has been read
    (`reset`), or closes its side while it is idle (`close_idle`).
    `seen` lists each request's verb as it was read."""

    def __init__(self, mode: str):
        self.mode = mode
        self.seen = []
        self.idle_closed = threading.Event()
        self._listener = socket.create_server(("127.0.0.1", 0))
        self.url = "http://127.0.0.1:%d" % self._listener.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    @staticmethod
    def _read_request(f):
        line = f.readline()
        if not line:
            return None
        length = 0
        while True:
            header = f.readline()
            if header in (b"\r\n", b""):
                break
            name, _, value = header.decode().partition(":")
            if name.lower() == "content-length":
                length = int(value)
        f.read(length)
        return line.split()[0].decode()

    def _serve(self):
        first = True
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            half_closed = False
            with conn, conn.makefile("rb") as f:
                while True:
                    verb = self._read_request(f)
                    if verb is None:
                        break
                    self.seen.append(verb)
                    if first and len(self.seen) == 2 and \
                            self.mode == "reset":
                        conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                        struct.pack("ii", 1, 0))
                        break
                    if half_closed:
                        self.seen[-1] += " on the closed connection"
                        break
                    conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: "
                                 b"application/json\r\nContent-Length: 2"
                                 b"\r\n\r\n{}")
                    if first and self.mode == "close_idle":
                        # half closed: a request sent on it still
                        # arrives, and shows in `seen`
                        conn.shutdown(socket.SHUT_WR)
                        half_closed = True
                        self.idle_closed.set()
            first = False

    def stop(self):
        self._listener.close()
        self._thread.join(timeout=5.0)


def _plain(url):
    return RestClient(k8s_config.ClusterConfig(
        server=url, ssl_context=None, headers=dict))


@pytest.mark.parametrize("verb,sent", [("POST", 1), ("GET", 2),
                                       ("DELETE", 2)])
def test_a_reset_after_the_request_resends_only_get_and_delete(verb, sent):
    server = _KeepAliveServer("reset")
    try:
        rest = _plain(server.url)
        rest.request("GET", PODS)               # the connection is kept
        if verb == "POST":
            # the server read the create and may have carried it out:
            # sent again it would meet 409 AlreadyExists
            with pytest.raises(ConnectionResetError):
                rest.request(verb, PODS, body={"metadata": {}})
        else:
            assert rest.request(verb, PODS + "/p") == {}
        assert server.seen == ["GET"] + [verb] * sent
        rest.close()
    finally:
        server.stop()


def test_an_idle_connection_the_server_closed_is_not_used():
    server = _KeepAliveServer("close_idle")
    try:
        rest = _plain(server.url)
        rest.request("GET", PODS)
        assert server.idle_closed.wait(5.0)
        assert rest.request("POST", PODS, body={"metadata": {}}) == {}
        assert server.seen == ["GET", "POST"]
        rest.close()
    finally:
        server.stop()


# ---- expiry stamps -------------------------------------------------------


@pytest.mark.parametrize("stamp,seconds", [
    ("2026-10-18T02:00:00Z", 1792288800.0),
    ("2026-10-18T02:00:00+00:00", 1792288800.0),
    ("2026-10-18T04:00:00+02:00", 1792288800.0),
    ("2026-10-18T02:00:00.250000000Z", 1792288800.25),
    ("2026-10-18T02:00:00.5z", 1792288800.5),
])
def test_expiry_stamps_are_rfc3339(stamp, seconds):
    assert k8s_config._parse_expiry(stamp) == seconds


@pytest.mark.parametrize("stamp,message", [
    ("2026-10-18T02:00:00", "no offset"),
    ("tomorrow", "not RFC 3339"),
])
def test_an_expiry_stamp_without_an_offset_is_refused(stamp, message):
    with pytest.raises(K8sConfigError, match=message):
        k8s_config._parse_expiry(stamp)
