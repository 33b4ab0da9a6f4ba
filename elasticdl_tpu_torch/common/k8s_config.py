"""Where the Kubernetes API server is and how to authenticate to it: the
port's copy of the two loaders the JAX package's client calls through
the `kubernetes` package (`load_incluster_config`, then
`load_kube_config` when that raises), with the standard library only.

`load_config()` returns one `ClusterConfig`: the server's URL, the
`ssl.SSLContext` that verifies it (and carries a client certificate),
and `headers()`, which gives each request its `Authorization` header.

- In a pod: `KUBERNETES_SERVICE_HOST` and `KUBERNETES_SERVICE_PORT`,
  the service account's token and CA (`SERVICE_TOKEN_PATH`,
  `SERVICE_CA_PATH`).  The token is read again about once a minute
  (`TOKEN_REFRESH_S`): bound tokens rotate.
- Elsewhere: the kubeconfig files `KUBECONFIG` names (`:`-separated,
  merged as kubectl merges them: the first file to name a cluster, user
  or context, or to set `current-context`, wins), else
  `~/.kube/config`.  The current context's cluster gives `server`,
  `certificate-authority[-data]`, `insecure-skip-tls-verify` (only a
  literal true turns verification off) and `tls-server-name`; its user
  gives `token`, `tokenFile`, `client-certificate[-data]` with
  `client-key[-data]`, `username`/`password`, or an `exec` credential
  plugin (its ExecCredential's token is cached until its
  `expirationTimestamp`).  An `auth-provider` is refused by name.
  JSON parses with the standard library; YAML needs PyYAML.

Every failure raises `K8sConfigError`: nothing here falls back to an
unverified connection or to no credentials.
"""

from __future__ import annotations

import base64
import datetime
import json
import os
import ssl
import subprocess
import tempfile
import re
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

SERVICE_HOST_ENV = "KUBERNETES_SERVICE_HOST"
SERVICE_PORT_ENV = "KUBERNETES_SERVICE_PORT"
SERVICE_TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"
SERVICE_CA_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"
KUBECONFIG_ENV = "KUBECONFIG"
DEFAULT_KUBECONFIG = os.path.join("~", ".kube", "config")
# seconds a token read from a file is used before the file is read again
TOKEN_REFRESH_S = 60.0
# seconds an exec credential plugin may run
EXEC_TIMEOUT_S = 60.0
# the fraction of a second in an RFC 3339 stamp
_FRACTION = re.compile(r"\.(\d+)")


class K8sConfigError(Exception):
    """No usable cluster configuration (the `kubernetes` package's
    ConfigException)."""


@dataclass
class ClusterConfig:
    server: str
    # None for an http:// server
    ssl_context: Optional[ssl.SSLContext]
    headers: Callable[[], Dict[str, str]]
    # the name the server's certificate is checked against, when it is
    # not the server URL's host
    tls_server_name: str = ""


def load_config() -> ClusterConfig:
    """In-cluster first, then the kubeconfig: the JAX client's order."""
    try:
        return load_incluster_config()
    except K8sConfigError as incluster:
        try:
            return load_kube_config()
        except K8sConfigError as kube:
            raise K8sConfigError(
                f"no Kubernetes configuration: in-cluster: {incluster}; "
                f"kubeconfig: {kube}") from kube


# ---- in-cluster ------------------------------------------------------------


def load_incluster_config() -> ClusterConfig:
    host = os.environ.get(SERVICE_HOST_ENV, "")
    port = os.environ.get(SERVICE_PORT_ENV, "")
    if not host or not port:
        raise K8sConfigError(
            f"{SERVICE_HOST_ENV} and {SERVICE_PORT_ENV} are not both set "
            "(not running in a pod)")
    if ":" in host and not host.startswith("["):
        host = f"[{host}]"                      # an IPv6 address
    for path in (SERVICE_TOKEN_PATH, SERVICE_CA_PATH):
        if not os.path.isfile(path):
            raise K8sConfigError(f"the service account file {path} does "
                                 "not exist")
    token = FileToken(SERVICE_TOKEN_PATH)
    context = ssl_context(ca_file=SERVICE_CA_PATH)
    return ClusterConfig(server=f"https://{host}:{port}",
                         ssl_context=context, headers=token.headers)


class FileToken:
    """A bearer token read from a file, read again once it is
    `TOKEN_REFRESH_S` old (a service account's bound token rotates)."""

    def __init__(self, path: str, clock: Callable[[], float] = time.monotonic):
        self._path = path
        self._clock = clock
        self._lock = threading.Lock()
        self._token, self._read_at = self._read(), clock()

    def _read(self) -> str:
        try:
            with open(self._path) as f:
                token = f.read().strip()
        except OSError as exc:
            raise K8sConfigError(f"cannot read the token file "
                                 f"{self._path}: {exc}") from exc
        if not token:
            raise K8sConfigError(f"the token file {self._path} is empty")
        return token

    def headers(self) -> Dict[str, str]:
        with self._lock:
            if self._clock() - self._read_at >= TOKEN_REFRESH_S:
                self._token, self._read_at = self._read(), self._clock()
            return {"Authorization": f"Bearer {self._token}"}


# ---- kubeconfig ------------------------------------------------------------


def kubeconfig_paths() -> List[str]:
    """The kubeconfig files to merge, in order; raises naming KUBECONFIG
    when there is none."""
    listed = os.environ.get(KUBECONFIG_ENV, "")
    if listed:
        paths = [p for p in listed.split(os.pathsep) if p]
        found = [p for p in paths if os.path.isfile(p)]
        if not found:
            raise K8sConfigError(f"{KUBECONFIG_ENV}={listed!r} names no "
                                 "existing file")
        return found
    default = os.path.expanduser(DEFAULT_KUBECONFIG)
    if not os.path.isfile(default):
        raise K8sConfigError(f"{KUBECONFIG_ENV} is not set and {default} "
                             "does not exist")
    return [default]


def parse_kubeconfig(path: str) -> dict:
    """One kubeconfig file as a dict: JSON with the standard library,
    YAML with PyYAML."""
    with open(path) as f:
        text = f.read()
    if not text.strip():
        return {}
    try:
        doc = json.loads(text)
    except ValueError:
        try:
            import yaml
        except ImportError:
            raise K8sConfigError(
                f"{path} is not JSON, and reading it as YAML needs PyYAML, "
                "which is not installed (write the kubeconfig as JSON)"
            ) from None
        try:
            doc = yaml.safe_load(text)
        except yaml.YAMLError as exc:
            raise K8sConfigError(f"{path} is neither JSON nor YAML: "
                                 f"{exc}") from exc
    if doc is None:
        return {}
    if not isinstance(doc, dict):
        raise K8sConfigError(f"{path} holds no kubeconfig mapping")
    return doc


_SECTIONS = (("clusters", "cluster"), ("users", "user"),
             ("contexts", "context"))


def merge_kubeconfigs(docs: List[Tuple[str, dict]]) -> dict:
    """kubectl's merge: the first file to name an entry, or to set
    current-context, wins.  Each entry keeps its file's directory, which
    its relative paths are resolved against."""
    merged = {"current-context": "",
              **{section: {} for section, _ in _SECTIONS}}
    for path, doc in docs:
        base = os.path.dirname(os.path.abspath(path))
        if not merged["current-context"]:
            merged["current-context"] = doc.get("current-context") or ""
        for section, field in _SECTIONS:
            for entry in doc.get(section) or []:
                name = entry.get("name")
                if name is not None and name not in merged[section]:
                    merged[section][name] = (entry.get(field) or {}, base)
    return merged


def load_kube_config() -> ClusterConfig:
    paths = kubeconfig_paths()
    merged = merge_kubeconfigs([(p, parse_kubeconfig(p)) for p in paths])
    source = os.pathsep.join(paths)
    name = merged["current-context"]
    if not name:
        raise K8sConfigError(f"{source} sets no current-context")
    if name not in merged["contexts"]:
        raise K8sConfigError(f"{source}: context {name!r} is not defined")
    context, _ = merged["contexts"][name]
    cluster_name, user_name = context.get("cluster"), context.get("user")
    if cluster_name not in merged["clusters"]:
        raise K8sConfigError(f"{source}: context {name!r} names cluster "
                             f"{cluster_name!r}, which is not defined")
    cluster, cluster_base = merged["clusters"][cluster_name]
    if user_name and user_name not in merged["users"]:
        raise K8sConfigError(f"{source}: context {name!r} names user "
                             f"{user_name!r}, which is not defined")
    user, user_base = merged["users"].get(user_name, ({}, cluster_base))
    server = cluster.get("server")
    if not server:
        raise K8sConfigError(f"{source}: cluster {cluster_name!r} has no "
                             "server")
    if "auth-provider" in user:
        provider = (user["auth-provider"] or {}).get("name", "")
        raise K8sConfigError(
            f"{source}: user {user_name!r} authenticates through the "
            f"auth-provider {provider!r}, which the port does not support "
            "(use a token, a client certificate or an exec plugin)")
    headers, exec_pair = _user_auth(user, user_base)
    context_ssl = None
    if server.startswith("https://"):
        context_ssl = _cluster_ssl(cluster, cluster_base, source,
                                   cluster_name)
        cert = _user_cert_pair(user, user_base)
        if exec_pair is not None:
            cert = exec_pair
        if cert is not None:
            load_client_cert(context_ssl, *cert)
    elif not server.startswith("http://"):
        raise K8sConfigError(f"{source}: server {server!r} is neither "
                             "https:// nor http://")
    return ClusterConfig(server=server.rstrip("/"), ssl_context=context_ssl,
                         headers=headers,
                         tls_server_name=cluster.get("tls-server-name", ""))


def _resolve(base: str, path: str) -> str:
    return path if os.path.isabs(path) else os.path.join(base, path)


def _b64(value: str, what: str) -> bytes:
    try:
        return base64.b64decode("".join(value.split()), validate=True)
    except ValueError as exc:
        raise K8sConfigError(f"{what} is not base64: {exc}") from exc


def _cluster_ssl(cluster: dict, base: str, source: str,
                 name: str) -> ssl.SSLContext:
    if cluster.get("insecure-skip-tls-verify") is True:
        logger.warning("%s: cluster %r sets insecure-skip-tls-verify: the "
                       "server's certificate is not verified", source, name)
        return ssl_context(insecure=True)
    if cluster.get("certificate-authority-data"):
        data = _b64(cluster["certificate-authority-data"],
                    f"cluster {name!r} certificate-authority-data")
        return ssl_context(ca_data=data.decode("ascii", "replace"))
    if cluster.get("certificate-authority"):
        return ssl_context(ca_file=_resolve(base,
                                            cluster["certificate-authority"]))
    return ssl_context()


def ssl_context(ca_file: str = "", ca_data: str = "",
                insecure: bool = False) -> ssl.SSLContext:
    """A client context that verifies the server against `ca_file` or
    `ca_data` (PEM), else the system's CAs; `insecure` verifies
    nothing."""
    context = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if insecure:
        context.check_hostname = False
        context.verify_mode = ssl.CERT_NONE
        return context
    try:
        if ca_file or ca_data:
            context.load_verify_locations(cafile=ca_file or None,
                                          cadata=ca_data or None)
        else:
            context.load_default_certs()
    except (OSError, ssl.SSLError) as exc:
        raise K8sConfigError(f"cannot load the CA "
                             f"{ca_file or '(inline data)'}: {exc}") from exc
    return context


def _user_cert_pair(user: dict, base: str):
    """(cert, key) as ("file", path) or ("data", PEM bytes), or None."""
    def one(field):
        if user.get(f"{field}-data"):
            return ("data", _b64(user[f"{field}-data"], f"{field}-data"))
        if user.get(field):
            return ("file", _resolve(base, user[field]))
        return None

    cert, key = one("client-certificate"), one("client-key")
    if cert is None and key is None:
        return None
    if cert is None or key is None:
        raise K8sConfigError("a client certificate needs both "
                             "client-certificate and client-key")
    return cert, key


def load_client_cert(context: ssl.SSLContext, cert, key) -> None:
    """Load a client certificate into `context`.  Inline PEMs go to 0600
    temporary files (ssl loads certificates from files only), which are
    removed once loaded."""
    made = []
    try:
        paths = []
        for kind, value in (cert, key):
            if kind == "file":
                paths.append(value)
                continue
            fd, path = tempfile.mkstemp(prefix="k8s-client-", suffix=".pem")
            made.append(path)
            with os.fdopen(fd, "wb") as f:
                f.write(value)
            paths.append(path)
        context.load_cert_chain(certfile=paths[0], keyfile=paths[1])
    except (OSError, ssl.SSLError) as exc:
        raise K8sConfigError(f"cannot load the client certificate: "
                             f"{exc}") from exc
    finally:
        for path in made:
            os.unlink(path)


def _user_auth(user: dict, base: str):
    """(headers function, exec plugin's (cert, key) or None) in the
    package's order: token, tokenFile, exec, username/password."""
    if user.get("token"):
        value = {"Authorization": f"Bearer {user['token']}"}
        return (lambda: dict(value)), None
    if user.get("tokenFile"):
        return FileToken(_resolve(base, user["tokenFile"])).headers, None
    if user.get("exec"):
        plugin = ExecCredential(user["exec"], base)
        return plugin.headers, plugin.client_cert
    if user.get("username") is not None and user.get("password") is not None:
        basic = base64.b64encode(
            f"{user['username']}:{user['password']}".encode()).decode()
        value = {"Authorization": f"Basic {basic}"}
        return (lambda: dict(value)), None
    return (lambda: {}), None


def _parse_expiry(stamp: str) -> float:
    """An RFC 3339 stamp to seconds since the epoch.  Python 3.10's
    fromisoformat takes neither a `Z` nor a fraction of other than 3 or 6
    digits, so both are rewritten first; a stamp with no offset is
    refused rather than read as local time."""
    text = stamp.strip()
    if text[-1:] in ("Z", "z"):
        text = text[:-1] + "+00:00"
    match = _FRACTION.search(text)
    if match:
        text = (text[:match.start()] + "." + match.group(1)[:6].ljust(6, "0")
                + text[match.end():])
    try:
        when = datetime.datetime.fromisoformat(text)
    except ValueError as exc:
        raise K8sConfigError(f"exec plugin: expirationTimestamp {stamp!r} "
                             "is not RFC 3339") from exc
    if when.tzinfo is None:
        raise K8sConfigError(f"exec plugin: expirationTimestamp {stamp!r} "
                             "has no offset")
    return when.timestamp()


class ExecCredential:
    """A kubeconfig `exec` credential plugin: the command runs with its
    `args` and `env` (and KUBERNETES_EXEC_INFO, as client-go sets it) and
    prints an ExecCredential.  Its `status.token` is the bearer token,
    cached until `status.expirationTimestamp`; or its
    `status.clientCertificateData`/`clientKeyData` is the client
    certificate, read once when the config loads.  `clock` reads the wall
    clock the expiry is compared with (an absolute time, seconds since
    the epoch)."""

    def __init__(self, conf: dict, base: str,
                 clock: Callable[[], float] = time.time):
        if not conf.get("command"):
            raise K8sConfigError("exec plugin: no command")
        if not conf.get("apiVersion"):
            raise K8sConfigError("exec plugin: no apiVersion")
        self._conf = conf
        self._base = base
        self._clock = clock
        self._lock = threading.Lock()
        self._token = ""
        self._expiry: Optional[float] = None
        self.client_cert = None
        status = self._run()
        if status.get("token"):
            self._keep(status)
        elif status.get("clientCertificateData"):
            if not status.get("clientKeyData"):
                raise K8sConfigError("exec plugin: clientCertificateData "
                                     "without clientKeyData")
            self.client_cert = (
                ("data", status["clientCertificateData"].encode()),
                ("data", status["clientKeyData"].encode()))
        else:
            raise K8sConfigError("exec plugin: its ExecCredential has "
                                 "neither status.token nor "
                                 "status.clientCertificateData")

    def _keep(self, status: dict) -> None:
        self._token = status["token"]
        stamp = status.get("expirationTimestamp")
        self._expiry = _parse_expiry(stamp) if stamp else None

    def _run(self) -> dict:
        command = self._conf["command"]
        if os.sep in command:
            command = _resolve(self._base, command)
        env = dict(os.environ)
        env["KUBERNETES_EXEC_INFO"] = json.dumps({
            "apiVersion": self._conf["apiVersion"],
            "kind": "ExecCredential",
            "spec": {"interactive": False}})
        for item in self._conf.get("env") or []:
            env[item["name"]] = item["value"]
        argv = [command, *(self._conf.get("args") or [])]
        try:
            done = subprocess.run(argv, env=env, cwd=self._base,
                                  capture_output=True,
                                  timeout=EXEC_TIMEOUT_S, check=False)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise K8sConfigError(f"exec plugin {argv[0]!r} did not run: "
                                 f"{exc}") from exc
        if done.returncode != 0:
            raise K8sConfigError(
                f"exec plugin {argv[0]!r} exited {done.returncode}: "
                f"{done.stderr.decode(errors='replace').strip()}")
        try:
            credential = json.loads(done.stdout)
        except ValueError as exc:
            raise K8sConfigError(f"exec plugin {argv[0]!r} printed no "
                                 f"JSON: {exc}") from exc
        if credential.get("kind") != "ExecCredential" or \
                credential.get("apiVersion") != self._conf["apiVersion"]:
            raise K8sConfigError(
                f"exec plugin {argv[0]!r} printed kind "
                f"{credential.get('kind')!r} apiVersion "
                f"{credential.get('apiVersion')!r}, not an ExecCredential "
                f"of {self._conf['apiVersion']!r}")
        status = credential.get("status")
        if not isinstance(status, dict):
            raise K8sConfigError(f"exec plugin {argv[0]!r}: no status")
        return status

    def headers(self) -> Dict[str, str]:
        if self.client_cert is not None:
            return {}
        with self._lock:
            if self._expiry is not None and self._clock() >= self._expiry:
                status = self._run()
                if not status.get("token"):
                    raise K8sConfigError("exec plugin: a refreshed "
                                         "ExecCredential has no token")
                self._keep(status)
            return {"Authorization": f"Bearer {self._token}"}
