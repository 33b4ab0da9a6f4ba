"""JSON over HTTPS to the Kubernetes API server: the transport of the
port's `K8sClient` (common/k8s_client.py), in place of the `kubernetes`
package's ApiClient.

`RestClient.request` sends one request with the config's headers and a
timeout on a connection of the calling thread's own (the master calls
the client from several threads), and returns the decoded reply.  As
urllib3's default Retry does for the package, it sends a request once
more on a new connection when a kept-alive one fails: any verb when the
failure came before the request went out, GET and DELETE also when it
came after (a POST the server may have carried out is not sent twice).  A
reply outside 2xx raises `K8sApiError(status, reason, body)`, the
package's ApiException.  `RestClient.watch` opens a `?watch=true`
stream on a connection of its own, with no read timeout, and yields one
decoded event per line of the chunked reply.
"""

from __future__ import annotations

import http.client
import json
import select
import socket
import threading
import urllib.parse
from typing import Iterator, Optional

from elasticdl_tpu_torch.common.k8s_config import ClusterConfig, K8sConfigError

# seconds a request may take, and a watch may take to connect
REQUEST_TIMEOUT_S = 30.0
USER_AGENT = "elasticdl-tpu-torch"
# verbs sent again after a reply was lost on a kept-alive connection
_RESEND_AFTER_SEND = frozenset(("GET", "DELETE"))


class K8sApiError(Exception):
    """The API server answered outside 2xx."""

    def __init__(self, status: int, reason: str, body: str = ""):
        super().__init__(f"({status}) {reason}: {body[:512]}")
        self.status = status
        self.reason = reason
        self.body = body


class _HTTPSConnection(http.client.HTTPSConnection):
    """Checks the server's certificate against `server_name` when the
    kubeconfig gives a tls-server-name."""

    def __init__(self, host, port, *, context, server_name, timeout):
        super().__init__(host, port, timeout=timeout, context=context)
        self._server_name = server_name

    def connect(self):
        http.client.HTTPConnection.connect(self)
        self.sock = self._context.wrap_socket(
            self.sock, server_hostname=self._server_name or self.host)


class RestClient:
    def __init__(self, config: ClusterConfig):
        url = urllib.parse.urlsplit(config.server)
        if url.scheme not in ("https", "http") or not url.hostname:
            raise K8sConfigError(f"server {config.server!r} is not an "
                                 "http(s) URL")
        if url.scheme == "https" and config.ssl_context is None:
            raise K8sConfigError(f"server {config.server!r} has no TLS "
                                 "context")
        self._config = config
        self._https = url.scheme == "https"
        self._host = url.hostname
        self._port = url.port or (443 if self._https else 80)
        self._prefix = url.path.rstrip("/")
        self._local = threading.local()

    def _connect(self) -> http.client.HTTPConnection:
        if self._https:
            return _HTTPSConnection(
                self._host, self._port, context=self._config.ssl_context,
                server_name=self._config.tls_server_name,
                timeout=REQUEST_TIMEOUT_S)
        return http.client.HTTPConnection(self._host, self._port,
                                          timeout=REQUEST_TIMEOUT_S)

    def _url(self, path: str, query: Optional[dict]) -> str:
        url = self._prefix + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        return url

    def _headers(self) -> dict:
        return {"Accept": "application/json", "User-Agent": USER_AGENT,
                **self._config.headers()}

    def close(self) -> None:
        """Close the calling thread's connection."""
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        if conn is not None:
            conn.close()

    def request(self, method: str, path: str, query: Optional[dict] = None,
                body=None) -> dict:
        headers = self._headers()
        payload = None
        if body is not None:
            payload = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        url = self._url(path, query)
        while True:
            conn = getattr(self._local, "conn", None)
            if conn is not None and _dropped(conn):
                self.close()
                conn = None
            reused = conn is not None
            if conn is None:
                conn = self._local.conn = self._connect()
            sent = False
            try:
                conn.request(method, url, body=payload, headers=headers)
                sent = True
                reply = conn.getresponse()
                data = reply.read()
            except (http.client.RemoteDisconnected, ConnectionResetError,
                    BrokenPipeError):
                self.close()
                if reused and (not sent or method in _RESEND_AFTER_SEND):
                    # the server closed the kept-alive connection while
                    # it was idle: once more, on a new one
                    continue
                raise
            except BaseException:
                self.close()
                raise
            break
        if reply.will_close:
            self.close()
        if not 200 <= reply.status < 300:
            raise K8sApiError(reply.status, reply.reason,
                              data.decode(errors="replace"))
        return json.loads(data) if data else {}

    def watch(self, path: str, query: dict) -> "WatchStream":
        conn = self._connect()
        try:
            conn.request("GET", self._url(path, {**query, "watch": "true"}),
                         headers=self._headers())
            reply = conn.getresponse()
            if not 200 <= reply.status < 300:
                raise K8sApiError(reply.status, reply.reason,
                                  reply.read().decode(errors="replace"))
        except BaseException:
            conn.close()
            raise
        conn.sock.settimeout(None)      # a watch waits as long as it must
        return WatchStream(conn, reply)


def _dropped(conn: http.client.HTTPConnection) -> bool:
    """An idle kept-alive connection that has something to read has been
    closed by the server (urllib3's is_connection_dropped)."""
    sock = conn.sock
    if sock is None:
        return False
    try:
        return bool(select.select([sock], [], [], 0)[0])
    except (OSError, ValueError):
        return True


class WatchStream:
    """The events of one watch request, one JSON object a line.  `close`
    may come from another thread: it ends the iteration."""

    def __init__(self, conn: http.client.HTTPConnection,
                 reply: http.client.HTTPResponse):
        self._conn = conn
        self._reply = reply

    def __iter__(self) -> Iterator[dict]:
        while True:
            line = self._reply.readline()
            if not line:
                return                  # the server ended the stream
            line = line.strip()
            if line:
                yield json.loads(line)

    def close(self) -> None:
        sock = self._conn.sock
        if sock is not None:
            try:
                # the plain socket's shutdown: it wakes a reader blocked
                # in another thread without touching the TLS state
                socket.socket.shutdown(sock, socket.SHUT_RDWR)
            except OSError:
                pass
        self._conn.close()

