"""Per-role telemetry HTTP server: /metrics, /healthz, /varz (the port of
the JAX package's common/telemetry.py; standard library only).

* `/metrics` — Prometheus text exposition (format 0.0.4) over the role's
  registries (common/metrics.py).
* `/healthz` — `{"status": "ok", "role": ...}` plus whatever the role's
  `healthz_fn` reports; HTTP 200 means "process up and serving".
* `/varz`   — debug JSON: flat metric snapshot + role extras.

Port 0 binds an ephemeral port (available as `.port`) so tests and
several servers per host never collide.  Every server's /varz carries
the process-wide program registry's summary under `programs`
(common/programs.py: the trainer's and the serving engine's programs and
the kernel builds), the surface `programs` and `top`'s programs line
read.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, Optional

from elasticdl_tpu_torch.common import metrics, programs
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger(__name__)

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class TelemetryServer:
    def __init__(
        self,
        registries: Iterable = (),
        role: str = "",
        port: int = 0,
        host: str = "0.0.0.0",
        varz_fn: Optional[Callable[[], dict]] = None,
        healthz_fn: Optional[Callable[[], dict]] = None,
    ):
        # keep the raw iterable items: callables resolve lazily at each
        # request so registries built after start() still show up
        self._registries = list(registries) or [metrics.default_registry()]
        self._role = role
        self._requested_port = int(port)
        self._host = host
        self._varz_fn = varz_fn
        self._healthz_fn = healthz_fn
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def add_registry(self, registry) -> None:
        self._registries.append(registry)

    # ---- request surface ------------------------------------------------

    def metrics_text(self) -> str:
        return metrics.render_text(self._registries)

    def healthz_json(self) -> str:
        doc = {"status": "ok", "role": self._role}
        if self._healthz_fn is not None:
            try:
                doc.update(self._healthz_fn() or {})
            except Exception as exc:   # reported in the probe's answer
                doc["status"] = "degraded"
                doc["error"] = str(exc)
        return json.dumps(doc, sort_keys=True, default=str)

    def varz_json(self) -> str:
        extra = {}
        if self._varz_fn is not None:
            try:
                extra = self._varz_fn() or {}
            except Exception as exc:   # reported in the probe's answer
                extra = {"varz_error": str(exc)}
        if "programs" not in extra:
            extra["programs"] = programs.default_program_registry().summary()
        return metrics.varz(self._registries, role=self._role, extra=extra)

    # ---- lifecycle ------------------------------------------------------

    def start(self) -> int:
        if self._httpd is not None:
            return self.port
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        body = outer.metrics_text().encode()
                        ctype = PROMETHEUS_CONTENT_TYPE
                    elif path == "/healthz":
                        body = outer.healthz_json().encode()
                        ctype = "application/json"
                    elif path in ("/varz", "/"):
                        body = outer.varz_json().encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404, "unknown endpoint")
                        return
                except Exception as exc:  # never kill the prober
                    self.send_error(500, str(exc))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass  # scrapes are periodic; don't spam the job log

        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), _Handler
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"telemetry-{self._role or 'role'}",
            daemon=True,
        )
        self._thread.start()
        logger.info(
            "%s telemetry on port %d (/metrics /healthz /varz)",
            self._role or "process", self.port,
        )
        return self.port

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
