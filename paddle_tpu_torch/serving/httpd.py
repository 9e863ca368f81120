"""The live scrape surface: a stdlib-HTTP metrics server (the port of
``paddle_tpu/serving/httpd.py``).  Three endpoints off the process-wide
registry:

- ``GET /metrics``  — ``monitor.REGISTRY.to_prometheus()`` (text 0.0.4),
  the bytes the file export writes, but live;
- ``GET /healthz``  — drain-aware liveness: 200 ``ok`` normally, 503
  ``draining`` once the owning server has stopped admitting (a load
  balancer takes the replica out of rotation before its drain finishes);
- ``GET /statusz``  — the owning server's JSON snapshot (buckets and
  widths, slots, per-tenant queue depths, SLO burn state, memory).

``FLAGS_metrics_port`` picks the port (0 = disabled; the servers start one
in ``serve_until_terminated`` when it is set); an explicit port 0 binds an
ephemeral port (read ``.port``).  Requests are handled on daemon threads
(``http.server.ThreadingHTTPServer``) that only read registry snapshots and
call the provider callbacks, so a slow scrape never blocks serving.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

from .. import monitor as _monitor

__all__ = ["MetricsHTTPServer"]

HTTP_REQ_CTR = _monitor.REGISTRY.counter(
    "paddle_tpu_metrics_http_requests_total",
    "scrape-endpoint requests served, by path and status",
    ("path", "status"))


class MetricsHTTPServer:
    """One process's scrape endpoint (``/metrics`` ``/healthz``
    ``/statusz``).

    ``health_fn() -> (ok, state)`` drives ``/healthz`` (state is the
    body, ok picks 200 vs 503); ``status_fn() -> dict`` feeds
    ``/statusz``.  Both default to an always-healthy, empty-status
    standalone exporter — a training rank can expose ``/metrics`` with
    no serving plane at all.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 health_fn: Optional[Callable[[], Tuple[bool, str]]] = None,
                 status_fn: Optional[Callable[[], Dict[str, Any]]] = None):
        self._host = host
        self._requested_port = int(port)
        self._health_fn = health_fn or (lambda: (True, "ok"))
        self._status_fn = status_fn or (lambda: {})
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        #: the actually-bound port (ephemeral requests resolve at start)
        self.port: Optional[int] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MetricsHTTPServer":
        if self._httpd is not None:
            return self
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            # scrapes are high-frequency; stdlib's per-request stderr
            # line would drown real logs
            def log_message(self, fmt, *args):  # noqa: ARG002
                pass

            def _reply(self, status: int, body: str,
                       ctype: str = "text/plain; charset=utf-8"):
                data = body.encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802  (stdlib handler contract)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        status, body, ctype = (
                            200, _monitor.REGISTRY.to_prometheus(),
                            "text/plain; version=0.0.4; charset=utf-8")
                    elif path == "/healthz":
                        ok, state = outer._health_fn()
                        status, body, ctype = (
                            200 if ok else 503, state + "\n",
                            "text/plain; charset=utf-8")
                    elif path == "/statusz":
                        status, body, ctype = (
                            200,
                            json.dumps(outer._status_fn(), indent=1,
                                       sort_keys=True, default=str),
                            "application/json")
                    else:
                        status, body, ctype = (
                            404, "not found\n",
                            "text/plain; charset=utf-8")
                except Exception as e:   # a provider bug must answer,
                    status, body, ctype = (  # not hang the scraper
                        500, f"internal error: {e!r}\n",
                        "text/plain; charset=utf-8")
                known = path if path in ("/metrics", "/healthz",
                                         "/statusz") else "other"
                # unknown paths share one label: a scanner probing
                # random URLs must not grow the registry unbounded
                HTTP_REQ_CTR.inc(1, path=known, status=str(status))
                try:
                    self._reply(status, body, ctype)
                except (BrokenPipeError, ConnectionError):
                    pass             # scraper went away mid-reply

        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pt-metrics-http",
            daemon=True)
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        if self.port is None:
            raise RuntimeError("metrics HTTP server not started")
        # a wildcard bind is not a dialable address — hand back loopback
        host = "127.0.0.1" if self._host in ("", "0.0.0.0", "::") \
            else self._host
        return f"http://{host}:{self.port}"

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        # .url after stop must raise "not started", not hand out a dead
        # address an unrelated process may have re-bound by now
        self.port = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
