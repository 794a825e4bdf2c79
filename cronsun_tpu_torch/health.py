"""Health endpoints for the TCP servers (store, logd, sched).

Every server binary grows ``--health-port``: a tiny HTTP listener
serving

- ``GET /healthz`` — liveness: the process is up and serving its
  accept loop (always 200 once bound);
- ``GET /readyz``  — readiness: every registered check passes; 503
  with a JSON body NAMING the failing check otherwise
  (``{"ok": false, "checks": {"wal": {"ok": false, "detail": ...}}}``).

The web tier serves the same two routes on its existing HTTP port
(web/server.py readyz documents the shared contract); this module is
the twin for the line-JSON servers, which have no HTTP surface of
their own.  Checks are callables returning ``(ok, detail)`` — raising
counts as failing with the exception text as the detail.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from . import log

Check = Callable[[], Tuple[bool, str]]


def run_checks(checks: Dict[str, Check]) -> dict:
    out = {}
    for name, fn in checks.items():
        try:
            ok, detail = fn()
        except Exception as e:  # noqa: BLE001 — a raising check fails
            ok, detail = False, f"{type(e).__name__}: {e}"
        out[name] = {"ok": bool(ok), "detail": detail}
    return out


def wal_writable_check(path: Optional[str]) -> Check:
    """Shared readiness check: the server's WAL/DB sidecar directory
    still accepts writes (disk full / remount-ro are the outages this
    catches).  ``path`` None (in-memory server) always passes."""
    def check():
        if not path or path == ":memory:":
            return True, "in-memory"
        import os
        d = os.path.dirname(os.path.abspath(path)) or "."
        probe = os.path.join(d, f".cronsun-health-{os.getpid()}")
        with open(probe, "w") as f:
            f.write("ok")
        os.unlink(probe)
        return True, ""
    return check


def tcp_accept_check(host: str, port: int,
                     timeout: float = 2.0) -> Check:
    """Shared readiness check: the (possibly native) server still
    accepts TCP connections on its serving port."""
    def check():
        import socket
        with socket.create_connection((host, port), timeout=timeout):
            return True, ""
    return check


class HealthServer:
    """Serve /healthz + /readyz on ``port`` (0 picks a free port)."""

    def __init__(self, checks: Dict[str, Check],
                 host: str = "127.0.0.1", port: int = 0):
        self.checks = dict(checks)
        self.host, self.port = host, port
        self._httpd: Optional[ThreadingHTTPServer] = None

    def add_check(self, name: str, fn: Check):
        self.checks[name] = fn

    def start(self) -> "HealthServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.split("?")[0] == "/healthz":
                    body, status = {"ok": True}, 200
                elif self.path.split("?")[0] == "/readyz":
                    checks = run_checks(server.checks)
                    ok = all(c["ok"] for c in checks.values())
                    body = {"ok": ok, "checks": checks}
                    status = 200 if ok else 503
                else:
                    body, status = {"error": "no such route"}, 404
                payload = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="health-server").start()
        log.infof("health endpoints on %s:%d (/healthz /readyz)",
                  self.host, self.port)
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
