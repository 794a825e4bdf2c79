"""Shared line-JSON TCP plumbing for the two store servers.

The coordination store (store/remote.py) and the result store
(logsink/serve.py) speak the same transport: one JSON object per line,
``{"i", "o", "a"}`` requests, ``{"i", "r"}`` / ``{"i", "e"}`` replies,
and an optional first-frame shared-secret handshake.  This module holds
the pieces that must never drift apart — framing, the auth gate, and
the constant-time token comparison — so a protocol fix lands once.
"""

from __future__ import annotations

import hmac
import json
import socket
import socketserver
import ssl
import threading


def token_matches(presented, token: str) -> bool:
    """Constant-time token comparison over UTF-8 bytes.
    (``hmac.compare_digest`` on ``str`` raises TypeError for non-ASCII —
    an operator picking a token with an umlaut must not crash the auth
    path server-side.)"""
    return hmac.compare_digest(
        str(presented).encode("utf-8", "surrogatepass"),
        token.encode("utf-8", "surrogatepass"))


class LineJsonHandler(socketserver.BaseRequestHandler):
    """Base connection handler: line framing, locked writes, and the
    first-frame auth gate.  Subclasses implement ``dispatch(rid, op,
    args)`` (and may extend ``setup``/``finish``).  The server object
    must expose a ``token`` attribute ('' = open)."""

    # Per-connection WALL-CLOCK deadline on the TLS handshake plus (on
    # secured servers) the first auth frame: a client that connects and
    # stalls — or drip-feeds bytes to reset per-recv timeouts — must not
    # pin a handler thread forever.  Enforced by a watchdog timer that
    # shuts the raw socket down if the connection isn't authenticated by
    # the deadline (absolute, so partial progress never extends it).
    HANDSHAKE_TIMEOUT = 10.0

    def setup(self):
        self.wlock = threading.Lock()
        self.alive = True
        self.authed = False
        self._hs_lock = threading.Lock()
        self._hs_timer = None
        sslctx = getattr(self.server, "sslctx", None)
        if sslctx is not None or getattr(self.server, "token", ""):
            # watchdog only where a handshake can actually stall (TLS
            # and/or token servers) — open plaintext servers don't pay a
            # timer thread per accept.  The timer holds the FD NUMBER,
            # not the socket object: wrap_socket() detaches the raw
            # socket before the handshake, so an object reference would
            # go stale (EBADF) exactly when the deadline matters.
            fd = self.request.fileno()
            self._hs_timer = threading.Timer(self.HANDSHAKE_TIMEOUT,
                                             self._drop_unauthed, (fd,))
            self._hs_timer.daemon = True
            self._hs_timer.start()
        if sslctx is not None:
            # handshake runs here, in the per-connection thread (never in
            # the accept loop); a failed handshake — plaintext client,
            # wrong CA, missing client cert under mutual TLS — drops the
            # connection without killing the server
            try:
                self.request = sslctx.wrap_socket(self.request,
                                                  server_side=True)
            except (OSError, ssl.SSLError):
                self.alive = False
                self.rfile = None
                return
        self.rfile = self.request.makefile("rb")
        if not getattr(self.server, "token", ""):
            self._auth_ok()   # open (possibly TLS) server: TLS done, no
                              # auth frame to wait for

    def _auth_ok(self):
        with self._hs_lock:
            self.authed = True
            if self._hs_timer is not None:
                self._hs_timer.cancel()

    def _drop_unauthed(self, fd):
        """Watchdog body: sever an unauthenticated connection at the
        deadline.  Runs under the same lock as _auth_ok, and finish()
        marks the connection authed BEFORE socketserver closes the fd —
        so this can never shut down a recycled fd number."""
        with self._hs_lock:
            if self.authed:
                return
            self.alive = False
            try:
                s = socket.socket(fileno=fd)
            except OSError:
                return
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            finally:
                s.detach()   # fd still belongs to the connection

    def finish(self):
        self._auth_ok()   # retire the watchdog before the fd closes

    def _send(self, obj):
        data = (json.dumps(obj, separators=(",", ":")) + "\n").encode()
        with self.wlock:
            try:
                self.request.sendall(data)
            except OSError:
                self.alive = False

    def handle(self):
        if self.rfile is None:       # TLS handshake failed in setup
            return
        while self.alive:
            try:
                line = self.rfile.readline()
            except OSError:          # reset / TLS abort mid-read
                return
            if not line:
                return
            try:
                req = json.loads(line)
            except ValueError:
                # covers JSONDecodeError AND UnicodeDecodeError: binary
                # garbage (a TLS ClientHello against a plaintext port, a
                # port scanner) drops the connection, quietly
                return
            rid, op, args = req.get("i"), req.get("o"), req.get("a", [])
            if not self.authed:
                # first frame must authenticate; wrong token closes the
                # connection (the reference passes store credentials via
                # config, conf/conf.go:66-67, db/mgo.go:33-36)
                if op == "auth" and len(args) == 1 and \
                        token_matches(args[0], self.server.token):
                    self._auth_ok()                 # handshake complete
                    self._send({"i": rid, "r": True})
                    continue
                self._send({"i": rid, "e": "unauthenticated",
                            "k": "RuntimeError"})
                return
            if op == "auth":                 # no-op when unsecured
                self._send({"i": rid, "r": True})
                continue
            self.dispatch(rid, op, args)

    def dispatch(self, rid, op, args):  # pragma: no cover - abstract
        raise NotImplementedError
