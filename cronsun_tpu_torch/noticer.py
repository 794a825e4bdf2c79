"""Failure notification (reference noticer.go).

Agents put JSON messages under /cronsun/noticer/<node>; a Noticer hosted by
the web process watches the prefix and delivers — by SMTP (connection kept
alive between sends, closed after ``keepalive`` idle seconds,
noticer.go:70-104) or by POSTing to an HTTP API (noticer.go:114-145).
Node-death monitoring (noticer.go:172-200): a DELETE of a node key whose
result-store mirror still says alive means a crash, not a clean shutdown —
that also produces a notice.

Copy of ``cronsun_tpu/noticer.py``.
"""

from __future__ import annotations

import json
import smtplib
import threading
import time
import urllib.request
from email.mime.text import MIMEText
from typing import Callable, List, Optional

from .core import Keyspace
from .core.backoff import NOTICER
from .core.errors import is_error
from . import log
from .logsink import JobLogStore
from .store.memstore import DELETE, MemStore, WatchLost


class Notice:
    def __init__(self, subject: str, body: str, to: Optional[List[str]] = None):
        self.subject = subject
        self.body = body
        self.to = to or []


class MailNoticer:
    """SMTP sender with a kept-alive connection."""

    def __init__(self, host: str, port: int, user: str, password: str,
                 default_to: List[str], keepalive: int = 30,
                 use_tls: bool = True):
        self.host, self.port = host, port
        self.user, self.password = user, password
        self.default_to = default_to
        self.keepalive = keepalive
        self.use_tls = use_tls
        self._conn: Optional[smtplib.SMTP] = None
        self._last_send = 0.0
        self._lock = threading.Lock()

    def _connect(self) -> smtplib.SMTP:
        conn = smtplib.SMTP(self.host, self.port, timeout=10)
        if self.use_tls:
            conn.starttls()
        if self.user:
            conn.login(self.user, self.password)
        return conn

    def send(self, notice: Notice):
        to = notice.to or self.default_to
        if not to:
            return
        msg = MIMEText(notice.body)
        msg["Subject"] = notice.subject
        msg["From"] = self.user
        msg["To"] = ", ".join(to)
        with self._lock:
            if self._conn is None:
                self._conn = self._connect()
            try:
                self._conn.sendmail(self.user, to, msg.as_string())
            except smtplib.SMTPException:
                self._conn = self._connect()     # reconnect once
                self._conn.sendmail(self.user, to, msg.as_string())
            self._last_send = time.time()

    def idle_check(self):
        """Close the cached connection after ``keepalive`` idle seconds."""
        with self._lock:
            if self._conn is not None and \
                    time.time() - self._last_send > self.keepalive:
                try:
                    self._conn.quit()
                except smtplib.SMTPException:
                    pass
                self._conn = None


class HttpNoticer:
    """POST the notice as JSON to an HTTP API (noticer.go:114-145)."""

    def __init__(self, url: str):
        self.url = url

    def send(self, notice: Notice):
        payload = json.dumps({"subject": notice.subject, "body": notice.body,
                              "to": notice.to}).encode()
        req = urllib.request.Request(
            self.url, data=payload, method="POST",
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=10)


class _Pending:
    """A notice awaiting (re)delivery.  ``key`` is the store key deleted
    on success (None for synthesized node-death alerts); ``on_success``
    runs exactly once after the first successful send."""

    def __init__(self, notice: Notice, key: Optional[str],
                 on_success: Optional[Callable[[], None]]):
        self.notice = notice
        self.key = key
        self.on_success = on_success
        self.attempts = 0
        self.next_at = 0.0


class NoticerHost:
    """Watches the noticer prefix + node deaths; fans out to a sender.

    Delivery is durable: the noticer store key is deleted only after a
    successful send (the reference deletes the etcd key after SMTP
    delivery, noticer.go:147-170).  A failed send stays queued with
    exponential backoff (capped at RETRY_CAP seconds), and because the key
    survives, a noticer restart re-lists and re-delivers via resync()."""

    RETRY_CAP = NOTICER.cap     # schedule lives in core.backoff.NOTICER

    def __init__(self, store: MemStore, sink: JobLogStore, sender,
                 ks: Optional[Keyspace] = None):
        self.store = store
        self.sink = sink
        self.sender = sender
        self.ks = ks or Keyspace()
        self._open_watches()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sent: List[Notice] = []     # for introspection/tests
        self._pending: dict = {}         # dedupe-key -> _Pending

    def _open_watches(self):
        self._w_notice = self.store.watch(self.ks.noticer)
        self._w_nodes = self.store.watch(self.ks.node)

    def _alert_node_down(self, nid: str) -> int:
        """Queue the crash alert; the mirror is marked dead only once the
        alert is actually delivered, so a crash of *this* process before
        delivery leaves the mirror alive and the next resync re-alerts.
        The dedupe key stops the level-triggered resync check from
        queueing the same crash twice while delivery is pending."""
        return self._submit(
            Notice(f"[cronsun] node [{nid}] down",
                   f"node {nid} lease expired without clean shutdown"),
            dedupe=f"nodedown/{nid}",
            on_success=lambda: self._mark_down_if_still_gone(nid))

    def _mark_down_if_still_gone(self, nid: str):
        """Delivery can lag crash detection by a long retry outage; if
        the node re-registered meanwhile, leave the mirror alive — a
        wrong dead flag here would swallow the alert for its NEXT real
        crash (both poll and resync gate on mirror alived)."""
        try:
            if self.store.get(self.ks.node_key(nid)) is not None:
                return
            self.sink.set_node_alived(nid, False)
        except Exception as e:  # noqa: BLE001 — can't verify / can't mark:
            # keep the mirror alive; the next resync re-checks (a stale
            # alive flag re-alerts, a wrong dead flag swallows alerts)
            log.warnf("node-down mirror mark for %s skipped: %s", nid, e)

    def poll(self) -> int:
        try:
            return self._poll_once()
        except Exception as e:  # noqa: BLE001 — a transient store/sink
            # outage (e.g. the remote result store briefly unreachable)
            # must not kill the noticer thread: alerts stay queued/keyed
            # and the next poll retries
            if not is_error(e, WatchLost):
                log.errorf("noticer poll failed (retrying next poll): %s",
                           e)
                return 0
            log.warnf("noticer watch lost (%s); resynchronizing", e)
            try:
                return self.resync()
            except Exception as e2:  # noqa: BLE001
                log.errorf("noticer resync failed (retrying next poll): %s",
                           e2)
                return 0

    def resync(self) -> int:
        """Re-watch and queue any pending notices from a re-list (keys
        are deleted only after successful delivery, so the re-list sees
        everything undelivered; the dedupe key makes re-queueing a
        no-op for notices already awaiting retry).  Node-death events
        inside the lost window are recovered by checking the alived
        mirror against the current node list."""
        for w in (self._w_notice, self._w_nodes):
            try:
                w.close()
            except Exception:   # noqa: BLE001
                pass
        self._open_watches()
        n = 0
        for kv in self.store.get_prefix(self.ks.noticer):
            notice = self._parse(kv.value)
            if notice is not None:
                n += self._submit(notice, key=kv.key)
        # nodes the mirror says are alive but whose lease key vanished
        # during the gap died uncleanly
        live = {kv.key[len(self.ks.node):]
                for kv in self.store.get_prefix(self.ks.node)}
        for mirror in self.sink.get_nodes():
            nid = mirror.get("id")
            if mirror.get("alived") and nid not in live:
                n += self._alert_node_down(nid)
        return n

    def _poll_once(self) -> int:
        n = self._retry_due()
        for ev in self._w_notice.drain():
            if ev.type == DELETE:
                continue
            notice = self._parse(ev.kv.value)
            if notice is not None:
                n += self._submit(notice, key=ev.kv.key)
        for ev in self._w_nodes.drain():
            if ev.type != DELETE:
                continue
            node_id = ev.kv.key[len(self.ks.node):]
            mirror = self.sink.get_node(node_id)
            if mirror and mirror.get("alived"):
                # lease expired but the node never said goodbye: a fault
                # (reference node.go:93-102 ISNodeFault)
                n += self._alert_node_down(node_id)
        return n

    @staticmethod
    def _parse(value: str) -> Optional[Notice]:
        try:
            d = json.loads(value)
        except json.JSONDecodeError:
            return None
        return Notice(d.get("subject", ""), d.get("body", ""), d.get("to"))

    def _submit(self, notice: Notice, key: Optional[str] = None,
                dedupe: Optional[str] = None,
                on_success: Optional[Callable[[], None]] = None) -> int:
        """Attempt delivery now; on failure park in the retry queue.
        A notice already parked under the same key is *replaced*, not
        dropped: agents overwrite one per-node noticer key
        (node/agent.py), so the store itself only retains the latest
        value — delivering the stale parked one and deleting the key
        would silently lose the newer notice."""
        dk = dedupe or key or f"anon/{id(notice)}"
        parked = self._pending.get(dk)
        if parked is not None:
            parked.notice = notice            # latest wins, keep backoff
            return 0
        p = _Pending(notice, key, on_success)
        if self._attempt(p):
            return 1
        self._pending[dk] = p
        return 0

    def _attempt(self, p: _Pending) -> bool:
        try:
            self.sender.send(p.notice)
        except Exception as e:  # noqa: BLE001 — notification must not crash
            p.attempts += 1
            backoff = NOTICER.delay(p.attempts)
            p.next_at = time.time() + backoff
            log.errorf("noticer send failed (attempt %d, retry in %.1fs): %s",
                       p.attempts, backoff, e)
            return False
        self.sent.append(p.notice)
        if p.key is not None:
            try:
                self.store.delete(p.key)
            except Exception as e:  # noqa: BLE001 — redelivery beats loss
                log.warnf("noticer key %r delete failed: %s", p.key, e)
        if p.on_success is not None:
            p.on_success()
        return True

    def _retry_due(self) -> int:
        now = time.time()
        n = 0
        for dk, p in list(self._pending.items()):
            if p.next_at <= now and self._attempt(p):
                self._pending.pop(dk, None)
                n += 1
        return n

    def start(self):
        def run():
            while not self._stop.wait(0.5):
                try:
                    self.poll()
                    if hasattr(self.sender, "idle_check"):
                        self.sender.idle_check()
                except Exception as e:  # noqa: BLE001 — never die silently
                    log.errorf("noticer loop error: %s", e)
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="noticer")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3)
