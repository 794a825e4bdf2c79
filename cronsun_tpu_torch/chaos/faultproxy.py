"""TCP-level fault proxy for the line-JSON wire.

Sits in front of any store / logd / web address and injects network
faults without touching either endpoint — so the SAME drills run
against the Python servers and the native (C++) ones, and against
clients in either language.  Because every cronsun wire protocol is
newline-delimited JSON, the proxy forwards whole LINES: drop / dup /
reorder operate on protocol frames, never mid-record bytes (a split
line would corrupt the stream rather than simulate loss).  Plaintext
only — through TLS the proxy sees ciphertext and line faults would be
byte corruption, which the record layer already rejects loudly.

Faults (:class:`FaultRule.kind`):

``delay``      sleep ``ms`` before forwarding each matching line (the
               browned-out shard: alive but slow)
``drop``       swallow the line (lost request/reply)
``dup``        forward the line twice (duplicated delivery)
``reorder``    hold the line and emit it after the next one (swap)
``blackhole``  forward nothing while active (alive TCP, dead pipe)
``sever``      close every connection and refuse new ones while active

Rules carry a time window (``start``..``end`` seconds relative to
:meth:`FaultProxy.start`), a direction (``c2s``/``s2c``/``both``) and a
probability.  Determinism: a rule's per-line fire decision is a pure
hash of ``(schedule seed, rule id, connection seq, line ordinal)`` —
:func:`cronsun_tpu_torch.chaos.hooks.det01` — so a drill under a fixed seed
produces the SAME fault schedule every run;
:meth:`FaultSchedule.schedule_bytes` serializes the decisions for the
smoke test's byte-identity check.

Copy of ``cronsun_tpu/chaos/faultproxy.py``, whose :meth:`FaultProxy.stop`
leaves the accept thread blocked for the rest of the process (closing a
listening socket does not wake an ``accept`` in another thread); this one
shuts the socket down first and joins its threads.
"""

from __future__ import annotations

import select
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import log
from .hooks import det01

_KINDS = ("delay", "drop", "dup", "reorder", "blackhole", "sever")


class FaultRule:
    __slots__ = ("rule_id", "kind", "start", "end", "direction", "prob",
                 "ms")

    def __init__(self, rule_id: str, kind: str, start: float = 0.0,
                 end: Optional[float] = None, direction: str = "both",
                 prob: float = 1.0, ms: float = 0.0):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        if direction not in ("c2s", "s2c", "both"):
            raise ValueError(f"bad direction {direction!r}")
        self.rule_id = rule_id
        self.kind = kind
        self.start = start
        self.end = end          # None = until removed
        self.direction = direction
        self.prob = prob
        self.ms = ms

    def active(self, elapsed: float) -> bool:
        return elapsed >= self.start and \
            (self.end is None or elapsed < self.end)

    def matches(self, direction: str) -> bool:
        return self.direction == "both" or self.direction == direction

    def describe(self) -> str:
        end = "inf" if self.end is None else f"{self.end:.3f}"
        return (f"{self.rule_id}|{self.kind}|{self.start:.3f}|{end}|"
                f"{self.direction}|{self.prob:.6f}|{self.ms:.3f}")


class FaultSchedule:
    """An ordered rule set under one seed.  Pure data — the proxy
    evaluates it; tests serialize it."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rules: List[FaultRule] = []
        self._mu = threading.Lock()
        self._next = 0

    def add(self, kind: str, start: float = 0.0,
            end: Optional[float] = None, direction: str = "both",
            prob: float = 1.0, ms: float = 0.0) -> str:
        with self._mu:
            self._next += 1
            rid = f"r{self._next}-{kind}"
            self.rules.append(FaultRule(rid, kind, start, end, direction,
                                        prob, ms))
            return rid

    def remove(self, rule_id: str):
        with self._mu:
            self.rules = [r for r in self.rules if r.rule_id != rule_id]

    def clear(self):
        with self._mu:
            self.rules = []

    def snapshot(self) -> List[FaultRule]:
        with self._mu:
            return list(self.rules)

    def decide(self, rule: FaultRule, conn_seq: int, k: int,
               direction: str = "c2s") -> bool:
        """Does ``rule`` fire for line ordinal ``k`` of connection
        ``conn_seq`` in ``direction``?  Pure function of (seed, rule,
        conn, direction, k) — the direction is part of the key so a
        ``both`` rule's request and reply decisions are INDEPENDENT,
        not perfectly correlated."""
        if rule.prob >= 1.0:
            return True
        return det01(self.seed,
                     f"{rule.rule_id}/{conn_seq}/{direction}",
                     k) < rule.prob

    def schedule_bytes(self, conns: int = 4, lines: int = 256) -> bytes:
        """Canonical serialization of the rule set plus the first
        ``lines`` fire decisions (both directions) for the first
        ``conns`` connections — the determinism artifact: same seed,
        same bytes, every run and every process."""
        out = [f"seed={self.seed}"]
        for r in self.snapshot():
            out.append(r.describe())
            for c in range(conns):
                for d in ("c2s", "s2c"):
                    bits = "".join(
                        "1" if self.decide(r, c, k, d) else "0"
                        for k in range(lines))
                    out.append(f"  c{c}/{d}:{bits}")
        return ("\n".join(out) + "\n").encode()


class _Conn:
    __slots__ = ("seq", "client", "server", "alive")

    def __init__(self, seq, client, server):
        self.seq = seq
        self.client = client
        self.server = server
        self.alive = True

    def close(self):
        self.alive = False
        for s in (self.client, self.server):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class FaultProxy:
    """Forward ``listen`` -> ``target`` applying a :class:`FaultSchedule`.

    ``proxy = FaultProxy(("127.0.0.1", store_port), schedule).start()``
    then point the client at ``proxy.port``.  The schedule clock starts
    at :meth:`start` (override with ``epoch`` for multi-proxy drills
    that need one shared timeline).
    """

    def __init__(self, target: Tuple[str, int],
                 schedule: Optional[FaultSchedule] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 name: str = ""):
        self.target = target
        self.schedule = schedule or FaultSchedule()
        self.name = name or f"faultproxy->{target[0]}:{target[1]}"
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(64)
        self.host, self.port = self._lsock.getsockname()[:2]
        self._t0: Optional[float] = None
        self._stopped = False
        self._mu = threading.Lock()
        self._conns: List[_Conn] = []
        self._seq = 0
        self.stats: Dict[str, int] = {k: 0 for k in _KINDS}
        self.stats["conns"] = 0
        self._accept_thread: Optional[threading.Thread] = None
        self._monitor_thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self, epoch: Optional[float] = None) -> "FaultProxy":
        self._t0 = time.monotonic() if epoch is None else epoch
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name=self.name)
        self._accept_thread.start()
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name=self.name + "-mon")
        self._monitor_thread.start()
        return self

    def stop(self):
        self._stopped = True
        try:
            self._lsock.shutdown(socket.SHUT_RDWR)   # wakes the accept
        except OSError:
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._mu:
            conns, self._conns = self._conns, []
        for c in conns:
            c.close()
        for t in (getattr(self, "_accept_thread", None),
                  getattr(self, "_monitor_thread", None)):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=2.0)

    def elapsed(self) -> float:
        return 0.0 if self._t0 is None else time.monotonic() - self._t0

    # -- rule evaluation ---------------------------------------------------

    def _active(self, direction: str, kind: str) -> List[FaultRule]:
        el = self.elapsed()
        return [r for r in self.schedule.snapshot()
                if r.kind == kind and r.active(el) and
                r.matches(direction)]

    def _sever_active(self) -> bool:
        el = self.elapsed()
        return any(r.kind == "sever" and r.active(el)
                   for r in self.schedule.snapshot())

    def _bump(self, kind: str, n: int = 1):
        with self._mu:
            self.stats[kind] = self.stats.get(kind, 0) + n

    # -- data path ---------------------------------------------------------

    def _accept_loop(self):
        while not self._stopped:
            try:
                client, _addr = self._lsock.accept()
            except OSError:
                return
            if self._sever_active():
                self._bump("sever")
                try:
                    client.close()
                except OSError:
                    pass
                continue
            try:
                server = socket.create_connection(self.target, timeout=10)
            except OSError as e:
                log.warnf("%s: upstream connect failed: %s", self.name, e)
                try:
                    client.close()
                except OSError:
                    pass
                continue
            with self._mu:
                conn = _Conn(self._seq, client, server)
                self._seq += 1
                self._conns.append(conn)
                self.stats["conns"] += 1
            for src, dst, direction in ((client, server, "c2s"),
                                        (server, client, "s2c")):
                threading.Thread(
                    target=self._pump, args=(conn, src, dst, direction),
                    daemon=True,
                    name=f"{self.name}-{conn.seq}-{direction}").start()

    def _monitor(self):
        """Enforce window-activated severs on idle connections: a pump
        blocked in readline() can't notice the window opening."""
        was = False
        while not self._stopped:
            now = self._sever_active()
            if now and not was:
                with self._mu:
                    conns = list(self._conns)
                for c in conns:
                    c.close()
                self._bump("sever", len(conns))
            was = now
            time.sleep(0.05)

    # a held reorder line is flushed after this long if no successor
    # arrives — without the bound, holding the LAST line of a quiet
    # period delays that op until the connection's next traffic (an
    # rpc-timeout-shaped fault the schedule never asked for)
    REORDER_HOLD_S = 0.05

    def _pump(self, conn: _Conn, src: socket.socket, dst: socket.socket,
              direction: str):
        # manual framing (select + recv + split) instead of
        # file.readline(): the reorder hold needs an IDLE signal to
        # flush on, and it must come from select — a socket timeout
        # would also apply to the OPPOSITE pump's sendall into this
        # socket, turning ordinary backpressure into an unscripted
        # sever with a possibly PARTIAL line already written (the
        # mid-frame corruption this proxy promises never to produce)
        buf = bytearray()
        held: Optional[bytes] = None      # reorder slot
        k = 0

        def ship(data: bytes) -> bool:
            try:
                dst.sendall(data)
                return True
            except OSError:
                conn.close()
                return False

        try:
            eof = False
            while conn.alive and not self._stopped and not eof:
                try:
                    ready, _, _ = select.select([src], [], [],
                                                self.REORDER_HOLD_S)
                    if not ready:
                        if held is not None:   # idle: flush the hold
                            if not ship(held):
                                return
                            held = None
                        continue
                    data = src.recv(1 << 16)
                    if not data:
                        eof = True
                except (OSError, ValueError):
                    break
                buf += data
                while True:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    line = bytes(buf[:nl + 1])
                    del buf[:nl + 1]
                    k += 1
                    if self._sever_active():
                        self._bump("sever")
                        return
                    if self._active(direction, "blackhole"):
                        self._bump("blackhole")
                        continue
                    send = [line]
                    for r in self._active(direction, "drop"):
                        if self.schedule.decide(r, conn.seq, k, direction):
                            self._bump("drop")
                            send = []
                            break
                    if send:
                        for r in self._active(direction, "dup"):
                            if self.schedule.decide(r, conn.seq, k, direction):
                                self._bump("dup")
                                send.append(line)
                                break
                        for r in self._active(direction, "reorder"):
                            if self.schedule.decide(r, conn.seq, k, direction):
                                self._bump("reorder")
                                if held is None:
                                    held, send = send[0], send[1:]
                                break
                        for r in self._active(direction, "delay"):
                            if self.schedule.decide(r, conn.seq, k, direction):
                                self._bump("delay")
                                time.sleep(r.ms / 1000.0)
                                break
                    if held is not None and send:
                        send.append(held)  # held line AFTER this one
                        held = None
                    for data in send:
                        if not ship(data):
                            return
            # stream ending: flush the slot, then any partial tail
            if held is not None:
                if not ship(held):
                    return
            if buf:
                ship(bytes(buf))
        finally:
            conn.close()
            with self._mu:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass
