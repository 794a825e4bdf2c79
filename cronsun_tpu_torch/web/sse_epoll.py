"""Event-driven SSE writer: a fixed pool of epoll loops replaces
thread-per-connection.

The threaded writer parks one Python thread per viewer in
``SseClient.take``; at 8 KiB of interpreter state plus a kernel stack
per thread the CPU host tops out near 1k viewers per replica.  This
module moves the write side onto ``selectors`` (epoll on Linux): a
small fixed pool of writer loops owns every SSE socket non-blocking,
so 50k idle connections cost 50k registered fds and ZERO threads.

Ownership and ordering:

- Each connection is adopted by exactly ONE loop at accept time and
  never migrates, so all writes to a socket happen on one thread —
  frames cannot reorder or interleave.  Per-event bytes come from the
  shared frame memo (``push.event_frame_tail``): serialize once,
  concatenate a per-viewer ``id:`` line, write to N sockets.
- Outbound bytes sit in a per-connection ring of WHOLE frames bounded
  by ``CRONSUN_SSE_SENDBUF`` bytes.  A viewer that stops reading first
  fills its kernel socket buffer (sendmsg -> EAGAIN, the loop arms
  EPOLLOUT and drains on writability), then overflows the ring: the
  backlog is dropped whole-frame (a partially sent frame's remainder
  is kept — the stream never tears mid-frame), ``lost`` is latched —
  the same terminal contract as the event-queue overflow — and the
  socket closes once the terminal frame drains.
- Heartbeats are swept from the loop tick: one ``monotonic()`` read
  per wakeup covers every idle connection the loop owns, instead of
  one per-connection timed condvar wait.

``SseClient`` stays the fan-out queue (cap / ``lost`` / ``stop``
semantics untouched); its ``signal`` hook wakes the owning loop via a
self-pipe.  The wire bytes are pinned byte-for-byte against the
threaded writer by tests/test_sse_epoll.py; ``CRONSUN_SSE_WRITER=
threads`` is the rollback switch.

Copy of ``cronsun_tpu/web/sse_epoll.py``.
"""

from __future__ import annotations

import os
import selectors
import threading
import time
from collections import deque
from itertools import islice
from typing import List, Optional

from ..metrics import LatencyRing
from .push import event_frame_tail

RETRY_PREAMBLE = b"retry: 3000\n\n"
LOST_FRAME = b"event: lost\ndata: {}\n\n"
BYE_FRAME = b"retry: 30000\nevent: bye\ndata: {}\n\n"
HB_FRAME = b": hb\n\n"

# sendmsg iovec batch bound: far below any real IOV_MAX (1024 on
# Linux) and large enough that a drain round trip covers a burst
_SENDMSG_MAX_BUFS = 64


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def _frame_for(client, ev) -> bytes:
    """Advance the viewer cursor and build its frame: the per-viewer
    ``id:`` line + the memoized shared tail.  Byte-identical to the
    threaded writer's ``SseStream._event_bytes``."""
    client.advance(ev[0])
    cursor = ",".join(str(v) for v in client.vec)
    return b"id: " + cursor.encode("ascii") + b"\n" + event_frame_tail(ev)


class _Conn:
    """One adopted viewer socket, owned by exactly one writer loop."""

    __slots__ = ("sock", "fd", "client", "frames", "queued", "off",
                 "last_out", "closing", "want_w", "sig_ts")

    def __init__(self, sock, client, now: float):
        self.sock = sock
        self.fd = sock.fileno()
        self.client = client
        self.frames: deque = deque()  # whole SSE frames, FIFO
        self.queued = 0               # ring occupancy in bytes
        self.off = 0                  # sent prefix of frames[0]
        self.last_out = now           # heartbeat clock (loop tick time)
        self.closing = False          # terminal frame queued: close on drain
        self.want_w = False           # EVENT_WRITE armed
        self.sig_ts = 0.0             # pending-signal stamp (loop lag)


class _WriterLoop(threading.Thread):
    def __init__(self, pool: "EpollSsePool", idx: int):
        super().__init__(daemon=True, name=f"sse-epoll-{idx}")
        self.pool = pool
        self.idx = idx
        self.sel = selectors.DefaultSelector()
        r, w = os.pipe()
        os.set_blocking(r, False)
        os.set_blocking(w, False)
        self._rpipe, self._wpipe = r, w
        self.sel.register(r, selectors.EVENT_READ, None)
        self.mu = threading.Lock()
        self._adds: list = []       # (sock, client, init_frames)
        self._signaled: list = []   # _Conn with fresh queue state
        self.conns: dict = {}       # fd -> _Conn (loop thread only)
        self.nconns = 0             # adopted minus closed (cross-thread)
        self.lag = LatencyRing(cap=512)
        self._stopping = False
        self._last_sweep = 0.0

    # ---- cross-thread surface (HTTP handlers, push fan-out) --------------

    def wake(self):
        try:
            os.write(self._wpipe, b"\0")
        except (BlockingIOError, OSError):
            pass  # full pipe == wakeup already pending; closed == stopping

    def adopt(self, sock, client, init_frames: List[bytes]):
        with self.mu:
            self._adds.append((sock, client, init_frames))
            self.nconns += 1
        self.wake()

    def signal(self, conn: _Conn):
        """This viewer's queue changed (push / lost / stop)."""
        with self.mu:
            if conn.sig_ts == 0.0:
                conn.sig_ts = time.monotonic()
                self._signaled.append(conn)
        self.wake()

    def stop(self):
        self._stopping = True
        self.wake()

    # ---- the loop --------------------------------------------------------

    def run(self):
        hb = self.pool.heartbeat
        # one clock read per tick covers every idle conn this loop
        # owns; hb/4 granularity keeps the worst-case extra delay a
        # quarter beat (the threaded writer's condvar was exact, but
        # nothing on the wire contract depends on heartbeat phase)
        tick = min(1.0, max(0.05, hb / 4.0)) if hb > 0 else 1.0
        while not self._stopping:
            try:
                events = self.sel.select(timeout=tick)
            except OSError:
                events = []
            now = time.monotonic()
            for key, mask in events:
                if key.data is None:
                    self._drain_pipe()
                    continue
                conn = key.data
                if self.conns.get(conn.fd) is not conn:
                    continue
                if mask & selectors.EVENT_READ:
                    if not self._on_readable(conn):
                        continue
                if mask & selectors.EVENT_WRITE:
                    self._drain(conn, now)
            with self.mu:
                adds, self._adds = self._adds, []
                sigs, self._signaled = self._signaled, []
            for sock, client, init_frames in adds:
                self._register(sock, client, init_frames, now)
            for conn in sigs:
                with self.mu:
                    ts, conn.sig_ts = conn.sig_ts, 0.0
                if self.conns.get(conn.fd) is not conn:
                    continue
                if ts:
                    self.lag.add((now - ts) * 1000.0)
                self._pump(conn, now)
            if hb > 0 and now - self._last_sweep >= tick:
                self._last_sweep = now
                for conn in list(self.conns.values()):
                    if (not conn.closing and not conn.frames
                            and now - conn.last_out >= hb):
                        conn.frames.append(HB_FRAME)
                        conn.queued += len(HB_FRAME)
                        self._drain(conn, now)
        self._shutdown()

    def _drain_pipe(self):
        try:
            while os.read(self._rpipe, 4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _register(self, sock, client, init_frames, now: float):
        try:
            sock.setblocking(False)
            conn = _Conn(sock, client, now)
        except OSError:
            self._dispose(sock, client)
            return
        conn.frames.extend(init_frames)
        conn.queued = sum(len(f) for f in init_frames)
        try:
            self.sel.register(sock, selectors.EVENT_READ, conn)
        except (OSError, ValueError, KeyError):
            self._dispose(sock, client)
            return
        self.conns[conn.fd] = conn
        client.signal = (lambda loop=self, c=conn: loop.signal(c))
        # events that raced the handoff are sitting in the client
        # queue with no signal armed — pump once unconditionally
        self._pump(conn, now)

    def _on_readable(self, conn: _Conn) -> bool:
        """EVENT_READ on an SSE socket: either the browser went away
        (recv -> b"", the threaded writer only noticed at the next
        write) or it sent bytes we don't serve (ignored)."""
        try:
            d = conn.sock.recv(4096)
        except (BlockingIOError, InterruptedError):
            return True
        except OSError:
            self._close(conn)
            return False
        if not d:
            self._close(conn)
            return False
        return True

    def _pump(self, conn: _Conn, now: float):
        """Move queued events from the SseClient into the outbound
        ring as frames, append terminal frames, then drain."""
        if conn.closing:
            return
        evs, state = conn.client.take(timeout=0)
        if evs:
            frames = [_frame_for(conn.client, ev) for ev in evs]
            total = sum(len(f) for f in frames)
            if conn.queued + total > self.pool.sendbuf:
                self._evict(conn, now)
                return
            conn.frames.extend(frames)
            conn.queued += total
        if state == "lost":
            conn.frames.append(LOST_FRAME)
            conn.queued += len(LOST_FRAME)
            conn.closing = True
        elif state == "closed":
            conn.frames.append(BYE_FRAME)
            conn.queued += len(BYE_FRAME)
            conn.closing = True
        if conn.frames:
            self._drain(conn, now)

    def _evict(self, conn: _Conn, now: float):
        """Ring overflow: this viewer's kernel buffer AND its ring are
        full — the epoll layer's slow-consumer backpressure.  Drop the
        backlog whole-frame (the sent prefix of frames[0] is kept so
        the byte stream never tears mid-frame), latch ``lost``, close
        once the terminal frame drains.  Same contract as the
        event-queue overflow: the viewer re-lists and resumes."""
        keep: Optional[bytes] = None
        if conn.off and conn.frames:
            keep = conn.frames[0]
        conn.frames.clear()
        conn.queued = 0
        if keep is not None:
            conn.frames.append(keep)
            conn.queued = len(keep)
        conn.frames.append(LOST_FRAME)
        conn.queued += len(LOST_FRAME)
        conn.closing = True
        conn.client.mark_lost()
        pm = self.pool.manager
        pm.count("ring_evictions_total")
        pm.count("dropped_slow_total")
        pm.count("client_lost_total")
        self._drain(conn, now)

    def _drain(self, conn: _Conn, now: float):
        """Coalesced vectored write: every queued frame rides one
        ``sendmsg`` per _SENDMSG_MAX_BUFS, so a wakeup that fanned a
        burst to this viewer costs one syscall, not one per event."""
        sock = conn.sock
        while conn.frames:
            if conn.off:
                bufs = [memoryview(conn.frames[0])[conn.off:]]
                bufs.extend(islice(conn.frames, 1, _SENDMSG_MAX_BUFS))
            else:
                bufs = list(islice(conn.frames, 0, _SENDMSG_MAX_BUFS))
            try:
                n = sock.sendmsg(bufs)
            except (BlockingIOError, InterruptedError):
                self._want_write(conn, True)
                return
            except OSError:
                self._close(conn)
                return
            if n <= 0:
                self._want_write(conn, True)
                return
            conn.last_out = now
            n += conn.off
            conn.off = 0
            while conn.frames and n >= len(conn.frames[0]):
                f = conn.frames.popleft()
                n -= len(f)
                conn.queued -= len(f)
            conn.off = n
        self._want_write(conn, False)
        if conn.closing:
            self._close(conn)

    def _want_write(self, conn: _Conn, want: bool):
        if conn.want_w == want:
            return
        conn.want_w = want
        ev = selectors.EVENT_READ | (selectors.EVENT_WRITE if want else 0)
        try:
            self.sel.modify(conn.sock, ev, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _close(self, conn: _Conn):
        if self.conns.get(conn.fd) is conn:
            del self.conns[conn.fd]
        conn.client.signal = None
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        conn.frames.clear()
        conn.queued = 0
        with self.mu:
            self.nconns -= 1
        self.pool.on_close(conn.sock)
        self.pool.manager.unregister(conn.client)

    def _dispose(self, sock, client):
        """Adoption failed (socket died in the handoff window)."""
        try:
            sock.close()
        except OSError:
            pass
        with self.mu:
            self.nconns -= 1
        self.pool.on_close(sock)
        self.pool.manager.unregister(client)

    def _shutdown(self):
        with self.mu:
            adds, self._adds = self._adds, []
            self._signaled = []
        for sock, client, _frames in adds:
            self._dispose(sock, client)
        for conn in list(self.conns.values()):
            self._close(conn)
        try:
            self.sel.unregister(self._rpipe)
        except (KeyError, ValueError, OSError):
            pass
        self.sel.close()
        for fd in (self._rpipe, self._wpipe):
            try:
                os.close(fd)
            except OSError:
                pass

    # ---- observability (cross-thread, racy-read tolerant) ----------------

    def queue_depth(self) -> tuple:
        for _ in range(3):
            try:
                conns = list(self.conns.values())
                break
            except RuntimeError:  # resized mid-iteration; retry
                conns = []
        return (sum(c.queued for c in conns),
                sum(len(c.frames) for c in conns))


class EpollSsePool:
    """The replica's writer pool: ``CRONSUN_SSE_LOOPS`` epoll loops
    (default 2) splitting adopted sockets least-connections."""

    def __init__(self, manager, nloops: Optional[int] = None,
                 sendbuf: Optional[int] = None, on_close=None):
        self.manager = manager
        self.heartbeat = manager.heartbeat
        self.nloops = max(1, nloops if nloops is not None
                          else _env_int("CRONSUN_SSE_LOOPS", 2))
        self.sendbuf = max(4096, sendbuf if sendbuf is not None
                           else _env_int("CRONSUN_SSE_SENDBUF", 262144))
        # transport hook: the HTTP layer forgets its claim on an
        # adopted socket when the pool closes it
        self.on_close = on_close or (lambda sock: None)
        self.loops = [_WriterLoop(self, i) for i in range(self.nloops)]
        for lp in self.loops:
            lp.start()

    def adopt(self, sock, client, replay: list):
        """Take ownership of an accepted SSE socket (headers already
        sent).  The preamble + replay are enqueued unbounded — the
        threaded writer wrote them synchronously whatever their size,
        and the replay is already page-bounded by PushManager.replay —
        then the least-loaded loop registers the socket."""
        frames = [RETRY_PREAMBLE]
        frames.extend(_frame_for(client, ev) for ev in replay)
        loop = min(self.loops, key=lambda lp: lp.nconns)
        loop.adopt(sock, client, frames)

    def stop(self, timeout: float = 2.0):
        for lp in self.loops:
            lp.stop()
        deadline = time.monotonic() + max(0.0, timeout)
        for lp in self.loops:
            lp.join(timeout=max(0.05, deadline - time.monotonic()))

    def stats(self) -> dict:
        """Flat numeric gauges for /v1/metrics (rendered under the
        ``cronsun_web_sse_`` prefix) + the per-loop connection counts
        (rendered with a ``loop`` label)."""
        samples: list = []
        qbytes = qframes = 0
        per_loop = []
        for lp in self.loops:
            per_loop.append(max(0, lp.nconns))
            samples.extend(lp.lag._v)
            b, f = lp.queue_depth()
            qbytes += b
            qframes += f
        merged = LatencyRing(cap=len(samples) or 1)
        for s in samples:
            merged.add(s)
        return {
            "writer_loops": self.nloops,
            "loop_lag_p50_ms": round(merged.percentile(0.50), 3),
            "loop_lag_p99_ms": round(merged.percentile(0.99), 3),
            "write_queue_bytes": qbytes,
            "write_queue_frames": qframes,
            "loop_connections": per_loop,
        }
