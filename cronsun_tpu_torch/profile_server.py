"""Live profiler captures over HTTP: the scheduler's ``--profile-port``.

The counterpart of the reference's ``jax.profiler.start_server``, which
serves the TSL profiler's gRPC service to TensorBoard.  This server
answers one route::

    GET /capture?ms=N[&stack=1]

It runs one ``torch.profiler`` session for ``N`` ms (1..60000) over every
thread of the process and answers with the session's Chrome trace,
gzip-compressed (``Content-Type: application/gzip``), for Perfetto or
TensorBoard::

    curl -o trace.json.gz 'http://HOST:P/capture?ms=2000'

- Activities: the CPU, plus CUDA when the server's device is the card.
- Every thread is profiled (``profile_all_threads``): the capture runs on
  the server's own request thread, while the planner's ranges
  (``cronsun.plan.dispatch``, ``cronsun.fire_mask``, ...) run on the
  service's step, dispatch and build threads.  A session opened on one
  thread records nothing of the others without it.
- ``stack=1`` adds Python frames (``with_stack``): that is what splits a
  span of the service's host code.
- 400 for an ``ms`` or ``stack`` out of range; 404 for any other path;
  409 while another capture runs or another profiler is active in the
  process; 500 when a capture on the card recorded no device activity
  (CUPTI unavailable, or no device work in the window): a CPU-only trace
  is never passed off as whole.
- The trace is spooled: exported to a temporary file, compressed into a
  second one while the first is read, and streamed from it, so no copy
  of a trace of hundreds of MB is held in memory.

Response headers beside the body: ``X-Export-Seconds`` (from the
session's end, its stop included, to a compressed file),
``X-Capture-Thread`` (the native id of the thread that held the session,
so a client can tell the server's events from the service's).

Cost: a session's stop and export hold the interpreter, so every thread
of the process waits for them.  With ``stack=1`` on a busy scheduler that
is long: a 40 s stacked session of a scheduler of 1M jobs x 10240 nodes
on an H100 host took 324 s from its end to the compressed trace (10.6M
events, 225 MB of gzip), and the scheduler's store calls timed out
meanwhile; without stacks the same process exported 12 s in 0.76 s
(``PERF.md`` §5).  A session's Python frames cover the threads that
existed when it began.
"""

from __future__ import annotations

import gzip
import os
import re
import shutil
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from . import log

MAX_MS = 60_000
# a device event's category in kineto's Chrome trace
_DEVICE_EVENT = re.compile(rb'"cat":\s*"(?:kernel|gpu_memcpy|gpu_memset)"')
_CHUNK = 1 << 20


class CaptureError(Exception):
    """A capture refused or failed: ``status`` is the HTTP answer."""

    def __init__(self, status: int, reason: str):
        super().__init__(reason)
        self.status = status


def _spool(raw_path: str, gz_path: str) -> int:
    """Gzip ``raw_path`` into ``gz_path`` chunk by chunk; returns the
    device events seen on the way (0 or more)."""
    seen, tail = 0, b""
    with open(raw_path, "rb") as src, \
            gzip.open(gz_path, "wb", compresslevel=1) as dst:
        while True:
            chunk = src.read(_CHUNK)
            if not chunk:
                return seen
            dst.write(chunk)
            if not seen:
                # a match may straddle two chunks: search the seam too
                seen = len(_DEVICE_EVENT.findall(tail + chunk))
                tail = chunk[-64:]


class _HTTPServer(ThreadingHTTPServer):
    # request threads are joined by server_close, so stop() leaves none
    daemon_threads = False
    block_on_close = True


class ProfileServer:
    """Serve ``/capture`` on ``port`` (0 picks a free one) on every
    interface, from a daemon thread, for a process whose planner is on
    ``device``.  Binding happens here: a port in use raises ``OSError``."""

    def __init__(self, port: int, device):
        self.device = torch.device(device)
        self._busy = threading.Lock()
        self._stopping = threading.Event()
        self._httpd = _HTTPServer(("", port), self._handler())
        if self.device.type == "cuda":
            # a process's first kineto session sets CUPTI up, which can
            # take seconds: pay it here, so that a capture records the
            # window its client asked for
            from torch.profiler import ProfilerActivity, profile
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]):
                    pass
            except BaseException:
                self._httpd.server_close()
                raise
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="profile-server")
        self._thread.start()

    def capture(self, ms: int, stack: bool) -> "tuple[str, float]":
        """One session of ``ms`` ms; returns the path of the gzip Chrome
        trace (the caller deletes it) and the seconds from the session's
        end (its stop included) to that file."""
        if not self._busy.acquire(blocking=False):
            raise CaptureError(409, "a capture is already running")
        try:
            return self._capture(ms, stack)
        finally:
            self._busy.release()

    def _capture(self, ms, stack):
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import profiler as autograd_profiler
        from torch.profiler import ProfilerActivity, profile
        # the process-wide flag every torch.profiler session sets: a
        # second kineto session started beside a live one ends both
        # (torch._C._autograd._profiler_enabled() sees only this thread)
        if autograd_profiler._is_profiler_enabled:
            raise CaptureError(409, "another profiler is active")
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts, with_stack=stack,
                       experimental_config=_ExperimentalConfig(
                           profile_all_threads=True))
        try:
            prof.start()
        except RuntimeError as e:
            # kineto admits one session per process
            raise CaptureError(409, f"another profiler is active: {e}")
        try:
            self._stopping.wait(ms / 1e3)
        finally:
            t0 = time.perf_counter()
            prof.stop()
        if self._stopping.is_set():
            raise CaptureError(503, "the server is stopping")
        fd, raw = tempfile.mkstemp(prefix="cronsun-capture-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(raw)
            del prof
            fd, gz = tempfile.mkstemp(prefix="cronsun-capture-",
                                      suffix=".json.gz")
            os.close(fd)
            try:
                device_events = _spool(raw, gz)
            except BaseException:
                os.unlink(gz)
                raise
        finally:
            os.unlink(raw)
        if self.device.type == "cuda" and not device_events:
            os.unlink(gz)
            raise CaptureError(500, "the capture recorded no CUDA activity "
                                    "(CUPTI unavailable, or the card idle "
                                    "for the whole window); a CPU-only "
                                    "trace is not returned")
        return gz, time.perf_counter() - t0

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            timeout = 60     # a client that stops reading cannot wedge stop()

            def log_message(self, *a):
                pass

            def _fail(self, status, reason):
                body = (reason + "\n").encode()
                self.send_response(status)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urllib.parse.urlsplit(self.path)
                if url.path != "/capture":
                    return self._fail(404, "no such route; GET /capture?ms=N")
                q = urllib.parse.parse_qs(url.query)
                try:
                    ms = int(q.get("ms", [""])[-1])
                except ValueError:
                    ms = 0
                stack = q.get("stack", ["0"])[-1]
                if not 1 <= ms <= MAX_MS or stack not in ("0", "1"):
                    return self._fail(400, f"want ms in 1..{MAX_MS} and "
                                           f"stack 0 or 1")
                try:
                    gz, export_s = server.capture(ms, stack == "1")
                except CaptureError as e:
                    log.warnf("profile capture refused (%d): %s",
                              e.status, e)
                    return self._fail(e.status, str(e))
                except Exception as e:  # noqa: BLE001 — export, disk
                    log.errorf("profile capture failed: %r", e)
                    return self._fail(500, f"{type(e).__name__}: {e}")
                try:
                    size = os.path.getsize(gz)
                    log.infof("profile capture: %d ms%s, %d bytes gzip, "
                              "exported in %.2f s", ms,
                              " with stacks" if stack == "1" else "", size,
                              export_s)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/gzip")
                    self.send_header("Content-Length", str(size))
                    self.send_header(
                        "Content-Disposition", "attachment; filename="
                        f'"cronsun-{os.getpid()}-{int(time.time())}'
                        '.json.gz"')
                    self.send_header("X-Export-Seconds", f"{export_s:.3f}")
                    self.send_header("X-Capture-Thread",
                                     str(threading.get_native_id()))
                    self.end_headers()
                    with open(gz, "rb") as f:
                        shutil.copyfileobj(f, self.wfile, _CHUNK)
                finally:
                    os.unlink(gz)

        return Handler

    def stop(self):
        """End a running capture, stop serving and join every thread."""
        self._stopping.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()
