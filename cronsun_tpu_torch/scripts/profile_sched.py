"""Split a scheduler process's step from a live capture of its
``--profile-port``.

    python -m cronsun_tpu_torch.scripts.profile_sched [--jobs 1048576]
        [--nodes 10240] [--window 4] [--steps 2] [--ranges-ms 12000]
        [--stack-ms 30000] [--device cpu] [--out DIR]

Seeds an in-process ``MemStore`` with ``bench_sched``'s placement-realistic
deployment (``synth.seed_service_store``), serves it with the port's
``StoreServer``, and starts ``python -m cronsun_tpu_torch.bin.sched
--profile-port P`` against it (on the card unless ``--device cpu``).
Once the scheduler leads and ``--steps`` windows have landed past its
first, two captures are taken over HTTP, each opening a third of its
length before a minute boundary (where the deployment's herd second and
its overflow re-plan fall):

- ``ranges`` (``stack=0``): the planner's ``cronsun.*`` ranges and, on the
  card, the device's busy share and top operations, without the cost of
  a Python tracer; the scheduler's metrics snapshot (its span
  percentiles) is read after it;
- ``stacks`` (``stack=1``): Python frames of every thread, from which the
  step's spans split: ``step`` on the service's loop thread,
  ``drain_watches`` (``drain``), ``reconcile_capacity`` (``reconcile``),
  ``plan_window_async`` on the dispatch thread (``plan``) and
  ``_build_window`` on the build worker (``build``), each as a tree of the
  calls under it by total ms, with each node's own time (``self_ms``: its code,
  and waits in ``with`` blocks, which the tracer records as no call) and
  its longest calls.  Times under the tracer are inflated; compare
  shares.

The traces are parsed after the scheduler has stopped, since the parse
holds this process's interpreter and the store is served from here.

Prints one JSON line (also written to ``DIR/profile_sched.json``) with
both summaries, the scheduler's own span percentiles from its metrics
snapshot, and the card's name and power limit.  The traces are not kept.

The module also holds the client that ``chip_smoke.py`` uses:
:func:`fetch_capture` and :func:`capture_summary`.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

from .bench import ROOT, nvidia_smi_line

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# split roots: (label, Python function as the tracer names it, less its line)
_SERVICE, _PLANNER = ("cronsun_tpu_torch/sched/service.py: ",
                      "cronsun_tpu_torch/ops/planner.py: ")
ROOTS = (("step", _SERVICE + "step"),
         ("drain", _SERVICE + "drain_watches"),
         ("reconcile", _SERVICE + "reconcile_capacity"),
         ("plan", _PLANNER + "plan_window_async"),
         ("build", _SERVICE + "_build_window"))

Event = collections.namedtuple("Event", "cat key tid ts dur pyid parent")


def _key(name: str) -> str:
    """A frame's name less what varies between calls: the line the frame
    was on when the tracer met it, and a C method's object address."""
    return re.sub(r"\(\d+\): ", ": ", re.sub(r" at 0x[0-9a-f]+", "", name))


def iter_trace_events(path: str):
    """The ``traceEvents`` of a gzip Chrome trace, one dict at a time,
    without holding the whole document (a stacked capture runs to GBs)."""
    dec = json.JSONDecoder()
    with gzip.open(path, "rt") as f:
        buf, eof, i = "", False, -1
        while i < 0:
            chunk = f.read(1 << 20)
            if not chunk:
                raise ValueError("no traceEvents in the trace")
            buf += chunk
            m = re.search(r'"traceEvents"\s*:\s*\[', buf)
            if m:
                i = m.end()
            else:
                buf = buf[-64:]
        while True:
            while i < len(buf) and buf[i] in " \t\r\n,":
                i += 1
            if i < len(buf) and buf[i] == "]":
                return
            try:
                if i >= len(buf):
                    raise ValueError
                obj, j = dec.raw_decode(buf, i)
            except ValueError:
                if eof:
                    raise
                chunk = f.read(1 << 22)
                eof = not chunk
                buf, i = buf[i:] + chunk, 0
                continue
            yield obj
            i = j


def load_events(path: str) -> list:
    """The trace's complete ("X") events, compacted to :class:`Event`."""
    out = []
    for e in iter_trace_events(path):
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        out.append(Event(e.get("cat"), _key(e.get("name", "")), e.get("tid"),
                         float(e.get("ts", 0)), float(e.get("dur", 0)),
                         args.get("Python id"), args.get("Python parent id")))
    return out


def download_capture(host: str, port: int, ms: int, stack: bool,
                     path: str, timeout: float = 900.0) -> dict:
    """One ``GET /capture`` saved to ``path``; returns what the answer said
    of itself (compressed bytes, seconds from the session's end to its
    compressed trace, the server's thread) and the seconds it took."""
    t0 = time.perf_counter()
    url = f"http://{host}:{port}/capture?ms={ms}&stack={int(stack)}"
    with open(path, "wb") as out, \
            urllib.request.urlopen(url, timeout=timeout) as r:
        if r.headers["Content-Type"] != "application/gzip":
            raise ValueError(f"capture answered {r.headers['Content-Type']}")
        shutil.copyfileobj(r, out, 1 << 20)
        return {"gz_bytes": int(r.headers["Content-Length"]),
                "export_s": float(r.headers["X-Export-Seconds"]),
                "server_tid": int(r.headers["X-Capture-Thread"]),
                "request_s": time.perf_counter() - t0}


def fetch_capture(host: str, port: int, ms: int, stack: bool = False,
                  timeout: float = 900.0) -> "tuple[list, dict]":
    """:func:`download_capture` to a temporary file, then its events
    (:func:`load_events`)."""
    fd, path = tempfile.mkstemp(prefix="cronsun-capture-", suffix=".json.gz")
    os.close(fd)
    try:
        info = download_capture(host, port, ms, stack, path, timeout)
        return load_events(path), info
    finally:
        os.unlink(path)


def _top(durs: dict, n: int) -> list:
    return [{"name": k, "ms": v[0] / 1e3, "calls": v[1], "max_ms": v[2] / 1e3}
            for k, v in sorted(durs.items(), key=lambda kv: -kv[1][0])[:n]]


def _add(durs: dict, e: Event) -> None:
    d = durs.setdefault(e.key, [0.0, 0, 0.0])
    d[0] += e.dur
    d[1] += 1
    d[2] = max(d[2], e.dur)


def capture_summary(events: list, ms: int, n: int = 5) -> dict:
    """The device's busy share over the capture (the union of its kernels,
    copies and memsets over ``ms``), its top ``n`` operations and the top
    ``n`` host ranges (``record_function``) by total time (calls, total
    and longest ms), and on which threads each ``cronsun.*`` range ran."""
    dev, host = {}, {}
    spans = []
    range_tids = collections.defaultdict(set)
    for e in events:
        if e.cat in DEVICE_CATS:
            _add(dev, e)
            spans.append((e.ts, e.ts + e.dur))
        elif e.cat == "user_annotation":
            _add(host, e)
            range_tids[e.key].add(e.tid)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"device_busy_share": busy / (ms * 1e3),
            "device_events": len(spans),
            "top_device_ops": _top(dev, n), "top_host_ranges": _top(host, n),
            "range_threads": {k: sorted(v) for k, v in range_tids.items()
                              if k.startswith("cronsun.")}}


def split(events: list, root: str, depth: int = 3, top: int = 8) -> dict:
    """The calls of Python function ``root`` (a :func:`_key`) as a tree:
    for each node its calls, total and longest ms, own ms, and (to
    ``depth`` levels) its ``top`` heaviest callees by total ms; at the
    root also its threads and its five longest calls (ms, and ms from
    the capture's first event)."""
    kids = collections.defaultdict(list)
    roots = []
    for e in events:
        if e.cat != "python_function":
            continue
        if e.parent is not None:
            kids[e.parent].append(e)
        if e.key == root:
            roots.append(e)

    def node(calls, d):
        total = sum(c.dur for c in calls)
        by = collections.defaultdict(list)
        for c in calls:
            for k in kids.get(c.pyid, ()):
                by[k.key].append(k)
        out = {"calls": len(calls), "ms": total / 1e3,
               "max_ms": max(c.dur for c in calls) / 1e3,
               "self_ms": (total - sum(k.dur for ks in by.values()
                                       for k in ks)) / 1e3}
        if d > 0 and by:
            heavy = sorted(by.items(), key=lambda kv: -sum(
                k.dur for k in kv[1]))[:top]
            out["callees"] = {k: node(v, d - 1) for k, v in heavy}
        return out
    if not roots:
        return {"calls": 0}
    t0 = min(e.ts for e in events)
    out = node(roots, depth)
    out["threads"] = sorted({r.tid for r in roots})
    out["longest"] = [{"ms": r.dur / 1e3, "at_ms": (r.ts - t0) / 1e3}
                      for r in sorted(roots, key=lambda r: -r.dur)[:5]]
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(n_jobs, n_nodes, window_s, steps, ranges_ms, stack_ms, device,
        on_log=print, align=True) -> dict:
    """The module docstring's run; ``align`` False takes each capture at
    once instead of before a minute boundary."""
    from ..core import Keyspace
    from ..store import MemStore, RemoteStore, StoreServer
    from ..synth import seed_service_store
    ks = Keyspace()
    tmp = tempfile.mkdtemp(prefix="cronsun-profile-sched-")
    out = {"jobs": n_jobs, "nodes": n_nodes, "window_s": window_s,
           "device": device or "cuda"}
    server = client = proc = None
    lines = []
    try:
        t = time.perf_counter()
        store = MemStore()
        seed_service_store(store, ks, n_jobs, n_nodes, int(time.time()))
        server = StoreServer(store).start()
        client = RemoteStore(server.host, server.port, timeout=600)
        out["seed_s"] = time.perf_counter() - t
        on_log(f"seeded {n_jobs} jobs x {n_nodes} nodes in "
               f"{out['seed_s']:.1f} s")
        conf = os.path.join(tmp, "conf.json")
        with open(conf, "w") as f:
            # lock_ttl: no agent consumes the orders; bench_sched's 3600 s
            # keeps a mass expiry out of the measured steps
            json.dump({"window_s": window_s, "job_capacity": n_jobs,
                       "node_capacity": n_nodes, "lock_ttl": 3600,
                       "log_db": os.path.join(tmp, "unused.db")}, f)
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        t = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "cronsun_tpu_torch.bin.sched", "--store",
             f"{server.host}:{server.port}", "--conf", conf, "--node-id",
             "profiled", "--profile-port", str(port),
             *(["--device", device] if device else [])],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        ready = threading.Event()

        def drain():
            for line in proc.stdout:
                lines.append(line)
                if line.startswith("READY"):
                    ready.set()
        threading.Thread(target=drain, daemon=True).start()

        def wait(cond, timeout, what):
            deadline = time.perf_counter() + timeout
            while not cond():
                if proc.poll() is not None:
                    raise RuntimeError(f"the scheduler exited rc "
                                       f"{proc.returncode} before {what}:\n"
                                       + "".join(lines[-40:]))
                if time.perf_counter() > deadline:
                    raise RuntimeError(f"no {what} within {timeout} s")
                time.sleep(0.2)

        def hwm():
            kv = client.get(ks.hwm)
            return int(kv.value) if kv is not None else 0
        wait(ready.is_set, 1800, "READY")
        out["ready_s"] = time.perf_counter() - t
        on_log(f"READY in {out['ready_s']:.1f} s")
        wait(lambda: hwm() > 0, 900, "a first window")
        first = hwm()
        wait(lambda: hwm() >= first + steps * window_s,
             300 + 60 * steps * window_s, f"{steps} more windows")

        def take(name, ms, stack):
            """Download one capture that opens a third of its length
            before a minute boundary: the deployment's herd second and its
            overflow re-plan fall there."""
            now = time.time()
            at = (now // 60 + 1) * 60 - ms / 3e3
            if at < now + 1:
                at += 60
            time.sleep(at - now if align else 0)
            path = os.path.join(tmp, f"{name}.json.gz")
            info = download_capture("127.0.0.1", port, ms, stack, path)
            info.update(ms=ms, stack=stack)
            on_log(f"{name}: {info['gz_bytes']} bytes gzip, "
                   f"{info['export_s']:.1f} s from its end")
            return path, info
        # the stacked capture last: its stop holds the scheduler's
        # interpreter for a long while, which the snapshot must not see
        taken = [take("ranges", ranges_ms, False)] if ranges_ms else []
        kv = client.get(ks.metrics_key("sched", "profiled"))
        snap = json.loads(kv.value) if kv is not None else {}
        out["sched_snapshot"] = {k: v for k, v in snap.items() if k in (
            "steps_total", "sched_step_p50_ms", "sched_step_p99_ms",
            "overflow_late_fires_total") or k.startswith("step_span_")}
        if stack_ms:
            taken.append(take("stacks", stack_ms, True))
        proc.send_signal(signal.SIGTERM)
        out["sched_rc"] = proc.wait(timeout=600)
        out["nvidia_smi"] = nvidia_smi_line()
        # parsed once the scheduler is gone: the parse holds this
        # process's interpreter, and the store server lives here
        for path, info in taken:
            events = load_events(path)
            info.update(events=len(events),
                        **capture_summary(events, info["ms"]))
            if info["stack"]:
                info["split"] = {label: split(events, root)
                                 for label, root in ROOTS}
            out["stacks" if info["stack"] else "ranges"] = info
            del events
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        if client is not None:
            client.close()
        if server is not None:
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out["sched_log_tail"] = lines[-20:]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--jobs", type=int, default=1 << 20)
    ap.add_argument("--nodes", type=int, default=10240)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2,
                    help="windows to land past the first before capturing")
    ap.add_argument("--ranges-ms", type=int, default=12_000,
                    help="the stack=0 capture's ms (0 skips it)")
    ap.add_argument("--stack-ms", type=int, default=30_000,
                    help="the stack=1 capture's ms (0 skips it)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the scheduler's --device (default: the card)")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"),
                    help="directory of profile_sched.json")
    args = ap.parse_args(argv)
    res = run(args.jobs, args.nodes, args.window, args.steps, args.ranges_ms,
              args.stack_ms, args.device,
              on_log=lambda *a: print(*a, file=sys.stderr, flush=True))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_sched.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0 if res.get("sched_rc") == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
