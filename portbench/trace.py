"""Reading a ``torch.profiler`` Chrome trace: device operations, the host
ranges they were launched in, the device's busy time and its idle gaps.

The traced block is wrapped in one host range, :data:`WINDOW`; busy and
idle are taken inside it.  Times are in the trace's microseconds.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short(name: str, width: int = 120) -> str:
    """A kernel's name cut to ``width`` characters (templated names run to
    thousands)."""
    return name if len(name) <= width else name[:width - 3] + "..."


class Trace:
    """The events of one exported trace."""

    def __init__(self, events: List[dict]):
        self.device_ops: List[Tuple[str, float, float, Optional[int]]] = []
        self.launch: Dict[int, Tuple[object, float]] = {}
        self.ranges: Dict[str, List[Tuple[float, float, object]]] = {}
        self.cpu_ops: Dict[object, List[Tuple[float, float, str]]] = {}
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            args = ev.get("args") or {}
            if cat in DEVICE_CATS:
                self.device_ops.append((ev["name"], ts, dur,
                                        args.get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = args.get("correlation")
                if corr is not None:
                    self.launch[corr] = (ev.get("tid"), ts)
            elif cat == "user_annotation":
                self.ranges.setdefault(ev["name"], []).append(
                    (ts, ts + dur, ev.get("tid")))
            elif cat == "cpu_op":
                self.cpu_ops.setdefault(ev.get("tid"), []).append(
                    (ts, ts + dur, ev["name"]))
        self.device_ops.sort(key=lambda o: o[1])
        for v in self.ranges.values():
            v.sort()
        for v in self.cpu_ops.values():
            v.sort()
        win = self.ranges.get(WINDOW) or [(0.0, 0.0, None)]
        self.t0, self.t1 = win[0][0], win[0][1]

    # -- the window ---------------------------------------------------------

    def window_ops(self):
        return [o for o in self.device_ops
                if o[1] < self.t1 and o[1] + o[2] > self.t0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """Merged intervals in which an operation ran, clipped to the
        window."""
        out: List[List[float]] = []
        for _n, ts, dur, _c in self.window_ops():
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    # -- attribution ----------------------------------------------------------

    def device_s_in(self, name: str) -> float:
        """Seconds of the window's device operations launched inside a host
        range ``name`` (matched by the launch's correlation id)."""
        rs = self.ranges.get(name, [])
        by_tid: Dict[object, List[Tuple[float, float]]] = {}
        for a, b, tid in rs:
            by_tid.setdefault(tid, []).append((a, b))
        total = 0.0
        for _n, _ts, dur, corr in self.window_ops():
            hit = self.launch.get(corr)
            if hit is None:
                continue
            tid, t = hit
            iv = by_tid.get(tid)
            if not iv:
                continue
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                total += dur
        return total * 1e-6

    def host_s_of(self, name: str) -> float:
        """Seconds the window spent inside host ranges ``name``."""
        return sum(min(b, self.t1) - max(a, self.t0)
                   for a, b, _t in self.ranges.get(name, [])
                   if b > self.t0 and a < self.t1) * 1e-6

    def ops_named(self, part: str):
        """The window's device operations whose name holds ``part``, in
        start order: (name, ts, dur)."""
        return [(n, ts, dur) for n, ts, dur, _c in self.window_ops()
                if part in n]

    # -- breakdown -------------------------------------------------------------

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for name, _ts, dur, _c in self.window_ops():
            name = short(name)
            tot[name] = tot.get(name, 0.0) + dur * 1e-6
        return [[k, v] for k, v in sorted(tot.items(),
                                           key=lambda kv: -kv[1])[:n]]

    def _innermost(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost open range (any
        thread) and, on its thread, the innermost open operator."""
        best = None
        for name, rs in self.ranges.items():
            if name == WINDOW:
                continue
            i = bisect.bisect_right(rs, (t, float("inf"), None)) - 1
            for j in range(i, max(-1, i - 64), -1):
                a, b, tid = rs[j]
                if a <= t <= b:
                    if best is None or a > best[0]:
                        best = (a, name, tid)
                    break
        label = best[1] if best else "host"
        tid = best[2] if best else None
        ops = self.cpu_ops.get(tid, []) if tid is not None else []
        i = bisect.bisect_right(ops, (t, float("inf"), "")) - 1
        inner = None
        for j in range(i, max(-1, i - 256), -1):
            a, b, name = ops[j]
            if a <= t <= b:
                if inner is None or a > inner[0]:
                    inner = (a, name)
        return f"{label} > {inner[1]}" if inner else label

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The window's idle time by what the host was doing at each gap's
        middle, largest first."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        tot: Dict[str, float] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                key = self._innermost((a + b) / 2)
                tot[key] = tot.get(key, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(),
                                           key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def profiled(device_type: str, all_threads: bool = False):
    """A ``torch.profiler`` session around a block, wrapped in the
    :data:`WINDOW` range; yields a list that holds the :class:`Trace` once
    the block has ended (the export goes through a temporary file)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    kw = {}
    if all_threads:
        try:
            from torch._C._profiler import _ExperimentalConfig
            kw["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
        except (ImportError, TypeError):
            pass
    out: list = []
    with profile(activities=acts, **kw) as prof:
        with record_function(WINDOW):
            yield out
            if device_type == "cuda":
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    out.append(Trace(doc.get("traceEvents", doc) if isinstance(doc, dict)
                     else doc))
