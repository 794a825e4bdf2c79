"""Spans of the planner's path, kept in memory whether or not a profiler runs.

Every range the planner's path names (``cronsun.plan.dispatch``,
``cronsun.fire_mask``, ``cronsun.sync``, ...) is opened with :func:`span`:

    with span("cronsun.fire_mask"):
        ...

A span always stamps its start and end with ``time.perf_counter_ns`` and
records them in memory, under the window it belongs to, with its parent
span and whether a profiler was running.  Only while a profiler runs does
it also open a ``torch.profiler.record_function`` range of the same name,
so a device trace shows the same spans; with no profiler running no
range is entered at all.

**Windows.**  Each planner owns a :class:`SpanRecorder`.  A planned window
is a :class:`Window`, identified by ``(planner serial, first epoch
second)``: the dispatch opens it (``span(name, window)``) and every span
opened under it on that thread joins it; the gather reopens it from the
handle, on whatever thread gathers.  A span opened outside any window
(a warm-up dispatch, the mesh planners' reconcile) records nothing; it
still opens its range under a profiler.  Work issued between two windows
(a bulk release, ``cronsun.release``) is recorded in
:meth:`SpanRecorder.ahead`, which the next window takes over when it is
made: such spans belong to the window they precede.  The recorder keeps
the newest :data:`RING_WINDOWS` windows (a ring: nothing grows over a
run), and sums each span name's count and time in an
:class:`~..metrics.OpStats` (:attr:`SpanRecorder.totals`) as each
window's dispatch and gather end; the scheduler's metrics publish them.

**Stream waits.**  ``cronsun.sync`` wraps each call on the dispatch path
that blocks the host on the card's stream (a boolean-mask selection runs
a ``nonzero``; a pageable host-to-device copy waits for the stream): one
such span is one stream wait.  The spans are the same on the CPU, where
nothing waits, so a count there is the count the card would make, but
for the accept: the CPU's is the plain chain, whose per-node totals wait
three times a round, and the card's one kernel launch waits for nothing.

**Counters.**  A window also counts what its spans do not time
(:meth:`Window.count`, read from :attr:`Window.counts`): the exclusive
fires the window left unplaced (:data:`UNPLACED`, counted by its gather
from the output it copied).

**One clock.**  :attr:`SpanRecorder.anchor` pairs ``time.time_ns()`` with
``time.perf_counter_ns()``; :meth:`SpanRecorder.wall_ns` maps a span's
stamp onto the wall clock, which is the profiler's (a Chrome trace event's
``ts`` in us plus the trace's ``baseTimeNanoseconds``).  A span is stamped
before its range opens and after it closes, so it contains its range.

Cost: a few O(1) Python operations a span, no device operation and no
read-back.  Appends are GIL-atomic list and deque operations; one window
is written by one thread at a time (its gather starts once its dispatch
has returned the handle).
"""

from __future__ import annotations

import array
import collections
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

from ..metrics import OpStats

RING_WINDOWS = 2048
SYNC = "cronsun.sync"
GATHER = "cronsun.plan.gather"
RELEASE = "cronsun.release"
NAMES = ("cronsun.plan.dispatch", "cronsun.fire_mask", "cronsun.deps",
         "cronsun.tenants", "cronsun.compact", "cronsun.fanout",
         "cronsun.assign", "cronsun.assign.bid", "cronsun.assign.accept",
         SYNC, GATHER, "cronsun.plan.gather.wait", RELEASE)
# a window's counter
UNPLACED = "cronsun.unplaced"
_CODE = {n: i for i, n in enumerate(NAMES)}
_GATHER = _CODE[GATHER]
_FIELDS = 5          # a span in Window.rec: code, start, end, parent, profiled

_serials = itertools.count()
_newest: Optional["SpanRecorder"] = None


class Span(NamedTuple):
    """One recorded span: ``parent`` is the index of the enclosing span of
    its window, -1 for none; ``end_ns`` is 0 while it is open."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    profiled: bool


class Window:
    """The spans of one planned window, in the order they opened.  While
    the window is being planned ``rec`` is a flat list, :data:`_FIELDS`
    ints a span (code, start, end, parent, profiled); the gather's end
    folds it into the totals and packs it into an ``array('q')``."""

    __slots__ = ("id", "seconds", "profiled", "rec", "counts", "_folded",
                 "_totals")

    def __init__(self, wid, seconds: int, totals: OpStats):
        self.id = wid
        self.seconds = seconds
        self.profiled = False        # a span of it opened under a profiler
        self.rec: list = []
        self.counts: dict = {}       # counter name -> count
        self._folded = 0             # records already in the totals
        self._totals = totals

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the window's counter ``name``."""
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def _adopt(self, ahead: "Window") -> None:
        """Take over the spans recorded ahead of this window (they were
        folded into the totals as they closed)."""
        self.rec, self._folded = ahead.rec, ahead._folded
        self.profiled = ahead.profiled

    def spans(self) -> List[Span]:
        r = self.rec
        return [Span(NAMES[r[i]], r[i + 1], r[i + 2], r[i + 3],
                     bool(r[i + 4])) for i in range(0, len(r), _FIELDS)]

    def _fold(self, last: bool) -> None:
        """Add the spans closed since the last fold to the totals; the
        window's last fold packs its records."""
        r = self.rec
        acc: dict = {}
        for i in range(self._folded, len(r), _FIELDS):
            dt = r[i + 2] - r[i + 1]
            ent = acc.get(r[i])
            if ent is None:
                acc[r[i]] = [1, dt, dt]
            else:
                ent[0] += 1
                ent[1] += dt
                if dt > ent[2]:
                    ent[2] = dt
        for code, (n, tot, mx) in acc.items():
            self._totals.add(NAMES[code], n, tot, mx)
        self._folded = len(r)
        if last:
            self.rec = array.array("q", self.rec)


def _anchor():
    """(``time.time_ns()``, ``time.perf_counter_ns()``) read together: of
    five tries, the wall reading bracketed closest by two counter
    readings, against their midpoint."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall, (a + b) // 2)
    return best[1], best[2]


class SpanRecorder:
    """A planner's windows and span totals.  The newest recorder built in
    the process is :func:`newest`'s."""

    def __init__(self, windows: int = RING_WINDOWS):
        global _newest
        self.serial = next(_serials)
        self.totals = OpStats()
        self.anchor = _anchor()
        self._ring: collections.deque = collections.deque(maxlen=windows)
        self._ahead: Optional[Window] = None
        _newest = self

    def ahead(self) -> Window:
        """Where spans recorded between windows go: the next
        :meth:`window` takes them over.  The caller serializes this with
        :meth:`window` (the planner holds its lock for both)."""
        if self._ahead is None:
            self._ahead = Window(None, 0, self.totals)
        return self._ahead

    def window(self, epoch_s: int, seconds: int) -> Window:
        """A new window, in the ring (the oldest falls out), holding what
        was recorded :meth:`ahead` of it."""
        w = Window((self.serial, int(epoch_s)), int(seconds), self.totals)
        if self._ahead is not None:
            w._adopt(self._ahead)
            self._ahead = None
        self._ring.append(w)
        return w

    def windows(self) -> List[Window]:
        """The ring's windows, oldest first."""
        return list(self._ring)

    def wall_ns(self, t_ns: int) -> int:
        """A span's stamp on the wall clock (the profiler's)."""
        return self.anchor[0] + (t_ns - self.anchor[1])


def newest() -> Optional[SpanRecorder]:
    """The recorder of the newest planner built in this process: for a
    reader that holds no planner (the benchmark's span metrics, read after
    the run has let its planner go)."""
    return _newest


class _Frames(threading.local):
    def __init__(self):
        # the thread's open spans, three entries each: window (None
        # outside any), span index, profiler range (None with no
        # profiler).  Flat, so a span allocates no container the garbage
        # collector counts.
        self.stack: list = []


_tls = _Frames()
_now = time.perf_counter_ns


class _Opener:
    """Opens a span named ``name`` in ``window``, or in the window of the
    thread's innermost open span when ``window`` is None."""

    __slots__ = ("name", "code", "window")

    def __init__(self, name: str, window: Optional[Window] = None):
        self.name = name
        self.code = _CODE[name]
        self.window = window

    def __enter__(self):
        t0 = _now()
        stack = _tls.stack
        rf = None
        # whether a profiler runs in the process: the flag the profiler
        # sets in Python, not torch._C._autograd._profiler_enabled(), which
        # is per thread and reads False on every thread under a session
        # that profiles all threads (the --profile-port capture's)
        prof = _autograd_profiler._is_profiler_enabled
        if prof:
            rf = record_function(self.name)
            rf.__enter__()
        win = self.window
        if win is not None:
            parent = -1
        elif stack and stack[-3] is not None:
            win = stack[-3]
            parent = stack[-2]
        else:
            stack.append(None)
            stack.append(0)
            stack.append(rf)
            return
        rec = win.rec
        stack.append(win)
        stack.append(len(rec) // _FIELDS)
        stack.append(rf)
        rec.append(self.code)
        rec.append(t0)
        rec.append(0)
        rec.append(parent)
        rec.append(prof)
        if prof:
            win.profiled = True

    def __exit__(self, exc_type, exc, tb):
        stack = _tls.stack
        rf = stack.pop()
        j = stack.pop()
        win = stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        if win is not None:
            win.rec[j * _FIELDS + 2] = _now()
            if self.window is not None:        # it opened its window
                win._fold(self.code == _GATHER)
        return False


_SHARED = {n: _Opener(n) for n in NAMES}


def span(name: str, window: Optional[Window] = None) -> _Opener:
    """A span named ``name`` (one of :data:`NAMES`): in ``window``, or
    in the window of the thread's innermost open span."""
    return _SHARED[name] if window is None else _Opener(name, window)
