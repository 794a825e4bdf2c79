"""Process-wide event bus + signal wait (reference event/event.go:20-94).

On/Emit/Off with handler dedupe by identity; Wait() blocks until
SIGINT/SIGTERM, then emits EXIT — the shutdown fan-out the entrypoints use.
"""

from __future__ import annotations

import inspect
import signal
import threading
from typing import Callable, Dict, List

EXIT = "exit"
WAIT = "wait"   # config reloaded (reference: fsnotify -> WAIT)

_lock = threading.Lock()
_handlers: Dict[str, List[Callable]] = {}


def on(name: str, *fns: Callable):
    with _lock:
        hs = _handlers.setdefault(name, [])
        for fn in fns:
            if all(fn is not h for h in hs):   # dedupe by identity
                hs.append(fn)


def off(name: str, *fns: Callable):
    with _lock:
        hs = _handlers.get(name, [])
        for fn in fns:
            _handlers[name] = hs = [h for h in hs if h is not fn]


def _wants_arg(fn: Callable) -> bool:
    """Does the handler take a positional argument?  (Bound methods must
    not count ``self`` — ``__code__.co_argcount`` does, which made emit
    call zero-arg methods like ``server.stop`` with a spurious arg.)"""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return any(
        p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        for p in sig.parameters.values())


def emit(name: str, arg=None):
    with _lock:
        hs = list(_handlers.get(name, []))
    for fn in hs:
        fn(arg) if _wants_arg(fn) else fn()


def clear():
    with _lock:
        _handlers.clear()
    _stop.clear()


_stop = threading.Event()


def shutdown():
    """Release a blocked :func:`wait` programmatically — the path a
    component takes when it hits a fatal condition (e.g. the node agent
    losing its identity to a live replacement) and the process must wind
    down without an operator signal."""
    _stop.set()


def wait():
    """Block until SIGINT/SIGTERM (or :func:`shutdown`), then emit EXIT.
    Signal handlers install only from the main thread (Python forbids it
    elsewhere); an embedded wait() still releases via shutdown().

    shutdown() is sticky: one fired *before* main reaches wait() (e.g. a
    supervised child dying between READY and wait, bin/store.py) still
    releases immediately instead of being swallowed.  Tests reset the
    latch via :func:`clear`."""
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGINT, lambda *a: _stop.set())
        signal.signal(signal.SIGTERM, lambda *a: _stop.set())
    _stop.wait()
    emit(EXIT)
