"""The native (C++) result store server, ``native/cronsun-logd``, as a
child process.

``native/logd.cc`` implements the same wire protocol as
:class:`~cronsun_tpu_torch.logsink.serve.LogSinkServer` — in-memory tables
with a WAL instead of SQLite, no GIL, bounded retention.  The counterpart
of ``cronsun_tpu/logsink/native.py``, on the port's launcher
(:class:`cronsun_tpu_torch.store.native.NativeServer`: spawn, READY,
monitor, stop).
"""

from __future__ import annotations

from typing import Optional

from ..store import native as _native
from ..store.native import NativeServer

NAME = "cronsun-logd"


def find_binary() -> Optional[str]:
    """``cronsun-logd``: ``$CRONSUN_LOGD``, then ``native/`` (built when
    missing or stale), then ``$PATH``; None when none of them is there."""
    return _native.find_binary(NAME, "CRONSUN_LOGD")


class NativeLogSinkServer(NativeServer):
    """``cronsun-logd`` (``binary``, else :func:`find_binary`) with the
    flags of ``cronsun_tpu/logsink/native.py``'s launcher; with none, an
    in-memory result store."""

    def __init__(self, binary: Optional[str] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 db: Optional[str] = None, retain: Optional[int] = None,
                 token: str = "", hot_days: Optional[int] = None):
        binary = binary or find_binary()
        if binary is None:
            raise FileNotFoundError(
                "cronsun-logd not found (set $CRONSUN_LOGD or build "
                "native/)")
        argv = []
        if db:
            argv += ["--db", db]
        if retain is not None:
            argv += ["--retain", str(retain)]
        if hot_days is not None:
            argv += ["--hot-days", str(hot_days)]
        super().__init__(binary, argv, host=host, port=port, token=token)
