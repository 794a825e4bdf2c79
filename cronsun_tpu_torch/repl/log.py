"""The leader's in-memory shipping buffer for WAL-record replication.

A :class:`ReplLog` is a bounded ring of ``(seq, record)`` pairs in the
walsnap record format.  ``seq`` is a DEDICATED monotone cursor, not the
store revision: lease records ("g"/"k"/"x") and epoch stamps ("E")
never bump the revision yet must ship, and the revision itself is
reconstructed on the follower by applying the records in order.

The ring also keeps the fencing-epoch history — which epoch was in
force at which cursor — so a follower's hello can be log-matched
(Raft's AppendEntries consistency check, one entry deep): a follower
whose ``(seq, epoch)`` pair doesn't match the leader's history carries
a divergent tail (it followed a deposed leader) and must full-resync
instead of tailing.

Copy of ``cronsun_tpu/repl/log.py``.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, Optional, Tuple


class ReplLog:
    """Bounded, thread-safe record ring with long-poll reads.

    Appends come from the store's mutation paths (under the store lock
    that ordered the mutation — see ``MemStore._log``); reads come from
    the server's ``repl_pull`` handler threads.  A follower that falls
    further behind than the ring retains must bootstrap from a fresh
    snapshot (``covers`` returns False), exactly like a watch falling
    out of the event history.
    """

    CAPACITY = 1 << 16

    def __init__(self, capacity: int = CAPACITY, epoch: int = 0):
        self._cap = max(1, int(capacity))
        self._mu = threading.Condition()
        self._recs: "collections.deque[Tuple[int, list]]" = \
            collections.deque()
        self.seq = 0                       # last appended cursor
        # (epoch, first_seq_in_force) — seeded with the store's boot
        # epoch so epoch_at() answers for the pre-history baseline
        self._epochs: List[Tuple[int, int]] = [(int(epoch), 0)]

    def append(self, rec: list):
        with self._mu:
            self.seq += 1
            if rec and rec[0] == "E" and len(rec) >= 2:
                self._epochs.append((int(rec[1]), self.seq))
            self._recs.append((self.seq, list(rec)))
            while len(self._recs) > self._cap:
                self._recs.popleft()
            self._mu.notify_all()

    def covers(self, after_seq: int) -> bool:
        """True when a follower current through ``after_seq`` can tail
        from the ring (every later record is still retained)."""
        with self._mu:
            if after_seq > self.seq:
                return False
            if after_seq == self.seq:
                return True
            return bool(self._recs) and self._recs[0][0] <= after_seq + 1

    def epoch_at(self, seq: int) -> Optional[int]:
        """Fencing epoch in force at cursor ``seq`` (the epoch of the
        record at that cursor, or of the baseline for pre-history
        cursors)."""
        with self._mu:
            best: Optional[int] = None
            for ep, first in self._epochs:
                if first <= seq:
                    best = ep
                else:
                    break
            return best

    def read_after(self, after_seq: int, max_n: int = 512,
                   timeout: float = 0.0) -> List[Tuple[int, list]]:
        """Up to ``max_n`` records with cursor > ``after_seq``, waiting
        up to ``timeout`` seconds for new appends (long-poll) when none
        are pending.  The caller is responsible for the ``covers``
        check — a cursor older than the ring reads from the ring start,
        which would skip records."""
        deadline = time.monotonic() + timeout
        with self._mu:
            while True:
                if self._recs and self._recs[-1][0] > after_seq:
                    first = self._recs[0][0]
                    start = max(0, after_seq + 1 - first)
                    return list(itertools.islice(
                        self._recs, start, start + max(1, max_n)))
                remaining = deadline - time.monotonic()
                if timeout <= 0 or remaining <= 0:
                    return []
                self._mu.wait(remaining)

    def reset(self, seq: int, epoch: int):
        """Re-baseline after a bootstrap: the follower's log continues
        the LEADER's numbering from the snapshot's cursor, so its own
        cursor stays in lockstep with the stream it applies (one append
        per shipped record — see ``MemStore.repl_apply``) and remains
        valid against a promoted sibling."""
        with self._mu:
            self._recs.clear()
            self.seq = int(seq)
            self._epochs = [(int(epoch), 0)]
            self._mu.notify_all()

    def wake(self):
        """Wake long-poll waiters without appending (shutdown)."""
        with self._mu:
            self._mu.notify_all()
