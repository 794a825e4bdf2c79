"""Store persistence primitives: WAL file + atomic snapshot sidecar.

The record format is line-delimited JSON arrays, IDENTICAL to the native
``stored.cc`` WAL so operators can move a state directory between
backends:

    WAL (mutations, appended live):
        ["p", key, value, lease]        put
        ["d", key]                      delete
        ["g", lid, ttl, wall_deadline]  lease grant
        ["k", lid, wall_deadline]       lease keepalive
        ["x", lid]                      lease revoke/expiry (its key
                                        deletes follow as "d" records on
                                        the live path; replaying "x"
                                        deletes attached keys itself so
                                        the crash window between the "x"
                                        and its "d"s can't resurrect
                                        leased keys)
        ["E", epoch]                    replication fencing epoch
                                        (repl/): stamped by a follower
                                        promotion; replicas refuse
                                        records from any lower epoch,
                                        so a deposed leader's late
                                        appends cannot land
    snapshot (full state, written whole):
        ["v", rev, next_lease, epoch]   revision tag — FIRST line (the
                                        4th field is the replication
                                        fencing epoch; pre-replication
                                        snapshots omit it = epoch 0)
        ["g", lid, ttl, wall_deadline]  one per live lease
        ["s", key, value, create_rev, mod_rev, lease]   one per key

Layout: the WAL lives at ``path``; the snapshot at ``path + ".snap"``;
snapshot writes go to ``path + ".snap.tmp"`` and land by atomic rename.
Boot = replay snapshot (if any) + replay WAL tail.  The crash matrix:

- mid-snapshot crash: a torn ``.snap.tmp`` is left behind and IGNORED —
  boot recovers from the previous snapshot + the full (untruncated) WAL;
- crash after the rename but before the WAL truncation: the new
  snapshot is replayed, then the stale WAL re-applies a prefix of the
  history the snapshot already contains — last-write-wins record
  semantics converge to the exact pre-crash state (revisions may be
  advanced past their pre-crash values, which the revision contract
  permits: they only ever need to be monotone);
- torn FINAL WAL record (crash mid-append): tolerated; a bad record
  with more after it is corruption and refuses to boot.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, Optional


class SnapshotCorrupt(RuntimeError):
    """A WAL/snapshot record failed to parse with further records after
    it — real corruption, not a torn final append."""


def snap_path(wal_path: str) -> str:
    return wal_path + ".snap"


class WalFile:
    """Append-only mutation log with the native Wal's contract: appends
    are flushed to the OS immediately; fdatasync rides the caller's
    sweep cadence unless ``sync_per_commit``.  Write failures are
    FAIL-STOP (the native server aborts for the same reason): an
    acknowledged mutation the WAL could not record would silently break
    the durability contract."""

    def __init__(self, path: str, sync_per_commit: bool = False):
        self.path = path
        self.sync_per_commit = sync_per_commit
        self._f = open(path, "a", encoding="utf-8")

    def append(self, rec: list) -> None:
        try:
            self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            self._f.flush()
            if self.sync_per_commit:
                os.fdatasync(self._f.fileno())
        except OSError as e:
            import sys
            print(f"FATAL: wal append failed: {e}", file=sys.stderr,
                  flush=True)
            os._exit(1)

    def sync(self) -> None:
        # ValueError: file closed under us (the owning store's close()
        # racing an in-flight sweeper pass) — benign on the way out
        try:
            os.fdatasync(self._f.fileno())
        except (OSError, ValueError):
            pass

    def size(self) -> int:
        try:
            return os.fstat(self._f.fileno()).st_size
        except (OSError, ValueError):
            return 0

    def truncate(self) -> None:
        """Drop every logged record (the snapshot now covers them).
        Caller must hold whatever lock orders appends, so no mutation
        can slip between the snapshot and the truncation."""
        self._f.truncate(0)
        self._f.seek(0)

    def rotate(self, dst: str) -> None:
        """Move every record logged so far to ``dst`` and keep appending
        to a FRESH file at the original path — the staggered snapshot's
        pin: records at or before the pin land in ``dst`` (covered by
        the snapshot being cut), records after it in the fresh file (the
        replay tail).  Caller holds the locks that order appends.

        If ``dst`` already exists (a previous snapshot attempt crashed
        or failed between its pin and its rename), the current records
        are APPENDED to it instead — both files' records predate the new
        pin, and replacing dst would silently drop the older ones."""
        self._f.flush()
        self._f.close()
        try:
            if os.path.exists(dst) and os.path.getsize(dst) > 0:
                # a previous merge that died mid-append can leave a
                # TORN final line in dst; appending straight after it
                # would glue records onto the torn line — a malformed
                # record with valid records after it, which boot reads
                # as mid-file corruption and refuses.  Trim to the last
                # complete line first (a torn final record is a legal
                # crash artifact to drop).
                _trim_torn_tail(dst)
                with open(dst, "a", encoding="utf-8") as out, \
                        open(self.path, "r", encoding="utf-8",
                             errors="replace") as src:
                    for line in src:
                        out.write(line)
                    out.flush()
                    os.fdatasync(out.fileno())
                self._f = open(self.path, "w", encoding="utf-8")
            else:
                os.replace(self.path, dst)
                self._f = open(self.path, "a", encoding="utf-8")
        except OSError:
            # never leave the WAL detached: whatever failed, appends
            # must keep landing (fail-stop handles true write errors)
            self._f = open(self.path, "a", encoding="utf-8")
            raise

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


def _trim_torn_tail(path: str) -> None:
    """Truncate ``path`` to its last newline-terminated record (drop a
    torn final line — the tolerated crash artifact — so appends never
    glue onto it)."""
    with open(path, "rb+") as f:
        f.seek(0, os.SEEK_END)
        pos = f.tell()
        while pos > 0:
            step = min(1 << 16, pos)
            f.seek(pos - step)
            chunk = f.read(step)
            nl = chunk.rfind(b"\n")
            if nl >= 0:
                f.truncate(pos - step + nl + 1)
                return
            pos -= step
        f.truncate(0)


def rotated_path(wal_path: str) -> str:
    """Where a staggered snapshot parks the pre-pin WAL records while it
    images (``FILE.1``): boot replays snapshot, then FILE.1 if present
    (a snapshot died mid-image), then the live WAL — strictly older to
    newer, so last-write-wins convergence holds across every crash
    point."""
    return wal_path + ".1"


def read_records(path: str) -> Iterator[list]:
    """Yield parsed records from a WAL or snapshot file.  A torn FINAL
    line (crash mid-append) is tolerated silently; a bad record with
    more records after it raises :class:`SnapshotCorrupt`."""
    if not os.path.exists(path):
        return
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        bad: Optional[str] = None
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            if bad is not None:
                raise SnapshotCorrupt(
                    f"corrupt record in {path}: {bad[:200]!r}")
            try:
                rec = json.loads(line)
            except ValueError:
                bad = line
                continue
            if not isinstance(rec, list) or not rec \
                    or not isinstance(rec[0], str):
                bad = line
                continue
            yield rec


def write_snapshot(wal_path: str, lines: Iterable[list]) -> str:
    """Write a full-state snapshot ATOMICALLY: stream records to
    ``.snap.tmp``, flush + fdatasync, then rename over ``.snap`` — a
    crash mid-write leaves the previous snapshot untouched (the torn
    temp file is ignored at boot).  Every write is checked so an ENOSPC
    aborts before the rename, never after."""
    snap = snap_path(wal_path)
    tmp = snap + ".tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in lines:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
            os.fdatasync(f.fileno())
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, snap)
    return snap
