"""Cold-tier segment files for the tiered result store.

The tiered layout inside one logd shard splits execution history by a
single **prefix watermark** (``cold_boundary``): every record id at or
below it lives in an immutable, compacted per-day segment file on disk
(the COLD tier); every id above it is HOT — SQLite rows for the Python
backend, the in-memory deque for the native one.  The watermark only
advances, and it advances only past records whose UTC day has aged out
of the hot window, so the hot tier always holds a contiguous id suffix
(the invariant ``get_log``'s index jump and cursor mode's O(new) scan
rely on) and a day's records move cold exactly once per age-out pass.

Segment format — shared byte-for-byte with ``native/logd.cc`` so either
backend (and the reshard tool) can read the other's segments:

    ["d", day, count, min_id, max_id]          # header, first line
    ["L", id, job_id, job_group, name, node,   # one line per record,
          user, command, output, success,      # id ASCENDING — the
          begin_ts, end_ts]                    # native WAL's L body

One file per UTC day, ``<day>.seg`` inside ``<db>.segs/``.  A day's
segment is REWRITTEN (union by id, temp + rename + fdatasync) whenever
an age-out pass moves more of that day cold — late records whose
begin_ts falls in an already-aged day ride a later pass, and a crash
between segment write and hot-trim replays idempotently: the redo
unions the same records and produces the same bytes, then trims.
Readers never see a torn file (rename is atomic) and never double-count
(a segment row is consulted only for ids <= the durably-recorded
watermark; rows above it are still authoritatively hot).

Copy of ``cronsun_tpu/logsink/tiering.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

from .joblog import LogRecord

SEG_SUFFIX = ".seg"
IDX_SUFFIX = ".idx"
# one sparse-index mark every this many records: a seek lands within
# IDX_STRIDE parsed lines of the target id instead of the whole file
IDX_STRIDE = 64


def day_of(ts: float) -> str:
    """UTC day string of a begin_ts — the tier (and stat) day key."""
    return time.strftime("%Y-%m-%d", time.gmtime(ts))


def day_start(day: str) -> float:
    """Epoch seconds of ``day`` 00:00 UTC."""
    import calendar
    return float(calendar.timegm(time.strptime(day, "%Y-%m-%d")))


def hot_cutoff_ts(now: float, hot_days: int) -> float:
    """Start of the hot window: records with begin_ts below this are
    eligible to age cold.  ``hot_days`` counts whole UTC days including
    today — hot_days=1 keeps only today hot."""
    today = day_start(day_of(now))
    return today - 86400.0 * (max(1, hot_days) - 1)


def seg_dir(db_path: str) -> Optional[str]:
    """Segment directory for a sink's backing file, or None when the
    sink has no durable path (``:memory:``) — no file, no cold tier."""
    if not db_path or db_path == ":memory:":
        return None
    return db_path + ".segs"


def seg_path(dirp: str, day: str) -> str:
    return os.path.join(dirp, day + SEG_SUFFIX)


def idx_path(path: str) -> str:
    """``<day>.idx`` sidecar next to a ``<day>.seg``."""
    return path[:-len(SEG_SUFFIX)] + IDX_SUFFIX


def _rec_line(r: LogRecord) -> str:
    return json.dumps(
        ["L", r.id, r.job_id, r.job_group, r.name, r.node, r.user,
         r.command, r.output, bool(r.success), r.begin_ts, r.end_ts],
        separators=(",", ":"), ensure_ascii=False)


def read_segment(path: str) -> List[LogRecord]:
    """Records of one segment, id ASCENDING.  A torn/garbage file reads
    as empty — segments are only consulted below the durable watermark,
    and the age-out redo rewrites any file that predates a crash."""
    out: List[LogRecord] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            header = f.readline()
            h = json.loads(header)
            if not (isinstance(h, list) and h and h[0] == "d"):
                return []
            for line in f:
                v = json.loads(line)
                if not (isinstance(v, list) and len(v) >= 12
                        and v[0] == "L"):
                    return []
                out.append(LogRecord(
                    id=int(v[1]), job_id=v[2], job_group=v[3], name=v[4],
                    node=v[5], user=v[6], command=v[7], output=v[8],
                    success=bool(v[9]), begin_ts=float(v[10]),
                    end_ts=float(v[11])))
    except (OSError, ValueError):
        return []
    out.sort(key=lambda r: r.id)
    return out


def _read_index(path: str, seg_header: list) -> Optional[List[Tuple[int,
                                                                    int]]]:
    """Sparse (id, offset) marks for ``path``'s segment, or None when
    the ``.idx`` sidecar is missing or STALE — its mirrored header must
    equal the segment's (day, count, min, max), which any crash
    ordering between the two renames fails, so a stale index can only
    cost a full scan, never a wrong seek."""
    try:
        with open(idx_path(path), "r", encoding="utf-8") as f:
            h = json.loads(f.readline())
            if not (isinstance(h, list) and len(h) >= 5 and h[0] == "i"
                    and list(h[1:5]) == list(seg_header[1:5])):
                return None
            marks = []
            for line in f:
                v = json.loads(line)
                if not (isinstance(v, list) and len(v) >= 3
                        and v[0] == "e"):
                    return None
                marks.append((int(v[1]), int(v[2])))
            return marks
    except (OSError, ValueError):
        return None


def read_segment_range(path: str, lo: Optional[int] = None,
                       hi: Optional[int] = None) -> List[LogRecord]:
    """Records of one segment with ``lo <= id <= hi``, id ASCENDING —
    the memory-mapped ranged read.  With a fresh ``.idx`` sidecar the
    scan SEEKS to within IDX_STRIDE lines of ``lo`` and stops at the
    first id past ``hi`` (ids are ascending on disk), so a single-id
    lookup or a watermark/floor-bounded cold scan parses O(stride +
    matches) lines instead of the whole day.  Missing/stale sidecars
    fall back to scanning from the top; torn or garbage files read as
    empty, exactly like ``read_segment``."""
    import bisect
    import mmap
    if lo is None and hi is None:
        return read_segment(path)
    out: List[LogRecord] = []
    try:
        with open(path, "rb") as fh:
            try:
                mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
            except (OSError, ValueError):      # empty file can't map
                return []
            try:
                end = mm.find(b"\n")
                if end < 0:
                    return []
                h = json.loads(mm[:end])
                if not (isinstance(h, list) and len(h) >= 5
                        and h[0] == "d"):
                    return []
                if lo is not None and int(h[4]) < lo:
                    return []
                if hi is not None and int(h[3]) > hi:
                    return []
                pos = end + 1
                if lo is not None:
                    marks = _read_index(path, h)
                    if marks:
                        i = bisect.bisect_right(
                            [m[0] for m in marks], lo) - 1
                        if i >= 0:
                            pos = marks[i][1]
                size = mm.size()
                while pos < size:
                    nl = mm.find(b"\n", pos)
                    if nl < 0:
                        nl = size
                    line = mm[pos:nl]
                    pos = nl + 1
                    if not line:
                        continue
                    v = json.loads(line)
                    if not (isinstance(v, list) and len(v) >= 12
                            and v[0] == "L"):
                        return []
                    rid = int(v[1])
                    if hi is not None and rid > hi:
                        break                  # ids ascend on disk
                    if lo is not None and rid < lo:
                        continue
                    out.append(LogRecord(
                        id=rid, job_id=v[2], job_group=v[3], name=v[4],
                        node=v[5], user=v[6], command=v[7], output=v[8],
                        success=bool(v[9]), begin_ts=float(v[10]),
                        end_ts=float(v[11])))
            finally:
                mm.close()
    except (OSError, ValueError):
        return []
    return out


def write_segment(dirp: str, day: str, recs: Iterable[LogRecord]) -> dict:
    """Write (or extend) ``day``'s segment with ``recs``, UNIONED by id
    with whatever the existing file holds — idempotent, so the crash
    redo and a late-record pass both converge on the same bytes.
    Atomic: temp + fdatasync + rename.  Returns the index entry
    {day, path, min, max, count}."""
    os.makedirs(dirp, exist_ok=True)
    path = seg_path(dirp, day)
    by_id: Dict[int, LogRecord] = {r.id: r for r in read_segment(path)}
    for r in recs:
        by_id[r.id] = r
    rows = [by_id[i] for i in sorted(by_id)]
    tmp = path + ".tmp"
    header = json.dumps(
        ["d", day, len(rows), rows[0].id if rows else 0,
         rows[-1].id if rows else 0],
        separators=(",", ":")) + "\n"
    marks: List[Tuple[int, int]] = []    # (id, byte offset) every stride
    with open(tmp, "wb") as f:
        f.write(header.encode("utf-8"))
        off = len(header.encode("utf-8"))
        for i, r in enumerate(rows):
            line = (_rec_line(r) + "\n").encode("utf-8")
            if i % IDX_STRIDE == 0:
                marks.append((r.id, off))
            f.write(line)
            off += len(line)
        f.flush()
        os.fdatasync(f.fileno())
    os.replace(tmp, path)
    # sparse-index sidecar: (id, offset) marks every IDX_STRIDE records
    # so ranged reads SEEK instead of parsing the whole day.  Its header
    # mirrors the segment's — a reader uses the index only when the two
    # match, so any crash ordering between the renames (fresh seg +
    # stale idx, or idx written but seg redo pending) degrades to the
    # full-scan path, never to wrong offsets.  Advisory data: a failed
    # sidecar write must not fail the durable segment write.
    try:
        itmp = idx_path(path) + ".tmp"
        with open(itmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(
                ["i", day, len(rows), rows[0].id if rows else 0,
                 rows[-1].id if rows else 0],
                separators=(",", ":")) + "\n")
            for rid, o in marks:
                f.write(json.dumps(["e", rid, o],
                                   separators=(",", ":")) + "\n")
            f.flush()
            os.fdatasync(f.fileno())
        os.replace(itmp, idx_path(path))
    except OSError:
        pass
    # fsync the DIRECTORY: the rename is only a directory-entry update,
    # and the caller durably advances the cold watermark right after —
    # a power loss could otherwise persist a watermark pointing at a
    # segment whose directory entry never hit disk (rows already
    # deleted, day unrecoverable).  Process crashes can't hit this
    # (renames survive them); power loss can.
    dfd = os.open(dirp, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    return {"day": day, "path": path,
            "min": rows[0].id if rows else 0,
            "max": rows[-1].id if rows else 0, "count": len(rows)}


def scan_segments(dirp: Optional[str]) -> List[dict]:
    """Index every segment under ``dirp`` (day ASC): [{day, path, min,
    max, count}].  Leftover ``.tmp`` files from a crashed write are
    removed — the atomic rename never published them."""
    if not dirp or not os.path.isdir(dirp):
        return []
    out = []
    for name in sorted(os.listdir(dirp)):
        path = os.path.join(dirp, name)
        if name.endswith(".tmp"):
            try:
                os.remove(path)
            except OSError:
                pass
            continue
        if not name.endswith(SEG_SUFFIX):
            continue
        day = name[:-len(SEG_SUFFIX)]
        try:
            with open(path, "r", encoding="utf-8") as f:
                h = json.loads(f.readline())
            if not (isinstance(h, list) and len(h) >= 5 and h[0] == "d"):
                continue
            out.append({"day": day, "path": path, "min": int(h[3]),
                        "max": int(h[4]), "count": int(h[2])})
        except (OSError, ValueError):
            continue
    return out


def segment_overlaps(seg: dict, begin: Optional[float],
                     end: Optional[float]) -> bool:
    """Day-level pruning: can any record in ``seg`` match a
    [begin, end) begin_ts filter?  Every record in a day's segment has
    begin_ts inside that UTC day."""
    d0 = day_start(seg["day"])
    d1 = d0 + 86400.0
    if begin is not None and d1 <= begin:
        return False
    if end is not None and d0 >= end:
        return False
    return True


def cold_query(segments: List[dict], boundary: int, match,
               begin: Optional[float] = None,
               end: Optional[float] = None,
               min_id: int = 0,
               keep: Optional[int] = None,
               hist_order: bool = False
               ) -> Tuple[List[LogRecord], int, int]:
    """Scan the cold tier: records with ``min_id < id <= boundary``
    passing ``match`` (None = everything) from every segment the
    [begin, end) filter can touch.  Returns (rows, exact match count,
    segments read).  ``boundary`` caps reads at the durable watermark
    so a segment written just before a crash (rows still hot) is never
    double-counted; ``min_id`` is the retention floor.

    ``keep`` bounds the rows RETAINED (never the count): only the
    best ``keep`` under the caller's merge order survive — id ASC
    (cursor) or (begin_ts DESC, id ASC) with ``hist_order`` (history)
    — so a 90-day cold tier never materializes millions of records to
    serve page 1.  Segments walk in merge order (newest day first for
    history) and, once ``keep`` rows are held that every record of a
    later segment must sort after, an UNFILTERED fully-visible
    segment contributes its header count without being parsed at all
    — the common unfiltered history poll reads one or two segment
    files, not the whole tier."""
    out: List[LogRecord] = []
    total = 0
    touched = 0
    if hist_order:
        sort_key = lambda r: (-r.begin_ts, r.id)      # noqa: E731
        segs = sorted(segments, key=lambda s: s["day"], reverse=True)
    else:
        sort_key = lambda r: r.id                     # noqa: E731
        segs = sorted(segments, key=lambda s: s["min"])
    full = keep is not None and len(out) >= keep      # keep == 0
    for seg in segs:
        if seg["min"] > boundary or seg["max"] <= min_id:
            continue
        if not segment_overlaps(seg, begin, end):
            continue
        # header-count fast path: the segment is wholly visible (no
        # row filtered by match/time/floor/watermark) and none of its
        # rows can displace the kept set — count without parsing
        whole = (match is None and min_id < seg["min"]
                 and seg["max"] <= boundary
                 and (begin is None or begin <= day_start(seg["day"]))
                 and (end is None
                      or end >= day_start(seg["day"]) + 86400.0))
        if whole and full:
            if hist_order:
                # out is sorted, worst kept is out[-1]; every record
                # in this OLDER day begins before out[-1]
                if out[-1].begin_ts >= day_start(seg["day"]) + 86400.0:
                    total += seg["count"]
                    continue
            else:
                if seg["min"] > out[-1].id:
                    total += seg["count"]
                    continue
        touched += 1
        # ranged read: the retention floor and the durable watermark
        # become the seek bounds — a cursor poll deep into the tier
        # seeks past everything already served instead of re-parsing it
        for r in read_segment_range(seg["path"], lo=min_id + 1,
                                    hi=boundary):
            if match is not None and not match(r):
                continue
            total += 1
            out.append(r)
        if keep is not None and len(out) > keep:
            out.sort(key=sort_key)
            del out[keep:]
            full = True
        elif keep is not None:
            out.sort(key=sort_key)
            full = len(out) >= keep
    out.sort(key=sort_key)
    return out, total, touched
