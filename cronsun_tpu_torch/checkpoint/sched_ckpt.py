"""Versioned on-disk scheduler checkpoints.

A checkpoint is the scheduler's BUILT state — packed schedule-table
arrays, eligibility masks, row allocator, job metadata, execution-state
mirrors — keyed by the store revision it reflects.  A standby restores
one and replays only the watch delta since that revision instead of
re-listing and re-parsing the whole store (85.9 s of dispatch outage at
the 1M x 10k scale, BENCH_r05).

Format: one pickle file (host numpy arrays + plain dicts; the device
arrays are materialized to host at save time) wrapped in a version/shape
header, written atomically (temp file + rename, fdatasync before the
rename) so a crash mid-save leaves the previous checkpoint intact.
Compatibility is strict by design: any mismatch — version, planner
shapes, keyspace prefix — raises :class:`CheckpointError` and the caller
falls back to a cold load, LOUDLY.  A checkpoint is an optimization,
never an alternate source of truth.

DELTA CHAIN: a full (base) save is O(state) — ~seconds at 1M jobs —
which caps how tight the checkpoint cadence can run.  Since the
scheduler mirrors every mutation from its watch streams, the state
since the last save is exactly the applied watch events: a DELTA save
writes only those (plus the leader's own-publish order accounting,
which never echoes back through the delete-only orders watch) as
``FILE.d<seq>`` beside the base, each wrapped in a chain header —

    {version, kind: "delta", chain: <base nonce>, seq, prev_rev, rev,
     events: [(stream, type, key, value), ...]}

Restore = load base, fold each delta's events through the SAME watch
handlers live application used, then replay the store's watch tail from
the last element's revision (the existing rev+1 path).  Chain
validation is strict and runs BEFORE any state mutates: a torn element,
a sequence gap, a foreign nonce, or a prev_rev/rev mismatch raises
:class:`CheckpointError` and the caller cold-loads, loudly.  ``rev``
is a scalar against a single store and a per-shard revision VECTOR
against a sharded one (the resume shape ``ShardedStore.watch``
accepts).  Rebase (a fresh full save) unlinks the chain tail in
DESCENDING seq order before renaming the new base over the old, so
every crash point leaves either the old chain (a contiguous prefix) or
the new base — never a gap.

The file format is the JAX package's (``cronsun_tpu/checkpoint/
sched_ckpt.py``), so either scheduler restores the other's checkpoints.
The one class of the domain model a pickle names (``Group``, in the
scheduler's ``groups`` dict) is named by the package that wrote it; the
loaders here map the JAX package's module names onto this package's
copies, so loading a JAX scheduler's checkpoint never imports the JAX
package.
"""

from __future__ import annotations

import contextlib
import gc
import os
import pickle

FORMAT_VERSION = 1
FILE_NAME = "sched.ckpt"

# delta-chain elements live beside the base as FILE.d1, FILE.d2, ...
DELTA_SUFFIX = ".d"


class CheckpointError(RuntimeError):
    """The checkpoint is missing, unreadable, or shaped for a different
    deployment — the caller must cold-load instead."""


# the JAX package, whose modules this package copies under the same paths
_JAX_PACKAGE = "cronsun_tpu"
_PORT_PACKAGE = __name__.split(".")[0]


class _PortUnpickler(pickle.Unpickler):
    """Unpickles classes the JAX package's scheduler named as their
    copies in this package (``cronsun_tpu.core.models.Group`` ->
    ``cronsun_tpu_torch.core.models.Group``)."""

    def find_class(self, module, name):
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
            module = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
        return super().find_class(module, name)


def _unpickle(f):
    return _PortUnpickler(f).load()


def pack_jobs(jobs: dict) -> list:
    """Columnar encoding of the scheduler's jobs dict: plain tuples
    instead of dataclass object graphs.  Pickling 50k Job + JobRule
    objects pays the reduce protocol per object (~1.5 s of a measured
    2.2 s warm takeover at the 50k scale, most of it on load); tuple
    rows cut that to the low hundreds of ms and :func:`unpack_jobs`
    rebuilds real objects cheaper than pickle would have."""
    with gc_paused():
        return [
            (key,
             (j.id, j.name, j.group, j.command, j.user, j.pause,
              j.timeout, j.parallels, j.retry, j.interval, j.kind,
              j.avg_time, j.fail_notify, j.to,
              # deps ride as (on, misfire, max_in_flight) or None —
              # positional like every other column
              None if j.deps is None
              else (j.deps.on, j.deps.misfire, j.deps.max_in_flight),
              j.jitter),
             [(r.id, r.timer, r.gids, r.nids, r.exclude_nids)
              for r in j.rules])
            for key, j in jobs.items()]


def unpack_jobs(packed: list) -> dict:
    from ..core.models import DepSpec, Job, JobRule
    out = {}
    with gc_paused():
        for key, f, rules in packed:
            # pre-DAG checkpoints packed 14 columns; deps default None.
            # pre-jitter checkpoints packed 15; jitter defaults 0 (the
            # smear arm stays disarmed for them, bit-identically).
            d = f[14] if len(f) > 14 else None
            jit = f[15] if len(f) > 15 else 0
            out[tuple(key)] = Job(
                id=f[0], name=f[1], group=f[2], command=f[3], user=f[4],
                rules=[JobRule(id=r[0], timer=r[1], gids=r[2], nids=r[3],
                               exclude_nids=r[4]) for r in rules],
                pause=f[5], timeout=f[6], parallels=f[7], retry=f[8],
                interval=f[9], kind=f[10], avg_time=f[11],
                fail_notify=f[12], to=f[13],
                deps=None if d is None
                else DepSpec(on=list(d[0]), misfire=d[1],
                             max_in_flight=d[2]),
                jitter=jit)
    return out


@contextlib.contextmanager
def gc_paused():
    """Suppress the cyclic GC across a bulk (de)serialization: a
    million-object pickle load triggers generation-2 collections that
    scan the WHOLE heap (in a process that already holds a scheduler's
    state, that was a measured ~1.6 s of a 2.2 s warm takeover at 50k
    jobs), and everything allocated mid-load is live anyway."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def save_checkpoint(path: str, state: dict) -> None:
    """Atomically persist ``state`` (a plain dict of host arrays/dicts)
    with the format version stamped in."""
    state = dict(state, version=FORMAT_VERSION)
    tmp = path + ".tmp"
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    try:
        with open(tmp, "wb") as f, gc_paused():
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fdatasync(f.fileno())
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """Load and version-check a checkpoint; :class:`CheckpointError` on
    any mismatch (missing file, torn/foreign pickle, version skew)."""
    if not os.path.exists(path):
        raise CheckpointError(f"no checkpoint at {path}")
    try:
        with open(path, "rb") as f, gc_paused():
            state = _unpickle(f)
    except Exception as e:  # noqa: BLE001 — torn/foreign file
        raise CheckpointError(f"unreadable checkpoint {path}: {e}")
    if not isinstance(state, dict):
        raise CheckpointError(f"malformed checkpoint {path}")
    ver = state.get("version")
    if ver != FORMAT_VERSION:
        raise CheckpointError(
            f"checkpoint {path} version {ver} != {FORMAT_VERSION}")
    return state


# ---- delta chain -----------------------------------------------------------

def delta_path(base_path: str, seq: int) -> str:
    return f"{base_path}{DELTA_SUFFIX}{seq}"


def list_delta_seqs(base_path: str) -> list:
    """Ascending seq numbers of every ``FILE.d<seq>`` beside the base
    (gaps included — the chain validator refuses them)."""
    d = os.path.dirname(base_path) or "."
    name = os.path.basename(base_path) + DELTA_SUFFIX
    seqs = []
    try:
        entries = os.listdir(d)
    except OSError:
        return []
    for e in entries:
        if e.startswith(name) and not e.endswith(".tmp"):
            try:
                seqs.append(int(e[len(name):]))
            except ValueError:
                continue
    return sorted(seqs)


def _valid_events(events) -> bool:
    """Strict shape check so a validated delta's fold cannot fail on
    malformed content AFTER base state is installed: every event is
    (stream:str, type:str, key:str, value) where value is a str for
    watch-stream events and a (node:str, jobs:list) pair for the
    synthetic ``ordmirror`` own-publish accounting stream."""
    if not isinstance(events, list):
        return False
    for ev in events:
        if not (isinstance(ev, (list, tuple)) and len(ev) == 4
                and isinstance(ev[0], str) and isinstance(ev[1], str)
                and isinstance(ev[2], str)):
            return False
        v = ev[3]
        if ev[0] == "ordmirror":
            if not (isinstance(v, (list, tuple)) and len(v) == 2
                    and isinstance(v[0], str)
                    and isinstance(v[1], (list, tuple))):
                return False
        elif not isinstance(v, str):
            return False
    return True


def save_delta(base_path: str, chain: str, seq: int, prev_rev, rev,
               events: list) -> str:
    """Atomically persist one delta-chain element.  ``prev_rev``/``rev``
    are scalars (single store) or per-shard revision vectors (sharded);
    the restore path treats them as opaque equality-checked tokens."""
    path = delta_path(base_path, seq)
    rec = dict(version=FORMAT_VERSION, kind="delta", chain=chain,
               seq=seq, prev_rev=prev_rev, rev=rev, events=events)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f, gc_paused():
            pickle.dump(rec, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fdatasync(f.fileno())
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)
    return path


def load_delta_chain(base_path: str, base_state: dict) -> list:
    """Load and validate the WHOLE delta chain beside ``base_path``
    against the loaded base: contiguous seqs from 1, matching chain
    nonce, prev_rev linking element to element, well-formed event
    tuples.  Any violation — torn pickle, gap, foreign nonce, rev
    mismatch — raises :class:`CheckpointError` (the caller cold-loads
    LOUDLY; a delta chain is never an alternate source of truth).
    Returns the validated delta dicts in fold order ([] when the base
    stands alone).  Runs before ANY state mutates, so a refused chain
    leaves a clean slate."""
    seqs = list_delta_seqs(base_path)
    if not seqs:
        return []
    nonce = base_state.get("chain")
    if not nonce:
        raise CheckpointError(
            f"delta files {seqs} beside a base with no chain nonce "
            f"(pre-delta or foreign base) at {base_path}")
    if seqs != list(range(1, len(seqs) + 1)):
        raise CheckpointError(
            f"delta chain at {base_path} has gaps: seqs {seqs}")
    out = []
    prev_rev = base_state.get("rev")
    for seq in seqs:
        p = delta_path(base_path, seq)
        try:
            with open(p, "rb") as f, gc_paused():
                rec = _unpickle(f)
        except Exception as e:  # noqa: BLE001 — torn/foreign file
            raise CheckpointError(f"unreadable delta {p}: {e}")
        if not isinstance(rec, dict) or rec.get("kind") != "delta":
            raise CheckpointError(f"malformed delta {p}")
        if rec.get("version") != FORMAT_VERSION:
            raise CheckpointError(
                f"delta {p} version {rec.get('version')} != "
                f"{FORMAT_VERSION}")
        if rec.get("chain") != nonce:
            raise CheckpointError(
                f"delta {p} chain {rec.get('chain')!r} != base nonce "
                f"{nonce!r}")
        if rec.get("seq") != seq:
            raise CheckpointError(
                f"delta {p} header seq {rec.get('seq')} != file seq "
                f"{seq}")
        if rec.get("prev_rev") != prev_rev:
            raise CheckpointError(
                f"delta {p} prev_rev {rec.get('prev_rev')} != chain "
                f"rev {prev_rev}")
        if not _valid_events(rec.get("events")):
            raise CheckpointError(f"delta {p} carries malformed events")
        prev_rev = rec.get("rev")
        out.append(rec)
    return out


def clear_delta_chain(base_path: str) -> None:
    """Unlink every chain element, DESCENDING seq order — a crash
    mid-way leaves a contiguous prefix (a valid, shorter chain), never
    a gap."""
    for seq in reversed(list_delta_seqs(base_path)):
        try:
            os.remove(delta_path(base_path, seq))
        except OSError:
            pass


def compact_delta_chain(base_path: str) -> dict:
    """OFFLINE chain compaction: fold every ``FILE.d<seq>`` element into
    ONE (``cronsun-ctl checkpoint-compact``) — a long chain rebases
    without the O(state) full save the scheduler thread would otherwise
    pay, and the next restore folds one element instead of N.

    The chain validates WHOLE first with the same strictness a restore
    applies (:func:`load_delta_chain`): torn elements, seq gaps, foreign
    nonces and rev mismatches all refuse with :class:`CheckpointError`
    and leave the files untouched.  Event order is preserved exactly —
    the combined element is the concatenation in fold order, so base +
    combined reproduces base + chain.

    Crash-safe by the same prefix argument as the saver: the combined
    element writes to a temp file first; stale elements unlink in
    DESCENDING seq order (every intermediate crash leaves a contiguous,
    still-valid — merely shorter — old chain); the final atomic rename
    over ``.d1`` publishes the compacted chain.

    OFFLINE means offline: a LIVE scheduler extending this chain keeps
    its next seq in memory — compacting under it makes the live
    scheduler's next delta a seq gap, which a restore then refuses
    (loudly, cold load).  Run it against a quiesced checkpoint dir.
    """
    st = load_checkpoint(base_path)
    deltas = load_delta_chain(base_path, st)
    if len(deltas) <= 1:
        return {"folded": len(deltas), "events": 0,
                "rev": (deltas[-1]["rev"] if deltas else st.get("rev")),
                "compacted": False}
    events: list = []
    for d in deltas:
        events.extend(d["events"])
    rec = dict(version=FORMAT_VERSION, kind="delta",
               chain=st["chain"], seq=1, prev_rev=st.get("rev"),
               rev=deltas[-1]["rev"], events=events)
    d1 = delta_path(base_path, 1)
    tmp = d1 + ".ctmp"
    try:
        with open(tmp, "wb") as f, gc_paused():
            pickle.dump(rec, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fdatasync(f.fileno())
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    for d in reversed(deltas[1:]):
        os.remove(delta_path(base_path, d["seq"]))
    os.replace(tmp, d1)
    return {"folded": len(deltas), "events": len(events),
            "rev": rec["rev"], "compacted": True}
