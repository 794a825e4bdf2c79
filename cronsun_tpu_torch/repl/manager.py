"""Per-process replication role machine for one store shard replica.

A :class:`ReplManager` runs inside every store server process of a
replica group (``addr1|addr2|addr3``):

- LEADER side: owns the shard's :class:`~cronsun_tpu_torch.repl.log.ReplLog`
  (fed by ``MemStore._log``), answers ``repl_hello`` with the Raft-lite
  log-matching check (follower's ``(seq, epoch)`` must match the
  leader's epoch history or it full-resyncs), serves ``repl_pull``
  long-polls and ``repl_snapshot`` bootstraps, and tracks follower
  acks for ``--repl-ack quorum`` (``ack_wait``).
- FOLLOWER side: a background thread discovers the leader (highest
  fencing epoch wins, never below our own), bootstraps via snapshot
  transfer when tailing is impossible, then applies the pulled record
  stream through ``MemStore.repl_apply`` — watch events fire and the
  local WAL records everything, so the follower's on-disk state is
  exactly a replica's snap+WAL.
- FAILOVER: when no acceptable leader answers for ``promote_after``
  seconds, the most-caught-up live member (ties to lowest group index)
  promotes — ``MemStore.repl_promote`` bumps the fencing epoch and
  stamps an "E" record into the stream.  Every leader BOOT opens a new
  epoch the same way, so cursor numbering never survives a process
  restart unfenced.  This is deterministic COORDINATION, not
  consensus: a partitioned minority can briefly hold a deposed leader,
  but followers refuse its records and quorum-acked writes on it fail
  (no acks); on contact with a newer epoch — or with an EQUAL-epoch
  rival (a concurrent promotion, or a rebooted ex-leader whose boot
  term collided with the live leader's), where the HIGHER shipping
  cursor wins and group index breaks exact ties — it demotes, poisons
  its cursor, and full-resyncs, discarding its divergent tail.  The
  seq-first rule matters: a rebooted stale leader must never depose a
  promoted rival that carries quorum-acked writes it lacks.  Operators who need partition-proof
  election should front the group with a real consensus service (see
  DESIGN.md).

Leases and fences are granted only by the leader (followers refuse
mutations with ``NotLeaderError``), so exactly-once semantics are
unchanged by replication.

Copy of ``cronsun_tpu/repl/manager.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from .. import log as _log
from ..store.remote import NotLeaderError, RemoteStore, RemoteStoreError
from .log import ReplLog


def _split_addr(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host, int(port)


class ReplManager:
    PULL_MAX = 512          # records per pull reply
    PULL_WAIT_MS = 400      # long-poll hold at the leader
    PROBE_S = 1.0           # leader's deposed-epoch sweep cadence
    SNAP_PAGE = 50_000      # snapshot lines per repl_snapshot page

    def __init__(self, store, self_addr: str, group, ack_mode: str = "async",
                 token: str = "", promote_after: float = 3.0,
                 ack_timeout: float = 5.0,
                 initial_role: Optional[str] = None,
                 client_timeout: float = 10.0):
        if ack_mode not in ("async", "quorum"):
            raise ValueError(f"repl ack mode {ack_mode!r} "
                             "(want async|quorum)")
        self.store = store
        self.self_addr = str(self_addr)
        self.group = [str(a) for a in group]
        if self.self_addr not in self.group:
            raise ValueError(f"replica {self_addr!r} is not a member of "
                             f"its group {self.group}")
        self.index = self.group.index(self.self_addr)
        self.ack_mode = ack_mode
        self.ack_timeout = float(ack_timeout)
        self._token = token
        self._promote_after = float(promote_after)
        self._client_timeout = float(client_timeout)
        role = initial_role or ("leader" if self.index == 0
                                else "follower")
        if role not in ("leader", "follower"):
            raise ValueError(f"repl role {role!r}")
        self.log = ReplLog(epoch=store.repl_epoch())
        if role == "leader":
            # every leader BOOT opens a new fencing term (repl_promote
            # bumps the epoch and stamps the "E" record into the WAL),
            # then the cursor seeds at the store's boot revision.  Both
            # halves matter: the revision seed makes a follower
            # claiming cursor 0 against a nonempty leader bootstrap
            # instead of tail, and the epoch bump fences SURVIVING
            # followers — their cursors are numbered by the previous
            # process's ring, inflated past the revision by lease
            # records ("g"/"k"/"x" never bump rev), so once this ring's
            # seq catches up to such a stale cursor the log-match would
            # collide and silently skip records.  With the boot term
            # the baseline epoch no longer matches theirs and hello
            # full-resyncs them.
            epoch = store.repl_promote()
            self.log.reset(store.rev(), epoch)
        else:
            # a (re)starting follower's cursor lives in a DEAD
            # numbering space (the ring is in-memory; the leader's
            # cursors don't survive our restart): poison it so the
            # first hello always full-resyncs, which re-baselines the
            # cursor into the live leader's numbering
            self.log.reset(-1, store.repl_epoch())
        self._role = role
        store.repl_attach(self.log, follower=(role == "follower"))
        self._mu = threading.Condition()
        # fid -> (acked_seq, applied_rev, wall_ts) — leader side
        self._followers: Dict[str, Tuple[int, int, float]] = {}
        self._leader_addr: Optional[str] = (
            self.self_addr if role == "leader" else None)
        self._leader_head: Optional[int] = None
        self._lag_zero_at = time.time()
        self._leaderless_since: Optional[float] = None
        self.promotions = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._peers: Dict[str, RemoteStore] = {}
        # fid -> (lines, seq, epoch, pages): per-follower bootstrap
        # image held across its paged repl_snapshot fetches
        self._snap_cache: Dict[str, Tuple[list, int, int, int]] = {}

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "ReplManager":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repl-manager")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self.log.wake()
        with self._mu:
            self._mu.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=3)
        for cli in list(self._peers.values()):
            try:
                cli.close()
            except OSError:
                pass
        self._peers.clear()

    def role(self) -> str:
        with self._mu:
            return self._role

    # ---- wire handlers (called from the server's dispatch) ---------------

    def hello(self, fid: str, f_epoch: int, f_seq: int) -> dict:
        """Follower attach: log-match its ``(seq, epoch)`` cursor
        against our epoch history.  A matching cursor tails; anything
        else (divergent tail from a deposed leader, cursor older than
        the ring) full-resyncs via ``repl_snapshot``."""
        f_epoch, f_seq = int(f_epoch), int(f_seq)
        my_epoch = self.store.repl_epoch()
        if f_epoch > my_epoch:
            # the caller has seen a newer fencing epoch: we are deposed
            self._demote(f_epoch)
            raise NotLeaderError(
                f"repl: peer epoch {f_epoch} > ours {my_epoch}; deposed")
        if self.role() != "leader":
            raise NotLeaderError("repl: not the leader")
        resync = not (self.log.covers(f_seq)
                      and self.log.epoch_at(f_seq) == f_epoch)
        with self._mu:
            self._followers[str(fid)] = (
                -1 if resync else f_seq, -1, time.time())
        return {"resync": bool(resync), "seq": self.log.seq,
                "epoch": my_epoch}

    def pull(self, fid: str, after_seq: int, max_n: int, wait_ms: float,
             applied_rev: int) -> dict:
        """Tail read: up to ``max_n`` records after the follower's
        cursor, long-polled.  The cursor doubles as the follower's ack
        (it has applied everything <= after_seq)."""
        if self.role() != "leader":
            raise NotLeaderError("repl: not the leader")
        after_seq = int(after_seq)
        my_epoch = self.store.repl_epoch()
        if not self.log.covers(after_seq):
            return {"resync": True, "seq": self.log.seq,
                    "epoch": my_epoch}
        self.ack(fid, after_seq, applied_rev)
        recs = self.log.read_after(
            after_seq, max_n=int(max_n),
            timeout=min(float(wait_ms), 2000.0) / 1000.0)
        return {"recs": recs, "seq": self.log.seq, "epoch": my_epoch}

    def ack(self, fid: str, seq: int, applied_rev: int) -> bool:
        with self._mu:
            self._followers[str(fid)] = (int(seq), int(applied_rev),
                                         time.time())
            self._mu.notify_all()
        return True

    def snapshot_dump(self, fid: str = "", page: int = 0) -> dict:
        """Bootstrap image: consistent snapshot lines + the repl cursor
        and fencing epoch they correspond to.

        With a ``fid`` the transfer is PAGED: page 0 takes one
        staggered dump (writers stall at most one stripe's copy — see
        ``MemStore.repl_dump``), caches it per follower, and every
        reply ships at most ``SNAP_PAGE`` lines, so a large store never
        has to serialize into a single wire message inside one client
        timeout.  The cache entry drops when the last page is served
        (or on any role change).  Without a ``fid`` the whole image
        ships in one reply (tooling / conformance compat)."""
        if self.role() != "leader":
            raise NotLeaderError("repl: not the leader")
        if not fid:
            lines, seq, epoch = self.store.repl_dump()
            return {"lines": lines, "seq": seq, "epoch": epoch,
                    "pages": 1, "page": 0}
        fid, page = str(fid), int(page)
        if page == 0:
            lines, seq, epoch = self.store.repl_dump()
            pages = max(1, -(-len(lines) // self.SNAP_PAGE))
            with self._mu:
                self._snap_cache[fid] = (lines, seq, epoch, pages)
        with self._mu:
            cached = self._snap_cache.get(fid)
        if cached is None:
            # leader restarted / role flapped mid-transfer: the pages
            # would come from two different images — restart the
            # bootstrap from page 0 instead
            raise RuntimeError(
                f"repl_snapshot: no cached image for {fid!r} "
                f"(page {page}); restart from page 0")
        lines, seq, epoch, pages = cached
        lo = page * self.SNAP_PAGE
        if page >= pages - 1:
            with self._mu:
                self._snap_cache.pop(fid, None)
        return {"lines": lines[lo:lo + self.SNAP_PAGE], "seq": seq,
                "epoch": epoch, "pages": pages, "page": page}

    def ack_wait(self, seq: int, timeout: Optional[float] = None) -> bool:
        """Quorum ack: block until >= 1 follower has acked through
        ``seq`` (its cursor covers the write).  False on timeout — the
        write is applied locally but NOT known replicated; the server
        reports the op as failed so the client retries idempotently."""
        deadline = time.monotonic() + (self.ack_timeout if timeout is None
                                       else float(timeout))
        with self._mu:
            while True:
                if any(a[0] >= seq for a in self._followers.values()):
                    return True
                rem = deadline - time.monotonic()
                if rem <= 0 or self._stop.is_set() \
                        or self._role != "leader":
                    return False
                self._mu.wait(min(rem, 0.25))

    def status(self) -> dict:
        role = self.role()
        now = time.time()
        st = {"enabled": True, "role": role, "self": self.self_addr,
              "group": list(self.group),
              "epoch": self.store.repl_epoch(), "seq": self.log.seq,
              "applied_rev": self.store.rev(), "ack_mode": self.ack_mode,
              "promotions": self.promotions}
        if role == "leader":
            with self._mu:
                st["leader"] = self.self_addr
                st["followers"] = {
                    fid: {"acked_seq": a[0], "applied_rev": a[1],
                          "age_s": round(now - a[2], 3)}
                    for fid, a in self._followers.items()}
            st["lag_records"] = 0
            st["lag_seconds"] = 0.0
        else:
            with self._mu:
                st["leader"] = self._leader_addr
                head = self._leader_head
            lag = None if head is None else max(0, head - self.log.seq)
            st["lag_records"] = lag
            st["lag_seconds"] = (0.0 if lag == 0 else
                                 round(now - self._lag_zero_at, 3))
        return st

    # ---- follower loop ---------------------------------------------------

    def _run(self):
        while not self._stop.is_set():
            try:
                if self.role() == "leader":
                    self._leader_probe()
                    self._stop.wait(self.PROBE_S)
                else:
                    self._follow_once()
            except Exception as e:  # noqa: BLE001 — the loop must live
                _log.errorf("repl loop error: %s", e)
                self._stop.wait(0.25)

    def _leader_probe(self):
        """A leader sweeps its peers for a NEWER fencing epoch — the
        deposed-while-partitioned case: seeing one demotes us, so our
        divergent tail is discarded by the resync instead of serving
        stale reads forever.  An EQUAL-epoch peer leader (two followers
        promoted concurrently off the same base epoch, or a rebooted
        ex-leader whose boot term collided with the promoted rival's)
        is broken deterministically: the HIGHER shipping cursor wins —
        the contender that lacks writes the other carries is the one
        that must discard — and group index (lowest wins) only breaks
        exact seq ties, so exactly one of the pair demotes and resyncs
        instead of both serving as leader at identical epochs forever.
        Index-first would let a rebooted stale leader roll the group
        back over quorum-acked writes it slept through."""
        my_epoch = self.store.repl_epoch()
        for addr in self.group:
            if addr == self.self_addr:
                continue
            st = self._status_of(addr)
            if st is None:
                continue
            ep = int(st.get("epoch", 0))
            if ep > my_epoch:
                _log.warnf("repl: peer %s at epoch %d > ours %d; "
                           "demoting", addr, ep, my_epoch)
                self._demote(ep)
                return
            if ep == my_epoch and st.get("role") == "leader":
                peer_seq = int(st.get("seq", -1))
                my_seq = self.log.seq
                if peer_seq > my_seq or (peer_seq == my_seq and
                                         self.group.index(addr) < self.index):
                    _log.warnf("repl: equal-epoch leader %s (epoch %d, "
                               "seq %d vs ours %d) wins the tie-break; "
                               "demoting", addr, ep, peer_seq, my_seq)
                    self._demote(ep)
                    return

    def _follow_once(self):
        found = self._discover_leader()
        if found is None:
            self._maybe_promote()
            return
        addr, cli = found
        try:
            r = cli._call("repl_hello", self.self_addr,
                          self.store.repl_epoch(), self.log.seq)
            if int(r.get("epoch", -1)) < self.store.repl_epoch():
                return                      # stale leader: re-discover
            if r.get("resync"):
                snap = cli._call("repl_snapshot", self.self_addr, 0)
                lines = list(snap.get("lines") or [])
                for p in range(1, int(snap.get("pages", 1))):
                    nxt = cli._call("repl_snapshot", self.self_addr, p)
                    lines.extend(nxt.get("lines") or [])
                self.store.repl_load(lines, snap["seq"], snap["epoch"])
                _log.infof("repl: bootstrapped from %s (seq %d, "
                           "epoch %d)", addr, self.log.seq,
                           self.store.repl_epoch())
        except (RemoteStoreError, OSError, KeyError, TypeError):
            self._drop_peer(addr)
            return
        with self._mu:
            self._leader_addr = addr
            self._leader_head = None
        self._pull_loop(addr, cli)
        with self._mu:
            if self._leader_addr == addr:
                self._leader_addr = None

    def _pull_loop(self, addr: str, cli: RemoteStore):
        while not self._stop.is_set() and self.role() == "follower":
            try:
                r = cli._call("repl_pull", self.self_addr, self.log.seq,
                              self.PULL_MAX, self.PULL_WAIT_MS,
                              self.store.rev())
            except (RemoteStoreError, OSError):
                self._drop_peer(addr)
                return
            epoch = int(r.get("epoch", 0))
            if epoch < self.store.repl_epoch():
                return           # deposed leader still serving: refuse
            if r.get("resync"):
                return           # cursor fell out of its ring: re-hello
            for seq, rec in (r.get("recs") or []):
                self.store.repl_apply(rec)
                if self.log.seq != int(seq):
                    # lockstep broken (repl_apply logged != 1 record):
                    # poison our cursor so the next hello full-resyncs
                    _log.errorf("repl: cursor lockstep broken at seq "
                                "%s (local %d); forcing resync",
                                seq, self.log.seq)
                    self.log.reset(-1, -1)
                    return
            head = int(r.get("seq", self.log.seq))
            with self._mu:
                self._leader_head = head
            if self.log.seq >= head:
                self._lag_zero_at = time.time()

    # ---- leader discovery / takeover -------------------------------------

    def _discover_leader(self) -> Optional[Tuple[str, RemoteStore]]:
        my_epoch = self.store.repl_epoch()
        best: Optional[Tuple[int, str]] = None
        for addr in self.group:
            if addr == self.self_addr:
                continue
            st = self._status_of(addr)
            if st is None or st.get("role") != "leader":
                continue
            ep = int(st.get("epoch", 0))
            if ep < my_epoch:
                continue         # deposed leader: its records are fenced
            if best is None or ep > best[0]:
                best = (ep, addr)
        if best is None:
            return None
        self._leaderless_since = None
        try:
            return best[1], self._peer(best[1])
        except OSError:
            return None

    def _maybe_promote(self):
        now = time.monotonic()
        if self._leaderless_since is None:
            self._leaderless_since = now
        if now - self._leaderless_since < self._promote_after:
            self._stop.wait(0.25)
            return
        # takeover election (coordination, not consensus): the
        # most-caught-up LIVE member wins, ties to the lowest group
        # index; everyone else keeps waiting and re-discovers
        mine = (self.log.seq, -self.index)
        for addr in self.group:
            if addr == self.self_addr:
                continue
            st = self._status_of(addr)
            if st is None or not st.get("enabled"):
                continue
            if st.get("role") == "leader" \
                    and int(st.get("epoch", 0)) >= self.store.repl_epoch():
                self._leaderless_since = None
                return                     # a leader appeared after all
            cand = (int(st.get("seq", -1)), -self.group.index(addr))
            if cand > mine:
                self._stop.wait(0.25)
                return                     # a better candidate is live
        self._promote()

    def _promote(self):
        epoch = self.store.repl_promote()
        with self._mu:
            self._role = "leader"
            self._leader_addr = self.self_addr
            self._leader_head = None
            self._followers.clear()
            self._snap_cache.clear()
            self.promotions += 1
            self._leaderless_since = None
            self._mu.notify_all()
        _log.infof("repl: promoted to leader (epoch %d, seq %d, rev %d)",
                   epoch, self.log.seq, self.store.rev())

    def _demote(self, seen_epoch: int):
        with self._mu:
            if self._role != "leader":
                return
            self._role = "follower"
            self._leader_addr = None
            self._leader_head = None
            self._followers.clear()
            self._snap_cache.clear()
            self._leaderless_since = None
            self._mu.notify_all()
        # follower mode: local lease expiry off, mutations refused.
        # The cursor is POISONED so the next hello always full-resyncs:
        # our pre-deposition tail may carry appends the winning leader
        # never saw, and with an equal-epoch rival (concurrent
        # promotions) the epoch history alone cannot flag them.
        self.log.reset(-1, -1)
        self.store.repl_attach(self.log, follower=True)
        _log.warnf("repl: demoted (saw fencing epoch %d)", seen_epoch)

    # ---- peer clients ----------------------------------------------------

    def _peer(self, addr: str) -> RemoteStore:
        cli = self._peers.get(addr)
        if cli is not None and cli._sock is not None and not cli._closed:
            return cli
        if cli is not None:
            try:
                cli.close()
            except OSError:
                pass
        host, port = _split_addr(addr)
        cli = RemoteStore(host, port, timeout=self._client_timeout,
                          reconnect=False, token=self._token)
        self._peers[addr] = cli
        return cli

    def _drop_peer(self, addr: str):
        cli = self._peers.pop(addr, None)
        if cli is not None:
            try:
                cli.close()
            except OSError:
                pass

    def _status_of(self, addr: str) -> Optional[dict]:
        try:
            st = self._peer(addr)._call("repl_status")
        except (OSError, RemoteStoreError, KeyError):
            self._drop_peer(addr)
            return None
        if not isinstance(st, dict) or not st.get("enabled"):
            return None
        return st
