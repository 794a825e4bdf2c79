"""Job x node eligibility: bitpacked placement masks.

The reference resolves placement per rule as
``include-node-ids ∪ (nodes of include-group-ids) − exclude-node-ids``
(web/job.go:244-253 — the correct subtractive semantics; the node-agent path
job.go:597-601,618-622 has a no-op exclude bug we deliberately do NOT
reproduce, see SURVEY.md §7).

On device the whole relation is one bitpacked matrix ``[J, ceil(N/32)]``
uint32 — 1M jobs x 10k nodes is ~1.25 GB of HBM instead of 10 GB of bools.
The matrix is built and patched host-side with vectorized numpy bit ops
(group edits touch only member rows, mirroring the reference's link index
node/group.go:9-82) and lives on device between ticks; per-tick traffic is
zero unless rules changed.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

__all__ = ["NodeUniverse", "pack_eligibility", "EligibilityBuilder"]


class NodeUniverse:
    """Stable node-id -> column-index mapping with fixed capacity.

    Columns are never reused while a node id is live; freed columns are
    recycled after explicit removal.  Fixed capacity keeps device shapes
    static across node churn.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.index: Dict[str, int] = {}
        self._free = list(range(capacity - 1, -1, -1))

    @property
    def n_words(self) -> int:
        return (self.capacity + 31) // 32

    def add(self, node_id: str) -> int:
        if node_id in self.index:
            return self.index[node_id]
        if not self._free:
            raise RuntimeError(f"node capacity {self.capacity} exhausted")
        col = self._free.pop()
        self.index[node_id] = col
        return col

    def remove(self, node_id: str) -> Optional[int]:
        col = self.index.pop(node_id, None)
        if col is not None:
            self._free.append(col)
        return col

    def cols(self, node_ids: Iterable[str]) -> List[int]:
        return [self.index[n] for n in node_ids if n in self.index]


def pack_bitmask(cols: Sequence[int], n_words: int) -> np.ndarray:
    """One bitpacked row: uint32[n_words] with the given column bits set."""
    row = np.zeros(n_words, dtype=np.uint32)
    if len(cols):
        c = np.asarray(cols, dtype=np.int64)
        np.bitwise_or.at(row, c // 32, (np.uint32(1) << (c % 32).astype(np.uint32)))
    return row


def pack_eligibility(include_cols: Sequence[int], group_rows: Sequence[np.ndarray],
                     exclude_cols: Sequence[int], n_words: int) -> np.ndarray:
    """Eligibility row for one job: (includes ∪ groups) − excludes.

    Empty includes and no groups means eligible nowhere — the reference's
    ``included()`` returns false when a rule names no nodes and no groups
    (job.go:274-288).
    """
    row = pack_bitmask(include_cols, n_words)
    for g in group_rows:
        row |= g
    row &= ~pack_bitmask(exclude_cols, n_words)
    return row


class EligibilityBuilder:
    """Incrementally maintained host mirror of the [J, W32] matrix.

    Tracks per-job rule inputs and per-group membership so a group edit
    rebuilds only the affected job rows (a reverse group->jobs index, like
    the reference's ``link`` map node/group.go:9-17).  Call :meth:`dirty_rows`
    to collect changed rows for a device scatter.
    """

    def __init__(self, universe: NodeUniverse, job_capacity: int):
        self.u = universe
        self.matrix = np.zeros((job_capacity, universe.n_words), dtype=np.uint32)
        self.job_rules: Dict[int, dict] = {}          # row -> rule inputs
        self.group_mask: Dict[str, np.ndarray] = {}   # gid -> packed row
        self.group_jobs: Dict[str, set] = {}          # gid -> {row}
        self._dirty: set = set()

    def set_group(self, gid: str, node_ids: Sequence[str]):
        self.group_mask[gid] = pack_bitmask(self.u.cols(node_ids), self.u.n_words)
        for row in self.group_jobs.get(gid, ()):  # rebuild member jobs
            self._rebuild(row)

    def del_group(self, gid: str):
        self.group_mask.pop(gid, None)
        # Keep the reverse index: member jobs still name the gid in their
        # rules, and must re-gain eligibility if the group id is recreated.
        for row in self.group_jobs.get(gid, set()).copy():
            self._rebuild(row)

    def set_job(self, row: int, include_nids: Sequence[str], gids: Sequence[str],
                exclude_nids: Sequence[str]):
        """Set one job row's rule inputs and rebuild its mask.

        OWNERSHIP TRANSFER: the three lists are stored by REFERENCE,
        not copied — the caller hands them over and must never mutate
        (or reuse) them afterwards, or eligibility rows silently
        corrupt without a rebuild.  Every current caller passes
        freshly-parsed rule lists (JobRule.from_dict allocates per
        document); the aliasing is deliberate — a copy per job was
        measurable at the 1M cold-load scale."""
        old = self.job_rules.get(row)
        if old:
            for g in old["gids"]:
                self.group_jobs.get(g, set()).discard(row)
        # lists are referenced, not copied: callers hand over freshly
        # parsed rule lists (JobRule.from_dict allocates per document),
        # and a copy per job was measurable at the 1M cold-load scale
        self.job_rules[row] = dict(nids=include_nids, gids=gids,
                                   ex=exclude_nids)
        for g in gids:
            self.group_jobs.setdefault(g, set()).add(row)
        self._rebuild(row)

    def del_job(self, row: int):
        old = self.job_rules.pop(row, None)
        if old:
            for g in old["gids"]:
                self.group_jobs.get(g, set()).discard(row)
        self.matrix[row] = 0
        self._dirty.add(row)

    def node_added(self, node_id: str):
        """New node: groups referencing it by id and jobs including it by id
        gain the column."""
        self.u.add(node_id)
        for row, r in self.job_rules.items():
            if node_id in r["nids"] or node_id in r["ex"]:
                self._rebuild(row)
        # group masks must be re-derived by the caller via set_group (it owns
        # the gid -> node_ids source of truth).

    def node_removed(self, node_id: str):
        """Node gone: free its column and scrub the bit everywhere, so a
        later recycled column never leaks old eligibility onto a new node."""
        col = self.u.remove(node_id)
        if col is None:
            return
        word, bit = col // 32, np.uint32(1 << (col % 32))
        for g in self.group_mask.values():
            g[word] &= ~bit
        affected = np.nonzero(self.matrix[:, word] & bit)[0]
        self.matrix[:, word] &= ~bit
        self._dirty.update(int(r) for r in affected)

    def _rebuild(self, row: int):
        r = self.job_rules.get(row)
        m = self.matrix
        if r is None:
            m[row] = 0
        elif not r["gids"] and not r["ex"]:
            # fast path — plain include list, the dominant fleet shape:
            # set bits directly in the matrix row instead of allocating
            # two scratch rows per job (pack_bitmask for includes AND
            # excludes was ~40% of the 1M cold load)
            m[row] = 0
            idx = self.u.index
            mrow = m[row]
            for n in r["nids"]:
                c = idx.get(n)
                if c is not None:
                    mrow[c >> 5] |= np.uint32(1 << (c & 31))
        else:
            groups = [self.group_mask[g] for g in r["gids"] if g in self.group_mask]
            m[row] = pack_eligibility(
                self.u.cols(r["nids"]), groups, self.u.cols(r["ex"]),
                self.u.n_words)
        self._dirty.add(row)

    def dirty_rows(self):
        """(rows, values) of changed rows since last call; resets the set."""
        rows = np.array(sorted(self._dirty), dtype=np.int32)
        self._dirty.clear()
        return rows, self.matrix[rows] if len(rows) else np.zeros((0, self.u.n_words), np.uint32)
