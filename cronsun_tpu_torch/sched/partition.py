"""Partitioned scheduler plane: job-space routing + the partition-map pin.

The job space splits into P partitions by the SAME 64-bit FNV routing
token the sharded store already routes a job's key family by
(``store/sharded.py shard_token``: ``cmd``/``lock``/``proc``/``phase``
keys all hash ``"j:" + job_id``), so a job's fences, orders, procs and
alone-locks co-locate with its owning partition by construction.  Each
partition runs as an independent ``SchedulerService`` — its own leader
lease (``lock/sched/p<i>``), its own watch slice (job-keyed streams
filtered to owned tokens; node/group/tenant/ckpt streams shared), its
own high-water mark and checkpoint chain — so P leaders tick
concurrently against the store with no cross-partition coordination on
the fire path.  The only shared state is per-node load/remaining
capacity, reconciled through the leased ``sched/acct/p<i>`` demand
summaries (O(nodes) each, folded into every partition's capacity view).

The topology is pinned under ``sched/partmap`` exactly like the store's
shardmap (PR 6): the first partition leader publishes ``{"p": P,
"hash": SCHEME}``, every later scheduler verifies it, and a scheduler
configured with a different partition count refuses to start instead of
silently double-scheduling the job space under two topologies.  P=1 is
pure passthrough: no partmap write, no key changes, byte-identical
wire output (pinned by differential test) — but a P=1 scheduler DOES
refuse to start against a fleet whose partmap pins P>1.
"""

from __future__ import annotations

import json
from typing import Optional

from ..core import Keyspace
from ..store.sharded import fnv1a

# versioned with the store's token scheme on purpose: partition routing
# IS the store's job-token routing taken mod P
PART_SCHEME = "fnv1a-jobtoken-v1"


class PartitionMapMismatch(RuntimeError):
    """The fleet's pinned partition topology contradicts this
    scheduler's configuration — refusing beats double-scheduling."""


def job_token(job_id: str) -> int:
    """The job's 64-bit routing token — identical to the sharded
    store's token for the job's ``cmd``/``lock``/``proc``/``phase``
    keys (``fnv1a("j:" + job_id)``)."""
    return fnv1a("j:" + job_id)


def job_partition(job_id: str, partitions: int) -> int:
    """Owning partition of a job: its routing token mod P."""
    return job_token(job_id) % partitions if partitions > 1 else 0


def pin_partition_map(store, ks: Keyspace, partitions: int) -> None:
    """Publish-or-verify the ``sched/partmap`` pin.

    P>1: publish ``{"p": P, "hash": PART_SCHEME}`` create-if-absent,
    then read back and verify — the first leader pins, every later
    scheduler (leader or standby, any partition) must agree.  P=1:
    verify-only — no write (the passthrough contract), but a pinned
    P>1 map refuses the unpartitioned scheduler loudly: its single
    leader would re-dispatch every partition's jobs under a second
    topology.  Raises :class:`PartitionMapMismatch` on any conflict."""
    want = {"p": int(partitions), "hash": PART_SCHEME}
    if partitions > 1:
        kv = store.get(ks.partmap)
        if kv is None:
            store.put_if_absent(
                ks.partmap, json.dumps(want, separators=(",", ":")))
            kv = store.get(ks.partmap)
        pinned = _parse(kv.value if kv is not None else None)
        if pinned != want:
            raise PartitionMapMismatch(
                f"partition map pinned at {ks.partmap} is {pinned}, "
                f"this scheduler is configured for {want} — resize "
                f"requires draining the fleet and clearing the pin "
                f"(see OPERATIONS.md)")
        return
    kv = store.get(ks.partmap)
    if kv is None:
        return
    pinned = _parse(kv.value)
    if pinned is not None and pinned.get("p", 1) != 1:
        raise PartitionMapMismatch(
            f"fleet partition map pins p={pinned.get('p')} "
            f"({ks.partmap}) but this scheduler runs UNPARTITIONED — "
            f"it would re-dispatch every partition's jobs; launch with "
            f"--partitions {pinned.get('p')} --partition <i> instead")


def _parse(value: Optional[str]) -> Optional[dict]:
    if value is None:
        return None
    try:
        doc = json.loads(value)
        if not isinstance(doc, dict):
            return None
        return {"p": int(doc.get("p", 0)), "hash": doc.get("hash", "")}
    except (json.JSONDecodeError, TypeError, ValueError):
        # a hand-edited/corrupted pin must surface as the LOUD
        # mismatch refusal (parsed None != want), never a raw
        # TypeError crashing startup
        return None


def encode_demand(excl: dict, load: dict) -> str:
    """One partition's per-node demand summary wire format:
    ``{node: [excl_slots, load]}`` over nodes with NONZERO demand only
    (demand-sparse: an idle fleet's summary is ``{}``)."""
    out = {}
    for n, e in excl.items():
        if e:
            out[n] = [int(e), 0.0]
    for n, l in load.items():
        if l:
            ent = out.get(n)
            if ent is None:
                out[n] = [0, round(float(l), 3)]
            else:
                ent[1] = round(float(l), 3)
    return json.dumps(out, separators=(",", ":"))


def decode_demand(value: str) -> Optional[dict]:
    """Parse a demand summary into ``{node: (excl, load)}``; None on a
    malformed value (dropped loudly by the caller, never a crash on a
    foreign partition's write)."""
    try:
        doc = json.loads(value)
    except (json.JSONDecodeError, TypeError):
        return None
    if not isinstance(doc, dict):
        return None
    out = {}
    for n, ent in doc.items():
        try:
            out[str(n)] = (int(ent[0]), float(ent[1]))
        except (TypeError, ValueError, IndexError):
            return None
    return out
