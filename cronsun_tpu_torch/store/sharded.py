"""Shard routing hash of the coordination store (the routing half of
``cronsun_tpu/store/sharded.py``).

Only what the scheduler and ``sched/partition.py`` call lives here:
:func:`fnv1a`, :func:`shard_token` and :func:`shard_index`, the
deterministic key -> shard mapping every component of a sharded fleet
agrees on.  The routing client itself (``ShardedStore`` with its circuit
breakers) comes with the port of the launcher and the remote store
client.

Routing: :func:`shard_token` extracts a ROUTING TOKEN so related keys
co-locate (``lock``/``proc``/``cmd``/``once``/``phase`` keys route by the
JOB, ``dispatch``/``node`` keys by the NODE, everything else by the full
key), and :func:`fnv1a` (64-bit FNV-1a over UTF-8) maps the token to a
shard.
"""

from __future__ import annotations

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_MASK64 = (1 << 64) - 1


def fnv1a(s: str) -> int:
    """64-bit FNV-1a over UTF-8 bytes — deterministic across processes
    and languages (native/agentd.cc carries the same constants)."""
    h = _FNV_OFFSET
    for b in s.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def shard_token(key: str, prefix: str = "/cronsun") -> str:
    """Routing token for ``key`` (see the module docstring).  Keys
    outside the keyspace prefix route by their full text — always
    deterministic, never an error."""
    pfx = prefix + "/"
    if not key.startswith(pfx):
        return key
    seg = key[len(pfx):].split("/")
    comp = seg[0]
    if comp in ("dispatch", "node") and len(seg) >= 2 and seg[1]:
        return "n:" + seg[1]
    if comp == "lock":
        if len(seg) >= 3 and seg[1] == "alone" and seg[2]:
            return "j:" + seg[2]
        if len(seg) >= 2 and seg[1]:
            return "j:" + seg[1]
    if comp == "proc" and len(seg) >= 4 and seg[3]:
        return "j:" + seg[3]
    if comp in ("cmd", "once", "phase") and len(seg) >= 3 and seg[2]:
        return "j:" + seg[2]
    return key


def shard_index(key: str, nshards: int, prefix: str = "/cronsun") -> int:
    if nshards <= 1:
        return 0
    if key == prefix + "/shardmap":
        return 0            # the topology pin lives on shard 0 by fiat
    return fnv1a(shard_token(key, prefix)) % nshards
