"""The checkpoint plane: bounded-time recovery for every stateful piece
(copy of ``cronsun_tpu/checkpoint/``, in the same file formats).

BENCH_r05 put ``failover_cold_load_s`` at 85.9 s at the 1M x 10k scale:
a standby scheduler rebuilt every host mirror from a full store scan and
re-parsed a million cron specs before it could dispatch, and the store's
write-ahead log grew without bound with O(all-history) replay on
restart.  This package is the recovery-path analogue of what PRs 1-3
did to the dispatch plane and PR 4 to the result plane — the same
checkpoint-and-restore shape every training stack relies on:

- :mod:`walsnap` — store-side persistence primitives shared by the
  Python MemStore (the native ``stored.cc`` mirrors the exact record
  format): an append-only WAL file plus an atomically-replaced snapshot
  sidecar, so boot is load-snapshot + replay-tail instead of
  replay-everything and a size-triggered compaction keeps the WAL
  bounded.
- :mod:`sched_ckpt` — versioned on-disk checkpoints of the scheduler's
  BUILT state (packed schedule table, eligibility masks, row allocator,
  job metadata, execution-state mirrors) keyed by the store revision
  they reflect; a standby restores one and replays only the watch delta
  since that revision, turning the cold load into a seconds-scale warm
  takeover.
"""

from .sched_ckpt import (  # noqa: F401
    CheckpointError, clear_delta_chain, compact_delta_chain,
    list_delta_seqs, load_checkpoint, load_delta_chain, save_checkpoint,
    save_delta)
from .walsnap import (  # noqa: F401
    SnapshotCorrupt, WalFile, read_records, rotated_path, snap_path,
    write_snapshot)
