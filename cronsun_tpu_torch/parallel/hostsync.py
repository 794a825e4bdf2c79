"""Multi-host scheduling: one leader process drives the store; worker
processes hold their shards of the global mesh and join the collective
plan calls in lockstep (counterpart of ``cronsun_tpu/parallel/hostsync.py``,
on ``torch.distributed``).

Every process must call ``plan_window`` with identical logical state, or
the collectives exchange garbage.  Workers have NO store connection:

- the leader wraps its planner in :class:`PlannerSyncProxy`, which records
  every state mutation (the five setter ops the SchedulerService drives)
  and, at each ``plan_window``, broadcasts the op log and (epoch, window)
  from rank 0 to all processes;
- each worker replays the identical ops on its local shards of the SAME
  sharded planner and calls ``plan_window`` with the broadcast args,
  joining the collectives; its outputs are discarded (the leader alone
  talks to the store and dispatches).

Leader and workers must run with the SAME planner capacities (job_capacity
/ node_capacity / window — the conf file): they shape every collective, and
mismatched shapes wedge them.  A worker that dies stalls the collective —
run workers under the same supervision as the leader.

Wire format per sync point, over the default process group (gloo, host
tensors): one int64 header [n_bytes, epoch, window, stop, sla_bucket], then
an uint8 payload (the pickled op list) — two ``broadcast`` calls from rank
0.  The payload is pickled by the leader of the same deployment; workers
unpickle nothing else.
"""

from __future__ import annotations

import pickle
from typing import List, Tuple

import numpy as np
import torch

from .. import log

_OPS = ("update_table_rows", "set_eligibility_rows", "set_job_meta",
        "set_node_capacity", "set_load")


def _apply(planner, ops) -> None:
    """Replay a recorded op log — THE application point for leader and
    workers alike.  Every process executes the log at the same protocol
    point, in the same order (the reference's planner mutations are
    themselves collective; the port's are not, and keep the rule)."""
    for op, args in ops:
        if op not in _OPS:               # defense against version skew
            raise RuntimeError(f"unknown sync op {op!r}")
        getattr(planner, op)(*args)


def _broadcast(header: np.ndarray, payload: np.ndarray,
               is_leader: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Two-phase broadcast from rank 0: the fixed-shape header first (it
    carries the payload length), then the payload.  Non-leaders' inputs
    are ignored."""
    import torch.distributed as dist
    log.debugf("hostsync: %s header barrier enter",
               "lead" if is_leader else "worker")
    h = torch.from_numpy(np.array(header, np.int64))
    dist.broadcast(h, src=0)
    header = h.numpy()
    n = int(header[0])
    log.debugf("hostsync: header done (%d payload bytes)", n)
    if not n:
        return header, np.zeros(0, np.uint8)
    buf = (torch.from_numpy(np.array(payload[:n], np.uint8)) if is_leader
           else torch.zeros(n, dtype=torch.uint8))
    dist.broadcast(buf, src=0)
    return header, buf.numpy()


class PlannerSyncProxy:
    """Leader-side wrapper: records mutations (WITHOUT applying them) and,
    at each plan, broadcasts the log then applies it locally — the exact
    sequence workers run.  Duck-compatible with the planner surface
    SchedulerService uses (which writes planner state and plans, but never
    reads back between the two)."""

    def __init__(self, planner):
        self._planner = planner
        self._log: List[tuple] = []

    # Planner mutators NOT in _OPS: a leader-side call would mutate only
    # the leader's planner — the divergence that wedges the next collective
    # plan (workers replay the op log, nothing else).  Fail loudly instead.
    _UNLOGGED_MUTATORS = frozenset({
        "set_table", "set_eligibility", "set_job_meta_full",
        "set_node_capacity_full", "job_finished", "common_finished",
        "decay_load"})

    def __getattr__(self, name):
        if name in PlannerSyncProxy._UNLOGGED_MUTATORS:
            raise RuntimeError(
                f"planner.{name}() is a mutator with no op-log entry; "
                "calling it on the multi-host leader would desync the "
                "workers (add it to hostsync._OPS + the proxy instead)")
        # reads (N, J, mesh, ...) pass through
        return getattr(self._planner, name)

    def _record(self, op, *args):
        self._log.append((op, args))

    # the mutator surface (see _OPS) — explicit defs, so the proxy's API
    # is grep-able next to the planner's
    def update_table_rows(self, rows, vals):
        return self._record("update_table_rows", rows, vals)

    def set_eligibility_rows(self, rows, values):
        return self._record("set_eligibility_rows", rows, values)

    def set_job_meta(self, rows, exclusive, cost):
        return self._record("set_job_meta", rows, exclusive, cost)

    def set_node_capacity(self, cols, caps):
        return self._record("set_node_capacity", list(cols), list(caps))

    def set_load(self, loads):
        return self._record("set_load", np.asarray(loads))

    def plan_window(self, epoch_s: int, window_s: int, sla_bucket=None):
        # sla_bucket shapes the collectives (k_local): it rides the header
        # so every process plans the same bucket
        ops, self._log = self._log, []
        payload = pickle.dumps(ops, protocol=4)
        header = np.array([len(payload), epoch_s, window_s, 0,
                           -1 if sla_bucket is None else int(sla_bucket)],
                          np.int64)
        _broadcast(header, np.frombuffer(payload, np.uint8), True)
        _apply(self._planner, ops)
        return self._planner.plan_window(epoch_s, window_s,
                                         sla_bucket=sla_bucket)

    def shutdown_workers(self):
        """Release the worker loops (they exit instead of waiting on a
        collective that will never come)."""
        header = np.array([0, 0, 0, 1, -1], np.int64)
        _broadcast(header, np.zeros(0, np.uint8), True)


def run_worker(planner, on_step=None) -> int:
    """Worker loop: replay broadcast mutations, join each collective plan,
    discard outputs.  Returns the number of plan steps joined."""
    steps = 0
    while True:
        header, payload = _broadcast(np.zeros(5, np.int64),
                                     np.zeros(0, np.uint8), False)
        _n, epoch, window, stop, sla = (int(x) for x in header)
        if stop:
            return steps
        _apply(planner, pickle.loads(payload.tobytes()))
        planner.plan_window(epoch, window,
                            sla_bucket=None if sla < 0 else sla)
        steps += 1
        if on_step is not None:
            on_step(steps, epoch)
