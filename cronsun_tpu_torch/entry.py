"""Single-device plan step of the port (counterpart of ``__graft_entry__.entry``).

:func:`entry` returns ``(fn, example_args)``: the fused tick+assign step
(fire mask -> compact -> bid/waterfill assignment) on the same small
synthetic schedule table as the JAX package's entry (J 4096, N 320,
K 1024, rounds 3).  On the card the step's fan-out and bids run through
the hand-written kernels (K2 ``fanout_add``, K1 ``bid_argmin``), which
gather the bucket's rows themselves; on the CPU the same wrappers run
their plain versions.  The multi-device dry run waits for the port of
the mesh planners.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ops.assign import _assign_excl, _fanout_load
from .ops.planner import _compact
from .ops.schedule_table import table_from_numpy
from .ops.tick import _fire_mask

J, N, K, ROUNDS = 4096, 320, 1024, 3
# (sec, min, hour, dom, month, dow, t_rel) of the one planned second
FIELDS = (30, 15, 12, 15, 6, 3, 207000000)


def synth_state(n_jobs: int, n_nodes: int, seed: int = 0):
    """numpy table columns, eligibility, exclusivity and cost: the JAX
    entry's ``_synth_state``, draw for draw."""
    rng = np.random.default_rng(seed)
    periods = rng.integers(5, 120, n_jobs).astype(np.int32)
    cols = dict(
        sec_lo=rng.integers(0, 2**32, n_jobs, dtype=np.uint32),
        sec_hi=rng.integers(0, 2**28, n_jobs, dtype=np.uint32),
        min_lo=rng.integers(1, 2**32, n_jobs, dtype=np.uint32),
        min_hi=rng.integers(0, 2**28, n_jobs, dtype=np.uint32),
        hour=rng.integers(1, 2**24, n_jobs, dtype=np.uint32),
        dom=rng.integers(2, 2**32, n_jobs, dtype=np.uint32),
        month=rng.integers(2, 2**13, n_jobs, dtype=np.uint32),
        dow=rng.integers(1, 2**7, n_jobs, dtype=np.uint32),
        dom_star=rng.random(n_jobs) < 0.5,
        dow_star=rng.random(n_jobs) < 0.5,
        is_every=rng.random(n_jobs) < 0.5,
        period=periods,
        phase_mod=rng.integers(0, 5, n_jobs).astype(np.int32),
        active=np.ones(n_jobs, bool),
        paused=np.zeros(n_jobs, bool),
        has_dep=np.zeros(n_jobs, bool),
        dep_policy=np.zeros(n_jobs, np.int32),
        dep_cols=np.full((n_jobs, 8), -1, np.int32),
        tenant=np.zeros(n_jobs, np.int32),
        jitter=np.zeros(n_jobs, np.int32))
    elig = rng.integers(0, 2**32, (n_jobs, n_nodes // 32), dtype=np.uint32)
    excl = rng.random(n_jobs) < 0.5
    cost = np.ones(n_jobs, np.float32)
    return cols, elig, excl, cost


def tick_step(table, fields, elig, exclusive, cost, load, rem_cap):
    """One planned second: returns ([3, K] int32 of the bucket's rows, the
    fire count in [1, 0] and each row's node or -1; the new load; the new
    remaining capacity)."""
    fire = _fire_mask(table, *fields[:, None].unbind(0))[:, 0]
    idx, valid, total = _compact(fire, K)
    n_nodes = rem_cap.shape[0]
    pad = elig.shape[1] * 32 - n_nodes
    # pad columns have zero capacity, so they are never chosen
    load = torch.nn.functional.pad(load, (0, pad))
    rem_cap = torch.nn.functional.pad(rem_cap, (0, pad))
    cost_b = cost[idx].to(torch.float32)
    excl_b = exclusive[idx]
    load = _fanout_load(elig, valid & ~excl_b, cost_b, load, rows=idx)
    assigned, load, rem_cap = _assign_excl(
        valid & excl_b, elig, load, rem_cap, cost_b, ROUNDS, rows=idx)
    total_row = torch.zeros_like(idx)
    total_row[0] = total
    return (torch.stack([idx, total_row, assigned], 0), load[:n_nodes],
            rem_cap[:n_nodes])


def entry(device: DeviceLike = None):
    """Returns ``(fn, example_args)``: the single-device tick+assign step
    and its inputs on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    cols, elig, excl, cost = synth_state(J, N)
    example_args = (
        table_from_numpy(cols, dev),
        torch.tensor(FIELDS, dtype=torch.int32, device=dev),
        torch.tensor(elig.view(np.int32), device=dev),
        torch.tensor(excl, device=dev),
        torch.tensor(cost, device=dev),
        torch.zeros(N, dtype=torch.float32, device=dev),
        torch.full((N,), 64, dtype=torch.int32, device=dev))
    return tick_step, example_args
