"""Single-device plan step of the port (counterpart of ``__graft_entry__.entry``).

:func:`entry` returns ``(fn, example_args)``: the fused tick+assign step
(fire mask -> compact -> bid/waterfill assignment) on the same small
synthetic schedule table as the JAX package's entry (J 4096, N 320,
K 1024, rounds 3).  On the card the step's fan-out and bids run through
the hand-written kernels (K2 ``fanout_add``, K1 ``bid_argmin``), which
gather the bucket's rows themselves; on the CPU the same wrappers run
their plain versions.

:func:`dryrun_multichip` runs one fused window and one tick of the mesh
planners (``__graft_entry__.dryrun_multichip``'s counterpart).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ops.assign import _assign_excl, _fanout_load
from .ops.planner import _compact
from .ops.schedule_table import table_from_numpy
from .ops.tick import _fire_mask
from .parallel.mesh import Mesh, Sharded2DTickPlanner, ShardedTickPlanner

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


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> str:
    """One fused window (W = 4) and one tick on a 1-D mesh of ``n_devices``
    shards and, for an even ``n_devices`` >= 4, the window on an
    (n/2) x 2 mesh, which must fire the same rows; returns (and prints)
    a summary line.

    On the card the shards share the cards there are (all ``n_devices``
    on ``cuda:0`` with one card), as the reference provisions a virtual
    n-device mesh on a one-chip host; with ``device="cpu"`` every shard is
    on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i % torch.cuda.device_count())
                for i in range(n_devices)]
    else:
        devs = [dev] * n_devices
    J, N, W, T = n_devices * 512, 96, 4, 1_753_000_000
    sp = ShardedTickPlanner(Mesh(devs), job_capacity=J, node_capacity=N,
                            max_fire_bucket=n_devices * 256)
    cols, elig, excl, cost = synth_state(sp.J, sp.N, seed=1)
    sp.set_table(table_from_numpy(cols, "cpu"))
    sp.set_eligibility(elig)
    sp.set_job_meta_full(excl, cost)
    sp.set_node_capacity_full(np.full(sp.N, 32, np.int32))
    plans = sp.plan_window(T, W)
    plan_t = sp.plan(T + W)
    if len(plans) != W or plans[0].fired.ndim != 1 \
            or not torch.isfinite(sp.load).all():
        raise AssertionError("dryrun_multichip: malformed 1-D mesh plan")
    msg2 = ""
    if n_devices >= 4 and n_devices % 2 == 0:
        # 2-D (jobs x nodes) mesh: the eligibility matrix shards both ways
        dj = n_devices // 2
        sp2 = Sharded2DTickPlanner(
            Mesh(np.array(devs, dtype=object).reshape(dj, 2)),
            job_capacity=J, node_capacity=N, max_fire_bucket=n_devices * 256)
        sp2.set_table(table_from_numpy(cols, "cpu"))
        elig2 = np.zeros((sp2.J, sp2.N // 32), np.uint32)
        elig2[:, :sp.N // 32] = elig
        sp2.set_eligibility(elig2)
        sp2.set_job_meta_full(excl, cost)
        caps2 = np.zeros(sp2.N, np.int32)
        caps2[:sp.N] = 32
        sp2.set_node_capacity_full(caps2)
        plans2 = sp2.plan_window(T, W)
        for p1, p2 in zip(plans, plans2):
            if set(p2.fired.tolist()) != set(p1.fired.tolist()):
                raise AssertionError(
                    f"1-D and 2-D meshes disagree on the fired set "
                    f"@{p1.epoch_s}")
        msg2 = (f", 2d-mesh({dj}x2) fused-window "
                f"fired={sum(len(p.fired) for p in plans2)}")
    msg = (f"dryrun_multichip OK: {n_devices} devices on {dev.type}, fused "
           f"W={W} window fired={sum(len(p.fired) for p in plans)} "
           f"(+{len(plan_t.fired)} single-tick), "
           f"overflow={plans[0].overflow}{msg2}")
    print(msg)
    return msg
