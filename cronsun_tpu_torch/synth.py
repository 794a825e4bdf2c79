"""Seeded synthetic planner states, as numpy arrays in the JAX planner's
dtypes (the ``state`` dict of :mod:`cronsun_tpu_torch.convert`).

Used by the differential tests, ``chip_smoke.py`` and benches: one state
from one seed can be handed to the JAX planner and to the port alike.
Distinct specs are parsed once and their rows tiled in numpy, so a
million-row table costs no per-row Python.

:func:`synth_state` makes a state with both arms disarmed;
:func:`arm_dag` and :func:`arm_tenants` arm them in place (:func:`arm_mixed`
both, as the armed equivalence checks do), and :func:`completions` makes the
completion rounds folded between windows.

:func:`synth_table` is ``bench.py``'s ``synth_table``: a bare schedule table of
``@every`` rows, as the mesh bench installs it.

:func:`seed_service_store` is of another kind: it writes a whole cluster
(nodes, groups, jobs, ``@every`` phase anchors) into a coordination store,
for a scheduler service to load.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .device import DeviceLike
from .ops.deps import NEVER, POLICY_FIRE, POLICY_HOLD, POLICY_SKIP
from .ops.schedule_table import (DEP_BROKEN, DEP_EMPTY, DTYPES,
                                 FRAMEWORK_EPOCH, MAX_DEPS, ScheduleTable,
                                 _rows_to_numpy, make_row, table_from_numpy)

# six-field cron specs and @every rows of mixed rates (sec min hour dom month dow)
MIXED_SPECS = (
    "*/5 * * * * *",
    "*/7 * * * * *",
    "0 * * * * *",
    "15,45 * * * * *",
    "*/2 * 9-17 * * Mon-Fri",
    "30 */2 * * * *",
    "0 0 * * * *",
    "*/3 * * 1,15 * ?",
    "*/10 * * ? * 0,6",
    "@every 7s",
    "@every 13s",
    "@every 1m30s",
    "@every 45s",
)


# bench.py's headline @every periods, [lo, hi) seconds
EVERY_PERIODS = (35, 70)

# the upstream count of each dep row (scripts/bench_sched.py's fan_in)
FAN_IN = 4

# tenant quotas as scripts/bench_sched.py:733-765 sets them: a victim's rate
# is VICTIM_HEADROOM times its offer, the noisy tenant offers NOISY_FACTOR
# times its rate
VICTIM_HEADROOM = 2.0
NOISY_FACTOR = 10.0


def synth_state(J: int, N: int, *, seed: int,
                specs: Optional[Sequence[str]] = MIXED_SPECS,
                node_cap: int = 4, empty_rows: float = 0.0,
                tenant_capacity: int = 64) -> dict:
    """A planner state of J rows x N nodes (N a multiple of 32), both arms
    disarmed, ``tenant_capacity`` tenant ids (a power of two).

    ``specs``: each row takes one of them at random (``@every`` rows get a
    uniform random phase over their period).  ``specs=None`` makes every row
    ``@every p`` with p uniform in ``EVERY_PERIODS`` and a uniform
    phase — a steady aggregate fire rate of about J / p per second.
    Eligibility is uniform random bits (density 1/2), with a fraction
    ``empty_rows`` of rows eligible nowhere.  Half the rows are exclusive.
    Costs are integers in [1, 4], so every float sum on the plan path is
    exact.
    """
    if N % 32:
        raise ValueError(f"N={N} must be a multiple of 32")
    rng = np.random.default_rng(seed)
    if specs is None:
        cols = _rows_to_numpy([], J)
        cols["is_every"][:] = True
        cols["active"][:] = True
        period = rng.integers(*EVERY_PERIODS, J)
    else:
        table = _rows_to_numpy([make_row(s) for s in specs], len(specs))
        pick = rng.integers(0, len(specs), J)
        cols = {k: v[pick] for k, v in table.items()}
        period = cols["period"].astype(np.int64)
    cols["period"] = period.astype(np.int32)
    phase = rng.integers(0, 1 << 30, J) % period
    cols["phase_mod"] = np.where(cols["is_every"], phase, 0).astype(np.int32)
    state = {k: np.ascontiguousarray(cols[k], dtype=dt)
             for k, dt in DTYPES.items()}
    w32 = N // 32
    elig = np.frombuffer(rng.bytes(J * w32 * 4), dtype=np.uint32)
    elig = elig.reshape(J, w32).copy()
    elig[rng.random(J) < empty_rows] = 0
    state["elig"] = elig
    state["exclusive"] = rng.random(J) < 0.5
    state["cost"] = rng.integers(1, 5, J).astype(np.float32)
    state["load"] = np.zeros(N, np.float32)
    state["rem_cap"] = np.full(N, node_cap, np.int32)
    T = tenant_capacity
    state.update(
        dep_succ=np.full(J, NEVER, np.int32),
        dep_fail=np.full(J, NEVER, np.int32),
        dep_last_fire=np.zeros(J, np.int32), dep_block=np.zeros(J, bool),
        tb_rate=np.zeros(T, np.float32), tb_burst=np.zeros(T, np.float32),
        tb_limited=np.zeros(T, bool), tb_weight=np.ones(T, np.float32),
        tb_tokens=np.zeros(T, np.float32), row_tenant=np.zeros(J, np.int32),
        dep_enabled=np.bool_(False), tenants_enabled=np.bool_(False))
    return state


def synth_table(J: int, fire_period_lo: int, fire_period_hi: int,
                seed: int = 0, device: DeviceLike = None) -> ScheduleTable:
    """``bench.py:77-97`` on ``device``: J active ``@every`` rows, each
    period uniform in [lo, hi) and its phase uniform over the period (a
    steady aggregate fire rate), every other column empty."""
    rng = np.random.default_rng(seed)
    cols = _rows_to_numpy([], J)
    cols["is_every"][:] = True
    cols["active"][:] = True
    cols["period"] = rng.integers(fire_period_lo, fire_period_hi,
                                  J).astype(np.int32)
    cols["phase_mod"] = (rng.integers(0, 1 << 30, J)
                         % cols["period"]).astype(np.int32)
    return table_from_numpy(cols, device)


def bench_mixed_specs(n: int = 10_000, seed: int = 0,
                      rng: Optional[np.random.Generator] = None) -> list:
    """BASELINE config 2's mix of cron specs, generated by the loop of
    ``bench.py:289-302`` from ``rng`` (default a fresh
    ``default_rng(seed)``): a fifth each of ``@every`` 1-299 s, hourly at a
    random second, every k seconds, weekly and monthly."""
    rng = np.random.default_rng(seed) if rng is None else rng
    mixed = []
    for i in range(n):
        r = i % 5
        if r == 0:
            mixed.append(f"@every {rng.integers(1, 300)}s")
        elif r == 1:
            mixed.append(f"{rng.integers(0, 60)} {rng.integers(0, 60)} * * * *")
        elif r == 2:
            mixed.append(f"*/{rng.integers(2, 30)} * * * * *")
        elif r == 3:
            mixed.append(f"0 {rng.integers(0, 60)} {rng.integers(0, 24)} * * "
                         f"{rng.integers(0, 7)}")
        else:
            mixed.append(f"0 0 {rng.integers(0, 24)} {rng.integers(1, 29)} * ?")
    return mixed


def set_every(state: dict, rows: np.ndarray, periods: np.ndarray,
              phases: np.ndarray) -> None:
    """Make ``rows`` plain ``@every`` rows of the given periods and phases
    (phase_mod = phase mod period)."""
    for k in ("sec_lo", "sec_hi", "min_lo", "min_hi", "hour", "dom",
              "month", "dow"):
        state[k][rows] = 0
    state["dom_star"][rows] = state["dow_star"][rows] = False
    state["is_every"][rows] = True
    state["period"][rows] = periods
    state["phase_mod"][rows] = np.asarray(phases) % np.asarray(periods)


def arm_dag(state: dict, n_dep: int, *, seed: int,
            policies: Sequence[int] = (POLICY_SKIP,), t_rel0: int = 0,
            broken: float = 0.0, blocked: float = 0.0) -> dict:
    """Wire a 3-stage DAG into ``state`` in place and arm the dep arm.

    The DAG's stages (sources, mids, sinks) take 40/40/20 of its rows, as
    ``scripts/bench_sched.py:488-490``'s do: ``n_dep`` dep rows (mids and
    sinks, 2:1) over as many time-triggered sources as mids, all picked at
    random.  Mid i depends on sources
    ``(FAN_IN*i + k) % n_src``, sink i on mids the same way — the wiring of
    ``scripts/bench_sched.py:502-506``.  Dep rows never time-fire; each
    takes a policy from ``policies``, a fraction ``broken`` gets one
    DEP_BROKEN slot and ``blocked`` the max_in_flight gate.  ``t_rel0`` is
    the registration anchor (initial last_fire).  Returns the stages'
    rows: ``{"sources", "mids", "sinks"}``."""
    rng = np.random.default_rng(seed)
    n_mid = (n_dep * 2) // 3
    n_sink = n_dep - n_mid
    n_src = max(FAN_IN, n_mid)
    J = len(state["active"])
    if n_src + n_dep > J:
        raise ValueError(f"a DAG of {n_src + n_dep} rows does not fit J={J}")
    perm = rng.permutation(J)
    src = np.sort(perm[:n_src])
    mids = np.sort(perm[n_src:n_src + n_mid])
    sinks = np.sort(perm[n_src + n_mid:n_src + n_dep])
    for rows, ups in ((mids, src), (sinks, mids)):
        i = np.arange(len(rows))[:, None]
        cols = np.full((len(rows), MAX_DEPS), DEP_EMPTY, np.int32)
        cols[:, :FAN_IN] = ups[(i * FAN_IN + np.arange(FAN_IN)) % len(ups)]
        state["dep_cols"][rows] = cols
    dep = np.concatenate([mids, sinks])
    for k in ("sec_lo", "sec_hi", "min_lo", "min_hi", "hour", "dom",
              "month", "dow", "phase_mod"):
        state[k][dep] = 0
    for k in ("dom_star", "dow_star", "is_every", "paused"):
        state[k][dep] = False
    state["period"][dep] = 1
    state["active"][dep] = True
    state["has_dep"][dep] = True
    state["dep_policy"][dep] = rng.choice(np.asarray(policies, np.int32),
                                          len(dep))
    bad = dep[rng.random(len(dep)) < broken]
    state["dep_cols"][bad, FAN_IN - 1] = DEP_BROKEN
    state["dep_block"][dep] = rng.random(len(dep)) < blocked
    state["dep_last_fire"][dep] = t_rel0
    state["dep_enabled"] = np.bool_(True)
    return {"sources": src, "mids": mids, "sinks": sinks}


def offered_rates(state: dict, start_epoch_s: int,
                  seconds: int = 600) -> np.ndarray:
    """[J] each row's time fires per second over ``seconds`` seconds from
    ``start_epoch_s`` (UTC), counted with the port's fire mask on the
    CPU."""
    from .ops.schedule_table import table_from_numpy
    from .ops.tick import fire_mask
    table = table_from_numpy(state, device="cpu")
    return fire_mask(table, start_epoch_s, seconds).double().mean(1).numpy()


def every_rates(state: dict) -> np.ndarray:
    """[J] offered fires per second of the live ``@every`` rows (1/period),
    0 for every other row."""
    live = state["active"] & ~state["paused"] & state["is_every"]
    return np.where(live, 1.0 / state["period"].astype(np.float64), 0.0)


def arm_tenants(state: dict, *, seed: int, rates: np.ndarray,
                noisy_rows: np.ndarray, exempt: Optional[np.ndarray] = None,
                weights: Sequence[float] = (1.0,)) -> None:
    """Assign tenants and quotas in place and arm the tenant arm, the way
    ``scripts/bench_sched.py:733-765`` builds its skewed fleet.

    Of the T tenant ids, 0 is the default tenant (unlimited), T - 1 the
    noisy one and 1 .. T - 2 the victims.  ``noisy_rows`` go to the noisy
    tenant; ``exempt`` rows stay in tenant 0; every other row goes to a
    victim, victims sized by a rank-1 Zipf law.  ``rates`` [J] is each
    row's offered fires per second: a victim's rate and burst are
    ``VICTIM_HEADROOM`` times its offered rate (unlimited if it offers
    none), the noisy tenant's ``floor(offered / NOISY_FACTOR)``.  Each victim's
    weight is drawn from ``weights``.  Buckets start full."""
    rng = np.random.default_rng(seed)
    J = len(state["active"])
    T = len(state["tb_rate"])
    if T < 3:
        raise ValueError("needs at least 3 tenant ids")
    taken = np.zeros(J, bool)
    taken[noisy_rows] = True
    if exempt is not None:
        taken[exempt] = True
    cand = rng.permutation(np.flatnonzero(~taken))
    zw = 1.0 / np.arange(1, T - 1)
    sizes = np.floor(len(cand) * zw / zw.sum()).astype(np.int64)
    tid = np.zeros(J, np.int32)
    tid[cand[:sizes.sum()]] = np.repeat(np.arange(1, T - 1, dtype=np.int32),
                                        sizes)
    tid[noisy_rows] = T - 1
    state["row_tenant"] = tid
    state["tenant"] = tid.copy()
    offered = np.bincount(tid, weights=rates, minlength=T)
    rate = np.zeros(T)
    rate[1:T - 1] = VICTIM_HEADROOM * offered[1:T - 1]
    rate[T - 1] = np.floor(offered[T - 1] / NOISY_FACTOR)
    limited = rate > 0
    limited[0] = False
    rate[0] = 0.0
    state["tb_rate"] = rate.astype(np.float32)
    state["tb_burst"] = rate.astype(np.float32)
    state["tb_limited"] = limited
    w = np.ones(T)
    w[1:T - 1] = rng.choice(np.asarray(weights, np.float64), T - 2)
    state["tb_weight"] = w.astype(np.float32)
    state["tb_tokens"] = np.where(limited, rate, 0.0).astype(np.float32)
    state["tenants_enabled"] = np.bool_(True)


def arm_mixed(state: dict, *, seed: int, n_dep: int, n_noisy: int,
              start_epoch_s: int) -> dict:
    """Arm both arms of a mixed-spec state for the armed equivalence
    checks: a 3-stage DAG of ``n_dep`` dep rows with every misfire policy
    (5% broken, 5% blocked, registered 30 s before ``start_epoch_s``), and
    Zipf tenants of weights 0.5-2 (dyadic, so fair-share sums are exact)
    with a noisy tenant of ``n_noisy`` non-dep rows offering 10x its quota.
    Returns the DAG's stages (see :func:`arm_dag`)."""
    stages = arm_dag(state, n_dep, seed=seed,
                     policies=(POLICY_SKIP, POLICY_FIRE, POLICY_HOLD),
                     t_rel0=start_epoch_s - FRAMEWORK_EPOCH - 30,
                     broken=0.05, blocked=0.05)
    rng = np.random.default_rng(seed + 1)
    noisy = rng.choice(np.flatnonzero(~state["has_dep"]), n_noisy,
                       replace=False)
    arm_tenants(state, seed=seed + 2,
                rates=offered_rates(state, start_epoch_s, 120),
                noisy_rows=noisy, weights=(0.5, 1.0, 1.5, 2.0))
    return stages


def completions(plans, upstream: np.ndarray, rng: np.random.Generator,
                fail_share: float = 0.1):
    """One completion per fire of an ``upstream`` row ([J] bool) in
    ``plans``, each a round at its fire's second, a share ``fail_share``
    of them failures: ``(rows, succ, fail)`` for ``set_dep_epochs``."""
    rows = np.concatenate([pl.fired[upstream[pl.fired]] for pl in plans])
    ep = np.concatenate([np.full(int(upstream[pl.fired].sum()),
                                 pl.epoch_s - FRAMEWORK_EPOCH, np.int32)
                         for pl in plans])
    ok = rng.random(len(rows)) >= fail_share
    return (rows, np.where(ok, ep, NEVER).astype(np.int32),
            np.where(ok, NEVER, ep).astype(np.int32))


def seed_service_store(store, ks, n_jobs: int, n_nodes: int,
                       now: int) -> None:
    """Write the placement-realistic cluster of ``scripts/bench_sched.py``'s
    ``seed`` (lines 30-111) into ``store``, with the clock ``now`` passed
    in: ``n_nodes`` live nodes, 32 groups of 10-1000 members (log-uniform),
    and ``n_jobs`` jobs in group ``bench`` — 3 in 5 ``@every`` 30-899 s with
    their phase anchors back-dated over their period, 1 in 5 ``*/k`` second
    specs, 1 in 5 one fire an hour; ~45% Common, ~45% Interval, ~10% Alone;
    ~80% placed on one node, ~10% on a group, ~10% on a group less that
    node (``exclude_nids``).  Same seed (7), same keys and values as the
    script's for the same clock."""
    rng = np.random.default_rng(7)
    node_ids = [f"bn{i:05d}" for i in range(n_nodes)]
    store.put_many([(ks.node_key(n), "bench:1") for n in node_ids])
    n_groups = 32
    group_ids = []
    gitems = []
    for g in range(n_groups):
        size = int(10 ** rng.uniform(1, np.log10(min(1000, n_nodes))))
        members = rng.choice(n_nodes, size=size, replace=False)
        gid = f"bg{g:02d}"
        group_ids.append(gid)
        doc = (f'{{"id":"{gid}","name":"{gid}","nids":['
               + ",".join(f'"{node_ids[m]}"' for m in members) + "]}")
        gitems.append((ks.group_key(gid), doc))
    store.put_many(gitems)
    items = []
    phase_items = []
    periods = rng.integers(30, 900, n_jobs)
    kind_draw = rng.random(n_jobs)
    nodes = rng.integers(0, n_nodes, n_jobs)
    gsel = rng.integers(0, n_groups, n_jobs)
    placement_draw = rng.random(n_jobs)
    phase_off = rng.integers(0, 1 << 30, n_jobs)
    for i in range(n_jobs):
        r = i % 5
        if r < 3:
            timer = f"@every {int(periods[i])}s"
            # anchors spread over each job's period: a long-lived fleet's
            # aggregate fire rate is steady
            anchor = now - int(phase_off[i]) % int(periods[i])
            phase_items.append((ks.phase_key("bench", f"bj{i}", "r"),
                                f"{timer}|{anchor}"))
        elif r == 3:
            timer = f"*/{int(periods[i]) % 28 + 2} * * * * *"
        else:
            timer = f"{i % 60} {i % 60} * * * *"
        kind = 0 if kind_draw[i] < 0.45 else (2 if kind_draw[i] < 0.9
                                              else 1)
        if placement_draw[i] < 0.8:
            place = f'"nids":["{node_ids[int(nodes[i])]}"]'
        else:
            place = f'"gids":["{group_ids[int(gsel[i])]}"]'
            if placement_draw[i] >= 0.9:
                place += f',"exclude_nids":["{node_ids[int(nodes[i])]}"]'
        doc = (f'{{"name":"b{i}","command":"true","kind":{kind},'
               f'"rules":[{{"id":"r","timer":"{timer}",{place}}}]}}')
        items.append((f"{ks.cmd}bench/bj{i}", doc))
        if len(items) >= 20_000:
            store.put_many(items)
            items = []
        if len(phase_items) >= 20_000:
            store.put_many(phase_items)
            phase_items = []
    if items:
        store.put_many(items)
    if phase_items:
        store.put_many(phase_items)
