"""The accept step on the CPU: ``waterfill_accept`` takes the plain chain
there, each round is one ``cronsun.assign.accept`` span in the planner's
totals, and the scheduler's ``/v1/metrics`` publishes the rounds by the
route the planner's device gives them.  The waterfill level is one
definition on every route of the port, also where the loads sum past 2^24
and an f32 sum would round: the plain chain and the mesh's presplit accept
agree there.  The kernel route itself is held to the plain chain on the
card (``tests/test_torch_waterfill_cuda.py``)."""

import pytest
import torch

from cronsun_tpu_torch.convert import planner_from_numpy
from cronsun_tpu_torch.ops import assign, kernels, spans
from cronsun_tpu_torch.synth import synth_state

T0 = 1_753_000_000
ACCEPT = "cronsun.assign.accept"


def _bids(K=64, N=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    cand = torch.rand(K, generator=g) < 0.7
    choice = torch.randint(0, N, (K,), generator=g, dtype=torch.int32)
    cost = torch.randint(1, 5, (K,), generator=g).float()
    load = torch.randint(0, 20, (N,), generator=g).float()
    rem_cap = torch.randint(0, 4, (N,), generator=g, dtype=torch.int32)
    return cand, choice, cost, load, rem_cap


def test_the_cpu_takes_the_plain_route_and_counts_it():
    """The plain chain's result, no kernel launch counted, and one accept
    span in the window."""
    rec = spans.SpanRecorder()
    args = _bids()
    kernels.reset_launch_counts()
    with spans.span("cronsun.plan.dispatch", rec.window(T0, 1)):
        with spans.span(ACCEPT):
            got = assign.waterfill_accept(*args, False)
    want = assign.waterfill_accept_plain(*args, False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.launch_counts()["waterfill_accept"] == 0


def test_the_accept_kernel_counts_with_the_other_kernels():
    kernels.reset_launch_counts()
    assert "waterfill_accept" in kernels.launch_counts()
    kernels.waterfill_accept.launches = 3
    assert kernels.launch_counts()["waterfill_accept"] == 3
    kernels.reset_launch_counts()
    assert kernels.waterfill_accept.launches == 0


@pytest.mark.parametrize("N,chunk", [
    (1, 16384), (10240, 16384), (102400, 16384), (131071, 16384),
    (262143, 16384), (262144, 8192), (300000, 8192), (1 << 20, 2048),
    ((1 << 24) - 1, 256), (2**31 - 1, 2)])
def test_one_pass_of_the_kernel_takes_a_chunk_of_bids(N, chunk):
    """One pass of the block sorts up to 16384 bids by a 32-bit key of the
    node (N for a non-candidate) above the bid's index within the pass;
    a larger bucket is taken in chunks of that size."""
    assert kernels._wf_chunk(N) == chunk
    assert N.bit_length() + (chunk - 1).bit_length() <= 32


def test_the_kernel_wrapper_takes_cuda_tensors_only():
    cand, choice, cost, load, rem_cap = _bids()
    n0 = kernels.waterfill_accept.launches
    with pytest.raises(ValueError):
        kernels.waterfill_accept(cand, choice, cost, load, rem_cap, False)
    with pytest.raises(TypeError):
        kernels.waterfill_accept(cand.to(torch.uint8), choice, cost, load,
                                 rem_cap, False)
    assert kernels.waterfill_accept.launches == n0


@pytest.mark.parametrize("rounds,W", [(1, 1), (2, 8)])
def test_the_route_counts_fold_into_the_recorders_totals(rounds, W):
    """One accept span a round in the planner's totals: what the
    scheduler's route series count."""
    state = synth_state(2048, 128, seed=5, specs=None, node_cap=1 << 20)
    p = planner_from_numpy(state, device="cpu", max_fire_bucket=256,
                           rounds=rounds)
    p.warm_window(T0, W)
    assert ACCEPT not in p.spans.totals.snapshot()
    for i in range(3):
        p.gather_window(p.plan_window_async(T0 + W * i, W))
    snap = p.spans.totals.snapshot()
    assert snap[ACCEPT]["count"] == 3 * W * rounds


def test_the_scheduler_publishes_the_accept_routes():
    from cronsun_tpu_torch.core import Keyspace
    from cronsun_tpu_torch.logsink import JobLogStore
    from cronsun_tpu_torch.metrics import parse_exposition
    from cronsun_tpu_torch.sched import SchedulerService
    from cronsun_tpu_torch.store import MemStore
    from cronsun_tpu_torch.synth import seed_service_store
    from cronsun_tpu_torch.web.server import ApiServer
    ks = Keyspace()
    store = MemStore()
    seed_service_store(store, ks, 512, 64, T0)
    svc = SchedulerService(store, ks, job_capacity=1024, node_capacity=64,
                           window_s=4, dispatch_ttl=3600.0,
                           clock=lambda: float(T0), device="cpu",
                           node_id="s0")
    srv = ApiServer(store, JobLogStore(), ks=ks, auth_enabled=False,
                    port=0).start()
    try:
        t = T0
        for _ in range(3):
            svc.step(now=t)
            t = svc._next_epoch
        if svc._pending_plan is not None:
            svc._resolve_handle(svc._pending_plan[1])
        snap = svc.planner.spans.totals.snapshot()
        svc.metrics._next_at = 0.0
        svc.metrics.maybe_publish()
        body, _ctx = srv.handle("GET", "/v1/metrics", {}, b"", {})
        series = parse_exposition(str(body))
    finally:
        srv.stop()
        svc.stop()
    got = {name: v for (name, lbl), v in series.items()
           if name.startswith("cronsun_sched_planner_accept_")
           and dict(lbl).get("instance") == "s0"}
    assert got["cronsun_sched_planner_accept_plain_total"] == \
        snap[ACCEPT]["count"] > 0
    assert got["cronsun_sched_planner_accept_kernel_total"] == 0


def _large_loads(K, N, seed):
    """Integer loads summing past 2^24 (each node between 2^14 and 2^15),
    spread so the waterfill quota binds for some nodes and not others, and
    bids crowding a quarter of the nodes."""
    g = torch.Generator().manual_seed(seed)
    load = torch.randint(1 << 14, 1 << 15, (N,), generator=g).float()
    rem_cap = torch.randint(0, 40, (N,), generator=g, dtype=torch.int32)
    cand = torch.rand(K, generator=g) < 0.8
    choice = torch.randint(0, N // 4, (K,), generator=g, dtype=torch.int32)
    cost = torch.randint(1, 2000, (K,), generator=g).float()
    return cand, choice, cost, load, rem_cap


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("is_final", [False, True])
def test_the_level_is_one_definition_above_2_24(seed, is_final):
    """Loads summing past 2^24, where a running f32 sum rounds: the
    plain chain and the presplit accept of a bucket sharded in two (each
    shard's local ranks lifted by the earlier shard's demand, the cost
    total summed in f64 as the mesh does) give the same verdicts."""
    K, N = 4096, 2048
    cand, choice, cost, load, rem_cap = _large_loads(K, N, seed)
    open_load = torch.where(rem_cap > 0, load, 0.0)
    assert open_load.sum(dtype=torch.float64) > 2 ** 24
    # a running f32 sum rounds here
    assert float(open_load.cumsum(0)[-1]) != float(
        open_load.sum(dtype=torch.float64))
    acc, new_load, new_cap = assign.waterfill_accept_plain(
        cand, choice, cost, load, rem_cap, is_final)
    halves = [slice(0, K // 2), slice(K // 2, K)]
    loc = [assign.local_bid_demand(cand[h], choice[h], cost[h], N)
           for h in halves]
    tot_w = sum(d[1].sum(dtype=torch.float64) for _, _, d in loc)
    got = []
    prefix = torch.zeros(2, N)
    for h, (rank_l, cum_l, demand) in zip(halves, loc):
        at = choice[h].to(torch.int64)
        got.append(assign.waterfill_accept_presplit(
            cand[h], choice[h], cost[h], load, rem_cap, is_final,
            prefix[0][at].to(torch.int32) + rank_l, prefix[1][at] + cum_l,
            tot_w))
        prefix = prefix + demand
    assert torch.equal(torch.cat(got), acc)
    assert 0 < int(acc.sum()) < int(cand.sum())
    # the plain chain's own totals against a float64 scatter of its verdicts
    want = load.double().index_add(0, choice[acc].long(),
                                   cost[acc].double()).float()
    assert torch.equal(new_load, want)
