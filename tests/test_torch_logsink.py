"""The port's result store, ``cronsun_tpu_torch.logsink``, against the JAX
package's, on the CPU.

- One op script runs against each pairing of {JAX, port} ``LogSinkServer``
  and {JAX, port} ``RemoteJobLogStore``: records (bulk and single, with
  idempotency tokens re-sent), every ``query_logs`` mode, the latest view,
  stats, node and account rows, trace spans shipped beside a record batch
  and read back, and a live subscription.  Every pairing's transcript must
  equal the JAX pair's: the wire is one protocol.
- A file-backed store (sqlite db, cold segments, trace spill) written by
  either package is opened and read by the other, as the scheduler's
  checkpoints cross the packages.
"""

import dataclasses
import time

import pytest

from cronsun_tpu.logsink import JobLogStore as JaxJobLogStore
from cronsun_tpu.logsink import LogRecord as JaxLogRecord
from cronsun_tpu.logsink.serve import LogSinkServer as JaxServer
from cronsun_tpu.logsink.serve import RemoteJobLogStore as JaxClient
from cronsun_tpu_torch.logsink import JobLogStore as PortJobLogStore
from cronsun_tpu_torch.logsink import LogRecord as PortLogRecord
from cronsun_tpu_torch.logsink.serve import LogSinkServer as PortServer
from cronsun_tpu_torch.logsink.serve import RemoteJobLogStore as PortClient
from cronsun_tpu_torch.trace import trace_id
from torch_parity import one_torch_thread, time_limit  # noqa: F401

T = 1_760_000_000
RECORD_CLS = {JaxClient: JaxLogRecord, PortClient: PortLogRecord}


def plain(x):
    """Records as dicts, tuples as lists: a transcript both packages'
    classes reduce to alike."""
    if dataclasses.is_dataclass(x):
        return {"record": plain(dataclasses.asdict(x))}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def records(Rec, n, t0, tag):
    return [Rec(job_id=f"job{i % 7}", job_group="default", name=f"n{i % 7}",
                node=f"node-{i % 3}", user="", command="true",
                output=f"{tag} {i}", success=i % 5 != 0,
                begin_ts=float(t0 + i), end_ts=float(t0 + i) + 0.25)
            for i in range(n)]


def spans(recs):
    """One trace span per record, stamped through every stage."""
    out = []
    for r in recs:
        sec = int(r.begin_ts)
        out.append({"tid": str(trace_id(r.job_id, sec)), "job": r.job_id,
                    "grp": r.job_group, "sec": sec, "node": r.node,
                    "ok": r.success,
                    "ts": {"b": sec - 0.5, "recv": sec - 0.25,
                           "claim": sec + 0.004, "start": sec + 0.01,
                           "end": r.end_ts, "flush": r.end_ts + 0.1}})
    return out


def op_script(cli, Rec) -> list:
    out = []
    batch = records(Rec, 24, T, "b1")
    cli.create_job_logs(batch, idem="batch-1", spans=spans(batch))
    out.append(("bulk ids", [r.id for r in batch]))
    again = records(Rec, 24, T, "b1")
    cli.create_job_logs(again, idem="batch-1", spans=spans(again))
    out.append(("bulk re-sent ids", [r.id for r in again]))
    one = records(Rec, 1, T + 100, "one")[0]
    cli.create_job_log(one, idem="one-1")
    twice = records(Rec, 1, T + 100, "one")[0]
    cli.create_job_log(twice, idem="one-1")
    out.append(("single ids", one.id, twice.id))
    for kw in ({}, {"page": 2, "page_size": 7}, {"job_ids": ["job3"]},
               {"node": "node-1"}, {"failed_only": True},
               {"name_like": "n2"}, {"begin": T + 5, "end": T + 12},
               {"latest": True}, {"latest": True, "node": "node-2"},
               {"after_id": 10, "page_size": 5}):
        out.append(("query", kw, plain(cli.query_logs(**kw))))
    out.append(("get_log", plain(cli.get_log(3)), cli.get_log(9999)))
    day = time.strftime("%Y-%m-%d", time.gmtime(T))
    out.append(("stats", cli.stat_overall(), cli.stat_day(day)))
    out.append(("revision", cli.revision()))
    out.append(("tail", plain(cli.tail_snapshot(4))))
    for r in batch[:5]:
        out.append(("trace_get", r.job_id,
                    plain(cli.trace_get(r.job_id, int(r.begin_ts)))))
    out.append(("trace_get missing", cli.trace_get("nope", T)))
    out.append(("trace_top", plain(cli.trace_top(6))))
    out.append(("trace_stats", cli.trace_stats()))
    cli.upsert_node("node-0", '{"id": "node-0"}', True)
    cli.upsert_node("node-1", '{"id": "node-1"}', False)
    cli.set_node_alived("node-1", True)
    out.append(("nodes", plain(cli.get_nodes()), plain(cli.get_node("node-1")),
                cli.get_node("node-9")))
    cli.upsert_account("a@x", '{"email": "a@x"}')
    cli.upsert_account("b@x", '{"email": "b@x"}')
    out.append(("accounts", cli.get_account("a@x"), cli.list_accounts(),
                cli.delete_account("b@x"), cli.list_accounts()))
    out.append(("logmap", cli.logmap(), cli.logmap(2, "fnv"),
                cli.logmap()))
    # a live subscription from the current revision: the next batch
    # arrives as change events, in order
    sub = cli.subscribe(after_id=cli.revision())
    try:
        late = records(Rec, 6, T + 200, "late")
        cli.create_job_logs(late, idem="late-1")
        events, deadline = [], time.monotonic() + 10
        while len(events) < len(late) and time.monotonic() < deadline:
            events += sub.get(timeout=0.5)
        out.append(("subscription", plain(events)))
    finally:
        sub.close()
    return out


def transcript(server_cls, client_cls):
    srv = server_cls().start()
    cli = client_cls("127.0.0.1", srv.port, timeout=10)
    try:
        return op_script(cli, RECORD_CLS[client_cls])
    finally:
        cli.close()
        srv.stop()


@pytest.mark.parametrize("server,client", [
    (JaxServer, PortClient), (PortServer, JaxClient),
    (PortServer, PortClient)], ids=["jax-server.port-client",
                                    "port-server.jax-client",
                                    "port-server.port-client"])
def test_every_pairing_gives_the_jax_pairs_transcript(server, client):
    with time_limit(120, "logsink transcripts"):
        ref = transcript(JaxServer, JaxClient)
        got = transcript(server, client)
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert b == a, a[0]


def test_the_transcript_exercises_what_it_names():
    """The reference transcript itself: the idempotency tokens dedup,
    the queries return rows, spans assemble and the subscription
    delivers."""
    with time_limit(60, "logsink transcript"):
        ops = transcript(PortServer, PortClient)
    got = {op[0]: op[1:] for op in ops}
    assert got["bulk re-sent ids"] == got["bulk ids"]
    assert got["single ids"][0] == got["single ids"][1] == 25
    assert got["stats"][0]["total"] == 25
    assert got["trace_stats"][0]["spans_total"] == 24
    assert all(len(op[2]) == 1 for op in ops if op[0] == "trace_get")
    assert all(op[2][1] > 0 for op in ops if op[0] == "query"
               and "after_id" not in op[1])
    assert len(got["subscription"][0]) == 6


def write_store(Sink, Rec, path):
    """A file-backed store: records of old days (aged to cold segments)
    and of today, spans spilled beside them, stats, nodes, accounts."""
    now = time.time()
    sink = Sink(path, hot_days=1)
    try:
        old = records(Rec, 30, T, "old")
        sink.create_job_logs(old, spans=spans(old))
        sink.trace_ingest(spans(old))
        new = records(Rec, 12, int(now) - 30, "new")
        sink.create_job_logs(new)
        aged = sink.age_out(now)
        sink.upsert_node("node-0", "{}", True)
        sink.upsert_account("a@x", "{}")
    finally:
        sink.close()
    return aged


def read_store(Sink, path):
    sink = Sink(path, hot_days=1)
    try:
        day = time.strftime("%Y-%m-%d", time.gmtime(T))
        return plain([
            sink.query_logs(page_size=100), sink.query_logs(latest=True),
            sink.query_logs(job_ids=["job2"], begin=T, end=T + 40),
            sink.stat_overall(), sink.stat_day(day), sink.revision(),
            sink.get_log(4), sink.tier_info()["cold_boundary"],
            sink.trace_get("job1", T + 1), sink.trace_get("job5", T + 26),
            sink.get_nodes(), sink.list_accounts()])
    finally:
        sink.close()


@pytest.mark.parametrize("writer,reader", [
    (JaxJobLogStore, PortJobLogStore), (PortJobLogStore, JaxJobLogStore)],
    ids=["jax-written.port-read", "port-written.jax-read"])
def test_a_store_file_written_by_one_package_reads_alike_in_the_other(
        tmp_path, writer, reader):
    path = str(tmp_path / "logs.db")
    rec_cls = JaxLogRecord if writer is JaxJobLogStore else PortLogRecord
    aged = write_store(writer, rec_cls, path)
    assert aged > 0                     # cold segments exist
    own = read_store(writer, path)
    other = read_store(reader, path)
    assert other == own
    assert own[3]["total"] == 42
    assert own[8] and own[9]            # spans read from the spill
