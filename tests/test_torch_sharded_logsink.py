"""The port's sharded result store (``cronsun_tpu_torch.logsink.sharded``)
against the JAX package's: the same record stream through both routing
clients lands on the same shards with the same ids, every read (queries,
the latest view, paging, cursors, stats, ``fetch_top``,
``merge_stat_days``) answers the same, each package's client reads the
other's shards over the wire, ``reshard_sinks`` 2 -> 3 places every
record alike, and the logmap pin refuses a single-address client pointed
at one shard in both packages.  All comparisons exact; nothing is
volatile (records carry fixed timestamps)."""

import dataclasses

import numpy as np
import pytest

import cronsun_tpu.logsink as jls
import cronsun_tpu.logsink.sharded as jsh
import cronsun_tpu_torch.logsink as pls
import cronsun_tpu_torch.logsink.sharded as psh

PKGS = {"jax": (jls, jsh), "port": (pls, psh)}
JOBS = [f"dj{i}" for i in range(12)]
NODES = ["n0", "n1", "n2"]


def _docs(seed=20261017, batches=30):
    """Batches of record fields from a seeded stream; few distinct begin
    times, so ordering ties happen."""
    rng = np.random.default_rng(seed)
    out, serial = [], 0
    for _ in range(batches):
        batch = []
        for _ in range(int(rng.integers(1, 6))):
            serial += 1
            batch.append(dict(
                job_id=JOBS[int(rng.integers(len(JOBS)))], job_group="g",
                name=f"nm{int(rng.integers(4))}",
                node=NODES[int(rng.integers(len(NODES)))], user="",
                command="c", output=f"o{serial}",
                success=bool(rng.random() < 0.7),
                begin_ts=1_700_000_000.0 + int(rng.integers(6)) * 86400.0,
                end_ts=1_700_000_002.0))
        out.append(batch)
    return out


def _fill(pkg, sink, docs):
    ls = PKGS[pkg][0]
    for b, batch in enumerate(docs):
        recs = [ls.LogRecord(**d) for d in batch]
        if len(recs) == 1 and b % 2:
            sink.create_job_log(recs[0], idem=f"t{b}")
        else:
            sink.create_job_logs(recs, idem=f"t{b}")


def _rows(recs):
    return [dataclasses.asdict(r) for r in recs]


def _sharded(pkg, n=2):
    ls, sh = PKGS[pkg]
    shards = [ls.JobLogStore() for _ in range(n)]
    return sh.ShardedJobLogStore(shards), shards


QUERIES = [dict(), dict(node="n1"), dict(failed_only=True),
           dict(job_ids=JOBS[:4]), dict(name_like="nm2"),
           dict(begin=1_700_086_400.0, end=1_700_345_600.0),
           dict(latest=True), dict(latest=True, node="n2")]


def _reads(pkg, ss):
    """Every read the web tier makes of a sharded sink, as plain data."""
    sh = PKGS[pkg][1]
    out = {"overall": ss.stat_overall(), "days": ss.stat_days(10),
           "revision": ss.revision()}
    out["day"] = [ss.stat_day(d["day"]) for d in out["days"]]
    for i, kw in enumerate(QUERIES):
        for page, size in ((1, 500), (1, 5), (2, 5), (3, 4)):
            rows, total = ss.query_logs(page=page, page_size=size, **kw)
            out[f"q{i}/{page}/{size}"] = (_rows(rows), total)
    vec, swept = [0] * ss.nshards, []
    while True:
        rows, total = ss.query_logs(after_id=vec, page_size=7)
        assert total == -1
        if not rows:
            break
        swept.append(_rows(rows))
        vec = sh.advance_cursor(vec, rows, ss.nshards)
    out["cursor"] = (swept, vec)
    out["get"] = [dataclasses.asdict(ss.get_log(r["id"]))
                  for batch in swept for r in batch[:2]]
    out["top"] = [(_rows(r), t) for r, t in (
        sh.fetch_top(s, dict(failed_only=True), 9) for s in ss._raw)]
    out["merged_days"] = sh.merge_stat_days(
        [s.stat_days(10) for s in ss._raw], 4)
    return out


def test_routing_matches_on_known_ids():
    ids = [f"job-{i}" for i in range(500)] + ["", "ü", "a/b"]
    for n in (1, 2, 3, 5, 16):
        assert [psh.log_shard_index(j, n) for j in ids] == \
               [jsh.log_shard_index(j, n) for j in ids]
    assert psh.LOG_HASH_SCHEME == jsh.LOG_HASH_SCHEME
    for gid in (0, 1, 7, 12345):
        assert psh.decode_log_id(gid, 3) == jsh.decode_log_id(gid, 3)
        assert psh.encode_log_id(gid, 2, 3) == jsh.encode_log_id(gid, 2, 3)


@pytest.mark.parametrize("nshards", [2, 3])
def test_the_same_stream_lands_alike_and_reads_alike(nshards):
    docs = _docs()
    got = {}
    for pkg in PKGS:
        ss, shards = _sharded(pkg, nshards)
        _fill(pkg, ss, docs)
        got[pkg] = {"shards": [_rows(s.query_logs(page_size=500)[0])
                               for s in shards], **_reads(pkg, ss)}
        ss.close()
    assert got["port"] == got["jax"]
    # every job's records on its hashed shard only
    for si, rows in enumerate(got["port"]["shards"]):
        assert {psh.log_shard_index(r["job_id"], nshards)
                for r in rows} <= {si}


def _served(pkg, n=2):
    ls = PKGS[pkg][0]
    return [ls.LogSinkServer().start() for _ in range(n)]


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_each_package_reads_the_others_shards_over_the_wire(
        server_pkg, client_pkg):
    docs = _docs(seed=7, batches=12)
    srvs = _served(server_pkg)
    addrs = [f"{s.host}:{s.port}" for s in srvs]
    try:
        writer = PKGS[server_pkg][1].connect_sharded_sink(addrs)
        _fill(server_pkg, writer, docs)
        own = _reads(server_pkg, writer)
        reader = PKGS[client_pkg][1].connect_sharded_sink(addrs)
        assert reader.logmap() == writer.logmap()
        assert _reads(client_pkg, reader) == own
        # and writes through the other package's client land alike
        _fill(client_pkg, reader, _docs(seed=8, batches=4))
        assert _reads(client_pkg, reader) == _reads(server_pkg, writer)
        reader.close()
        writer.close()
    finally:
        for s in srvs:
            s.stop()


def test_reshard_two_to_three_places_every_record_alike():
    docs = _docs(seed=11, batches=20)
    got = {}
    for pkg in PKGS:
        ls, sh = PKGS[pkg]
        src, _ = _sharded(pkg, 2)
        _fill(pkg, src, docs)
        src.upsert_node("n0", '{"id": "n0"}', True)
        dst = [ls.JobLogStore() for _ in range(3)]
        summary = sh.reshard_sinks(src._raw, dst)
        got[pkg] = (summary, [_rows(d.query_logs(page_size=500)[0])
                              for d in dst],
                    [d.stat_overall() for d in dst], dst[0].get_nodes())
        src.close()
    assert got["port"] == got["jax"]
    assert sum(len(rows) for rows in got["port"][1]) == \
        sum(len(b) for b in docs)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_the_logmap_pin_refuses_one_shard_alone(pkg):
    sh = PKGS[pkg][1]
    srvs = _served(pkg)
    addrs = [f"{s.host}:{s.port}" for s in srvs]
    try:
        ss = sh.connect_sharded_sink(addrs)
        assert ss.logmap() == {"n": 2, "hash": sh.LOG_HASH_SCHEME}
        with pytest.raises(RuntimeError, match="logmap"):
            sh.connect_sharded_sink(addrs[:1])
        with pytest.raises(RuntimeError, match="logmap"):
            sh.connect_sharded_sink(addrs + addrs[:1])
        ss.close()
    finally:
        for s in srvs:
            s.stop()


def test_the_port_client_refuses_a_shard_of_a_jax_pinned_layout():
    srvs = _served("jax")
    addrs = [f"{s.host}:{s.port}" for s in srvs]
    try:
        jsh.connect_sharded_sink(addrs).close()
        with pytest.raises(RuntimeError, match="logmap"):
            psh.connect_sharded_sink(addrs[:1])
    finally:
        for s in srvs:
            s.stop()
