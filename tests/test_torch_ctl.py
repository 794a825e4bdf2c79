"""The port's operator CLI (``cronsun_tpu_torch.bin.ctl``) against the JAX
package's.

- Every case of ``tests/test_ctl.py`` runs, its own assertions included,
  over three (CLI, web) pairs: (port, port), (port, JAX) and (JAX, port),
  where "web" is that package's ``ApiServer`` over its ``MemStore`` and
  ``JobLogStore``.  Each pair's transcript (every exit code, every
  ``capsys`` read) must equal the (JAX, JAX) pair's on the same case.
  Normalised, and only these: job and rule ids (random at each save),
  in order of first sight, and the servers' measured op durations that
  ``metrics`` prints.
- The offline commands across the packages: ``checkpoint-compact`` of
  the same chain bytes (written by a port scheduler, and by a JAX one)
  gives identical files and output; ``fsck`` of one seeded store with
  planted faults gives identical findings and exit codes (a leaked
  order's age in seconds is read off the clock, so it is not compared);
  ``logd-reshard``
  2 -> 3 gives identical reads of the destinations.
- ``--help`` of every command and subcommand is identical.
"""

import os
import re
import shutil

import pytest

import cronsun_tpu.bin.ctl as jctl
import cronsun_tpu.logsink as jls
import cronsun_tpu.store as jstore
import cronsun_tpu.web as jweb
import cronsun_tpu_torch.bin.ctl as pctl
import cronsun_tpu_torch.logsink as pls
import cronsun_tpu_torch.store as pstore
import cronsun_tpu_torch.web as pweb
import test_ctl as ref

CTL = {"jax": jctl, "port": pctl}
WEB = {"jax": (jstore, jls, jweb), "port": (pstore, pls, pweb)}
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]
CASES = sorted(n for n in dir(ref) if n.startswith("test_"))
JAX_TRANSCRIPTS = {}       # case -> the (JAX, JAX) pair's, run once
VOLATILE_METRICS = re.compile(
    r"(cronsun_(?:store|logsink)_op_(?:total|max)_ms\{[^}]*\}) [0-9.e+-]+")


class Transcript:
    """A ``capsys`` whose reads are kept in order, beside ``run``'s exit
    codes."""

    def __init__(self, capsys):
        self._capsys, self.lines = capsys, []

    def readouterr(self):
        got = self._capsys.readouterr()
        self.lines.append(("read", got.out, got.err))
        return got


def _world(ctl_pkg, web_pkg, tmp_path, rec):
    st, ls, web = WEB[web_pkg]
    store, sink = st.MemStore(), ls.JobLogStore()
    srv = web.ApiServer(store, sink, port=0).start()
    session = str(tmp_path / "session")

    def run(*argv):
        try:
            rc = CTL[ctl_pkg].main(["--url", f"http://127.0.0.1:{srv.port}",
                                    "--session", session, *argv])
        except SystemExit as e:
            rec.lines.append(("exit", argv[0], e.code))
            raise
        rec.lines.append(("rc", argv[0], rc))
        return rc
    return (store, sink, run), lambda: (srv.stop(), store.close())


def transcript(case, ctl_pkg, web_pkg, tmp_path, capsys, monkeypatch):
    """Run ``test_ctl.<case>`` on (``ctl_pkg``, ``web_pkg``); its
    transcript, normalised."""
    fn = getattr(ref, case)
    rec = Transcript(capsys)
    monkeypatch.setattr(ref, "ctl", CTL[ctl_pkg])
    tmp = tmp_path / f"{ctl_pkg}-{web_pkg}"
    tmp.mkdir()
    kw = {}
    names = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    stop = None
    if "world" in names:
        kw["world"], stop = _world(ctl_pkg, web_pkg, tmp, rec)
    if "capsys" in names:
        kw["capsys"] = rec
    if "tmp_path" in names:
        kw["tmp_path"] = tmp
    try:
        fn(**kw)
    finally:
        if stop is not None:
            stop()
        monkeypatch.undo()
    rec.readouterr()
    return normalise(rec.lines)


def normalise(lines):
    """Job and rule ids (8 hex digits, random at each save), numbered in
    order of first sight, and the servers' measured op durations in
    ``metrics`` (as ``tests/test_torch_web.py`` treats ``/v1/metrics``),
    so two runs of one case compare."""
    seen = {}

    def sub(m):
        return seen.setdefault(m.group(0), f"<id{len(seen)}>")
    text = re.sub(r"(?<![0-9a-z])[0-9a-f]{8}(?![0-9a-z])", sub, repr(lines))
    return VOLATILE_METRICS.sub(r"\1 <ms>", text)


@pytest.mark.parametrize("ctl_pkg,web_pkg", PAIRS,
                         ids=[f"{c}-ctl-{w}-web" for c, w in PAIRS])
@pytest.mark.parametrize("case", CASES)
def test_every_ctl_case_reads_the_same_on_every_pair(
        case, ctl_pkg, web_pkg, tmp_path, capsys, monkeypatch):
    if case not in JAX_TRANSCRIPTS:
        JAX_TRANSCRIPTS[case] = transcript(case, "jax", "jax", tmp_path,
                                           capsys, monkeypatch)
    want = JAX_TRANSCRIPTS[case]
    got = transcript(case, ctl_pkg, web_pkg, tmp_path, capsys, monkeypatch)
    assert got == want


# -------------------------------------------------------------- --help

def _commands(parser, path=()):
    """Every command path of ``parser``, the root's included."""
    import argparse
    yield path
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sub in a.choices.items():
                yield from _commands(sub, path + (name,))


HELP_PATHS = list(_commands(jctl.build_parser()))


def _help(ctl, path, capsys, monkeypatch):
    monkeypatch.setenv("COLUMNS", "100")
    with pytest.raises(SystemExit) as ei:
        ctl.main([*path, "--help"])
    return ei.value.code, capsys.readouterr()


@pytest.mark.parametrize("path", HELP_PATHS,
                         ids=[" ".join(p) or "(root)" for p in HELP_PATHS])
def test_help_is_identical(path, capsys, monkeypatch):
    assert [p for p in _commands(pctl.build_parser())] == HELP_PATHS
    assert _help(pctl, path, capsys, monkeypatch) == \
        _help(jctl, path, capsys, monkeypatch)


# -------------------------------------------------- checkpoint-compact

def _chain(saver, ckpt):
    """A scheduler of ``saver``'s package saves a full checkpoint, then two
    delta elements around job churn, into ``ckpt``."""
    from test_torch_ckpt_delta import churn
    from test_torch_service_fleet import saved, seeded_store
    store = seeded_store()
    svc, ep = saved(saver, store, ckpt)
    try:
        for _ in range(2):
            churn(store)
            svc.step(now=ep)
            ep = svc._next_epoch
            if svc._pending_plan is not None:
                svc._resolve_handle(svc._pending_plan[1])
            assert svc.checkpoint_save(kind="delta")["kind"] == "delta"
    finally:
        svc.stop()


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoint_compact_gives_identical_files(saver, tmp_path, capsys):
    from cronsun_tpu.sched import SchedulerService as JaxService
    from cronsun_tpu_torch.sched import SchedulerService as PortService
    src = str(tmp_path / "src")
    _chain({"jax": JaxService, "port": PortService}[saver], src)
    before = _files(src)
    assert sum(n.startswith("sched.ckpt.d") for n in before) == 2
    out = {}
    for pkg, ctl in CTL.items():
        d = str(tmp_path / pkg)
        shutil.copytree(src, d)
        for argv in (["checkpoint-compact", d],
                     ["--json", "checkpoint-compact",
                      os.path.join(d, "sched.ckpt")]):
            assert ctl.main(argv) == 0
        out[pkg] = (capsys.readouterr(), _files(d))
    assert out["port"] == out["jax"]
    assert "compacted 2 delta elements -> 1" in out["jax"][0].out
    assert out["jax"][1] != before


def test_checkpoint_compact_refusals_read_alike(tmp_path, capsys):
    got = {}
    for pkg, ctl in CTL.items():
        with pytest.raises(SystemExit) as ei:
            ctl.main(["checkpoint-compact", str(tmp_path / "missing")])
        got[pkg] = (ei.value.code, capsys.readouterr())
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------- fsck

def _fsck_store(now):
    """A JAX ``MemStore`` with one live job and a planted fault of every
    class ``fsck`` names (``tests/test_chaos.py``'s seed)."""
    from cronsun_tpu.core import Job, JobRule, KIND_INTERVAL, Keyspace
    ks, store = Keyspace(), jstore.MemStore()
    job = Job(id="alive", name="alive", command="true", kind=KIND_INTERVAL,
              rules=[JobRule(timer="* * * * * *", nids=["node-0"])])
    job.check()
    store.put(ks.job_key("default", "alive"), job.to_json())
    store.put(ks.dispatch_bundle_key("node-0", now - 3600), "[]")
    store.put(ks.proc_key("node-0", "default", "ghost", 1), "{}")
    store.put(ks.dep_key("default", "ghost2"), "100|ok")
    store.put(ks.lock_key("ghost3", now), "x")
    store.put(ks.lock_key("alive", now - 3600), "x")
    return store


@pytest.mark.parametrize("server", ["jax", "port"])
def test_fsck_names_the_same_findings(server, capsys):
    import time
    from cronsun_tpu.store.remote import StoreServer as JaxServer
    from cronsun_tpu_torch.store.remote import StoreServer as PortServer
    store = _fsck_store(int(time.time()))
    srv = {"jax": JaxServer, "port": PortServer}[server](store).start()
    sink = jls.LogSinkServer().start()
    argv = ["fsck", "--store", f"127.0.0.1:{srv.port}",
            "--logsink", f"127.0.0.1:{sink.port}"]
    got = {}
    try:
        for pkg, ctl in CTL.items():
            runs = []
            for a in (argv, ["--json", *argv]):
                with pytest.raises(SystemExit) as ei:
                    ctl.main(a)
                # a leaked order's age is read off the clock at each run
                runs.append((ei.value.code, re.sub(
                    r"scheduled \d+s ago", "scheduled <n>s ago",
                    capsys.readouterr().out)))
            got[pkg] = runs
    finally:
        sink.stop()
        srv.stop()
    assert got["port"] == got["jax"]
    assert got["jax"][0][0] == 1
    for code in ("orphan_proc", "orphan_fence", "dangling_dep",
                 "leaked_reservation", "fence_without_record"):
        assert code in got["jax"][0][1]


# -------------------------------------------------------- logd-reshard

def test_logd_reshard_two_to_three_reads_alike(capsys):
    from test_torch_sharded_logsink import _docs, _fill, _rows
    import cronsun_tpu.logsink.sharded as jsh
    docs = _docs(seed=11, batches=6)
    src = [jls.LogSinkServer().start() for _ in range(2)]
    src_addr = ",".join(f"127.0.0.1:{s.port}" for s in src)
    got, dsts = {}, []
    try:
        writer = jsh.connect_sharded_sink(src_addr.split(","))
        _fill("jax", writer, docs)
        writer.upsert_node("n0", '{"id": "n0"}', True)
        writer.close()
        for pkg, ctl in CTL.items():
            dst = [jls.LogSinkServer().start() for _ in range(3)]
            dsts += dst
            to = ",".join(f"127.0.0.1:{s.port}" for s in dst)
            assert ctl.main(["logd-reshard", "--from", src_addr,
                             "--to", to, "--batch", "7"]) == 0
            out = capsys.readouterr().out
            reader = jsh.connect_sharded_sink(to.split(","))
            got[pkg] = (out, _rows(reader.query_logs(page_size=500)[0]),
                        reader.stat_overall(), reader.get_nodes(),
                        reader.logmap())
            reader.close()
            # a second run onto the now-full destination is refused alike
            with pytest.raises(SystemExit) as ei:
                ctl.main(["logd-reshard", "--from", src_addr, "--to", to])
            got[pkg] += (ei.value.code, capsys.readouterr().out)
    finally:
        for s in src + dsts:
            s.stop()
    assert got["port"] == got["jax"]
    assert got["jax"][4] == {"n": 3, "hash": jsh.LOG_HASH_SCHEME}
    assert len(got["jax"][1]) == sum(len(b) for b in docs)
