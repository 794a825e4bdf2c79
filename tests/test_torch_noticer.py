"""The port's noticer (``cronsun_tpu_torch.noticer``) against the JAX
package's: the same events (a job failure an agent records, a node whose
lease ends without a goodbye, a clean shutdown, a notice written straight
to the noticer prefix) through each package's ``NoticerHost`` post
identical bodies to a local HTTP receiver and send identical mails
through a stand-in for ``smtplib.SMTP``.  Each host runs on its own
package's store and sink.  Nothing is volatile: the failing execution
carries fixed timestamps."""

import json

import pytest

import cronsun_tpu.core as jcore
import cronsun_tpu.logsink as jls
import cronsun_tpu.node.agent as jagent
import cronsun_tpu.node.executor as jexec
import cronsun_tpu.noticer as jnot
import cronsun_tpu.store.memstore as jmem
import cronsun_tpu_torch.core as pcore
import cronsun_tpu_torch.logsink as pls
import cronsun_tpu_torch.node.agent as pagent
import cronsun_tpu_torch.node.executor as pexec
import cronsun_tpu_torch.noticer as pnot
import cronsun_tpu_torch.store.memstore as pmem
from torch_fleet import Receiver

PKGS = {"jax": (jcore, jls, jagent, jexec, jnot, jmem),
        "port": (pcore, pls, pagent, pexec, pnot, pmem)}


@pytest.fixture
def receiver():
    r = Receiver()
    yield r
    r.close()


def _script(pkg, sender):
    """The scripted events through one package's host; the host's sent
    notices' (subject, body, to) and the node mirror at the end."""
    core, ls, agent_mod, exec_mod, noticer, mem = PKGS[pkg]
    ks = core.Keyspace()
    store, sink = mem.MemStore(), ls.JobLogStore()
    host = noticer.NoticerHost(store, sink, sender, ks=ks)
    agent = agent_mod.NodeAgent(store, sink, node_id="ag1", ks=ks)
    job = core.Job(id="j1", group="g", name="nightly", command="false",
                   fail_notify=True, to=["ops@example.com"],
                   rules=[core.JobRule(id="r", timer="@every 5s",
                                       nids=["ag1"])])
    agent._record(job, exec_mod.ExecResult(
        False, "disk full", 1_700_000_000.0, 1_700_000_003.0, exit_code=1,
        error="exit status 1"), 1_700_000_000)
    agent.stop()
    assert host.poll() == 1
    # a crash: the lease ends while the mirror says alive
    sink.upsert_node("n7", '{"id": "n7"}', alived=True)
    store.put(ks.node_key("n7"), "host:1")
    host.poll()
    store.delete(ks.node_key("n7"))
    assert host.poll() == 1
    # a clean shutdown: no alert
    sink.set_node_alived("n8", False)
    store.put(ks.node_key("n8"), "host:2")
    host.poll()
    store.delete(ks.node_key("n8"))
    assert host.poll() == 0
    store.put(ks.noticer_key("slo"), json.dumps(
        {"subject": "[cronsun] SLO burn", "body": "2% of budget",
         "to": ["a@b.c", "d@e.f"]}))
    assert host.poll() == 1
    out = ([(n.subject, n.body, n.to) for n in host.sent],
           sink.get_node("n7"), store.get(ks.noticer_key("slo")))
    store.close()
    return out


def test_both_hosts_post_identical_bodies(receiver):
    seen = {pkg: _script(pkg, PKGS[pkg][4].HttpNoticer(receiver.url + pkg))
            for pkg in PKGS}
    assert seen["port"] == seen["jax"]
    got = {pkg: [(c, b) for _t, p, c, b in receiver.posts if p == "/" + pkg]
           for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert [b["subject"] for _t, b in got["jax"]] == [
        "[cronsun] job [nightly] fail", "[cronsun] node [n7] down",
        "[cronsun] SLO burn"]
    assert seen["jax"][1]["alived"] is False      # marked after delivery
    assert seen["jax"][2] is None                  # consumed


class _FakeSMTP:
    """Records the session; stands in for ``smtplib.SMTP``."""

    log = []

    def __init__(self, host, port, timeout=None):
        self.log.append(("connect", host, port, timeout))

    def starttls(self):
        self.log.append(("starttls",))

    def login(self, user, password):
        self.log.append(("login", user, password))

    def sendmail(self, frm, to, msg):
        self.log.append(("sendmail", frm, list(to), msg))

    def quit(self):
        self.log.append(("quit",))


def test_both_mail_noticers_send_identical_mail(monkeypatch):
    sessions = {}
    for pkg in PKGS:
        noticer = PKGS[pkg][4]
        _FakeSMTP.log = []
        monkeypatch.setattr(noticer.smtplib, "SMTP", _FakeSMTP)
        mail = noticer.MailNoticer("smtp.example.com", 587, "cron@x",
                                   "pw", default_to=["ops@x"], keepalive=0)
        _script(pkg, mail)
        mail.send(noticer.Notice("no recipients", "dropped", to=[]))
        mail.idle_check()
        sessions[pkg] = list(_FakeSMTP.log)
    assert sessions["port"] == sessions["jax"]
    sends = [e for e in sessions["jax"] if e[0] == "sendmail"]
    assert len(sends) == 4 and sends[0][2] == ["ops@example.com"]
    assert sessions["jax"][-1] == ("quit",)


class _LostWatch:
    """A watch of another package's store that was cancelled."""

    def drain(self):
        raise jmem.WatchLost("watch cancelled: slow consumer")

    def close(self):
        pass


@pytest.mark.parametrize("pkg", list(PKGS))
def test_a_lost_watch_of_a_jax_store_resyncs_in_both_hosts(pkg):
    """The port's host takes the JAX package's ``WatchLost`` for its own
    (matched by name) and re-lists, as the JAX host does."""
    core, ls, _a, _e, noticer, _m = PKGS[pkg]

    class Collect:
        def __init__(self):
            self.notices = []

        def send(self, n):
            self.notices.append(n.subject)

    ks = core.Keyspace()
    store, sink, sender = jmem.MemStore(), ls.JobLogStore(), Collect()
    host = noticer.NoticerHost(store, sink, sender, ks=ks)
    store.put(ks.noticer_key("n1"), json.dumps({"subject": "s", "body": "b"}))
    host._w_notice.close()
    host._w_notice = _LostWatch()
    assert host.poll() == 1
    assert sender.notices == ["s"]
    assert store.get(ks.noticer_key("n1")) is None
    store.close()
