"""The port's web tier (``cronsun_tpu_torch.web.ApiServer``) against the
JAX package's.

- Route by route: two twin deployments, each a JAX ``StoreServer`` and
  ``LogSinkServer`` over TCP seeded alike, one served by the JAX
  ``ApiServer`` and one by the port's, each web on its own package's wire
  clients.  One scripted sequence of requests (login, accounts, jobs,
  DAGs, once-execute, logs, stats, nodes, groups, tenants, the scheduler
  and replication views, checkpoints, traces, SLOs, health, metrics, the
  SPA's bytes; 45 of the 49 routes) gives equal status codes and equal
  bodies, JSON compared parsed.
- One shared store and result store behind both webs: an account made by
  either logs in on the other, and a session cookie of either is good on
  the other (a rolling migration of the web tier keeps users logged in).
- The port web's ``/v1/stream`` delivers what the JAX web's does.

Normalised, and only these: the ``sid`` cookie (never compared) and
the session keys it names in the store, the
servers' ephemeral ``host:port`` (``/v1/repl``), the last key segment of
the once-execute order, and the servers' measured op durations at
``/v1/metrics`` (``VOLATILE_METRICS``: ``*_op_total_ms``, ``*_op_max_ms``)."""

import http.cookies
import json
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

import cronsun_tpu.core as jcore
import cronsun_tpu.logsink as jls
import cronsun_tpu.store.remote as jremote
import cronsun_tpu.web as jweb
import cronsun_tpu_torch.core as pcore
import cronsun_tpu_torch.logsink as pls
import cronsun_tpu_torch.store.remote as premote
import cronsun_tpu_torch.web as pweb
from cronsun_tpu_torch.store import MemStore as PortMemStore
from cronsun_tpu.logsink import LogSinkServer
from cronsun_tpu.store import MemStore
from cronsun_tpu.store.remote import StoreServer

PKGS = {"jax": (jcore, jls, jremote, jweb), "port": (pcore, pls, premote, pweb)}
KS = jcore.Keyspace()
T0 = 1_790_000_000.0
VOLATILE_METRICS = re.compile(r"^cronsun_(store|logsink)_op_(total|max)_ms\{")


def _seed(store, sink):
    """A small deployment, every value fixed."""
    for n in ("n1", "n2", "n3"):
        store.put(KS.node_key(n), f"host-{n}:10{n[1]}")
        sink.upsert_node(n, json.dumps({"id": n, "pid": 100, "ip": n,
                                        "hostname": "h", "version": "v",
                                        "up_ts": T0}), True)
    store.put(KS.group_key("web"), jcore.Group(
        id="web", name="web", node_ids=["n1", "n2"]).to_json())
    for i, (kind, timer) in enumerate([(0, "@every 5s"), (1, "0 * * * * *"),
                                       (2, "*/10 * * * * *")]):
        job = jcore.Job(id=f"s{i}", group="ops", name=f"seeded {i}",
                        command=f"echo {i}", kind=kind, tenant="acme",
                        rules=[jcore.JobRule(id="r", timer=timer,
                                             nids=["n1"], gids=["web"])])
        store.put(KS.job_key("ops", job.id), job.to_json())
    store.put(KS.tenant_quota_key("acme"), json.dumps(
        {"tenant": "acme", "max_jobs": 10, "rate": 5.0, "burst": 10.0}))
    recs = []
    for k in range(24):
        recs.append(jls.LogRecord(
            job_id=f"s{k % 3}", job_group="ops", name=f"seeded {k % 3}",
            node=f"n{1 + k % 2}", user="", command=f"echo {k % 3}",
            output=f"line {k}", success=k % 5 != 0,
            begin_ts=T0 + 86400 * (k % 3) + k, end_ts=T0 + 86400 * (k % 3)
            + k + 1))
    sink.create_job_logs(recs, idem="seed")
    store.put(KS.metrics_key("sched", "s-1"), json.dumps(
        {"steps_total": 42, "tick_p50_ms": 1.5, "tick_p99_ms": 9.25,
         "sched_step_p50_ms": 12.0, "sched_step_p99_ms": 80.5,
         "is_leader": 1, "jobs": 3, "nodes": 3}))
    store.put(KS.metrics_key("node", "n1"), json.dumps(
        {"execs_total": 24, "exec_failures_total": 5}))


class Client:
    """A cookie-holding client; each reply as (status, content type,
    body parsed when JSON)."""

    def __init__(self, addr):
        self.base = f"http://{addr}"
        self.sid = ""

    def req(self, method, path, body=None, raw=False):
        data = None if body is None else json.dumps(body).encode()
        r = urllib.request.Request(self.base + path, data=data,
                                   method=method)
        if self.sid:
            r.add_header("Cookie", f"sid={self.sid}")
        try:
            resp = urllib.request.urlopen(r, timeout=10)
        except urllib.error.HTTPError as e:
            resp = e
        cookie = http.cookies.SimpleCookie(resp.headers.get("Set-Cookie", ""))
        if "sid" in cookie:
            self.sid = cookie["sid"].value
        ctype = resp.headers.get("Content-Type", "")
        payload = resp.read()
        if "json" in ctype and payload and not raw:
            payload = json.loads(payload)
        return resp.status, ctype.split(";")[0], payload


def _login(c, email="admin@admin.com", password="admin"):
    q = urllib.parse.urlencode({"email": email, "password": password})
    return c.req("GET", f"/v1/session?{q}")


SCRIPT_CALLS = []


def _script(c):
    """The request sequence: [(label, reply)]."""
    out = []

    def go(label, method, path, body=None, **kw):
        SCRIPT_CALLS.append((method, path))
        out.append((label, c.req(method, path, body, **kw)))

    go("version", "GET", "/v1/version")
    go("unauthorized", "GET", "/v1/jobs")
    go("spa", "GET", "/")
    go("spa-ui", "GET", "/ui/")
    go("healthz", "GET", "/healthz")
    go("readyz", "GET", "/readyz")
    SCRIPT_CALLS.append(("GET", "/v1/session"))
    out.append(("login", _login(c)))
    go("login-post", "POST", "/v1/session",
       {"email": "admin@admin.com", "password": "admin"})
    go("me", "GET", "/v1/session/me")
    go("accounts", "GET", "/v1/admin/accounts")
    go("account-add", "PUT", "/v1/admin/account",
       {"email": "dev@x.io", "password": "pw1", "role": 2})
    go("account-get", "GET", "/v1/admin/account/dev@x.io")
    go("account-update", "POST", "/v1/admin/account",
       {"email": "dev@x.io", "status": 1, "role": 2})
    go("jobs", "GET", "/v1/jobs")
    go("jobs-group", "GET", "/v1/jobs?group=ops")
    go("job-groups", "GET", "/v1/job/groups")
    go("job-put", "PUT", "/v1/job",
       {"id": "new1", "name": "new", "group": "ops", "command": "echo n",
        "kind": 2, "rules": [{"id": "r", "timer": "@every 3s",
                              "nids": ["n2"]}]})
    go("job-put-bad", "PUT", "/v1/job",
       {"id": "bad", "name": "bad", "group": "ops", "command": "x",
        "rules": [{"id": "r", "timer": "not a spec", "nids": ["n2"]}]})
    go("job-get", "GET", "/v1/job/ops-new1")
    go("job-missing", "GET", "/v1/job/ops-nope")
    go("job-pause", "POST", "/v1/job/ops-new1", {"pause": True})
    go("job-nodes", "GET", "/v1/job/ops-s0/nodes")
    go("job-executing", "GET", "/v1/job/executing")
    go("job-dep-put", "PUT", "/v1/job",
       {"id": "down1", "name": "down", "group": "ops", "command": "echo d",
        "deps": {"on": ["s2"], "misfire": "skip"},
        "rules": [{"id": "r", "timer": "@dep", "nids": ["n1"]}]})
    go("dag", "GET", "/v1/dag/ops")
    go("dag-runs", "GET", "/v1/dag/ops/runs")
    go("job-delete", "DELETE", "/v1/job/ops-new1")
    go("logs", "GET", "/v1/logs")
    go("logs-node", "GET", "/v1/logs?node=n2&pageSize=5&page=2")
    go("logs-latest", "GET", "/v1/logs?latest=true")
    go("logs-failed", "GET", "/v1/logs?failedOnly=true&ids=s0,s1")
    go("logs-tail", "GET", "/v1/logs?afterId=tail")
    go("log", "GET", "/v1/log/3")
    go("log-missing", "GET", "/v1/log/999")
    go("stat-overall", "GET", "/v1/stat/overall")
    go("stat-days", "GET", "/v1/stat/days?days=5")
    go("nodes", "GET", "/v1/nodes")
    go("node-groups", "GET", "/v1/node/groups")
    go("node-group", "GET", "/v1/node/group/web")
    go("node-group-put", "PUT", "/v1/node/group",
       {"id": "db", "name": "db", "nids": ["n3"]})
    go("node-group-delete", "DELETE", "/v1/node/group/db")
    go("tenants", "GET", "/v1/tenants")
    go("tenant-put", "PUT", "/v1/tenant",
       {"tenant": "beta", "max_jobs": 2, "rate": 1, "burst": 2})
    go("tenant-get", "GET", "/v1/tenant/acme")
    go("tenant-delete", "DELETE", "/v1/tenant/beta")
    go("sched", "GET", "/v1/sched")
    go("repl", "GET", "/v1/repl")
    go("overview", "GET", "/v1/info/overview")
    go("configurations", "GET", "/v1/configurations")
    go("checkpoint", "POST", "/v1/checkpoint")
    go("trace-top", "GET", "/v1/trace/top")
    go("trace", "GET", "/v1/trace/s0/1790000000")
    go("slo-put", "PUT", "/v1/slo",
       {"name": "ops-ok", "objective": 0.99, "window_s": 3600,
        "selector": {"group": "ops"}})
    go("slos", "GET", "/v1/slos")
    go("slo-status", "GET", "/v1/slo/status")
    go("slo-delete", "DELETE", "/v1/slo/ops-ok")
    go("metrics", "GET", "/v1/metrics")
    go("execute", "PUT", "/v1/job/ops-s0/execute?node=n1")
    go("setpwd", "POST", "/v1/user/setpwd",
       {"password": "admin", "newPassword": "admin2"})
    go("logout", "DELETE", "/v1/session")
    go("after-logout", "GET", "/v1/jobs")
    return out


def _normalise(label, reply, addrs):
    """``addrs``: {host:port of this world's servers: its role name}."""
    status, ctype, body = reply
    if label == "metrics":
        body = "\n".join(ln for ln in body.decode().splitlines()
                         if not VOLATILE_METRICS.match(ln))
    if not isinstance(body, bytes):
        text = json.dumps(body)
        for addr, role in addrs.items():
            text = text.replace(addr, role)
        body = json.loads(text)
    return status, ctype, body


class World:
    """A JAX store and result store over TCP, seeded, and a web of
    ``pkg`` on its own package's wire clients."""

    def __init__(self, pkg, store_srv=None, sink_srv=None, seed=True):
        self.own = store_srv is None
        self.store_srv = store_srv or StoreServer(MemStore()).start()
        self.sink_srv = sink_srv or LogSinkServer().start()
        if seed:
            _seed(self.store_srv.store, self.sink_srv.sink)
        _core, ls, remote, web = PKGS[pkg]
        self.store = remote.RemoteStore(self.store_srv.host,
                                        self.store_srv.port)
        self.sink = ls.RemoteJobLogStore(self.sink_srv.host,
                                         self.sink_srv.port)
        self.api = web.ApiServer(self.store, self.sink, port=0).start()
        self.addr = f"127.0.0.1:{self.api.port}"

    def close(self):
        self.api.stop()
        self.store.close()
        self.sink.close()
        if self.own:
            self.store_srv.stop()
            self.sink_srv.stop()


def _run_script(pkg):
    w = World(pkg)
    try:
        addrs = {f"{w.store_srv.host}:{w.store_srv.port}": "STORE",
                 f"{w.sink_srv.host}:{w.sink_srv.port}": "SINK",
                 w.addr: "WEB"}
        out = [(label, _normalise(label, reply, addrs))
               for label, reply in _script(Client(w.addr))]
        once = [kv.key for kv in w.store_srv.store.get_prefix(KS.once)]
        store_keys = sorted(
            KS.sess + "SID" if kv.key.startswith(KS.sess) else kv.key
            for kv in w.store_srv.store.get_prefix("/cronsun/")
            if not kv.key.startswith(KS.once))
    finally:
        w.close()
    return out, store_keys, [k.rsplit("/", 1)[0] for k in once]


def test_the_same_requests_get_the_same_replies():
    jax_out, jax_keys, jax_once = _run_script("jax")
    port_out, port_keys, port_once = _run_script("port")
    assert [label for label, _ in port_out] == [l for l, _ in jax_out]
    diff = [label for (label, want), (_, got) in zip(jax_out, port_out)
            if got != want]
    assert not diff, [(l, dict(jax_out)[l], dict(port_out)[l])
                      for l in diff]
    assert port_keys == jax_keys
    assert port_once == jax_once and len(jax_once) == 1
    codes = {label: r[0] for label, r in jax_out}
    assert codes["unauthorized"] == 401 and codes["after-logout"] == 401
    assert codes["job-put"] == 200 and codes["job-put-bad"] == 400
    # the routes the script reached, of the port's table
    api = pweb.ApiServer(PortMemStore(), pls.JobLogStore(), port=0)
    hit = {(m, rx.pattern) for m, rx, *_ in api.routes
           for meth, path in SCRIPT_CALLS
           if m == meth and rx.match(urllib.parse.urlparse(path).path)}
    assert len(api.routes) == 49 and len(hit) >= 45, sorted(
        (m, rx.pattern) for m, rx, *_ in api.routes
        if (m, rx.pattern) not in hit)


def test_the_spa_bytes_are_the_jax_packages():
    from cronsun_tpu.web.ui import INDEX_HTML as jax_html
    from cronsun_tpu_torch.web.ui import INDEX_HTML as port_html
    assert port_html.encode() == jax_html.encode()


@pytest.fixture
def shared():
    """Both webs over ONE store and ONE result store."""
    store_srv = StoreServer(MemStore()).start()
    sink_srv = LogSinkServer().start()
    _seed(store_srv.store, sink_srv.sink)
    worlds = {pkg: World(pkg, store_srv, sink_srv, seed=False)
              for pkg in PKGS}
    yield worlds
    for w in worlds.values():
        w.close()
    store_srv.stop()
    sink_srv.stop()


@pytest.mark.parametrize("maker,user", [("jax", "port"), ("port", "jax")])
def test_an_account_made_by_one_web_logs_in_on_the_other(shared, maker,
                                                          user):
    admin = Client(shared[maker].addr)
    assert _login(admin)[0] == 200
    email = f"made-by-{maker}@x.io"
    assert admin.req("PUT", "/v1/admin/account",
                     {"email": email, "password": "s3cret",
                      "role": 2})[0] == 200
    other = Client(shared[user].addr)
    assert _login(other, email, "s3cret")[0] == 200
    assert other.req("GET", "/v1/session/me")[2]["email"] == email
    assert _login(Client(shared[user].addr), email, "wrong")[0] != 200
    # the session cookie of one web is good on the other
    roaming = Client(shared[user].addr)
    roaming.sid = admin.sid
    status, _t, me = roaming.req("GET", "/v1/session/me")
    assert status == 200 and me["email"] == "admin@admin.com"
    # a password set on one web is the password on the other
    assert other.req("POST", "/v1/user/setpwd",
                     {"password": "s3cret", "newPassword": "n3w-pass"})[0] == 200
    assert _login(Client(shared[maker].addr), email, "n3w-pass")[0] == 200


class _Stream:
    """One ``/v1/stream`` viewer collecting its events' data."""

    def __init__(self, addr, sid):
        r = urllib.request.Request(f"http://{addr}/v1/stream")
        r.add_header("Cookie", f"sid={sid}")
        self.resp = urllib.request.urlopen(r, timeout=10)
        self.events = []
        self.t = threading.Thread(target=self._read, daemon=True)
        self.t.start()

    def _read(self):
        try:
            for raw in self.resp:
                line = raw.decode().rstrip("\n")
                if line.startswith("data:"):
                    self.events.append(json.loads(line[5:]))
        except (OSError, ValueError):
            pass

    def close(self):
        self.resp.close()
        self.t.join(5)


def test_the_port_webs_stream_delivers_what_the_jax_webs_does(shared):
    streams = {}
    for pkg, w in shared.items():
        c = Client(w.addr)
        assert _login(c)[0] == 200
        streams[pkg] = _Stream(w.addr, c.sid)
    time.sleep(0.5)
    shared["jax"].sink_srv.sink.create_job_logs([jls.LogRecord(
        job_id="s1", job_group="ops", name="seeded 1", node="n2", user="",
        command="echo 1", output=f"live {k}", success=k != 1,
        begin_ts=T0 + 500 + k, end_ts=T0 + 501 + k) for k in range(3)],
        idem="live")
    deadline = time.time() + 10
    while time.time() < deadline and not all(
            len(s.events) >= 3 for s in streams.values()):
        time.sleep(0.05)
    for s in streams.values():
        s.close()
    assert len(streams["jax"].events) == 3
    assert streams["port"].events == streams["jax"].events
