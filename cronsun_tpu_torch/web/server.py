"""The /v1 REST API (reference web/routers.go:17-114 — all routes).

Stdlib ThreadingHTTPServer + a regex route table.  Handlers mirror the
reference's semantics:

- session login/logout + salted-hash accounts, bootstrap admin
  (web/authentication.go:20-133)
- role-gated admin account CRUD with force-logout on edit and the
  Unchangeable guard (web/administrator.go)
- job CRUD against the coordination store — CAS pause toggle, group-move
  delete, run-now via the once key, node resolution include ∪ groups −
  exclude (web/job.go)
- executing-list from the proc registry (web/job.go:278-337)
- group CRUD with the job-scrub on delete (web/node.go:78-139)
- paged/filtered log queries (web/job_log.go)
- overview + configurations (web/info.go, web/configuration.go)

Copy of ``cronsun_tpu/web/server.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from collections import OrderedDict
from http import HTTPStatus
from http.cookies import SimpleCookie
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .. import log, trace as _trace
from ..core import (
    Account, Group, Job, Keyspace, ROLE_ADMIN, TenantQuota,
    ValidationError, next_id, validate_dag)
from ..core.models import SloSpec, hash_password
from ..logsink import JobLogStore
from ..store.memstore import MemStore
from .sessions import Session, SessionStore
from .ui import INDEX_HTML

VERSION = "v0.1.0-tpu"
BOOTSTRAP_ADMIN = "admin@admin.com"
BOOTSTRAP_PASSWORD = "admin"


def _esc_label(v) -> str:
    """Prometheus exposition label-value escaping: backslash, double
    quote AND newline (the one the ad-hoc escapes missed — a tenant or
    op name containing a newline emitted a torn, unparseable line)."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


class HttpError(Exception):
    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status
        self.msg = msg


class NotModified(HttpError):
    """304 via If-None-Match: the client's cached body is current.
    Carries the ETag so the transport can re-assert it; no body."""

    def __init__(self, etag: str):
        super().__init__(304, "not modified")
        self.etag = etag


class PlainText(str):
    """Handler return type served as text/plain instead of JSON
    (the /v1/metrics Prometheus exposition)."""


class SseStream:
    """Handler return type that takes over the transport: the HTTP
    layer sends ``text/event-stream`` headers and calls ``serve`` on
    the request thread, which writes events until the client drops,
    falls behind (terminal ``lost``), or the server drains (final
    ``bye`` with a long ``retry:``).  Event ``id:`` is the cursor
    vector — a reconnecting client resumes exactly-once via
    ``Last-Event-ID``."""

    def __init__(self, manager, client, replay: list):
        self.manager = manager
        self.client = client
        self.replay = replay

    def _event_bytes(self, ev) -> bytes:
        from .push import event_data_json
        self.client.advance(ev[0])
        cursor = ",".join(str(v) for v in self.client.vec)
        data = event_data_json(ev)
        return (f"id: {cursor}\nevent: log\ndata: {data}\n\n").encode()

    def serve(self, wfile):
        c, pm = self.client, self.manager
        try:
            wfile.write(b"retry: 3000\n\n")
            if self.replay:
                wfile.write(b"".join(
                    self._event_bytes(ev) for ev in self.replay))
            wfile.flush()
            while True:
                evs, state = c.take(timeout=pm.heartbeat)
                if evs:
                    # one syscall per wakeup, not per event: under load
                    # take() batches, so write count degrades gracefully
                    wfile.write(b"".join(
                        self._event_bytes(ev) for ev in evs))
                if state == "lost":
                    # terminal: this viewer overflowed (or resumed past
                    # the replay window) — it re-lists and reconnects
                    wfile.write(b"event: lost\ndata: {}\n\n")
                    wfile.flush()
                    return
                if state == "closed":
                    # graceful drain: tell the browser to back off the
                    # dying replica before the socket closes
                    wfile.write(b"retry: 30000\nevent: bye\ndata: {}\n\n")
                    wfile.flush()
                    return
                if not evs:
                    wfile.write(b": hb\n\n")
                wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            pm.unregister(c)


class ApiServer:
    def __init__(self, store: MemStore, sink: JobLogStore,
                 ks: Optional[Keyspace] = None, security=None, alarm=None,
                 auth_enabled: bool = True,
                 host: str = "127.0.0.1", port: int = 7079,
                 cache_enabled: Optional[bool] = None,
                 slo_engine=None, push_enabled: Optional[bool] = None,
                 sse_writer: Optional[str] = None):
        # auth_enabled=False replicates the reference's Web.Auth.Enabled
        # switch (web/base.go:98: every request passes as an implicit
        # admin; the UI skips login).  Unlike the reference — whose Go
        # zero value DISABLES auth unless configured — the rebuild's
        # default is enabled.
        self.auth_enabled = auth_enabled
        self._implicit_admin = Session(email=BOOTSTRAP_ADMIN,
                                       role=ROLE_ADMIN)
        self.store = store
        self.sink = sink
        self.ks = ks or Keyspace()
        self.security = security
        self.alarm = alarm
        self.sessions = SessionStore(store, self.ks)
        self.host, self.port = host, port
        self._httpd: Optional[ThreadingHTTPServer] = None
        # revision-vector response cache (web/cache.py): None = off —
        # today's recompute-per-poll behavior, exactly
        from .cache import ResponseCache, cache_default
        if cache_enabled is None:
            cache_enabled = cache_default()
        self.cache = ResponseCache() if cache_enabled else None
        self._bootstrap_admin()
        # result-store shard breakers page through the noticer this
        # process hosts: a browning-out logd shard writes a notice key
        # into the coordination store (store-shard breakers arm
        # themselves — they can write their own plane)
        arm = getattr(sink, "arm_breaker_notices", None)
        if arm is not None:
            try:
                arm(self.store, self.ks.prefix)
            except Exception as e:  # noqa: BLE001 — paging is optional
                log.warnf("breaker notice arming failed: %s", e)
        # SLO engine (web/slo.py): burn-rate evaluation + paging runs
        # in THIS process; None = engine hosted elsewhere (or off) —
        # the /v1/slo surfaces then serve specs without live burn rates
        self.slo_engine = slo_engine
        # live-push plane (web/push.py): one subscription per logd
        # shard feeding SSE fan-out and push-driven cache refresh.
        # CRONSUN_WEB_PUSH=off (or push_enabled=False) is the rollback:
        # no subscriptions, /v1/stream 503s, poll behavior unchanged.
        from .push import PushManager, push_default
        if push_enabled is None:
            push_enabled = push_default()
        self._push = None
        self._push_refreshers: OrderedDict = OrderedDict()
        self._push_ref_mu = threading.Lock()
        if push_enabled and hasattr(sink, "subscribe"):
            try:
                self._push = PushManager(
                    sink, on_change=self._push_refresh).start()
            except Exception as e:  # noqa: BLE001 — degrade to polling
                log.warnf("live push unavailable: %s", e)
                self._push = None
        # SSE writer mode: the epoll pool (web/sse_epoll.py) owns every
        # viewer socket by default; CRONSUN_SSE_WRITER=threads (or
        # sse_writer="threads") is the rollback to the
        # thread-per-connection writer — byte-identical on the wire,
        # pinned by tests/test_sse_epoll.py
        mode = (sse_writer or os.environ.get("CRONSUN_SSE_WRITER", "")
                or "epoll").strip().lower()
        self.sse_writer = "threads" if mode in ("threads", "thread") \
            else "epoll"
        self._sse_pool = None
        self._sse_adopted: set = set()
        self._sse_adopt_mu = threading.Lock()
        if self._push is not None and self.sse_writer == "epoll":
            from .sse_epoll import EpollSsePool
            self._sse_pool = EpollSsePool(
                self._push, on_close=self._sse_forget)
        self.routes = self._build_routes()

    # ---- SSE socket adoption (epoll writer) ------------------------------
    # The HTTP layer marks a streaming socket adopted BEFORE handing it
    # to the pool; socketserver's per-request teardown then skips it
    # (shutdown_request would otherwise send FIN under the pool).  The
    # marker is consumed by whichever side tears down first — the
    # request thread exiting or the pool closing the socket — and both
    # paths are safe against the other having already run because a
    # closed Python socket's fd is -1 (no fd-reuse hazard).

    def _sse_adopt(self, sock):
        with self._sse_adopt_mu:
            self._sse_adopted.add(sock)

    def _sse_forget(self, sock) -> bool:
        with self._sse_adopt_mu:
            if sock in self._sse_adopted:
                self._sse_adopted.discard(sock)
                return True
            return False

    # ---- bootstrap (web/authentication.go:20-52) -------------------------

    def _bootstrap_admin(self):
        if self.sink.get_account(BOOTSTRAP_ADMIN) is None:
            salt = next_id()
            acc = Account(email=BOOTSTRAP_ADMIN, salt=salt,
                          password=hash_password(BOOTSTRAP_PASSWORD, salt),
                          role=ROLE_ADMIN, unchangeable=True)
            self.sink.upsert_account(acc.email, acc.to_json())

    # ---- routing ---------------------------------------------------------

    def _build_routes(self):
        R = []

        def route(method, pattern, fn, auth=True, admin=False):
            R.append((method, re.compile("^" + pattern + "$"), fn, auth,
                      admin))

        route("GET", r"/v1/version", self.get_version, auth=False)
        route("GET", r"/v1/session", self.login, auth=False)
        # POST variant: credentials ride the JSON body, not the query
        # string, so they can't land in proxy/access logs (the GET route
        # stays for UI compatibility with the reference's login flow)
        route("POST", r"/v1/session", self.login, auth=False)
        route("GET", r"/v1/session/me", self.session_me)
        route("DELETE", r"/v1/session", self.logout)
        route("POST", r"/v1/user/setpwd", self.set_password)
        route("GET", r"/v1/admin/accounts", self.admin_list, admin=True)
        route("GET", r"/v1/admin/account/(?P<email>[^/]+)", self.admin_get,
              admin=True)
        route("PUT", r"/v1/admin/account", self.admin_add, admin=True)
        route("POST", r"/v1/admin/account", self.admin_update, admin=True)
        route("GET", r"/v1/jobs", self.job_list)
        route("GET", r"/v1/job/groups", self.job_groups)
        route("PUT", r"/v1/job", self.job_update)
        route("GET", r"/v1/job/executing", self.job_executing)
        route("POST", r"/v1/job/(?P<group>[^/]+)-(?P<id>[^/-]+)",
              self.job_change_status)
        route("GET", r"/v1/job/(?P<group>[^/]+)-(?P<id>[^/-]+)", self.job_get)
        route("DELETE", r"/v1/job/(?P<group>[^/]+)-(?P<id>[^/-]+)",
              self.job_delete)
        route("GET", r"/v1/dag/(?P<group>[^/]+)/runs", self.dag_runs)
        route("GET", r"/v1/dag/(?P<group>[^/]+)", self.dag_show)
        route("GET", r"/v1/job/(?P<group>[^/]+)-(?P<id>[^/-]+)/nodes",
              self.job_nodes)
        route("PUT", r"/v1/job/(?P<group>[^/]+)-(?P<id>[^/-]+)/execute",
              self.job_execute)
        route("GET", r"/v1/logs", self.log_list)
        # live event stream (SSE) — the poll loop's push replacement
        route("GET", r"/v1/stream", self.log_stream)
        route("GET", r"/v1/log/(?P<id>\d+)", self.log_detail)
        route("GET", r"/v1/stat/overall", self.stat_overall)
        route("GET", r"/v1/stat/days", self.stat_days)
        route("GET", r"/v1/nodes", self.node_list)
        route("GET", r"/v1/node/groups", self.group_list)
        route("GET", r"/v1/node/group/(?P<id>[^/]+)", self.group_get)
        route("PUT", r"/v1/node/group", self.group_update)
        route("DELETE", r"/v1/node/group/(?P<id>[^/]+)", self.group_delete)
        route("GET", r"/v1/tenants", self.tenant_list)
        route("PUT", r"/v1/tenant", self.tenant_set, admin=True)
        route("GET", r"/v1/tenant/(?P<id>[^/]+)", self.tenant_get)
        route("DELETE", r"/v1/tenant/(?P<id>[^/]+)", self.tenant_delete,
              admin=True)
        route("GET", r"/v1/sched", self.sched_status)
        # store replication plane: per-shard role/lag/epoch (repl/)
        route("GET", r"/v1/repl", self.repl_status)
        route("GET", r"/v1/info/overview", self.overview)
        route("GET", r"/v1/configurations", self.configurations)
        route("POST", r"/v1/checkpoint", self.checkpoint, admin=True)
        # trace plane: assembled waterfalls + slowest-trace summaries
        route("GET", r"/v1/trace/top", self.trace_top)
        route("GET", r"/v1/trace/(?P<job>[^/]+)/(?P<sec>\d+)",
              self.trace_show)
        # SLO engine: declarative specs + live burn rates
        route("GET", r"/v1/slos", self.slo_list)
        route("PUT", r"/v1/slo", self.slo_set, admin=True)
        route("DELETE", r"/v1/slo/(?P<name>[^/]+)", self.slo_delete,
              admin=True)
        route("GET", r"/v1/slo/status", self.slo_status)
        # liveness/readiness (unauthenticated: probes don't log in)
        route("GET", r"/healthz", self.healthz, auth=False)
        route("GET", r"/readyz", self.readyz, auth=False)
        # unauthenticated like /v1/version: Prometheus scrapers don't
        # hold sessions, and the surface carries only operational gauges
        route("GET", r"/v1/metrics", self.metrics, auth=False)
        return R

    # ---- handlers: auth --------------------------------------------------

    def get_version(self, ctx):
        return VERSION

    def login(self, ctx):
        body = ctx.json()
        if not isinstance(body, dict):
            raise HttpError(400, "body must be a JSON object")
        email = body.get("email") or ctx.q("email")
        password = body.get("password") or ctx.q("password")
        if (not body.get("email") and ctx.q("email")) or \
                (not body.get("password") and ctx.q("password")):
            # credentials in a query string land in proxy/access logs;
            # the GET route survives only for reference-UI compatibility
            log.warnf("deprecated query-string credentials on "
                      "/v1/session — use POST with a JSON body")
        doc = self.sink.get_account(email)
        if doc is None:
            raise HttpError(401, "invalid email or password")
        acc = Account.from_json(doc)
        if acc.status == 0 or not acc.check_password(password):
            raise HttpError(401, "invalid email or password")
        sid = self.sessions.create(acc.email, acc.role)
        ctx.set_cookie("sid", sid)
        return {"email": acc.email, "role": acc.role}

    def session_me(self, ctx):
        """Who am I — the UI restores its logged-in state across page
        reloads from this (the auth gate already resolved the session)."""
        return {"email": ctx.session.email, "role": ctx.session.role}

    def logout(self, ctx):
        if ctx.sid:
            self.sessions.destroy(ctx.sid)
        ctx.set_cookie("sid", "")
        return {}

    def set_password(self, ctx):
        body = ctx.json()
        old, new = body.get("password", ""), body.get("newPassword", "")
        if len(new) < 4:
            raise HttpError(400, "new password too short")
        doc = self.sink.get_account(ctx.session.email)
        acc = Account.from_json(doc)
        if not acc.check_password(old):
            raise HttpError(401, "wrong password")
        acc.salt = next_id()
        acc.password = hash_password(new, acc.salt)
        self.sink.upsert_account(acc.email, acc.to_json())
        return {}

    # ---- handlers: admin accounts ---------------------------------------

    @staticmethod
    def _pub(acc: Account) -> dict:
        return {"email": acc.email, "role": acc.role, "status": acc.status,
                "unchangeable": acc.unchangeable}

    def admin_list(self, ctx):
        return [self._pub(Account.from_json(d))
                for d in self.sink.list_accounts()]

    def admin_get(self, ctx):
        doc = self.sink.get_account(ctx.path_args["email"])
        if doc is None:
            raise HttpError(404, "no such account")
        return self._pub(Account.from_json(doc))

    def admin_add(self, ctx):
        body = ctx.json()
        email = (body.get("email") or "").strip().lower()
        password = body.get("password") or ""
        if "@" not in email or len(password) < 4:
            raise HttpError(400, "invalid email or password")
        if self.sink.get_account(email) is not None:
            raise HttpError(409, "account exists")
        salt = next_id()
        acc = Account(email=email, salt=salt,
                      password=hash_password(password, salt),
                      role=int(body.get("role", 2)),
                      status=int(body.get("status", 1)),
                      tenant=str(body.get("tenant", "") or "").strip())
        self.sink.upsert_account(acc.email, acc.to_json())
        return {}

    def admin_update(self, ctx):
        body = ctx.json()
        email = (body.get("email") or "").strip().lower()
        doc = self.sink.get_account(email)
        if doc is None:
            raise HttpError(404, "no such account")
        acc = Account.from_json(doc)
        if acc.unchangeable and ctx.session.email != acc.email:
            raise HttpError(403, "account is unchangeable")
        if "role" in body:
            acc.role = int(body["role"])
        if "status" in body:
            acc.status = int(body["status"])
        if "tenant" in body:
            acc.tenant = str(body["tenant"] or "").strip()
        if body.get("password"):
            acc.salt = next_id()
            acc.password = hash_password(body["password"], acc.salt)
        self.sink.upsert_account(acc.email, acc.to_json())
        self.sessions.destroy_email(email)   # force re-login on edit
        return {}

    # ---- handlers: jobs --------------------------------------------------

    def job_list(self, ctx):
        group = ctx.q("group")
        prefix = self.ks.cmd + (group + "/" if group else "")
        out = []
        latest, _ = self.sink.query_logs(latest=True, page_size=500)
        status = {}
        for l in latest:
            cur = status.setdefault(l.job_id, {"success": 0, "failed": 0})
            cur["success" if l.success else "failed"] += 1
        for kv in self._degraded_prefix(prefix):
            try:
                job = Job.from_json(kv.value)
            except (json.JSONDecodeError, TypeError):
                continue
            d = json.loads(job.to_json())
            d["latest_status"] = status.get(job.id)
            out.append(d)
        return out

    def job_groups(self, ctx):
        groups = set()
        for kv in self.store.get_prefix(self.ks.cmd):
            rest = kv.key[len(self.ks.cmd):]
            if "/" in rest:
                groups.add(rest.split("/", 1)[0])
        return sorted(groups)

    def _tenant_quota(self, tenant: str) -> Optional[TenantQuota]:
        if not tenant:
            return None
        kv = self.store.get(self.ks.tenant_quota_key(tenant))
        if kv is None:
            return None
        try:
            q = TenantQuota.from_json(kv.value)
            q.tenant = tenant
            q.validate()
            return q
        except (json.JSONDecodeError, TypeError, ValueError,
                ValidationError):
            return None

    def _account_tenant(self, ctx) -> str:
        """The session account's pinned tenant ("" = unpinned).  Admins
        are never pinned; with auth off every request is an implicit
        admin (reference Web.Auth.Enabled semantics)."""
        sess = ctx.session
        if not self.auth_enabled or sess is None \
                or sess.role == ROLE_ADMIN:
            return ""
        doc = self.sink.get_account(sess.email)
        if doc is None:
            return ""
        return Account.from_json(doc).tenant or ""

    def _guard_pinned(self, ctx, tenant: str):
        """Refuse a MUTATION of a job owned by another tenant (or the
        default tenant) from a tenant-pinned account — pinning must
        cover pause/delete/run-now/overwrite, not just the tenant
        field on create."""
        acc = self._account_tenant(ctx)
        if acc and (tenant or "") != acc:
            raise HttpError(
                403, f"account is pinned to tenant {acc!r}; cannot "
                     f"modify jobs of tenant "
                     f"{(tenant or 'default')!r}")

    @staticmethod
    def _doc_tenant(value: str) -> str:
        try:
            return json.loads(value).get("tenant") or ""
        except (json.JSONDecodeError, TypeError, AttributeError):
            return ""

    def job_update(self, ctx):
        body = ctx.json()
        old_group = (body.pop("oldGroup", "") or "").strip()
        job = Job.from_json(json.dumps(body))
        try:
            job.check()
            job.security_valid(self.security)
        except ValidationError as e:
            raise HttpError(400, str(e))
        # tenancy: a tenant-pinned account's jobs land in ITS tenant —
        # a mismatching explicit tenant is refused, not silently moved
        acc_tenant = self._account_tenant(ctx)
        if acc_tenant:
            if job.tenant and job.tenant != acc_tenant:
                raise HttpError(
                    403, f"account is pinned to tenant {acc_tenant!r}; "
                         f"cannot write jobs for {job.tenant!r}")
            job.tenant = acc_tenant
        # the document this PUT replaces (same id; possibly the old
        # group on a move): its (tenant, group) decides whether the
        # max_jobs gate sees a NEW job and which index marker to retire
        src_group = old_group if (old_group and old_group != job.group) \
            else job.group
        prev_kv = self.store.get(self.ks.job_key(src_group, job.id))
        prev = None
        if prev_kv is not None:
            prev = (self._doc_tenant(prev_kv.value), src_group)
            # overwriting another tenant's (or an untenanted) existing
            # job from a pinned account is a cross-tenant move — refuse
            self._guard_pinned(ctx, prev[0])
        dest = None
        if src_group != job.group:
            # a group move can ALSO overwrite a pre-existing job at
            # the DESTINATION id: guard it and retire its marker too,
            # or the clobbered tenant's index counts the ghost forever
            dest_kv = self.store.get(self.ks.job_key(job.group, job.id))
            if dest_kv is not None:
                dest = (self._doc_tenant(dest_kv.value), job.group)
                self._guard_pinned(ctx, dest[0])
        reserved = None
        if job.tenant:
            quota = self._tenant_quota(job.tenant)
            # a PUT that replaces a same-tenant document — at the
            # source OR the move destination — is not a new job; the
            # destination case also keeps the reservation key from
            # ALIASING the live marker (a rollback would delete it)
            replaces = (prev is not None and prev[0] == job.tenant) or \
                (dest is not None and dest[0] == job.tenant)
            if quota is not None and quota.max_jobs and not replaces:
                # reserve the index marker FIRST, then recount: two
                # racing creates both see each other's marker and the
                # recount refuses past the quota (worst case both
                # roll back one slot under — refusal is the safe
                # direction; a plain count-then-put would admit both)
                reserved = self.ks.tenant_job_key(job.tenant,
                                                  job.group, job.id)
                self.store.put(reserved, "1")
                n = self.store.count_prefix(
                    self.ks.tenant_jobs(job.tenant))
                if n > quota.max_jobs:
                    self.store.delete(reserved)
                    raise HttpError(
                        429, f"tenant {job.tenant!r} is at its "
                             f"max_jobs quota "
                             f"({n - 1}/{quota.max_jobs}); delete "
                             "jobs or raise the quota")
        try:
            if job.deps is not None:
                # DAG validation is group-scoped: every upstream must
                # exist in the group and the new edges must not close
                # a cycle — refused HERE, loudly, before the document
                # lands (the scheduler would otherwise hold the job
                # forever)
                self._validate_job_dag(job)
            if old_group and old_group != job.group:
                # a group move deletes the old-group document: same
                # dependents guard as job_delete, or the move silently
                # breaks downstream chains the delete path refuses to
                dep_map, _ids = self._group_dep_map(old_group)
                dependents = sorted(j for j, ups in dep_map.items()
                                    if job.id in ups and j != job.id)
                if dependents:
                    raise HttpError(
                        409, f"job {job.id!r} is an upstream of "
                             f"{', '.join(dependents)} in group "
                             f"{old_group!r} — moving it would break "
                             "their chains; update or delete the "
                             "dependents first")
                self.store.delete(self.ks.job_key(old_group, job.id))
            self.store.put(self.ks.job_key(job.group, job.id),
                           job.to_json())
        except BaseException:
            # a refusal after the reservation must not leak the
            # marker (it would count a job that never landed)
            if reserved is not None:
                self.store.delete(reserved)
            raise
        # per-tenant job index: retire the replaced document's marker
        # when its (tenant, group) moved, then assert the new one (the
        # markers make the max_jobs gate one count_prefix, not a scan)
        for old in (prev, dest):
            if old is not None and old[0] and \
                    (old[0] != job.tenant or old[1] != job.group):
                self.store.delete(
                    self.ks.tenant_job_key(old[0], old[1], job.id))
        if job.tenant:
            self.store.put(
                self.ks.tenant_job_key(job.tenant, job.group, job.id),
                "1")
        return {"id": job.id, "group": job.group}

    def _group_dep_map(self, group: str):
        """{job_id: [upstream ids]} + the id set for one group (the
        validate_dag inputs), read straight from the store."""
        prefix = self.ks.cmd + group + "/"
        dep_map, ids = {}, set()
        for kv in self.store.get_prefix(prefix):
            jid = kv.key[len(prefix):]
            ids.add(jid)
            try:
                doc = json.loads(kv.value)
            except (json.JSONDecodeError, TypeError):
                continue
            d = doc.get("deps")
            if isinstance(d, dict) and d.get("on"):
                dep_map[jid] = [str(u) for u in d["on"]]
        return dep_map, ids

    def _validate_job_dag(self, job: Job):
        dep_map, ids = self._group_dep_map(job.group)
        dep_map[job.id] = list(job.deps.on)
        ids.add(job.id)
        try:
            validate_dag(dep_map, ids, job.id)
        except ValidationError as e:
            raise HttpError(400, str(e))

    def _load_job(self, ctx) -> Job:
        group, job_id = ctx.path_args["group"], ctx.path_args["id"]
        kv = self.store.get(self.ks.job_key(group, job_id))
        if kv is None:
            raise HttpError(404, "no such job")
        job = Job.from_json(kv.value)
        job.group, job.id = group, job_id
        job._mod_rev = kv.mod_rev
        return job

    def job_get(self, ctx):
        return json.loads(self._load_job(ctx).to_json())

    def job_delete(self, ctx):
        group, job_id = ctx.path_args["group"], ctx.path_args["id"]
        # deleting an upstream leaves its dependents' dep columns BROKEN
        # (they hold forever): refuse unless the operator forces it
        dep_map, _ids = self._group_dep_map(group)
        dependents = sorted(j for j, ups in dep_map.items()
                            if job_id in ups and j != job_id)
        if dependents and ctx.q("force") != "true":
            raise HttpError(
                409, f"job {job_id!r} is an upstream of "
                     f"{', '.join(dependents)} — their chains would "
                     "hold forever; delete them first or pass "
                     "?force=true")
        kv = self.store.get(self.ks.job_key(group, job_id))
        if kv is None:
            raise HttpError(404, "no such job")
        tenant = self._doc_tenant(kv.value)
        self._guard_pinned(ctx, tenant)
        if not self.store.delete(self.ks.job_key(group, job_id)):
            raise HttpError(404, "no such job")
        if tenant:
            self.store.delete(
                self.ks.tenant_job_key(tenant, group, job_id))
        return {}

    def job_change_status(self, ctx):
        """Pause/resume via CAS (reference web/job.go:54-79)."""
        job = self._load_job(ctx)
        self._guard_pinned(ctx, job.tenant)
        body = ctx.json()
        job.pause = bool(body.get("pause"))
        if not self.store.put_if_mod_rev(
                self.ks.job_key(job.group, job.id), job.to_json(),
                job._mod_rev):
            raise HttpError(409, "job was modified concurrently, retry")
        return json.loads(job.to_json())

    def job_nodes(self, ctx):
        """include ∪ groups − exclude (reference web/job.go:222-257)."""
        job = self._load_job(ctx)
        nodes = set()
        for rule in job.rules:
            nodes.update(rule.nids)
            for gid in rule.gids:
                kv = self.store.get(self.ks.group_key(gid))
                if kv is not None:
                    nodes.update(Group.from_json(kv.value).node_ids)
            nodes.difference_update(rule.exclude_nids)
        return sorted(nodes)

    def job_execute(self, ctx):
        """Run-now (reference web/job.go:259-276 -> once.go:14-17)."""
        group, job_id = ctx.path_args["group"], ctx.path_args["id"]
        kv = self.store.get(self.ks.job_key(group, job_id))
        if kv is None:
            raise HttpError(404, "no such job")
        self._guard_pinned(ctx, self._doc_tenant(kv.value))
        node = ctx.q("node")
        self.store.put(self.ks.once_key(group, job_id), node)
        return {}

    # ---- workflow DAG views ---------------------------------------------

    def _dag_group_jobs(self, group: str):
        """Jobs of the group that participate in its DAG (dep-triggered
        jobs + their upstreams), plus the dep-less lookup set."""
        prefix = self.ks.cmd + group + "/"
        jobs = {}
        for kv in self.store.get_prefix(prefix):
            jid = kv.key[len(prefix):]
            try:
                job = Job.from_json(kv.value)
            except (json.JSONDecodeError, TypeError):
                continue
            job.group, job.id = group, jid
            jobs[jid] = job
        dag = {jid: j for jid, j in jobs.items() if j.deps is not None}
        involved = set(dag)
        for j in dag.values():
            involved.update(j.deps.on)
        return jobs, dag, involved

    def dag_show(self, ctx):
        """Dependency graph of one group: involved jobs in topological
        order (upstreams first), edges, and broken references."""
        group = ctx.path_args["group"]
        jobs, dag, involved = self._dag_group_jobs(group)
        missing = {}
        for jid, j in dag.items():
            gone = [u for u in j.deps.on if u not in jobs]
            if gone:
                missing[jid] = gone
        # Kahn topo over the involved subgraph (cycles can't exist for
        # validated saves; hand-written store content falls back to
        # sorted order for any leftover)
        indeg = {jid: 0 for jid in involved}
        downs = {jid: [] for jid in involved}
        for jid, j in dag.items():
            for u in j.deps.on:
                if u in indeg:
                    indeg[jid] += 1
                    downs[u].append(jid)
        ready = sorted(j for j, d in indeg.items() if d == 0)
        order = []
        while ready:
            cur = ready.pop(0)
            order.append(cur)
            for dn in sorted(downs[cur]):
                indeg[dn] -= 1
                if indeg[dn] == 0:
                    ready.append(dn)
        order += sorted(j for j in involved if j not in set(order))
        out_jobs = []
        for jid in order:
            j = jobs.get(jid)
            if j is None:
                continue            # missing upstream: listed in missing
            d = json.loads(j.to_json())
            out_jobs.append({"id": jid, "name": j.name, "pause": j.pause,
                             "kind": j.kind, "deps": d.get("deps")})
        edges = [[u, jid] for jid, j in sorted(dag.items())
                 for u in j.deps.on]
        return {"group": group, "jobs": out_jobs, "edges": edges,
                "missing": missing}

    def dag_runs(self, ctx):
        """Live chain state per DAG job: latest completed round (the
        dep/ completion key) and in-flight executions (proc registry)."""
        group = ctx.path_args["group"]
        jobs, dag, involved = self._dag_group_jobs(group)
        in_flight = {}
        pfx = self.ks.proc
        for kv in self.store.get_prefix(pfx):
            rest = kv.key[len(pfx):].split("/")
            if len(rest) != 4 or rest[1] != group:
                continue
            if rest[2] in involved:
                in_flight[rest[2]] = in_flight.get(rest[2], 0) + 1
        out = []
        for jid in sorted(involved):
            j = jobs.get(jid)
            row = {"id": jid,
                   "deps": (json.loads(j.to_json()).get("deps")
                            if j is not None else None),
                   "missing": j is None,
                   "in_flight": in_flight.get(jid, 0),
                   "last_epoch": None, "last_status": ""}
            kv = self.store.get(self.ks.dep_key(group, jid))
            if kv is not None:
                epoch, _, status = kv.value.partition("|")
                try:
                    row["last_epoch"] = int(float(epoch))
                    row["last_status"] = status or "ok"
                except ValueError:
                    pass
            out.append(row)
        return {"group": group, "jobs": out}

    def job_executing(self, ctx):
        """Scan of the proc registry (reference web/job.go:278-337)."""
        node_f, job_f = ctx.q("node"), ctx.q("jobId")
        out = []
        for kv in self.store.get_prefix(self.ks.proc):
            parts = kv.key[len(self.ks.proc):].split("/")
            if len(parts) != 4:
                continue
            node, group, job_id, pid = parts
            if node_f and node != node_f:
                continue
            if job_f and job_id != job_f:
                continue
            try:
                info = json.loads(kv.value)
            except json.JSONDecodeError:
                info = {}
            out.append({"node": node, "group": group, "jobId": job_id,
                        "pid": pid, "time": info.get("time")})
        return sorted(out, key=lambda d: (d["node"], d["jobId"]))

    # ---- handlers: logs --------------------------------------------------

    def _sink_revision(self):
        """The result store's change token: scalar max record id
        (unsharded) or the per-shard vector (sharded) — one cheap read
        instead of re-running the dashboard query."""
        rev = getattr(self.sink, "revision", None)
        if rev is None:
            return None
        try:
            return rev()
        except Exception:  # noqa: BLE001 — pre-revision server
            return None

    @staticmethod
    def _rev_str(rev) -> str:
        return ",".join(str(v) for v in rev) \
            if isinstance(rev, (list, tuple)) else str(rev)

    def _etag_guard(self, ctx, extra: str = ""):
        """Revision-keyed ETag for the read endpoints: repeated
        dashboard polls answer ``304 Not Modified`` in O(1) — one
        revision read, no query — whenever nothing was written since
        the poll that produced the cached body.  ``extra``
        discriminates endpoints sharing the same revision key (a
        stat_days body and a latest-view body must not satisfy each
        other's cache)."""
        rev = self._sink_revision()
        if rev is None:
            return
        etag = f'W/"{extra}{self._rev_str(rev)}"'
        if ctx.header("If-None-Match") == etag:
            raise NotModified(etag)
        ctx.out_headers["ETag"] = etag

    def _sink_shards(self) -> list:
        """The sink as a shard list — the real shard clients when
        sharded, [sink] otherwise, so the cached scatter path has ONE
        shape."""
        return getattr(self.sink, "shards", None) or [self.sink]

    def _scatter_pool(self):
        """Lazy fan-out pool for cached-scatter recomputes (sharded
        sinks only reach it with > 1 changed shard)."""
        pool = getattr(self, "_scatter_pool_obj", None)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=8,
                                      thread_name_prefix="web-scatter")
            self._scatter_pool_obj = pool
        return pool

    def _cached_scatter(self, ctx, key, extra: str, per_shard, merge,
                        direct):
        """Serve a read endpoint through the revision-vector response
        cache: 304 on a matching If-None-Match (today's ETag contract,
        byte-identical tags), the cached body when the vector is
        unchanged, and on a CHANGED vector recompute ONLY the shards
        whose entry moved — unchanged shards' cached partials feed
        ``merge`` unchanged.  ``per_shard(client, i)`` must return a
        merge-stable partial; ``merge(parts)`` the response body.

        With the cache off (or a sink without revision support) this
        degrades to the plain guard + ``direct()`` — the sink's OWN
        merged read (the sharded client fans concurrently on its
        pool), exactly today's bytes AND today's latency."""
        rev = self._sink_revision()
        if rev is None or self.cache is None:
            self._etag_guard(ctx, extra)
            return direct()
        etag = f'W/"{extra}{self._rev_str(rev)}"'
        if ctx.header("If-None-Match") == etag:
            self.cache.bump("etag_304_total")
            raise NotModified(etag)
        ctx.out_headers["ETag"] = etag
        revs = list(rev) if isinstance(rev, (list, tuple)) else [rev]
        ent = self.cache.lookup(key)
        if ent is not None and ent["revs"] == revs:
            self.cache.bump("body_hits_total")
            return ent["body"]
        shards = self._sink_shards()
        same_shape = (ent is not None and len(ent["revs"]) == len(revs)
                      == len(shards))
        parts: list = [None] * len(shards)
        recompute = []
        reused = 0
        for i, s in enumerate(shards):
            if same_shape and ent["revs"][i] == revs[i]:
                # reuse is sound: equal revision means no write landed
                # on this shard since its partial was computed, so the
                # partial is exactly what a fresh scatter would return
                parts[i] = ent["parts"][i]
                reused += 1
            else:
                recompute.append((i, s))
        if len(recompute) > 1:
            # recompute CONCURRENTLY — the uncached path fanned shard
            # RPCs through the sharded client's pool, and a serial loop
            # here would turn the poll into the SUM of shard latencies
            futs = [(i, self._scatter_pool().submit(per_shard, s, i))
                    for i, s in recompute]
            first_err = None
            for i, f in futs:
                try:
                    parts[i] = f.result()
                except BaseException as e:  # noqa: BLE001 — collected
                    if first_err is None:
                        first_err = e
            if first_err is not None:
                raise first_err
        elif recompute:
            i, s = recompute[0]
            parts[i] = per_shard(s, i)
        body = merge(parts)
        self.cache.store(key, revs, parts, body)
        if ent is None:
            self.cache.bump("misses_total")
        self.cache.bump("shard_reused_total", reused)
        self.cache.bump("shard_recomputed_total", len(shards) - reused)
        if self._push is not None and self._push.running:
            # remember how to rebuild this entry: the push refresher
            # recomputes the changed shard's partial when events land,
            # so the NEXT poll body-hits instead of scattering.  The
            # closures capture only request-static filter state (never
            # ctx), so replaying them off-request is sound.
            with self._push_ref_mu:
                self._push_refreshers[key] = (per_shard, merge)
                self._push_refreshers.move_to_end(key)
                while len(self._push_refreshers) > 64:
                    self._push_refreshers.popitem(last=False)
        return body

    def _push_refresh(self) -> bool:
        """Recompute registered cache entries' CHANGED shard partials
        from the push-maintained vector (debounced by the manager).
        Labels are read BEFORE the recompute (the cache's documented
        soundness direction: a label older than the data can only cause
        an extra recompute, never a stale hit).  Returns True when any
        entry was refreshed."""
        if self.cache is None or self._push is None:
            return False
        with self._push_ref_mu:
            items = list(self._push_refreshers.items())
        if not items:
            return False
        shards = self._sink_shards()
        vec = self._push.vector()
        if len(vec) != len(shards):
            return False
        did = False
        for key, (per_shard, merge) in items:
            ent = self.cache.lookup(key)
            if ent is None:          # evicted: stop refreshing it
                with self._push_ref_mu:
                    self._push_refreshers.pop(key, None)
                continue
            revs = list(vec)
            if ent["revs"] == revs or len(ent["revs"]) != len(revs):
                continue
            parts = list(ent["parts"])
            try:
                for i, s in enumerate(shards):
                    if ent["revs"][i] != revs[i]:
                        parts[i] = per_shard(s, i)
                body = merge(parts)
            except Exception:  # noqa: BLE001 — next poll recomputes
                continue
            self.cache.store(key, revs, parts, body)
            did = True
        return did

    def _tenant_scope(self, ctx):
        """Effective tenant filter for the log/stat views: the explicit
        ``tenant=`` query, FORCED server-side to the account's pinned
        tenant for tenant-pinned sessions (a pinned dashboard cannot
        read other tenants' history by omitting or spoofing the
        parameter).  Returns ``(tenant, job_ids)``; ``job_ids`` is None
        when unscoped, else the tenant's job ids from the
        ``tenant/<t>/job/`` index markers set_job maintains (possibly
        empty — the caller short-circuits to an empty view)."""
        tenant = ctx.q("tenant")
        acc = self._account_tenant(ctx)
        if acc:
            if tenant and tenant != acc:
                raise HttpError(
                    403, f"account is pinned to tenant {acc!r}; cannot "
                         f"read tenant {tenant!r}")
            tenant = acc
        if not tenant:
            return "", None
        # short-TTL memo of the tenant -> job-ids resolution: the
        # latest view is THE dashboard poll, and an uncached index
        # scan per poll would put an O(tenant jobs) prefix RPC in
        # front of the response cache it exists to protect.  2 s of
        # staleness matches the poll cadence; a removed/added job's
        # records follow within one memo window.
        import time as _time
        memo = getattr(self, "_tenant_ids_memo", None)
        if memo is None:
            memo = self._tenant_ids_memo = {}
        now = _time.monotonic()
        ent = memo.get(tenant)
        if ent is not None and ent[0] > now:
            return tenant, ent[1]
        pfx = self.ks.tenant_jobs(tenant)
        ids = set()
        for kv in self.store.get_prefix(pfx):
            rest = kv.key[len(pfx):]
            if "/" in rest:
                ids.add(rest.split("/", 1)[1])
        out = sorted(ids)
        if len(memo) > 4096:    # unbounded-tenant-name backstop
            memo.clear()
        memo[tenant] = (now + 2.0, out)
        return tenant, out

    @staticmethod
    def _scoped_ids(ctx, tids):
        """Intersect the request's explicit ids filter with a tenant
        scope; either side absent passes the other through."""
        job_ids = ctx.q("ids").split(",") if ctx.q("ids") else None
        if tids is None:
            return job_ids
        if job_ids is None:
            return list(tids)
        allowed = set(tids)
        return [j for j in job_ids if j in allowed]

    def log_list(self, ctx):
        tenant, tids = self._tenant_scope(ctx)
        latest = ctx.q("latest") in ("true", "1")
        if latest:
            # the latest view is THE dashboard poll: revision-keyed 304
            # (and the response cache's partial reuse) makes an idle
            # dashboard O(1) per poll and a busy one O(changed shards)
            return self._log_latest(ctx, tenant, tids)
        job_ids = self._scoped_ids(ctx, tids)
        if tids is not None and not job_ids:
            return {"total": 0, "list": []}
        nshards = getattr(self.sink, "nshards", 1)
        after_raw = ctx.q("afterId")
        after_id = None
        if after_raw:
            if after_raw == "tail":
                # cursor bootstrap: revision AND the current tail from
                # ONE sink-side snapshot.  Reading them in two steps
                # (the old path: revision only, tail implied) lets a
                # record land in between — included in the cursor yet
                # absent from the tail page, so the first follow poll
                # (id > cursor) skips it forever.
                tsnap = getattr(self.sink, "tail_snapshot", None)
                rev = recs = None
                if tsnap is not None:
                    try:
                        rev, recs = tsnap(ctx.q_int("pageSize", 0) or 0)
                    except Exception:  # noqa: BLE001 — pre-snapshot server
                        rev = recs = None
                if rev is None:
                    rev = self._sink_revision()
                    recs = []
                if rev is None:
                    raise HttpError(400, "sink has no revision support")
                if tids is not None:
                    # tenant scope is a security boundary: the tail
                    # bootstrap page must not leak foreign records
                    allowed = set(tids)
                    recs = [r for r in recs if r.job_id in allowed]
                return {"total": -1,
                        "list": [self._log_dict(r) for r in recs],
                        "cursor": self._rev_str(rev)}
            try:
                if "," in after_raw:
                    after_id = [int(v) for v in after_raw.split(",")]
                else:
                    after_id = int(after_raw)
            except ValueError:
                raise HttpError(
                    400, f"bad integer for 'afterId': {after_raw!r}")
        try:
            recs, total = self.sink.query_logs(
                node=ctx.q("node") or None,
                job_ids=job_ids,
                name_like=ctx.q("names") or None,
                begin=ctx.q_float("begin"),
                end=ctx.q_float("end"),
                failed_only=ctx.q("failedOnly") in ("true", "1"),
                latest=latest,
                page=ctx.q_int("page", 1),
                page_size=ctx.q_int("pageSize", 50),
                # cursor mode for pollers: id > afterId (scalar, or the
                # per-shard vector a sharded sink's poller carries)
                after_id=after_id)
        except (ValueError, TypeError) as e:
            # a scalar cursor against a sharded sink, a wrong-length
            # vector, or a vector against an UNSHARDED sink (a stale
            # poller after a topology change — int(list) is the
            # TypeError) is a client error, not a 500
            raise HttpError(400, str(e))
        out = {"total": total, "list": [self._log_dict(r) for r in recs]}
        if after_id is not None:
            # the poller's next cursor: per delivered record (encoded
            # ids carry the shard), shards that delivered nothing keep
            # their entry
            vec = after_id if isinstance(after_id, list) else \
                ([0] * nshards if nshards > 1 else None)
            if vec is not None:
                from ..logsink.sharded import advance_cursor
                out["cursor"] = self._rev_str(
                    advance_cursor(vec, recs, nshards))
            else:
                nxt = max([after_id] + [r.id for r in recs
                                        if r.id is not None])
                out["cursor"] = str(nxt)
        return out

    def _log_latest(self, ctx, tenant: str = "", tids=None):
        """The latest view through the response cache: each shard's
        partial is its filtered top rows (exactly the sharded client's
        scatter fetch), the merge is the documented (begin_ts DESC,
        job_id, node) order — byte-identical to the direct
        ``sink.query_logs(latest=True, ...)`` path, pinned by test.
        A tenant scope narrows the job-ids filter server-side (and
        keys the cache, so scoped and unscoped polls never share a
        body)."""
        from ..logsink.sharded import (fetch_top, log_shard_index,
                                       merge_latest_parts)
        page = max(1, min(ctx.q_int("page", 1), 1 << 40))
        page_size = max(1, min(ctx.q_int("pageSize", 50), 500))
        job_ids = self._scoped_ids(ctx, tids)
        if tids is not None and not job_ids:
            return {"total": 0, "list": []}
        kw = dict(node=ctx.q("node") or None,
                  job_ids=job_ids,
                  name_like=ctx.q("names") or None,
                  begin=ctx.q_float("begin"),
                  end=ctx.q_float("end"),
                  failed_only=ctx.q("failedOnly") in ("true", "1"),
                  latest=True)
        need = page * page_size
        # the tenant scope keys the cache by its RESOLVED id set, not
        # the name: membership changes (job moved out of the tenant)
        # must change the key — the shard revisions only move on sink
        # writes, and a name-only key would keep serving the removed
        # job's cached records across the boundary
        key = ("latest", ctx.q("node"), ctx.q("ids"), ctx.q("names"),
               ctx.q("begin"), ctx.q("end"), ctx.q("failedOnly"),
               page, page_size, tenant,
               tuple(job_ids) if tids is not None else None)
        # a job-filtered poll touches only the filter's shards — the
        # sharded client's routing win, kept through the cache: pruned
        # shards contribute a constant empty partial without an RPC
        nshards = getattr(self.sink, "nshards", 1)
        sids = ({log_shard_index(j, nshards) for j in job_ids}
                if job_ids and nshards > 1 else None)

        def per_shard(s, i):
            if sids is not None and i not in sids:
                return [], 0
            return fetch_top(s, kw, need)

        def merge(parts):
            rows, total = merge_latest_parts(parts, page, page_size)
            return {"total": total,
                    "list": [self._log_dict(r) for r in rows]}

        def direct():
            rows, total = self.sink.query_logs(page=page,
                                               page_size=page_size, **kw)
            return {"total": total,
                    "list": [self._log_dict(r) for r in rows]}
        return self._cached_scatter(ctx, key, "logs:", per_shard, merge,
                                    direct)

    @staticmethod
    def _log_dict(r) -> dict:
        return {"id": r.id, "jobId": r.job_id, "jobGroup": r.job_group,
                "name": r.name, "node": r.node, "user": r.user,
                "command": r.command, "output": r.output,
                "success": r.success, "beginTime": r.begin_ts,
                "endTime": r.end_ts}

    def log_stream(self, ctx):
        """``GET /v1/stream`` — live SSE feed of new-record summaries,
        filtered SERVER-side (tenant pinning is forced exactly like the
        list endpoints: a pinned account cannot widen its stream by
        omitting or spoofing ``tenant=``).  ``Last-Event-ID`` (or
        ``cursor=``) resumes from a prior cursor vector through the
        cursor query — exactly-once across the reconnect.  503
        when push is off/unavailable: clients fall back to polling."""
        pm = self._push
        if pm is None or not pm.running:
            raise HttpError(
                503, "live push is disabled on this server "
                     "(CRONSUN_WEB_PUSH=off or no subscribe support)")
        _tenant, tids = self._tenant_scope(ctx)
        job_ids = self._scoped_ids(ctx, tids)
        filters = {
            # the tenant scope is a security boundary; the ids filter a
            # convenience — both resolve to job-id sets evaluated per
            # event.  frozenset(()) (empty tenant) matches nothing.
            "tenant_ids": frozenset(tids) if tids is not None else None,
            "job_ids": frozenset(job_ids) if job_ids is not None
            else None,
            "node": ctx.q("node") or None,
            "failed_only": ctx.q("failedOnly") in ("true", "1"),
        }
        cursor_raw = ctx.header("Last-Event-ID") or ctx.q("cursor")
        client = pm.register(filters)
        replay: list = []
        if cursor_raw:
            try:
                vec = [int(v) for v in cursor_raw.split(",")]
            except ValueError:
                pm.unregister(client)
                raise HttpError(400, f"bad cursor {cursor_raw!r}")
            if len(vec) != pm.nshards:
                pm.unregister(client)
                raise HttpError(
                    400, f"cursor has {len(vec)} entries; this sink "
                         f"has {pm.nshards} shard(s)")
            try:
                replay = pm.replay(client, vec)
            except (ValueError, TypeError) as e:
                pm.unregister(client)
                raise HttpError(400, str(e))
            client.vec = list(vec) if pm.nshards > 1 else [vec[0]]
        return SseStream(pm, client, replay)

    def log_detail(self, ctx):
        rec = self.sink.get_log(int(ctx.path_args["id"]))
        if rec is None:
            raise HttpError(404, "no such log")
        # the tenant boundary covers the detail endpoint too: ids are
        # sequential, so without this a pinned account could enumerate
        # every tenant's command/output history around the list
        # filters.  404, not 403 — existence is part of the secret.
        _tenant, tids = self._tenant_scope(ctx)
        if tids is not None and rec.job_id not in set(tids):
            raise HttpError(404, "no such log")
        return self._log_dict(rec)

    # ---- handlers: stats (revision-keyed, 304 on unchanged) -------------

    def stat_overall(self, ctx):
        from ..logsink.sharded import ShardedJobLogStore
        tenant, tids = self._tenant_scope(ctx)
        if tids is not None:
            return self._tenant_stat_overall(tids)
        return self._cached_scatter(
            ctx, ("stat_overall",), "so:",
            lambda s, _i: s.stat_overall(),
            ShardedJobLogStore._sum_stats,
            self.sink.stat_overall)

    def _tenant_stat_overall(self, tids) -> dict:
        """Tenant-scoped overall stats, computed from the filtered
        record counts (the sink's aggregate tables are fleet-wide).
        Memoized a few seconds like _tenant_stat_days — the counts
        bypass the revision-keyed response cache and a pinned
        dashboard polls this every refresh."""
        if not tids:
            return {"total": 0, "successed": 0, "failed": 0}
        import time as _time
        memo = getattr(self, "_tenant_stat_memo", None)
        if memo is None:
            memo = self._tenant_stat_memo = {}
        mkey = ("overall", tuple(tids))
        now = _time.monotonic()
        ent = memo.get(mkey)
        if ent is not None and ent[0] > now:
            return ent[1]
        _r, total = self.sink.query_logs(job_ids=tids, page=1,
                                         page_size=1)
        _r, failed = self.sink.query_logs(job_ids=tids, failed_only=True,
                                          page=1, page_size=1)
        total = max(0, total)
        failed = max(0, failed)
        out = {"total": total, "successed": max(0, total - failed),
               "failed": failed}
        if len(memo) > 1024:
            memo.clear()
        memo[mkey] = (now + 5.0, out)
        return out

    def stat_days(self, ctx):
        from ..logsink.sharded import merge_stat_days
        tenant, tids = self._tenant_scope(ctx)
        n = ctx.q_int("days", 7)
        if tids is not None:
            if (n or 0) > 62:
                # the scoped path counts per day (no aggregate table):
                # refuse loudly rather than silently truncating a
                # quarterly dashboard to 62 days
                raise HttpError(
                    400, "tenant-scoped stat/days supports at most 62 "
                         "days")
            return self._tenant_stat_days(tids, max(0, n or 0))
        days = max(0, min(n or 0, 3660))
        return self._cached_scatter(
            ctx, ("stat_days", days), f"sd{n}:",
            lambda s, _i: s.stat_days(days),
            lambda parts: merge_stat_days(parts, days),
            lambda: self.sink.stat_days(days))

    def _tenant_stat_days(self, tids, n_days: int) -> list:
        """Tenant-scoped per-day stats over UTC day windows (clamped to
        62 days: up to two filtered counts per day).  Days with no
        records are omitted, matching the fleet-wide view's shape.
        Memoized for a few seconds per (tenant ids, days): the per-day
        counts bypass the revision-keyed response cache, and a pinned
        dashboard must not pay ~2·days count scans per poll."""
        import datetime as _dt
        import time as _time
        out = []
        if not tids:
            return out
        memo = getattr(self, "_tenant_stat_memo", None)
        if memo is None:
            memo = self._tenant_stat_memo = {}
        mkey = (tuple(tids), n_days)
        now = _time.monotonic()
        ent = memo.get(mkey)
        if ent is not None and ent[0] > now:
            return ent[1]
        today = _dt.datetime.now(_dt.timezone.utc).replace(
            hour=0, minute=0, second=0, microsecond=0)
        for i in range(n_days):
            day0 = today - _dt.timedelta(days=i)
            b, e = day0.timestamp(), day0.timestamp() + 86399.999
            _r, total = self.sink.query_logs(job_ids=tids, begin=b,
                                             end=e, page=1, page_size=1)
            if total <= 0:
                continue
            _r, failed = self.sink.query_logs(job_ids=tids, begin=b,
                                              end=e, failed_only=True,
                                              page=1, page_size=1)
            failed = max(0, failed)
            out.append({"day": day0.strftime("%Y-%m-%d"),
                        "total": total,
                        "successed": max(0, total - failed),
                        "failed": failed})
        if len(memo) > 1024:
            memo.clear()
        memo[mkey] = (now + 5.0, out)
        return out

    # ---- handlers: nodes + groups ---------------------------------------

    def _degraded_prefix(self, prefix: str):
        """Dashboard prefix scan: against a sharded store with its
        breaker armed, a browned-out shard's keys are served ABSENT
        (counted loudly as shard_degraded) instead of stalling or
        erroring the whole page.  Only for pure read views — never for
        paths that interpret a missing key as a deletion."""
        fn = getattr(self.store, "get_prefix_degraded", None)
        return fn(prefix) if fn is not None else \
            self.store.get_prefix(prefix)

    def _degraded_count(self, prefix: str) -> int:
        fn = getattr(self.store, "count_prefix_degraded", None)
        return fn(prefix) if fn is not None else \
            self.store.count_prefix(prefix)

    def node_list(self, ctx):
        """Result-store mirror ⋈ live keys (reference web/node.go:141-165).
        STRICT read: a missing liveness key renders as "disconnected" —
        a state, exactly what the degraded helper's contract forbids
        serving partially (a browned-out shard would paint its healthy
        nodes down)."""
        live = {kv.key[len(self.ks.node):]
                for kv in self.store.get_prefix(self.ks.node)}
        out = []
        for doc in self.sink.get_nodes():
            doc["connected"] = doc.get("id") in live
            out.append(doc)
        return out

    def group_list(self, ctx):
        return [json.loads(kv.value)
                for kv in self._degraded_prefix(self.ks.group)]

    def group_get(self, ctx):
        kv = self.store.get(self.ks.group_key(ctx.path_args["id"]))
        if kv is None:
            raise HttpError(404, "no such group")
        return json.loads(kv.value)

    def group_update(self, ctx):
        body = ctx.json()
        g = Group(id=body.get("id", ""), name=body.get("name", ""),
                  node_ids=list(body.get("nids") or []))
        try:
            g.check()
        except ValidationError as e:
            raise HttpError(400, str(e))
        self.store.put(self.ks.group_key(g.id), g.to_json())
        return {"id": g.id}

    def group_delete(self, ctx):
        """Delete + scrub the gid from every job's rules via CAS
        (reference web/node.go:78-139)."""
        gid = ctx.path_args["id"]
        if not self.store.delete(self.ks.group_key(gid)):
            raise HttpError(404, "no such group")
        for kv in self.store.get_prefix(self.ks.cmd):
            try:
                job = Job.from_json(kv.value)
            except (json.JSONDecodeError, TypeError):
                continue
            dirty = False
            for rule in job.rules:
                if gid in rule.gids:
                    rule.gids.remove(gid)
                    dirty = True
            if dirty:
                self.store.put_if_mod_rev(kv.key, job.to_json(), kv.mod_rev)
        return {}

    # ---- handlers: tenants ----------------------------------------------

    def _tenant_live_stats(self, tenant: str) -> dict:
        """Aggregate the schedulers' leased per-tenant snapshots for
        one tenant (counters sum across instances; gauges take the
        max — a standby's zeros must not mask the leader's numbers)."""
        agg: dict = {}
        for kv in self._degraded_prefix(self.ks.metrics + "tenant/"):
            try:
                snap = json.loads(kv.value)
            except json.JSONDecodeError:
                continue
            ent = snap.get(tenant)
            if not isinstance(ent, dict):
                continue
            for k, v in ent.items():
                if not isinstance(v, (int, float)):
                    continue
                if k.endswith(("_fires", "_total")):
                    agg[k] = agg.get(k, 0) + v
                else:
                    agg[k] = max(agg.get(k, 0), v)
        return agg

    def tenant_list(self, ctx):
        # ONE prefix listing serves quotas, names AND the per-tenant
        # job counts (the /job/ index markers are right there — a
        # count_prefix per tenant would be N+1 fan-out RPCs)
        quotas: dict = {}
        counts: dict = {}
        pfx = self.ks.tenant
        for kv in self._degraded_prefix(pfx):
            rest = kv.key[len(pfx):]
            name, _, tail = rest.partition("/")
            if not name:
                continue
            if tail == "quota":
                try:
                    q = TenantQuota.from_json(kv.value)
                    q.tenant = name
                    quotas[name] = q
                except (json.JSONDecodeError, TypeError, ValueError):
                    continue
            elif tail.startswith("job/"):
                counts[name] = counts.get(name, 0) + 1
        out = []
        for name in sorted(set(quotas) | set(counts)):
            q = quotas.get(name)
            out.append({"tenant": name, "jobs": counts.get(name, 0),
                        "quota": q.to_dict() if q else None})
        return out

    def tenant_get(self, ctx):
        name = ctx.path_args["id"]
        q = self._tenant_quota(name)    # one get, not a prefix scan
        jobs = self._degraded_count(self.ks.tenant_jobs(name))
        if q is None and not jobs:
            raise HttpError(404, "no such tenant")
        return {"tenant": name, "jobs": jobs,
                "quota": q.to_dict() if q else None,
                "live": self._tenant_live_stats(name)}

    def tenant_set(self, ctx):
        body = ctx.json()
        q = TenantQuota(
            tenant=str(body.get("tenant", "")),
            max_jobs=int(body.get("max_jobs", 0) or 0),
            rate=float(body.get("rate", 0) or 0),
            burst=float(body.get("burst", 0) or 0),
            max_running=int(body.get("max_running", 0) or 0),
            weight=float(body.get("weight", 1.0) or 1.0))
        try:
            q.validate()
        except ValidationError as e:
            raise HttpError(400, str(e))
        self.store.put(self.ks.tenant_quota_key(q.tenant), q.to_json())
        return q.to_dict()

    def tenant_delete(self, ctx):
        name = ctx.path_args["id"]
        if not self.store.delete(self.ks.tenant_quota_key(name)):
            raise HttpError(404, "no such tenant quota")
        return {}

    # ---- handlers: info --------------------------------------------------

    def overview(self, ctx):
        live = self._degraded_count(self.ks.node)
        # planner health straight from the leased scheduler snapshots
        # (same source as /v1/metrics), keyed by instance
        scheds = {}
        for kv in self._degraded_prefix(self.ks.metrics + "sched/"):
            try:
                scheds[kv.key.rsplit("/", 1)[1]] = json.loads(kv.value)
            except json.JSONDecodeError:
                pass
        return {
            "totalJobs": self._degraded_count(self.ks.cmd),
            "jobExecuted": self.sink.stat_overall(),
            "jobExecutedDaily": self.sink.stat_days(7),
            "nodeCount": len(self.sink.get_nodes()),
            "nodeAlived": live,
            "schedulers": scheds,
        }

    def configurations(self, ctx):
        sec = self.security
        return {
            "security": {
                "open": bool(sec and sec.open),
                "users": list(sec.users) if sec else [],
                "exts": list(sec.exts) if sec else [],
            },
            "alarm": bool(self.alarm),
        }

    # ---- handlers: checkpoint plane --------------------------------------

    def checkpoint(self, ctx):
        """Operator checkpoint trigger (``cronsun-ctl checkpoint``):
        snapshot the coordination store's WAL (when the backing server
        persists) and ask every scheduler to save its state checkpoint
        — they watch the ckpt prefix and ack under ``ckpt/done/<id>``;
        save health is also visible as ``cronsun_sched_checkpoint_*``
        gauges at ``/v1/metrics``."""
        import time as _time
        out = {}
        snap = getattr(self.store, "snapshot", None)
        if snap is None:
            out["store_snapshot"] = "unsupported by this store client"
        else:
            try:
                out["store_snapshot_rev"] = snap()
            except Exception as e:  # noqa: BLE001 — store without a WAL
                out["store_snapshot"] = f"unavailable: {e}"
        self.store.put(self.ks.ckpt_req, str(int(_time.time() * 1000)))
        out["scheduler"] = ("checkpoint requested; acks land under "
                            f"{self.ks.ckpt}done/, save health at "
                            "/v1/metrics (cronsun_sched_checkpoint_*)")
        return out

    # ---- handlers: trace plane ------------------------------------------

    def trace_show(self, ctx):
        """Assembled waterfall for one (job, scheduled second): per
        executing node, the six stage durations (sched / publish /
        claim / queue / run / record) from the stored span stamps."""
        job = ctx.path_args["job"]
        sec = int(ctx.path_args["sec"])
        tg = getattr(self.sink, "trace_get", None)
        if tg is None:
            raise HttpError(501, "result store lacks the trace plane")
        try:
            spans = tg(job, sec)
        except Exception as e:  # noqa: BLE001 — degraded sink
            raise HttpError(503, f"trace read failed: {e}")
        wf = _trace.assemble(job, sec, spans)
        if wf is None:
            raise HttpError(
                404, "no trace recorded for this (job, second): not "
                     "sampled (trace_sample_shift), not yet flushed, "
                     "or aged out of the ring and spill")
        return wf

    def trace_top(self, ctx):
        """Slowest recent traces, optionally by one stage
        (?stage=claim&n=10) — summaries straight off the logd rings."""
        n = ctx.q_int("n", 10)
        stage = ctx.q("stage")
        if stage and stage not in _trace.STAGES:
            raise HttpError(400, f"unknown stage {stage!r} (one of "
                                 f"{', '.join(_trace.STAGES)})")
        tt = getattr(self.sink, "trace_top", None)
        if tt is None:
            raise HttpError(501, "result store lacks the trace plane")
        ents = tt(max(64, n * 4))

        def key(ent):
            if not stage:
                return ent.get("total_ms", 0.0)
            return max((nd.get("stages", {}).get(stage, 0.0)
                        for nd in ent.get("nodes", [])), default=0.0)
        ents.sort(key=key, reverse=True)
        return {"stage": stage or "total", "traces": ents[:max(1, n)]}

    # ---- handlers: SLO engine -------------------------------------------

    def slo_list(self, ctx):
        out = []
        for kv in self._degraded_prefix(self.ks.slo):
            try:
                out.append(dataclasses.asdict(SloSpec.from_json(kv.value)))
            except (json.JSONDecodeError, TypeError):
                continue
        return out

    def slo_set(self, ctx):
        body = ctx.json()
        try:
            # no `or`-defaulting: target=0 must reach validate() and
            # 400 ("target must be in (0, 1)"), not silently become
            # the default; a non-numeric value is a 400 too, like
            # every sibling route, not an unexplained 500
            spec = SloSpec(
                name=str(body.get("name", "")),
                scope=str(body.get("scope", "")),
                target=float(body.get("target", 0.999)),
                latency_ms=float(body.get("latency_ms", 0)))
            spec.validate()
        except (ValidationError, TypeError, ValueError) as e:
            raise HttpError(400, str(e))
        self.store.put(self.ks.slo_key(spec.name), spec.to_json())
        return dataclasses.asdict(spec)

    def slo_delete(self, ctx):
        name = ctx.path_args["name"]
        if not self.store.delete(self.ks.slo_key(name)):
            raise HttpError(404, "no such slo")
        return {}

    def slo_status(self, ctx):
        """Current burn rates + alert states (the `cronsun-ctl slo
        show` surface)."""
        if self.slo_engine is None:
            return {"engine": "off", "slos": {}, "stats": {}}
        snap = self.slo_engine.snapshot()
        snap["engine"] = "on"
        return snap

    # ---- handlers: health ------------------------------------------------

    def healthz(self, ctx):
        return {"ok": True}

    def readyz(self, ctx):
        """Readiness: the coordination store and result store answer,
        and no shard breaker is OPEN.  503 with the failing check named
        otherwise (the shared health contract — see
        cronsun_tpu_torch/health.py for the TCP servers' twin)."""
        checks = {}

        def check(name, fn):
            try:
                ok, detail = fn()
            except Exception as e:  # noqa: BLE001
                ok, detail = False, str(e)
            checks[name] = {"ok": bool(ok), "detail": detail}

        def store_ok():
            self.store.get(self.ks.hwm)   # raises when unreachable
            return True, ""

        def sink_ok():
            return True, f"revision {self.sink.revision()}"

        def sched_partitions_ok():
            """With a pinned partition map, readiness demands a live
            leader PER PARTITION (leased sched snapshots expire with
            dead processes, so a leaderless partition shows up within
            one lease ttl).  Unpartitioned fleets skip the check."""
            p, malformed, _snaps, leaderless = self._sched_fleet_view()
            if malformed:
                return False, "malformed partmap"
            if p is None:
                return True, "unpartitioned"
            if p <= 1:
                return True, "p=1"
            if leaderless:
                return False, f"{p} partitions, leaderless: {leaderless}"
            return True, f"all {p} partitions led"

        check("store", store_ok)
        check("logsink", sink_ok)
        if self._push is not None:
            # a dead shard subscription is a NAMED failing check, not
            # silent staleness: the stream (and push-refreshed cache)
            # for that shard is stale until the loop resubscribes, and
            # the operator's rollback is CRONSUN_WEB_PUSH=off
            for si, (ok_, detail) in enumerate(self._push.health()):
                checks[f"push_shard_{si}"] = {"ok": bool(ok_),
                                              "detail": detail}
        # INFORMATIONAL: a leaderless scheduler partition is surfaced
        # here (and on /v1/sched, metrics, and the schedulers' own
        # health ports) but must NOT 503 the web tier — everything
        # this server serves still works, and failing readiness would
        # drain every healthy web replica from the load balancer over
        # a routine partition failover
        check("sched_partitions", sched_partitions_ok)
        checks["sched_partitions"]["informational"] = True
        for label, backend in (("store", self.store),
                               ("logsink", self.sink)):
            bs = getattr(backend, "breaker_snapshot", None)
            if bs is None:
                continue
            snaps = bs() or []
            opened = [s["shard"] for s in snaps
                      if s.get("state") == "open"]
            checks[f"{label}_breakers"] = {
                "ok": not opened,
                "detail": f"open shards: {opened}" if opened else ""}
        ok = all(c["ok"] for c in checks.values()
                 if not c.get("informational"))
        if not ok:
            ctx.out_status = 503
        return {"ok": ok, "checks": checks}

    # ---- handlers: scheduler plane status -------------------------------

    def _sched_fleet_view(self):
        """Shared source for readyz's partition check and /v1/sched:
        the pinned topology (None = no pin, ``malformed`` flagged
        separately) plus every live scheduler's leased snapshot and
        the leaderless-partition set — ONE implementation so the two
        surfaces cannot drift."""
        partitions = None
        malformed = False
        kv = self.store.get(self.ks.partmap)
        if kv is not None:
            try:
                doc = json.loads(kv.value)
                if not isinstance(doc, dict):
                    raise ValueError("partmap is not an object")
                partitions = int(doc.get("p", 1))
            except (json.JSONDecodeError, TypeError, ValueError):
                malformed = True
        snaps = []
        for mkv in self.store.get_prefix(self.ks.metrics + "sched/"):
            instance = mkv.key[len(self.ks.metrics) + len("sched/"):]
            try:
                snap = json.loads(mkv.value)
            except json.JSONDecodeError:
                continue
            snaps.append((instance, snap))
        leaderless = []
        if partitions and partitions > 1:
            led = {int(s["partition"]) for _i, s in snaps
                   if s.get("is_leader")
                   and isinstance(s.get("partition"), (int, float))}
            leaderless = [i for i in range(partitions) if i not in led]
        return partitions, malformed, snaps, leaderless

    def sched_status(self, ctx):
        """Per-partition scheduler fleet view (the ``cronsun-ctl sched
        status`` surface): the pinned partition topology plus every
        live scheduler's leased snapshot — leaders AND warm standbys —
        so a stalled or leaderless partition is one call away."""
        partitions, _malformed, snaps, leaderless = \
            self._sched_fleet_view()
        insts = []
        for instance, snap in snaps:
            insts.append({
                "instance": instance,
                "partition": snap.get("partition"),
                "is_leader": int(snap.get("is_leader", 0) or 0),
                "steps_total": snap.get("steps_total", 0),
                "dispatches_total": snap.get("dispatches_total", 0),
                "sched_step_p99_ms": snap.get("sched_step_p99_ms", 0),
                "jobs": snap.get("jobs", 0),
                "watch_losses_total": snap.get("watch_losses_total", 0),
                "lease_resigns_total":
                    snap.get("lease_resigns_total", 0),
                "skipped_seconds_total":
                    snap.get("skipped_seconds_total", 0),
                "checkpoint_restored":
                    snap.get("checkpoint_restored", 0),
                "acct_partitions_seen":
                    snap.get("acct_partitions_seen"),
            })
        insts.sort(key=lambda d: (d["partition"] if d["partition"]
                                  is not None else -1, d["instance"]))
        return {"partitions": partitions, "instances": insts,
                "leaderless": leaderless}

    def repl_status(self, ctx):
        """Per-shard store replication view (the ``cronsun-ctl repl
        status`` surface): every replica's role, applied revision,
        lag, and fencing epoch — who leads each shard, and how far
        behind each follower reads, one call away."""
        from ..repl import fleet_repl_status
        return {"shards": fleet_repl_status(self.store)}

    # ---- handlers: metrics ----------------------------------------------

    def metrics(self, ctx):
        """Prometheus text surface for the whole fleet: every component
        publishes a leased JSON snapshot under /metrics/<component>/<id>
        (cronsun_tpu_torch.metrics.MetricsPublisher), so "is the planner
        keeping up" is one scrape away from any web server — dead
        publishers' snapshots expire with their lease."""
        lines = ["# HELP cronsun_web_up this web server is serving",
                 "# TYPE cronsun_web_up gauge",
                 "cronsun_web_up 1"]
        if self.cache is not None:
            # response-cache effectiveness (this web server's own):
            # 304s, whole-body hits, and the per-shard partial
            # reuse/recompute split behind CHANGED polls
            for field, val in sorted(self.cache.snapshot().items()):
                name = f"cronsun_web_cache_{field}"
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {val}")
        if self._push is not None:
            # live-push observability: viewer count, fan-out volume,
            # slow-consumer drops, resumes (this web server's own) —
            # plus the epoll writer pool's loop lag, ring evictions,
            # and write-queue depth when that writer is active
            sse_stats = dict(self._push.stats())
            per_loop = None
            if self._sse_pool is not None:
                pool_stats = self._sse_pool.stats()
                per_loop = pool_stats.pop("loop_connections", None)
                sse_stats.update(pool_stats)
            for field, val in sorted(sse_stats.items()):
                name = f"cronsun_web_sse_{field}"
                kind = "counter" if field.endswith("_total") else "gauge"
                lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name} {val}")
            if per_loop is not None:
                # a hot loop must be visible per loop, not averaged
                # away across the pool
                name = "cronsun_web_sse_loop_connections"
                lines.append(f"# TYPE {name} gauge")
                for i, nconns in enumerate(per_loop):
                    lines.append(f'{name}{{loop="{i}"}} {nconns}')
        seen_types: set = set()
        sched_snaps: list = []    # partitioned-plane aggregation input
        for kv in self._degraded_prefix(self.ks.metrics):
            rest = kv.key[len(self.ks.metrics):].split("/", 1)
            if len(rest) != 2:
                continue
            component, instance = rest
            try:
                snap = json.loads(kv.value)
            except json.JSONDecodeError:
                continue
            inst = _esc_label(instance)
            # partitioned scheduler plane: every sched series carries
            # its partition as a LABEL (a stalled partition must be
            # visible per series, not averaged away); unpartitioned
            # snapshots carry no partition field and render unchanged
            extra = ""
            if component == "sched":
                sched_snaps.append(snap)
                part = snap.get("partition")
                if isinstance(part, (int, float)):
                    extra = f',partition="{int(part)}"'
            # mesh plane: every cronsun_mesh_tick_* series carries the
            # demand wire format its ticks ran with (dense vs
            # compacted must be tellable apart per series — a format
            # flip mid-scrape-window is an auto-select event, not
            # noise); the string field itself renders only as this
            # label
            if component == "mesh":
                fmt = snap.get("demand_format")
                if isinstance(fmt, str) and fmt:
                    extra = f',demand_format="{_esc_label(fmt)}"'
            if component == "tenant":
                # per-tenant admission snapshots are NESTED
                # ({tenant: {field: n}}): render each numeric leaf as
                # cronsun_tenant_<field>{instance=,tenant=}
                for tname, fields in sorted(snap.items()):
                    if not isinstance(fields, dict):
                        continue
                    tn = _esc_label(tname)
                    for field, val in sorted(fields.items()):
                        if not isinstance(val, (int, float)):
                            continue
                        name = f"cronsun_tenant_{field}"
                        if name not in seen_types:
                            kind = ("counter"
                                    if field.endswith(("_total",
                                                       "_fires"))
                                    else "gauge")
                            lines.append(f"# TYPE {name} {kind}")
                            seen_types.add(name)
                        lines.append(
                            f'{name}{{instance="{inst}",'
                            f'tenant="{tn}"}} {val}')
                continue
            for field, val in sorted(snap.items()):
                if not isinstance(val, (int, float)):
                    continue
                if field == "partition" and extra:
                    continue    # rides every series as the label
                name = f"cronsun_{component}_{field}"
                if name not in seen_types:
                    kind = "counter" if field.endswith("_total") else "gauge"
                    lines.append(f"# TYPE {name} {kind}")
                    seen_types.add(name)
                lines.append(f'{name}{{instance="{inst}"{extra}}} {val}')
        # aggregate scheduler-plane view: sums over the LIVE leaders'
        # snapshots (one per partition when partitioned; the single
        # leader otherwise), so "what is the fleet dispatching" is one
        # series however many partitions tick behind it.  Gauges on
        # purpose — the leader set changes across failovers, so the
        # sums are not monotone.
        leaders = [s for s in sched_snaps if s.get("is_leader")]
        if leaders:
            led_parts = {int(s["partition"]) for s in leaders
                         if isinstance(s.get("partition"), (int, float))}
            lines.append("# TYPE cronsun_sched_fleet_leaders gauge")
            lines.append(f"cronsun_sched_fleet_leaders {len(leaders)}")
            lines.append("# TYPE cronsun_sched_fleet_partitions gauge")
            lines.append(f"cronsun_sched_fleet_partitions "
                         f"{max(len(led_parts), 1)}")
            for field in ("dispatches_total", "steps_total", "jobs",
                          "procs_running", "dispatch_queue_depth",
                          "overflow_drops_total",
                          "skipped_seconds_total",
                          "lease_resigns_total"):
                vals = [s.get(field) for s in leaders]
                vals = [v for v in vals if isinstance(v, (int, float))]
                if not vals:
                    continue
                name = f"cronsun_sched_fleet_{field}"
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {sum(vals)}")
        # server-side op timings from BOTH backing servers (their own
        # op_stats op).  Store: names the component that owns a
        # dispatch-plane ceiling — claim paths, bulk writes, watch
        # fan-out — and, next to the scheduler's pipeline_stall_*
        # gauges, shows publisher backpressure without running a bench.
        # Logsink: the RESULT plane's attribution — create_job_logs
        # count vs the log_records tally gives the fleet's
        # records-per-flush (the coalescing win), and total_ms names
        # logd itself as (or rules it out as) the exec-lag ceiling.
        for backend, prefix in ((self.store, "store"),
                                (self.sink, "logsink")):
            # sharded store clients expose per-SHARD stats; with more
            # than one shard each series carries a ``shard`` label so
            # cronsun_store_op_* series from different shards don't
            # collide.  Single-shard output is byte-identical to the
            # unlabeled form below.
            labeled = None    # [(shard label or None, stats dict), ...]
            oss = getattr(backend, "op_stats_shards", None)
            if oss is not None:
                try:
                    parts = oss()
                    if len(parts) > 1:
                        labeled = list(enumerate(parts))
                    elif parts and parts[0]:
                        # one shard: unlabeled form, without re-fetching
                        # the same stats through op_stats() below
                        labeled = [(None, parts[0])]
                except Exception:  # noqa: BLE001 — degraded shard set
                    labeled = None
            if labeled is None:
                op_stats = getattr(backend, "op_stats", None)
                if op_stats is None:
                    continue
                try:
                    stats = op_stats()
                except Exception:  # noqa: BLE001 — older server
                    stats = {}
                if not stats:
                    continue
                labeled = [(None, stats)]
            for field, kind in (("count", "counter"),
                                ("total_ms", "counter"),
                                ("max_ms", "gauge")):
                name = f"cronsun_{prefix}_op_{field}"
                lines.append(f"# TYPE {name} {kind}")
                for si, stats in labeled:
                    shard = "" if si is None else f',shard="{si}"'
                    for op, ent in sorted(stats.items()):
                        if field not in ent:
                            continue
                        o = _esc_label(op)
                        lines.append(
                            f'{name}{{op="{o}"{shard}}} {ent[field]}')
            # per-shard brownout breakers (store/sharded.py):
            # state gauge (0 closed / 1 probing / 2 open), opens,
            # fail-fast refusals, and degraded partial reads — the
            # operator's first stop when one shard browns out.  Absent
            # entirely when the breaker is disabled.
            bs = getattr(backend, "breaker_snapshot", None)
            if bs is None:
                continue
            try:
                snaps = bs()
            except Exception:  # noqa: BLE001 — degraded shard set
                snaps = []
            if not snaps:
                continue
            state_num = {"closed": 0, "probing": 1, "open": 2}
            for field, kind in (
                    ("state", "gauge"),
                    ("opens_total", "counter"),
                    ("refused_total", "counter"),
                    ("degraded_reads_total", "counter")):
                name = f"cronsun_{prefix}_shard_breaker_{field}"
                lines.append(f"# TYPE {name} {kind}")
                for snap in snaps:
                    val = snap.get(field, 0)
                    if field == "state":
                        val = state_num.get(val, -1)
                    lines.append(
                        f'{name}{{shard="{snap["shard"]}"}} {val}')

        # store replication plane (repl/): per-replica role, lag, and
        # fencing epoch for every shard served by a replica group.
        # Absent entirely when nothing is replicated, so unreplicated
        # deployments' scrape output is unchanged.
        try:
            from ..repl import fleet_repl_status
            repl_shards = [
                e for e in fleet_repl_status(self.store)
                if any(isinstance(st, dict) and st.get("enabled")
                       for st in e.get("replicas", {}).values())]
        except Exception:  # noqa: BLE001 — degraded shard set
            repl_shards = []
        if repl_shards:
            role_num = {"leader": 1, "follower": 0}
            series = {"role": [], "lag_records": [],
                      "lag_seconds": [], "fencing_epoch": []}
            for e in repl_shards:
                for addr, st in sorted(e["replicas"].items()):
                    lbl = (f'shard="{e["shard"]}",'
                           f'replica="{_esc_label(addr)}"')
                    if not isinstance(st, dict) or not st.get("enabled"):
                        # unreachable replica: role -1 is the alert
                        series["role"].append((lbl, -1))
                        continue
                    series["role"].append(
                        (lbl, role_num.get(st.get("role"), -1)))
                    lag = st.get("lag_records")
                    series["lag_records"].append(
                        (lbl, lag if isinstance(lag, (int, float))
                         else -1))
                    series["lag_seconds"].append(
                        (lbl, st.get("lag_seconds") or 0.0))
                    series["fencing_epoch"].append(
                        (lbl, st.get("epoch", 0)))
            for field in ("role", "lag_records", "lag_seconds",
                          "fencing_epoch"):
                name = f"cronsun_store_repl_{field}"
                lines.append(f"# TYPE {name} gauge")
                for lbl, val in series[field]:
                    lines.append(f"{name}{{{lbl}}} {val}")

        def render_hist(name, label_kv, snap):
            """One Prometheus histogram (cumulative _bucket + _sum +
            _count) from a {buckets, sum, count} snapshot."""
            buckets = snap.get("buckets") or []
            lbl = "".join(f'{k}="{_esc_label(v)}",'
                          for k, v in label_kv)
            cum = 0
            for i, n in enumerate(buckets):
                cum += int(n)
                le = (f"{_trace.BUCKETS_MS[i]:g}"
                      if i < len(_trace.BUCKETS_MS) else "+Inf")
                lines.append(f'{name}_bucket{{{lbl}le="{le}"}} {cum}')
            lbl = lbl[:-1]
            lbl = f"{{{lbl}}}" if lbl else ""
            lines.append(f'{name}_sum{lbl} {snap.get("sum", 0)}')
            lines.append(f'{name}_count{lbl} {snap.get("count", 0)}')

        # trace plane: per-stage latency histograms from the logd
        # span rings (fixed buckets — summed across shards by the
        # sharded client, addable across web replicas by Prometheus)
        ts = getattr(self.sink, "trace_stats", None)
        if ts is not None:
            try:
                tstats = ts()
            except Exception:  # noqa: BLE001 — older/degraded sink
                tstats = None
            if tstats and tstats.get("stages"):
                name = "cronsun_trace_stage_ms"
                lines.append(f"# TYPE {name} histogram")
                for stage in _trace.STAGES:
                    ent = tstats["stages"].get(stage)
                    if ent:
                        render_hist(name, [("stage", stage)], ent)
                lines.append("# TYPE cronsun_trace_spans_total counter")
                lines.append(f"cronsun_trace_spans_total "
                             f"{tstats.get('spans_total', 0)}")
        # SLO engine: per-scope exec-latency histograms (every
        # execution, unbiased — the burn-rate source) + live burn
        # rates and alert states
        if self.slo_engine is not None:
            sums = self.slo_engine.scrape_sums()
            if sums:
                name = "cronsun_exec_latency_ms"
                lines.append(f"# TYPE {name} histogram")
                for scope in sorted(sums):
                    count, fail, sum_ms, buckets = sums[scope]
                    render_hist(name, [("scope", scope or "global")],
                                {"buckets": buckets, "count": count,
                                 "sum": round(sum_ms, 3)})
                lines.append("# TYPE cronsun_exec_fail_total counter")
                for scope in sorted(sums):
                    lines.append(
                        f'cronsun_exec_fail_total{{scope='
                        f'"{_esc_label(scope or "global")}"}} '
                        f'{sums[scope][1]}')
            snap = self.slo_engine.snapshot()
            if snap["slos"]:
                lines.append("# TYPE cronsun_slo_burn_rate gauge")
                for sname in sorted(snap["slos"]):
                    st = snap["slos"][sname]
                    for w, v in sorted(st["burn"].items()):
                        lines.append(
                            f'cronsun_slo_burn_rate{{slo='
                            f'"{_esc_label(sname)}",window="{w}"}} {v}')
                lines.append("# TYPE cronsun_slo_alert gauge")
                sev_num = {"": 0, "slow": 1, "fast": 2}
                for sname in sorted(snap["slos"]):
                    st = snap["slos"][sname]
                    lines.append(
                        f'cronsun_slo_alert{{slo="{_esc_label(sname)}"}}'
                        f' {sev_num.get(st["alert"], 0)}')
            for field, val in sorted(snap["stats"].items()):
                name = f"cronsun_{field}"
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {val}")
        return PlainText("\n".join(lines) + "\n")

    # ---- plumbing --------------------------------------------------------

    def handle(self, method: str, path: str, query: dict, body: bytes,
               cookies: dict, headers: Optional[dict] = None):
        """Transport-independent dispatch (tests call this directly)."""
        ctx = _Ctx(query, body, cookies, headers)
        for m, rx, fn, need_auth, need_admin in self.routes:
            if m != method:
                continue
            match = rx.match(path)
            if not match:
                continue
            ctx.path_args = match.groupdict()
            if need_auth or need_admin:
                if not self.auth_enabled:
                    ctx.session = self._implicit_admin
                else:
                    ctx.session = self.sessions.get(ctx.sid)
                    if ctx.session is None:
                        raise HttpError(401, "not logged in")
                    if need_admin and ctx.session.role != ROLE_ADMIN:
                        raise HttpError(403, "admin only")
            return fn(ctx), ctx
        raise HttpError(404, "no such route")

    def start(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _run(self, method):
                parsed = urlparse(self.path)
                if parsed.path == "/" or parsed.path.startswith("/ui"):
                    page = INDEX_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(page)))
                    self.end_headers()
                    self.wfile.write(page)
                    return
                query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                cookies = {}
                if self.headers.get("Cookie"):
                    c = SimpleCookie(self.headers["Cookie"])
                    cookies = {k: v.value for k, v in c.items()}
                ctype = "application/json"
                try:
                    result, ctx = server.handle(method, parsed.path, query,
                                                body, cookies,
                                                dict(self.headers))
                    if isinstance(result, SseStream):
                        # streaming escape hatch: no Content-Length
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/event-stream")
                        self.send_header("Cache-Control", "no-cache")
                        self.send_header("X-Accel-Buffering", "no")
                        for k, v in ctx.out_headers.items():
                            self.send_header(k, v)
                        self.end_headers()
                        pool = server._sse_pool
                        if pool is not None:
                            # epoll writer: mark the socket adopted
                            # (teardown skips it), hand it to the
                            # pool, and this request thread exits —
                            # 50k viewers, zero parked threads
                            self.close_connection = True
                            server._sse_adopt(self.connection)
                            pool.adopt(self.connection, result.client,
                                       result.replay)
                            return
                        # threaded writer (rollback): this request
                        # thread writes until the viewer drops, falls
                        # behind, or the server drains
                        result.serve(self.wfile)
                        return
                    if isinstance(result, PlainText):
                        payload = result.encode()
                        ctype = "text/plain; version=0.0.4"
                    else:
                        payload = json.dumps(result).encode()
                    self.send_response(ctx.out_status or 200)
                    for k, v in ctx.out_cookies.items():
                        self.send_header(
                            "Set-Cookie", f"sid={v}; Path=/; HttpOnly")
                    for k, v in ctx.out_headers.items():
                        self.send_header(k, v)
                except NotModified as e:
                    # per RFC 9110 a 304 carries no body — just the
                    # validator the cached response stays keyed on
                    self.send_response(304)
                    self.send_header("ETag", e.etag)
                    self.end_headers()
                    return
                except HttpError as e:
                    payload = json.dumps({"error": e.msg}).encode()
                    self.send_response(e.status)
                except Exception as e:  # noqa: BLE001
                    payload = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                self._run("GET")

            def do_PUT(self):
                self._run("PUT")

            def do_POST(self):
                self._run("POST")

            def do_DELETE(self):
                self._run("DELETE")

        class _Httpd(ThreadingHTTPServer):
            # socketserver's default listen backlog is 5: a viewer
            # fleet reconnecting en masse (replica restart, LB
            # failover) overflows it instantly and every dropped SYN
            # costs that client a full 1 s retransmit — measured
            # ~150 ms/conn average on a fast ramp, vs ~1 ms with a
            # real backlog.  The kernel clamps to net.core.somaxconn.
            request_queue_size = 1024

            def shutdown_request(httpd_self, request):
                # a socket adopted by the epoll pool outlives its
                # request thread: skipping the base teardown here is
                # what keeps socketserver's shutdown(SHUT_WR)+close
                # from half-closing a live stream under the pool
                if server._sse_forget(request):
                    return
                ThreadingHTTPServer.shutdown_request(httpd_self, request)

        self._httpd = _Httpd((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                             name="api-server")
        t.start()
        return self

    def stop(self):
        # drain SSE viewers FIRST (final bye + long retry:, bounded
        # wait) so their writer threads close cleanly instead of dying
        # mid-write when the listener goes away
        if self._push is not None:
            self._push.stop(drain_timeout=2.0)
        if self._sse_pool is not None:
            self._sse_pool.stop()
            self._sse_pool = None
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        pool = getattr(self, "_scatter_pool_obj", None)
        if pool is not None:
            pool.shutdown(wait=False)
            self._scatter_pool_obj = None


class _Ctx:
    def __init__(self, query: dict, body: bytes, cookies: dict,
                 headers: Optional[dict] = None):
        self.query = query
        self.body = body
        self.cookies = cookies
        self.headers = headers or {}
        self.path_args: dict = {}
        self.session = None
        self.out_cookies: dict = {}
        self.out_headers: dict = {}
        self.out_status = 200     # handlers may override (503 readyz)

    @property
    def sid(self) -> str:
        return self.cookies.get("sid", "")

    def q(self, name: str) -> str:
        return self.query.get(name, "")

    def header(self, name: str) -> str:
        """Request header, case-insensitive."""
        for k, v in self.headers.items():
            if k.lower() == name.lower():
                return v
        return ""

    def q_int(self, name: str, default=None):
        """Query int with a 400 (not a 500) on malformed values."""
        raw = self.q(name)
        if not raw:
            return default
        try:
            return int(raw)
        except ValueError:
            raise HttpError(400, f"bad integer for {name!r}: {raw!r}")

    def q_float(self, name: str, default=None):
        raw = self.q(name)
        if not raw:
            return default
        try:
            return float(raw)
        except ValueError:
            raise HttpError(400, f"bad number for {name!r}: {raw!r}")

    def json(self) -> dict:
        if not self.body:
            return {}
        try:
            return json.loads(self.body)
        except json.JSONDecodeError:
            raise HttpError(400, "bad JSON body")

    def set_cookie(self, name: str, value: str):
        self.out_cookies[name] = value
