"""cronsun-ctl — operator command line over the REST API.

The reference manages the fleet only through the Vue UI; day-2
operations (cron edits from a terminal, scripting a job rollout,
tailing failures) all need a browser.  This CLI drives the same
``/v1/*`` surface (web/server.py, mirroring reference
web/routers.go:17-114) with a persisted session, so everything the UI
can do is scriptable:

    cronsun-ctl --url http://web:7079 login admin@admin.com
    cronsun-ctl jobs
    cronsun-ctl job get default-8a81f3d2
    cronsun-ctl job save job.json
    cronsun-ctl job pause default-8a81f3d2
    cronsun-ctl run default-8a81f3d2 --node worker-3
    cronsun-ctl logs --failed --node worker-3
    cronsun-ctl nodes
    cronsun-ctl metrics

Sessions persist as a cookie jar in ``~/.config/cronsun/session``
(override with --session or CRONSUN_SESSION).  ``--json`` prints raw
API responses for scripting; default output is aligned tables.

Copy of ``cronsun_tpu/bin/ctl.py`` (``python -m cronsun_tpu_torch.bin.ctl``,
``cronsun-ctl-torch``): the same flags, output and exit codes, its
offline commands (``checkpoint compact``, ``fsck``, ``logd reshard``) on
the port's modules.
"""

from __future__ import annotations

import argparse
import getpass
import http.cookiejar
import json
import os
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

from ..core.backoff import SSE_RECONNECT

DEFAULT_URL = os.environ.get("CRONSUN_URL", "http://127.0.0.1:7079")
DEFAULT_SESSION = os.environ.get(
    "CRONSUN_SESSION",
    os.path.join(os.path.expanduser("~"), ".config", "cronsun", "session"))


class ApiError(RuntimeError):
    def __init__(self, status: int, msg: str):
        super().__init__(f"HTTP {status}: {msg}")
        self.status = status


class Api:
    """Thin urllib client with a persisted cookie jar."""

    def __init__(self, url: str, session_file: str):
        self.url = url.rstrip("/")
        self.session_file = session_file
        self.jar = http.cookiejar.LWPCookieJar(session_file)
        if os.path.exists(session_file):
            try:
                self.jar.load(ignore_discard=True)
            except (OSError, http.cookiejar.LoadError):
                pass
        self.opener = urllib.request.build_opener(
            urllib.request.HTTPCookieProcessor(self.jar))

    def save(self):
        d = os.path.dirname(self.session_file)
        if d:
            os.makedirs(d, exist_ok=True)
        # pre-create 0600 so the session secret is never world-readable,
        # even for the instant between jar.save() and a chmod
        fd = os.open(self.session_file,
                     os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        os.close(fd)
        os.chmod(self.session_file, 0o600)   # pre-existing looser file
        self.jar.save(ignore_discard=True)

    def call(self, method: str, path: str, params: dict = None,
             body=None):
        url = self.url + path
        if params:
            qs = urllib.parse.urlencode(
                {k: v for k, v in params.items() if v not in (None, "")})
            if qs:
                url += "?" + qs
        data = None
        headers = {}
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with self.opener.open(req, timeout=30) as resp:
                raw = resp.read().decode()
                ctype = resp.headers.get("Content-Type", "")
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace").strip()
            try:
                detail = json.loads(detail).get("error", detail)
            except (json.JSONDecodeError, AttributeError):
                pass
            raise ApiError(e.code, detail or e.reason)
        except urllib.error.URLError as e:
            raise ApiError(0, f"cannot reach {self.url}: {e.reason}")
        if "json" in ctype:
            return json.loads(raw) if raw else None
        return raw


# ---------------------------------------------------------------------------
# output helpers
# ---------------------------------------------------------------------------

def table(rows, headers):
    """Aligned plain-text table; rows of str-able cells."""
    rows = [[("" if c is None else str(c)) for c in r] for r in rows]
    widths = [len(h) for h in headers]
    for r in rows:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(c))
    fmt = "  ".join("{:<%d}" % w for w in widths)
    print(fmt.format(*headers))
    for r in rows:
        print(fmt.format(*r).rstrip())


def ts(epoch) -> str:
    if not epoch:
        return ""
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(epoch))


def parse_when(s: str) -> float:
    """Epoch seconds, or local 'YYYY-MM-DD[ HH:MM[:SS]]'."""
    try:
        return float(s)
    except ValueError:
        pass
    for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d %H:%M", "%Y-%m-%d"):
        try:
            return time.mktime(time.strptime(s, fmt))
        except ValueError:
            continue
    raise SystemExit(f"error: cannot parse time {s!r} "
                     "(epoch or YYYY-MM-DD[ HH:MM[:SS]])")


def _role(role) -> str:
    return "admin" if role == 1 else "developer"


def _read_json_arg(path: str):
    """JSON body from a file argument, with - meaning stdin."""
    if path == "-":
        return json.load(sys.stdin)
    with open(path) as f:
        return json.load(f)


def positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return v


def poll_interval(s: str) -> float:
    v = float(s)
    if v < 0.1:
        raise argparse.ArgumentTypeError(
            "must be >= 0.1 (don't busy-loop the result store)")
    return v


KINDS = {0: "Common", 1: "Alone", 2: "Interval"}


def _gid(d) -> str:
    return f"{d['group']}-{d['id']}"


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------

def cmd_login(api, args):
    pw = args.password if args.password is not None else \
        getpass.getpass(f"password for {args.email}: ")
    # POST body keeps the password out of proxy/access logs (the server
    # keeps the GET-with-query route for UI compatibility)
    out = api.call("POST", "/v1/session",
                   body={"email": args.email, "password": pw})
    api.save()
    print(f"logged in as {out['email']} ({_role(out.get('role'))})")


def cmd_logout(api, args):
    api.call("DELETE", "/v1/session")
    api.save()
    print("logged out")


def cmd_whoami(api, args):
    out = api.call("GET", "/v1/session/me")
    print(json.dumps(out) if args.json else
          f"{out['email']} ({_role(out.get('role'))})")


def cmd_version(api, args):
    print(api.call("GET", "/v1/version"))


def cmd_overview(api, args):
    out = api.call("GET", "/v1/info/overview")
    if args.json:
        print(json.dumps(out, indent=2))
        return
    for k, v in out.items():
        print(f"{k:>16}  {v}")


def cmd_jobs(api, args):
    jobs = api.call("GET", "/v1/jobs", {"group": args.group})
    if args.json:
        print(json.dumps(jobs, indent=2))
        return
    rows = []
    for j in jobs:
        st = j.get("latest_status") or {}
        rows.append([_gid(j), j.get("name"), KINDS.get(j.get("kind"), "?"),
                     "paused" if j.get("pause") else "",
                     len(j.get("rules") or []),
                     j.get("jitter") or 0,
                     st.get("success", 0), st.get("failed", 0)])
    table(rows, ["ID", "NAME", "KIND", "STATE", "RULES", "JITTER",
                 "OK", "FAIL"])


def cmd_job_get(api, args):
    print(json.dumps(api.call("GET", f"/v1/job/{args.id}"), indent=2))


def cmd_job_save(api, args):
    out = api.call("PUT", "/v1/job", body=_read_json_arg(args.file))
    print(f"saved {out['group']}-{out['id']}")


def cmd_job_rm(api, args):
    api.call("DELETE", f"/v1/job/{args.id}")
    print(f"deleted {args.id}")


def _pause(api, job_id: str, pause: bool):
    api.call("POST", f"/v1/job/{job_id}", body={"pause": pause})
    print(f"{'paused' if pause else 'resumed'} {job_id}")


def cmd_job_pause(api, args):
    _pause(api, args.id, True)


def cmd_job_resume(api, args):
    _pause(api, args.id, False)


def cmd_job_nodes(api, args):
    nodes = api.call("GET", f"/v1/job/{args.id}/nodes")
    print(json.dumps(nodes) if args.json else "\n".join(nodes))


def cmd_run(api, args):
    api.call("PUT", f"/v1/job/{args.id}/execute",
             {"node": args.node or ""})
    print(f"run-now fired for {args.id}"
          + (f" on {args.node}" if args.node else " on all eligible nodes"))


def cmd_executing(api, args):
    out = api.call("GET", "/v1/job/executing",
                   {"node": args.node, "jobId": args.job})
    if args.json:
        print(json.dumps(out, indent=2))
        return
    table([[e["node"], f"{e['group']}-{e['jobId']}", e["pid"], e.get("time")]
           for e in out], ["NODE", "JOB", "PID", "STARTED"])


def _log_line(r) -> str:
    took = max(0.0, (r["endTime"] or 0) - (r["beginTime"] or 0))
    status = "ok  " if r["success"] else "FAIL"
    return (f"{ts(r['beginTime'])}  {status}  {r['name']:<20} "
            f"{r['node']:<12} {took:5.1f}s  #{r['id']}")


def _drain_cursor(api, params, cursor: str, as_json: bool) -> str:
    """Drain everything past ``cursor`` via the cursor query (one
    page loop), printing each record; returns the advanced cursor."""
    while True:
        out = api.call("GET", "/v1/logs",
                       dict(params, afterId=cursor, page=1,
                            pageSize=500))
        for r in out["list"]:
            print(json.dumps(r) if as_json else _log_line(r),
                  flush=True)
        if out["list"]:
            cursor = out.get("cursor", str(out["list"][-1]["id"]))
        if len(out["list"]) < 500:
            return cursor


def _follow_sse(api, params, cursor: str, as_json: bool):
    """One /v1/stream connection: print pushed records as they land.
    Returns ``(cursor, why)`` — ``why`` is "lost" (server dropped this
    stream; the caller re-lists via the cursor) or "closed" (EOF, a
    drain ``bye``, or a read timeout; the caller reconnects).  Raises
    ApiError on HTTP errors (the fallback signal)."""
    qs = {k: v for k, v in params.items() if v not in (None, "")}
    if cursor:
        qs["cursor"] = cursor
    url = api.url + "/v1/stream"
    if qs:
        url += "?" + urllib.parse.urlencode(qs)
    try:
        resp = api.opener.open(urllib.request.Request(url), timeout=60)
    except urllib.error.HTTPError as e:
        detail = e.read().decode(errors="replace").strip()
        try:
            detail = json.loads(detail).get("error", detail)
        except (json.JSONDecodeError, AttributeError):
            pass
        raise ApiError(e.code, detail or e.reason)
    except urllib.error.URLError as e:
        raise ApiError(0, f"cannot reach {api.url}: {e.reason}")
    event, data = "message", []
    try:
        with resp:
            for raw in resp:
                line = raw.decode("utf-8", "replace").rstrip("\r\n")
                if not line:                   # frame boundary
                    if event == "log" and data:
                        r = json.loads("\n".join(data))
                        print(json.dumps(r) if as_json else _log_line(r),
                              flush=True)
                    elif event == "lost":
                        return cursor, "lost"
                    elif event == "bye":
                        return cursor, "closed"
                    event, data = "message", []
                    continue
                if line.startswith(":"):       # heartbeat comment
                    continue
                field, _, value = line.partition(":")
                value = value[1:] if value.startswith(" ") else value
                if field == "event":
                    event = value
                elif field == "data":
                    data.append(value)
                elif field == "id":
                    cursor = value
    except (OSError, TimeoutError):
        pass                                   # reconnect with cursor
    return cursor, "closed"


def _follow_logs(api, params, interval: float, as_json: bool):
    """tail -f over the result store, cursor-exact: the afterId query
    returns rows in per-shard insertion order, so records inserted with
    old begin_ts — long jobs finishing late — are never missed.  The
    cursor is OPAQUE to this loop (a scalar id for one sink, a
    comma-joined per-shard vector for a sharded one): bootstrap asks
    the server for the tail (``afterId=tail`` — the sink revision IS
    the tail cursor, one cheap read instead of draining history).

    Transport: live push (/v1/stream SSE) when the server offers it —
    records print at publish lag, zero polls — resuming through the
    cursor on reconnects and re-listing on ``lost``.  Falls back to
    the cursor-poll protocol when the server predates /v1/stream
    or push is disabled (and for the begin/end/names filters, which
    only the query path evaluates)."""
    try:
        out = api.call("GET", "/v1/logs",
                       dict(params, afterId="tail", page=1, pageSize=1))
        cursor = out.get("cursor")
    except ApiError as e:
        # a pre-cursor server parses afterId with q_int and 400s on
        # "tail" — that's the compat signal, not a failure
        if e.status != 400:
            raise
        cursor = None
    if cursor is None:
        # pre-cursor server: the old probe path — one begin_ts-ordered
        # page finds the newest id, then cursored drains find the true
        # insertion high-water mark
        out = api.call("GET", "/v1/logs", dict(params, page=1, pageSize=1))
        cursor = str(max((r["id"] for r in out["list"]), default=0))
        while True:
            nxt = api.call("GET", "/v1/logs",
                           dict(params, afterId=cursor, page=1,
                                pageSize=500))
            if not nxt["list"]:
                break
            cursor = nxt.get("cursor", str(nxt["list"][-1]["id"]))
    print(f"following (cursor {cursor}; ^C to stop)", file=sys.stderr)
    # the stream evaluates node/ids/tenant/failedOnly server-side;
    # begin/end/names exist only on the query path — poll for those
    sse_ok = not any(params.get(k) for k in ("begin", "end", "names"))
    fails = 0
    while sse_ok:
        t0 = time.monotonic()
        err = None
        try:
            cursor, why = _follow_sse(api, params, cursor, as_json)
        except ApiError as e:
            if e.status in (400, 404, 501, 503):
                # the server doesn't speak /v1/stream (or push is
                # off): that's a capability signal, not an outage —
                # degrade to the poll protocol permanently
                print(f"live stream unavailable ({e}); polling every "
                      f"{interval:g}s", file=sys.stderr)
                break                          # poll fallback below
            # transient: unreachable (status 0), 5xx, mid-connect
            # resets — the cursor survives, so resume the stream on
            # the jittered ladder instead of crashing or falling back
            # to polls against a replica that is merely restarting
            why, err = "error", e
        if err is None and time.monotonic() - t0 >= 2.0:
            fails = 0              # the stream served; outage healed
        if why == "lost":
            # this viewer fell behind (or resumed past the replay
            # window): the cursor re-list is the documented recovery
            print("stream lost; re-listing from cursor",
                  file=sys.stderr)
            cursor = _drain_cursor(api, params, cursor, as_json)
            continue
        fails += 1
        delay = SSE_RECONNECT.delay(fails)
        if err is not None:
            print(f"stream error ({err}); retrying in {delay:.1f}s",
                  file=sys.stderr)
        time.sleep(delay)
    while True:
        time.sleep(interval)
        cursor = _drain_cursor(api, params, cursor, as_json)


def cmd_logs(api, args):
    params = {
        "node": args.node,
        "ids": args.job,
        "names": args.names,
        "tenant": args.tenant,
        "failedOnly": "true" if args.failed else None,
        "latest": "true" if args.latest else None,
        "page": args.page,
        "pageSize": args.size,
    }
    if args.begin:
        params["begin"] = parse_when(args.begin)
    if args.end:
        params["end"] = parse_when(args.end)
    if args.follow:
        if args.latest:
            raise SystemExit("error: --follow cannot combine with "
                             "--latest (the latest view has no cursor)")
        params.pop("page", None)
        params.pop("pageSize", None)
        try:
            _follow_logs(api, params, args.interval, args.json)
        except KeyboardInterrupt:
            pass
        return
    out = api.call("GET", "/v1/logs", params)
    if args.json:
        print(json.dumps(out, indent=2))
        return
    rows = [[r["id"], r["name"], r["node"],
             "ok" if r["success"] else "FAIL",
             ts(r["beginTime"]),
             f"{max(0.0, (r['endTime'] or 0) - (r['beginTime'] or 0)):.1f}s"]
            for r in out["list"]]
    table(rows, ["ID", "NAME", "NODE", "RESULT", "BEGIN", "TOOK"])
    pages = max(1, -(-out["total"] // args.size))
    print(f"({out['total']} records, page {args.page}/{pages})")


def cmd_log(api, args):
    r = api.call("GET", f"/v1/log/{args.id}")
    if args.json:
        print(json.dumps(r, indent=2))
        return
    for k in ("id", "name", "node", "user", "command", "success"):
        print(f"{k:>8}  {r.get(k)}")
    print(f"{'began':>8}  {ts(r['beginTime'])}")
    print(f"{'ended':>8}  {ts(r['endTime'])}")
    print("  output:")
    print(r.get("output") or "(empty)")


def cmd_job_export(api, args):
    """Full job definitions as a JSON array on stdout — the fleet's
    desired state, re-loadable with `job import` (backup, migration,
    code review of cron changes)."""
    jobs = api.call("GET", "/v1/jobs", {"group": args.group})
    for j in jobs:
        j.pop("latest_status", None)     # derived, not desired state
    json.dump(jobs, sys.stdout, indent=2)
    print()


def cmd_job_import(api, args):
    jobs = _read_json_arg(args.file)
    if not isinstance(jobs, list):
        jobs = [jobs]
    n = 0
    for i, j in enumerate(jobs):
        if not isinstance(j, dict):
            raise SystemExit(
                f"error: entry #{i + 1} is not a job object "
                f"({type(j).__name__})\n{n} of {len(jobs)} imported "
                "before the failure")
        try:
            out = api.call("PUT", "/v1/job", body=j)
        except ApiError as e:
            # job saves are idempotent upserts, so re-running the import
            # after fixing the bad entry is safe
            raise SystemExit(
                f"error: entry #{i + 1} ({j.get('name', '?')!r}) refused: "
                f"{e}\n{n} of {len(jobs)} imported before the failure")
        n += 1
        print(f"imported {out['group']}-{out['id']}  {j.get('name', '')}")
    print(f"{n} job(s) imported")


def cmd_nodes(api, args):
    out = api.call("GET", "/v1/nodes")
    if args.json:
        print(json.dumps(out, indent=2))
        return
    table([[n.get("id"), "up" if n.get("connected") else "DOWN",
            "alive" if n.get("alived") else "dead",
            n.get("pid"), ts(n.get("up_ts"))] for n in out],
          ["NODE", "CONN", "MIRROR", "PID", "UP SINCE"])


def cmd_groups(api, args):
    out = api.call("GET", "/v1/node/groups")
    if args.json:
        print(json.dumps(out, indent=2))
        return
    table([[g.get("id"), g.get("name"),
            ",".join(g.get("nids") or [])] for g in out],
          ["ID", "NAME", "NODES"])


def cmd_group_get(api, args):
    print(json.dumps(api.call("GET", f"/v1/node/group/{args.id}"), indent=2))


def cmd_group_save(api, args):
    out = api.call("PUT", "/v1/node/group",
                   body=_read_json_arg(args.file))
    print(f"saved group {out.get('id')}")


def cmd_group_rm(api, args):
    api.call("DELETE", f"/v1/node/group/{args.id}")
    print(f"deleted group {args.id}")


def cmd_accounts(api, args):
    out = api.call("GET", "/v1/admin/accounts")
    if args.json:
        print(json.dumps(out, indent=2))
        return
    table([[a.get("email"), _role(a.get("role")),
            "enabled" if a.get("status") else "disabled"] for a in out],
          ["EMAIL", "ROLE", "STATUS"])


def cmd_account_add(api, args):
    pw = args.password if args.password is not None else \
        getpass.getpass(f"password for new account {args.email}: ")
    role = 1 if args.admin else 2
    api.call("PUT", "/v1/admin/account",
             body={"email": args.email, "password": pw, "role": role,
                   "status": 0 if args.disabled else 1})
    print(f"created {args.email} ({_role(role)})")


def cmd_account_update(api, args):
    body = {"email": args.email}
    if args.role is not None:
        body["role"] = {"admin": 1, "developer": 2}[args.role]
    if args.enable:
        body["status"] = 1
    if args.disable:
        body["status"] = 0
    if args.password is not None:
        if not args.password:
            # the server ignores falsy passwords but still force-logs
            # the account out — refuse the silent no-op
            raise SystemExit("error: --password must not be empty")
        body["password"] = args.password
    if len(body) == 1:
        raise SystemExit("error: nothing to update "
                         "(--role/--enable/--disable/--password)")
    api.call("POST", "/v1/admin/account", body=body)
    print(f"updated {args.email} (any open sessions were logged out)")


def cmd_passwd(api, args):
    old = args.old if args.old is not None else \
        getpass.getpass("current password: ")
    new = args.new if args.new is not None else \
        getpass.getpass("new password: ")
    api.call("POST", "/v1/user/setpwd",
             body={"password": old, "newPassword": new})
    print("password changed")


def cmd_sched_status(api, args):
    """Per-partition scheduler fleet view: who leads each job-space
    slice, its step health, and whether any partition is leaderless —
    a stalled partition must be one command away, not averaged into a
    fleet mean."""
    out = api.call("GET", "/v1/sched")
    if args.json:
        print(json.dumps(out, indent=2))
        return
    p = out.get("partitions")
    print(f"partitions: {p if p else 'unpartitioned'}")
    rows = []
    for d in out.get("instances", []):
        part = d.get("partition")
        rows.append([
            "-" if part is None else part,
            d["instance"],
            "leader" if d.get("is_leader") else "standby",
            d.get("jobs", 0),
            d.get("dispatches_total", 0),
            _fmt_ms(d.get("sched_step_p99_ms")),
            d.get("lease_resigns_total", 0),
            d.get("watch_losses_total", 0),
            d.get("skipped_seconds_total", 0),
        ])
    table(rows, ["PART", "INSTANCE", "ROLE", "JOBS", "DISPATCHES",
                 "STEP_P99", "RESIGNS", "WATCHLOSS", "SKIPPED"])
    missing = out.get("leaderless") or []
    if missing:
        print(f"WARNING: leaderless partition(s): {missing}")


def cmd_repl_status(api, args):
    """Per-shard store replication view (repl/): each replica's role,
    applied revision, lag behind its leader, and fencing epoch —
    follower lag and a deposed or unreachable replica must be one
    command away."""
    out = api.call("GET", "/v1/repl")
    if args.json:
        print(json.dumps(out, indent=2))
        return
    rows = []
    for ent in out.get("shards", []):
        for addr in ent.get("group", []) or \
                sorted(ent.get("replicas", {})):
            st = (ent.get("replicas") or {}).get(addr)
            if not isinstance(st, dict):
                rows.append([ent.get("shard"), addr, "unreachable",
                             "-", "-", "-", "-", "-"])
                continue
            if not st.get("enabled"):
                rows.append([ent.get("shard"), addr, "unreplicated",
                             "-", "-", "-", "-", "-"])
                continue
            lag = st.get("lag_records")
            rows.append([
                ent.get("shard"), addr, st.get("role", "?"),
                st.get("epoch", 0), st.get("applied_rev", 0),
                "-" if lag is None else lag,
                "-" if st.get("role") == "leader"
                else st.get("lag_seconds", 0),
                st.get("ack_mode", "-"),
            ])
    table(rows, ["SHARD", "REPLICA", "ROLE", "EPOCH", "REV",
                 "LAG_RECS", "LAG_S", "ACK"])
    stale = [r for r in rows if r[2] == "unreachable"]
    if stale:
        print(f"WARNING: {len(stale)} unreachable replica(s)")


def cmd_metrics(api, args):
    sys.stdout.write(api.call("GET", "/v1/metrics"))


def cmd_checkpoint(api, args):
    """Trigger the checkpoint plane: store WAL snapshot + scheduler
    state checkpoints (admin)."""
    out = api.call("POST", "/v1/checkpoint")
    if args.json:
        print(json.dumps(out, indent=2))
        return
    if "store_snapshot_rev" in out:
        print(f"store snapshot written at revision "
              f"{out['store_snapshot_rev']} (WAL truncated)")
    else:
        print(f"store snapshot: {out.get('store_snapshot')}")
    print(out.get("scheduler", ""))


def cmd_configurations(api, args):
    print(json.dumps(api.call("GET", "/v1/configurations"), indent=2))


def cmd_checkpoint_compact(api, args):
    """Offline delta-chain compaction: fold every sched.ckpt.d<seq>
    beside the base into ONE element (direct filesystem access, not the
    web API).  Run against a QUIESCED checkpoint dir — compacting under
    a live scheduler makes its next delta a seq gap (which a restore
    then refuses, loudly)."""
    del api
    import os as _os
    from ..checkpoint.sched_ckpt import (CheckpointError, FILE_NAME,
                                         compact_delta_chain)
    path = args.path
    if _os.path.isdir(path):
        path = _os.path.join(path, FILE_NAME)
    try:
        out = compact_delta_chain(path)
    except (CheckpointError, OSError) as e:
        # refusals (torn/gapped/foreign chains, missing base) exit
        # cleanly with the files untouched — protection is not a crash
        raise SystemExit(f"error: {e}")
    if args.json:
        print(json.dumps(out, indent=2))
        return
    if not out["compacted"]:
        print(f"nothing to compact ({out['folded']} chain element(s) "
              f"at {path})")
        return
    print(f"compacted {out['folded']} delta elements -> 1 "
          f"({out['events']} events, chain tip rev {out['rev']})")


# ---------------------------------------------------------------------------
# workflow DAG views
# ---------------------------------------------------------------------------

def cmd_tenants(api, args):
    res = api.call("GET", "/v1/tenants")
    if args.json:
        print(json.dumps(res, indent=2))
        return
    rows = []
    for t in res:
        q = t.get("quota") or {}
        rows.append([t["tenant"], t["jobs"],
                     q.get("max_jobs") or "-", q.get("rate") or "-",
                     q.get("burst") or "-", q.get("max_running") or "-",
                     q.get("weight", 1.0)])
    table(rows, ["TENANT", "JOBS", "MAX_JOBS", "RATE/S", "BURST",
                 "MAX_RUN", "WEIGHT"])


def cmd_tenant_show(api, args):
    res = api.call("GET", f"/v1/tenant/{args.id}")
    if args.json:
        print(json.dumps(res, indent=2))
        return
    q = res.get("quota") or {}
    print(f"tenant:      {res['tenant']}")
    print(f"jobs:        {res['jobs']}"
          + (f" / {q['max_jobs']}" if q.get("max_jobs") else ""))
    if q:
        print(f"fire rate:   {q.get('rate') or 'unlimited'}"
              + (f"/s (burst {q.get('burst')})" if q.get("rate") else ""))
        print(f"max running: {q.get('max_running') or 'unlimited'}")
        print(f"weight:      {q.get('weight', 1.0)}")
    else:
        print("quota:       none (unlimited)")
    live = res.get("live") or {}
    if live:
        print("live (scheduler snapshots):")
        for k in sorted(live):
            print(f"  {k}: {live[k]}")


def cmd_tenant_set(api, args):
    body = {"tenant": args.id}
    for k in ("max_jobs", "rate", "burst", "max_running", "weight"):
        v = getattr(args, k)
        if v is not None:
            body[k] = v
    res = api.call("PUT", "/v1/tenant", body=body)
    if args.json:
        print(json.dumps(res, indent=2))
    else:
        print(f"quota set for tenant {res['tenant']!r}: "
              f"max_jobs={res['max_jobs']} rate={res['rate']}/s "
              f"burst={res['burst']} max_running={res['max_running']} "
              f"weight={res['weight']}")


def cmd_tenant_rm(api, args):
    api.call("DELETE", f"/v1/tenant/{args.id}")
    print(f"quota removed for tenant {args.id!r} (now unlimited)")


def _fmt_ms(v):
    return f"{v:.1f}ms" if isinstance(v, (int, float)) else "-"


def cmd_trace_show(api, args):
    """Render one fire's waterfall: per executing node, the six stage
    durations between the scheduled tick and the flushed record."""
    res = api.call("GET",
                   f"/v1/trace/{urllib.parse.quote(args.job)}/"
                   f"{int(args.second)}")
    if args.json:
        print(json.dumps(res, indent=2))
        return
    print(f"trace {res['trace_id']}  job {res.get('group', '')}/"
          f"{res['job']}  second {res['second']}  "
          f"total {_fmt_ms(res['total_ms'])}")
    from ..trace import STAGES
    rows = []
    for nd in res["nodes"]:
        st = nd.get("stages", {})
        rows.append([nd["node"], "ok" if nd.get("ok") else "FAIL"]
                    + [_fmt_ms(st[s]) if s in st else "-"
                       for s in STAGES]
                    + [_fmt_ms(nd.get("total_ms"))])
    table(rows, ["NODE", "RESULT"] + [s.upper() for s in STAGES]
          + ["TOTAL"])


def cmd_trace_top(api, args):
    """Slowest recent traces (by total or one stage) from the logd
    trace rings."""
    q = f"?n={args.n}"
    if args.stage:
        q += f"&stage={urllib.parse.quote(args.stage)}"
    res = api.call("GET", f"/v1/trace/top{q}")
    if args.json:
        print(json.dumps(res, indent=2))
        return
    rows = []
    for t in res["traces"]:
        worst = max(t.get("nodes", []),
                    key=lambda nd: nd.get("total_ms", 0), default={})
        st = worst.get("stages", {})
        slowest = max(st.items(), key=lambda kv: kv[1])[0] if st else "-"
        rows.append([t.get("grp", ""), t["job"], t["sec"],
                     len(t.get("nodes", [])), _fmt_ms(t["total_ms"]),
                     slowest])
    table(rows, ["GROUP", "JOB", "SECOND", "NODES", "TOTAL",
                 "SLOWEST STAGE"])
    if not rows:
        print("(no traces in the ring — sampling off, or no recent "
              "fires)")


def cmd_slos(api, args):
    res = api.call("GET", "/v1/slos")
    if args.json:
        print(json.dumps(res, indent=2))
        return
    rows = [[s["name"], s.get("scope") or "global", s["target"],
             s.get("latency_ms") or "-"] for s in res]
    table(rows, ["SLO", "SCOPE", "TARGET", "LATENCY_MS"])


def cmd_slo_show(api, args):
    """Current burn rates + alert states from the web tier's engine."""
    res = api.call("GET", "/v1/slo/status")
    if args.json:
        print(json.dumps(res, indent=2))
        return
    if res.get("engine") != "on":
        print("slo engine: off (web server started without one)")
        return
    rows = []
    for name in sorted(res["slos"]):
        st = res["slos"][name]
        b = st.get("burn", {})
        rows.append([name, st.get("scope") or "global",
                     st.get("target"),
                     b.get("5m", 0), b.get("1h", 0),
                     b.get("30m", 0), b.get("6h", 0),
                     st.get("alert") or "-"])
    table(rows, ["SLO", "SCOPE", "TARGET", "BURN 5M", "1H", "30M",
                 "6H", "ALERT"])
    stats = res.get("stats") or {}
    if stats:
        print(f"evals={stats.get('slo_evals_total', 0)} "
              f"alerts={stats.get('slo_alerts_total', 0)} "
              f"notices={stats.get('slo_notices_total', 0)} "
              f"recoveries={stats.get('slo_recoveries_total', 0)}")


def cmd_slo_set(api, args):
    body = {"name": args.name, "scope": args.scope or "",
            "target": args.target}
    if args.latency_ms is not None:
        body["latency_ms"] = args.latency_ms
    res = api.call("PUT", "/v1/slo", body=body)
    print(f"slo {res['name']!r} set: scope="
          f"{res.get('scope') or 'global'} target={res['target']}"
          + (f" latency<={res['latency_ms']}ms"
             if res.get("latency_ms") else ""))


def cmd_slo_rm(api, args):
    api.call("DELETE", f"/v1/slo/{urllib.parse.quote(args.name)}")
    print(f"slo {args.name!r} removed")


def cmd_dag_show(api, args):
    """Render the group's dependency graph: topological order, each
    job's upstreams, misfire policy and in-flight cap, plus broken
    references (missing upstreams)."""
    out = api.call("GET", f"/v1/dag/{urllib.parse.quote(args.group)}")
    if args.json:
        print(json.dumps(out, indent=2))
        return
    if not out["jobs"]:
        print(f"group {args.group!r} has no dep-triggered jobs")
        return
    rows = []
    for j in out["jobs"]:
        d = j.get("deps") or {}
        rows.append([
            j["id"], j.get("name", ""),
            "paused" if j.get("pause") else "",
            " ".join(d.get("on") or []) or "(time-triggered)",
            d.get("misfire", ""),
            d.get("max_in_flight") or "",
        ])
    table(rows, ["JOB", "NAME", "STATE", "UPSTREAMS", "MISFIRE",
                 "MAX-IN-FLIGHT"])
    if out.get("missing"):
        print("\nBROKEN upstream references (dependents hold, never "
              "fire):")
        for dep_id, ups in sorted(out["missing"].items()):
            print(f"  {dep_id} -> missing {', '.join(ups)}")


def cmd_dag_runs(api, args):
    """Latest completed round + in-flight executions per job of the
    group's DAG — the chain's live state (reads the dep/ completion
    keys and the proc registry)."""
    out = api.call("GET",
                   f"/v1/dag/{urllib.parse.quote(args.group)}/runs")
    if args.json:
        print(json.dumps(out, indent=2))
        return
    if not out["jobs"]:
        print(f"group {args.group!r} has no dep-triggered jobs")
        return
    rows = []
    for j in out["jobs"]:
        rows.append([
            j["id"],
            "dep" if j.get("deps") else "time",
            ts(j.get("last_epoch")) or "(never)",
            j.get("last_status", ""),
            j.get("in_flight", 0),
        ])
    table(rows, ["JOB", "TRIGGER", "LAST ROUND", "RESULT", "IN-FLIGHT"])


def cmd_logd_reshard(api, args):
    """Result-plane resharding escape hatch: record ids encode the
    shard count (raw * N + shard), so changing N is a dump/rehash/load
    into a FRESH shard set — this command performs it over the wire
    (logsink/sharded.reshard_sinks), re-encoding every id under the new
    layout and re-pinning the destination logmap.  Talks to the logd
    shards directly, not the web API."""
    del api
    from ..logsink.serve import RemoteJobLogStore

    def connect(addrs):
        conns = []
        try:
            for addr in addrs.split(","):
                host, _, port = addr.strip().rpartition(":")
                conns.append(RemoteJobLogStore(host or "127.0.0.1",
                                               int(port),
                                               token=args.token or ""))
        except BaseException:
            for c in conns:
                c.close()
            raise
        return conns
    from ..logsink.sharded import reshard_sinks
    src = dst = []
    try:
        src = connect(getattr(args, "from"))
        dst = connect(args.to)
        summary = reshard_sinks(
            src, dst, batch=args.batch,
            on_log=lambda m: print(m, file=sys.stderr, flush=True))
    except (RuntimeError, ValueError) as e:
        # refusals (non-empty destination, mismatched logmaps) and
        # malformed addresses exit cleanly — the tool protecting the
        # data is not a crash
        raise SystemExit(f"error: {e}")
    finally:
        for c in src + dst:
            try:
                c.close()
            except OSError:
                pass
    if args.json:
        print(json.dumps(summary, indent=2))
        return
    print(f"resharded {len(src)} -> {len(dst)} shards: "
          f"{summary['records']} records, {summary['nodes']} nodes, "
          f"{summary['accounts']} accounts")
    if summary["stat_shortfall"]:
        print(f"WARNING: {summary['stat_shortfall']} executions counted "
              "in source stats had no surviving record (retention-"
              "evicted); destination counters reflect migrated records "
              "only", file=sys.stderr)
    if summary.get("latest_shortfall"):
        print(f"WARNING: {summary['latest_shortfall']} (job, node) "
              "latest-status rows had no surviving record to rebuild "
              "from and are absent from the destination's latest view",
              file=sys.stderr)


def cmd_fsck(api, args):
    """Offline global-invariant audit (chaos/invariants.fsck): leaked
    dispatch reservations, orphan proc entries, fences without
    execution records, dangling dep completions — plus, when a shard
    is served by an ``a1|a2|a3`` replica group, the replication audit
    (replica state below the min applied revision must match the
    leader's byte-for-byte; divergence is named with its first key).
    Talks to the store (and optionally logd) shards DIRECTLY,
    read-only — the same checks the chaos drills gate on, runnable
    against a live fleet.  Exits nonzero when findings exist."""
    del api
    from ..chaos.invariants import (fsck, render, replication_audit,
                                    to_json)
    from ..core import Keyspace
    from ..store.sharded import connect_sharded
    store = sink = None
    try:
        try:
            store = connect_sharded(
                [a.strip() for a in args.store.split(",") if a.strip()],
                prefix=args.prefix, token=args.token or "")
            if args.logsink:
                from ..logsink.sharded import connect_sharded_sink
                sink = connect_sharded_sink(
                    [a.strip() for a in args.logsink.split(",")
                     if a.strip()],
                    token=args.token or "")
            findings = fsck(store, sink=sink,
                            ks=Keyspace(prefix=args.prefix),
                            stale_order_s=args.stale_order_s,
                            fence_settle_s=args.fence_settle_s)
            findings += replication_audit(store)
        except (RuntimeError, ValueError, OSError) as e:
            raise SystemExit(f"error: {e}")
    finally:
        for c in (store, sink):
            if c is not None:
                try:
                    c.close()
                except Exception:  # noqa: BLE001 — teardown
                    pass
    if args.json:
        print(to_json(findings))
    else:
        print(render(findings))
    raise SystemExit(1 if findings else 0)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="cronsun-ctl",
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--url", default=DEFAULT_URL,
                    help=f"web server base URL (default {DEFAULT_URL}, "
                         "env CRONSUN_URL)")
    ap.add_argument("--session", default=DEFAULT_SESSION,
                    help="cookie-jar file (env CRONSUN_SESSION)")
    ap.add_argument("--json", action="store_true",
                    help="raw JSON output (scripting)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, fn, help_, **kw):
        p = sub.add_parser(name, help=help_, **kw)
        p.set_defaults(fn=fn)
        return p

    p = add("login", cmd_login, "create a session")
    p.add_argument("email")
    p.add_argument("--password", default=None,
                   help="password (prompted when omitted)")
    add("logout", cmd_logout, "destroy the session")
    add("whoami", cmd_whoami, "show the logged-in account")
    add("version", cmd_version, "server version")
    add("overview", cmd_overview, "dashboard numbers")

    p = add("jobs", cmd_jobs, "list jobs")
    p.add_argument("--group", default=None)

    job = sub.add_parser("job", help="job operations")
    jsub = job.add_subparsers(dest="jobcmd", required=True)

    def jadd(name, fn, help_):
        p = jsub.add_parser(name, help=help_)
        p.set_defaults(fn=fn)
        return p
    jadd("get", cmd_job_get, "show one job as JSON").add_argument("id")
    jadd("save", cmd_job_save,
         "create/update a job from a JSON file (or - for stdin)"
         ).add_argument("file")
    jadd("rm", cmd_job_rm, "delete a job").add_argument("id")
    jadd("pause", cmd_job_pause, "pause a job").add_argument("id")
    jadd("resume", cmd_job_resume, "resume a paused job").add_argument("id")
    jadd("nodes", cmd_job_nodes,
         "nodes a job resolves to (include ∪ groups − exclude)"
         ).add_argument("id")
    p = jadd("export", cmd_job_export,
             "dump all job definitions as JSON (re-loadable)")
    p.add_argument("--group", default=None)
    jadd("import", cmd_job_import,
         "load jobs from a JSON array file (or -)").add_argument("file")

    p = add("run", cmd_run, "run a job immediately (bypasses schedule)")
    p.add_argument("id")
    p.add_argument("--node", default=None,
                   help="single node (default: all eligible)")

    p = add("executing", cmd_executing, "what is running right now")
    p.add_argument("--node", default=None)
    p.add_argument("--job", default=None)

    p = add("logs", cmd_logs, "execution history (filters match the UI)")
    p.add_argument("--node", default=None)
    p.add_argument("--job", default=None, help="job id (comma-list ok)")
    p.add_argument("--names", default=None, help="name substring")
    p.add_argument("--tenant", default=None,
                   help="only this tenant's jobs (enforced server-side "
                        "for tenant-pinned accounts)")
    p.add_argument("--failed", action="store_true")
    p.add_argument("--latest", action="store_true",
                   help="latest record per (job, node)")
    p.add_argument("--begin", default=None,
                   help="epoch or YYYY-MM-DD[ HH:MM[:SS]] (local)")
    p.add_argument("--end", default=None)
    p.add_argument("--page", type=positive_int, default=1)
    p.add_argument("--size", type=positive_int, default=50)
    p.add_argument("--follow", "-f", action="store_true",
                   help="poll for new records and stream them (tail -f)")
    p.add_argument("--interval", type=poll_interval, default=2.0,
                   help="--follow poll interval seconds (>= 0.1)")

    add("log", cmd_log, "one execution record with output"
        ).add_argument("id", type=int)
    add("nodes", cmd_nodes, "node liveness (mirror ⋈ live keys)")
    add("groups", cmd_groups, "node groups")

    grp = sub.add_parser("group", help="node-group operations")
    gsub = grp.add_subparsers(dest="groupcmd", required=True)

    def gadd(name, fn, help_):
        p = gsub.add_parser(name, help=help_)
        p.set_defaults(fn=fn)
        return p
    gadd("get", cmd_group_get, "show one group").add_argument("id")
    gadd("save", cmd_group_save,
         "create/update a group from a JSON file (or -)"
         ).add_argument("file")
    gadd("rm", cmd_group_rm,
         "delete a group (scrubs it from job rules)").add_argument("id")

    add("accounts", cmd_accounts, "list accounts (admin)")

    acct = sub.add_parser("account", help="account administration (admin)")
    asub = acct.add_subparsers(dest="acctcmd", required=True)
    p = asub.add_parser("add", help="create an account")
    p.set_defaults(fn=cmd_account_add)
    p.add_argument("email")
    p.add_argument("--password", default=None,
                   help="initial password (prompted when omitted)")
    p.add_argument("--admin", action="store_true",
                   help="Administrator role (default: Developer)")
    p.add_argument("--disabled", action="store_true")
    p = asub.add_parser("update",
                        help="change role/status/password "
                             "(force-logs-out the account)")
    p.set_defaults(fn=cmd_account_update)
    p.add_argument("email")
    p.add_argument("--role", choices=("admin", "developer"), default=None)
    st = p.add_mutually_exclusive_group()
    st.add_argument("--enable", action="store_true")
    st.add_argument("--disable", action="store_true")
    p.add_argument("--password", default=None)

    p = add("passwd", cmd_passwd, "change your own password")
    p.add_argument("--old", default=None, help="prompted when omitted")
    p.add_argument("--new", default=None, help="prompted when omitted")
    sch = sub.add_parser("sched",
                         help="scheduler plane (partition leaders)")
    schsub = sch.add_subparsers(dest="schedcmd", required=True)
    p = schsub.add_parser("status",
                          help="per-partition leaders, step health, "
                               "leaderless partitions")
    p.set_defaults(fn=cmd_sched_status)
    rp = sub.add_parser("repl",
                        help="store replication plane (replica groups)")
    rpsub = rp.add_subparsers(dest="replcmd", required=True)
    p = rpsub.add_parser("status",
                         help="per-shard replica roles, applied "
                              "revisions, lag, fencing epochs")
    p.set_defaults(fn=cmd_repl_status)

    add("metrics", cmd_metrics, "Prometheus metrics text")
    add("checkpoint", cmd_checkpoint,
        "trigger store WAL snapshot + scheduler checkpoints (admin)")
    p = add("checkpoint-compact", cmd_checkpoint_compact,
            "fold a scheduler checkpoint's delta chain into one element "
            "(offline; direct file access)")
    p.add_argument("path", help="checkpoint dir or sched.ckpt path")
    add("configurations", cmd_configurations,
        "security/alarm config exposed to the UI")

    p = add("fsck", cmd_fsck,
            "offline invariant audit (direct store access, read-only; "
            "nonzero exit on findings)")
    p.add_argument("--store", required=True,
                   help="store address(es), host:port[,host:port...]")
    p.add_argument("--logsink", default="",
                   help="logd address(es) for the fence-vs-record "
                        "cross-check (optional)")
    p.add_argument("--prefix", default="/cronsun")
    p.add_argument("--token", default=os.environ.get("CRONSUN_TOKEN", ""),
                   help="store/logsink shared secret (env CRONSUN_TOKEN)")
    p.add_argument("--stale-order-s", type=float, default=900.0,
                   help="dispatch keys older than this count as leaked "
                        "reservations (default 900)")
    p.add_argument("--fence-settle-s", type=float, default=60.0,
                   help="fences older than this must have an execution "
                        "record (default 60 — must stay BELOW the "
                        "fence lease lifetime, lock_ttl+60, or the "
                        "cross-check can never fire)")

    add("tenants", cmd_tenants, "list tenants (jobs + quotas)")
    ten = sub.add_parser("tenant",
                         help="tenant quotas and admission state")
    tsub = ten.add_subparsers(dest="tenantcmd", required=True)
    p = tsub.add_parser("show", help="one tenant's quota, job count "
                                     "and live throttle counters")
    p.set_defaults(fn=cmd_tenant_show)
    p.add_argument("id")
    p = tsub.add_parser("set", help="create/update a tenant quota "
                                    "(admin; omitted fields keep 0 = "
                                    "unlimited)")
    p.set_defaults(fn=cmd_tenant_set)
    p.add_argument("id")
    p.add_argument("--max-jobs", dest="max_jobs", type=int, default=None)
    p.add_argument("--rate", type=float, default=None,
                   help="sustained fires/second (token-bucket refill)")
    p.add_argument("--burst", type=float, default=None,
                   help="bucket depth (default max(rate, 1))")
    p.add_argument("--max-running", dest="max_running", type=int,
                   default=None,
                   help="max outstanding exclusive executions")
    p.add_argument("--weight", type=float, default=None,
                   help="fair-share weight under capacity scarcity")
    p = tsub.add_parser("rm", help="remove a tenant's quota (admin)")
    p.set_defaults(fn=cmd_tenant_rm)
    p.add_argument("id")

    tr = sub.add_parser("trace", help="fire-lifecycle trace plane")
    trsub = tr.add_subparsers(dest="tracecmd", required=True)
    p = trsub.add_parser("show",
                         help="one fire's waterfall: per-stage "
                              "durations tick -> record")
    p.set_defaults(fn=cmd_trace_show)
    p.add_argument("job", help="job id")
    p.add_argument("second", type=int, help="scheduled epoch second")
    p = trsub.add_parser("top",
                         help="slowest recent traces (by total or one "
                              "stage)")
    p.set_defaults(fn=cmd_trace_top)
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--stage", default="",
                   help="sort by one stage: sched publish claim queue "
                        "run record")

    add("slos", cmd_slos, "list SLO specs")
    slo = sub.add_parser("slo", help="SLO burn-rate engine")
    ssub = slo.add_subparsers(dest="slocmd", required=True)
    p = ssub.add_parser("show", help="current burn rates + alert "
                                     "states")
    p.set_defaults(fn=cmd_slo_show)
    p = ssub.add_parser("set", help="create/update an SLO (admin)")
    p.set_defaults(fn=cmd_slo_set)
    p.add_argument("name")
    p.add_argument("--scope", default="",
                   help="'' (global), tenant:<name>, or "
                        "chain:<group>/<job>")
    p.add_argument("--target", type=float, default=0.999,
                   help="good-fire ratio objective (default 0.999)")
    p.add_argument("--latency-ms", dest="latency_ms", type=float,
                   default=None,
                   help="runs longer than this count as bad (pick a "
                        "histogram bucket bound; 0/omitted = "
                        "success-only SLO)")
    p = ssub.add_parser("rm", help="remove an SLO (admin)")
    p.set_defaults(fn=cmd_slo_rm)
    p.add_argument("name")

    dag = sub.add_parser("dag", help="workflow DAG views")
    dsub = dag.add_subparsers(dest="dagcmd", required=True)
    p = dsub.add_parser("show",
                        help="dependency graph of a group (topo order, "
                             "policies, broken refs)")
    p.set_defaults(fn=cmd_dag_show)
    p.add_argument("group")
    p = dsub.add_parser("runs",
                        help="latest round + in-flight state per DAG job")
    p.set_defaults(fn=cmd_dag_runs)
    p.add_argument("group")

    p = add("logd-reshard", cmd_logd_reshard,
            "dump/rehash/load the result store into a new shard count "
            "(destination must be a fresh, empty logd set)")
    p.add_argument("--from", required=True, metavar="H:P,H:P,...",
                   help="current logd shard address list (ALL shards)")
    p.add_argument("--to", required=True, metavar="H:P,...",
                   help="destination logd shard address list (empty set)")
    p.add_argument("--token", default=None,
                   help="logd auth token (default: none)")
    p.add_argument("--batch", type=positive_int, default=500,
                   help="records per cursor page / bulk load (default 500)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    api = Api(args.url, args.session)
    try:
        args.fn(api, args)
    except ApiError as e:
        if e.status == 401 and args.cmd != "login":
            print("error: not logged in (or session expired) — "
                  "run: cronsun-ctl login EMAIL", file=sys.stderr)
        else:
            # login itself keeps the server detail ("invalid email or
            # password"), not circular advice to run login
            print(f"error: {e}", file=sys.stderr)
        return 1
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
