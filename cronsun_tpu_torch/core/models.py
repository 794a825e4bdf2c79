"""Domain models: Job, JobRule, Group, Node, Account.

Field-compatible with the reference's JSON wire format (job.go:38-84,
group.go:17-22, node.go:25-35, account.go:14-25) so stored state is
interoperable; validation mirrors Check/Valid (job.go:502-537,633-656).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Optional

from ..cron.parser import ParseError, parse
from .errors import SecurityInvalid, ValidationError
from .ids import next_id

KIND_COMMON = 0    # runs on every eligible node, no mutual exclusion
KIND_ALONE = 1     # exactly one execution fleet-wide at a time
KIND_INTERVAL = 2  # at most one start per schedule interval

ROLE_ADMIN = 1
ROLE_DEVELOPER = 2

# Workflow DAG plane: a dep-triggered job names up to MAX_DEPS upstream
# jobs; the on-device dependency matrix is padded to this width
# (ops/schedule_table.py stores one [capacity, MAX_DEPS] column block).
MAX_DEPS = 8

MISFIRE_SKIP = "skip"    # a failed upstream round is consumed, no fire
MISFIRE_FIRE = "fire"    # fire anyway on upstream failure
MISFIRE_HOLD = "hold"    # wait until every upstream's latest run succeeds
MISFIRE_POLICIES = (MISFIRE_SKIP, MISFIRE_FIRE, MISFIRE_HOLD)

# Rules of dep-triggered jobs carry this sentinel timer: placement
# (nids/gids/exclude) still comes from the rule, but the trigger is the
# upstream success-epoch test in the batched tick, not a cron mask.
DEP_TIMER = "@dep"


def _clean(s: Optional[str]) -> str:
    return (s or "").strip()


@dataclasses.dataclass
class DepSpec:
    """Workflow dependency spec: the job fires when the latest run of
    EVERY upstream job (same group) succeeds after this job's last fire.

    ``misfire`` picks the behaviour when an upstream's latest round
    FAILED (see MISFIRE_*); ``max_in_flight`` caps concurrently running
    executions of this job (0 = unlimited) — a saturated job holds its
    fire until a slot frees."""
    on: List[str] = dataclasses.field(default_factory=list)
    misfire: str = MISFIRE_SKIP
    max_in_flight: int = 0

    def validate(self):
        self.on = [_clean(u) for u in self.on]
        if not self.on:
            raise ValidationError("deps.on must name at least one "
                                  "upstream job id")
        if len(self.on) > MAX_DEPS:
            raise ValidationError(
                f"deps.on lists {len(self.on)} upstreams; the dependency "
                f"matrix is padded to {MAX_DEPS} columns per job")
        seen = set()
        for u in self.on:
            if not u:
                raise ValidationError("deps.on contains an empty job id")
            if "/" in u:
                raise ValidationError(
                    f"cross-group dep reference {u!r}: dependencies "
                    "resolve within the job's own group only")
            if u in seen:
                raise ValidationError(f"duplicate upstream {u!r} in deps.on")
            seen.add(u)
        self.misfire = _clean(self.misfire) or MISFIRE_SKIP
        if self.misfire not in MISFIRE_POLICIES:
            raise ValidationError(
                f"unknown misfire policy {self.misfire!r} "
                f"(one of {', '.join(MISFIRE_POLICIES)})")
        if self.max_in_flight < 0:
            raise ValidationError("deps.max_in_flight must be >= 0")

    def to_dict(self) -> dict:
        return {"on": self.on, "misfire": self.misfire,
                "max_in_flight": self.max_in_flight}

    @classmethod
    def from_dict(cls, d: dict) -> "DepSpec":
        return cls(on=list(d.get("on") or []),
                   misfire=d.get("misfire", MISFIRE_SKIP),
                   max_in_flight=int(d.get("max_in_flight") or 0))


def validate_dag(dep_map: dict, job_ids, root: str):
    """Group-level DAG validation for one (changed) job: every upstream
    reachable from ``root`` must exist in ``job_ids`` and the walk must
    not revisit ``root`` or any node on the current path (a cycle).

    ``dep_map`` is {job_id: [upstream ids]} for the whole group WITH the
    changed job's new deps substituted; pure host code so the web tier
    can run it at ``set_job`` without importing the device stack."""
    path: List[str] = []
    on_path = set()
    done = set()   # fully-validated subtrees: each node expands ONCE,
    #                or diamonds of shared substructure go exponential

    def walk(jid: str):
        if jid in done:
            return
        if jid in on_path:
            cyc = path[path.index(jid):] + [jid]
            raise ValidationError(
                "dependency cycle: " + " -> ".join(cyc))
        ups = dep_map.get(jid)
        if not ups:
            done.add(jid)
            return
        on_path.add(jid)
        path.append(jid)
        for u in ups:
            if u not in job_ids:
                raise ValidationError(
                    f"unknown upstream job {u!r} (dep of {jid!r}; "
                    "dependencies resolve within the job's group)")
            walk(u)
        path.pop()
        on_path.discard(jid)
        done.add(jid)

    walk(root)


@dataclasses.dataclass
class JobRule:
    """Placement rule: cron timer + include nodes/groups − exclude nodes
    (reference job.go:76-84)."""
    id: str = ""
    timer: str = ""
    gids: List[str] = dataclasses.field(default_factory=list)
    nids: List[str] = dataclasses.field(default_factory=list)
    exclude_nids: List[str] = dataclasses.field(default_factory=list)

    def validate(self, dep_triggered: bool = False):
        self.timer = _clean(self.timer)
        if dep_triggered:
            # dep-triggered jobs: the rule is placement-only; the timer
            # is pinned to the sentinel (an empty timer normalizes)
            if self.timer not in ("", DEP_TIMER):
                raise ValidationError(
                    f"rule timer {self.timer!r} conflicts with the "
                    "deps spec: dep-triggered jobs use timer "
                    f"{DEP_TIMER!r} (or omit it)")
            self.timer = DEP_TIMER
            return
        if self.timer == DEP_TIMER:
            raise ValidationError(
                f"timer {DEP_TIMER!r} requires a deps spec on the job")
        if not self.timer:
            raise ValidationError("rule timer required")
        try:
            parse(self.timer)
        except ParseError as e:
            raise ValidationError(f"invalid timer {self.timer!r}: {e}")

    def to_dict(self) -> dict:
        return {"id": self.id, "timer": self.timer, "gids": self.gids,
                "nids": self.nids, "exclude_nids": self.exclude_nids}

    @classmethod
    def from_dict(cls, d: dict) -> "JobRule":
        return cls(id=d.get("id", ""), timer=d.get("timer", ""),
                   gids=list(d.get("gids") or []),
                   nids=list(d.get("nids") or []),
                   exclude_nids=list(d.get("exclude_nids") or []))


@dataclasses.dataclass
class Job:
    """A schedulable command (reference job.go:38-74)."""
    id: str = ""
    name: str = ""
    group: str = ""
    command: str = ""
    user: str = ""
    # multi-tenant control plane: the isolation axis quotas/admission
    # key on; "" is the default tenant (never quota-limited)
    tenant: str = ""
    rules: List[JobRule] = dataclasses.field(default_factory=list)
    pause: bool = False
    timeout: int = 0            # seconds; 0 = unlimited
    parallels: int = 0          # max concurrent per node; 0 = unlimited
    retry: int = 0
    interval: int = 0           # seconds between retries
    kind: int = KIND_COMMON
    avg_time: float = 0.0       # EWMA execution seconds (job.go:581-589)
    fail_notify: bool = False
    to: List[str] = dataclasses.field(default_factory=list)
    # workflow DAG trigger: when set, the job fires on upstream success
    # instead of a cron mask (rules keep carrying placement)
    deps: Optional[DepSpec] = None
    # trace plane: force head-sampling of every fire of this job
    # regardless of the fleet's trace_sample_shift (failure runs are
    # always sampled either way)
    trace: bool = False
    # herd smearing: deterministic per-fire delay width in seconds
    # (0..300).  A fire matched at logical second s is dispatched at
    # s + fnv1a64("<group>/<id>|<s>") % (jitter+1) — no randomness,
    # the same job/second pair always lands on the same smeared epoch
    # across leaders and restores.  0 keeps today's exact-second
    # behaviour.
    jitter: int = 0

    # ---- validation (reference job.go:502-537) ---------------------------

    def check(self):
        self.id = _clean(self.id) or next_id()
        self.name = _clean(self.name)
        if not self.name:
            raise ValidationError("job name required")
        self.group = _clean(self.group) or "default"
        if "/" in self.group:
            raise ValidationError("group name must not contain '/'")
        self.tenant = _clean(self.tenant)
        if "/" in self.tenant:
            raise ValidationError("tenant name must not contain '/'")
        if self.timeout < 0:
            raise ValidationError("timeout must be >= 0")
        if self.parallels < 0:
            raise ValidationError("parallels must be >= 0")
        if self.retry < 0:
            raise ValidationError("retry must be >= 0")
        if self.interval < 0:
            raise ValidationError("interval must be >= 0")
        if self.kind not in (KIND_COMMON, KIND_ALONE, KIND_INTERVAL):
            raise ValidationError(f"unknown kind {self.kind}")
        if not _clean(self.command):
            raise ValidationError("command required")
        self.trace = bool(self.trace)
        j = self.jitter
        if isinstance(j, bool) or \
                (not isinstance(j, int) and
                 not (isinstance(j, float) and j.is_integer())):
            raise ValidationError(
                f"jitter must be an integer number of seconds, got {j!r}")
        j = int(j)
        if not 0 <= j <= 300:
            raise ValidationError(
                f"jitter must be in 0..300 seconds, got {j}")
        self.jitter = j
        if isinstance(self.deps, dict):
            self.deps = DepSpec.from_dict(self.deps)
        if self.deps is not None:
            self.deps.validate()
            if self.id in self.deps.on:
                raise ValidationError(
                    f"job {self.id!r} cannot depend on itself")
        dep_triggered = self.deps is not None
        if dep_triggered and self.jitter:
            raise ValidationError(
                "dep-triggered jobs cannot set jitter: their fires are "
                "event-driven (upstream success), not cron-matched, so "
                "there is no herd second to smear")
        if dep_triggered and not self.rules:
            raise ValidationError(
                "dep-triggered jobs need at least one rule for "
                "placement (nids/gids)")
        for rule in self.rules:
            rule.id = _clean(rule.id) or next_id()
            rule.validate(dep_triggered=dep_triggered)

    def security_valid(self, security) -> None:
        """Reject commands/users outside the policy (reference
        job.go:633-656).  ``security`` is conf.Security or None."""
        if security is None or security.open is False:
            return
        if security.users and self.user not in security.users:
            raise SecurityInvalid(
                f"user {self.user!r} not in allowed users")
        if security.exts:
            cmd = _clean(self.command).split()[0] if _clean(self.command) else ""
            if not any(cmd.endswith(ext) for ext in security.exts):
                raise SecurityInvalid(
                    f"command {cmd!r} does not match allowed suffixes")

    @property
    def exclusive(self) -> bool:
        return self.kind in (KIND_ALONE, KIND_INTERVAL)

    def update_avg_time(self, seconds: float):
        """avg of the last two (reference job.go:581-589)."""
        self.avg_time = seconds if self.avg_time == 0 \
            else (self.avg_time + seconds) / 2

    # ---- wire ------------------------------------------------------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["rules"] = [r.to_dict() if isinstance(r, JobRule) else r
                      for r in self.rules]
        if self.deps is None:
            # wire compat: dep-less jobs serialize exactly as before
            d.pop("deps", None)
        if not self.tenant:
            # wire compat: default-tenant jobs keep the pre-tenancy bytes
            d.pop("tenant", None)
        if not self.trace:
            # wire compat: untraced jobs keep the pre-trace bytes
            d.pop("trace", None)
        if not self.jitter:
            # wire compat: unsmeared jobs keep the pre-jitter bytes
            d.pop("jitter", None)
        return json.dumps(d, separators=(",", ":"))

    _FIELDS = None   # lazily cached field-name set (NOT annotated: an
                     # annotation would make it a dataclass field)

    @classmethod
    def from_json(cls, s: str) -> "Job":
        d = json.loads(s)
        rules = [JobRule.from_dict(r) for r in d.get("rules") or []]
        deps = d.get("deps")
        if isinstance(deps, dict) and deps.get("on"):
            deps = DepSpec.from_dict(deps)
        else:
            deps = None
        known = cls._FIELDS
        if known is None:
            # cached: dataclasses.fields() introspection per document
            # was a measured slice of the 1M-job cold load
            known = frozenset(f.name for f in dataclasses.fields(cls))
            cls._FIELDS = known
        kw = {k: v for k, v in d.items()
              if k in known and k not in ("rules", "deps")}
        return cls(rules=rules, deps=deps, **kw)


@dataclasses.dataclass
class Group:
    """Named node set (reference group.go:17-22)."""
    id: str = ""
    name: str = ""
    node_ids: List[str] = dataclasses.field(default_factory=list)

    def check(self):
        self.id = _clean(self.id) or next_id()
        self.name = _clean(self.name)
        if not self.name:
            raise ValidationError("group name required")
        if "/" in self.id:
            raise ValidationError("group id must not contain '/'")

    def included(self, node_id: str) -> bool:
        return node_id in self.node_ids

    def to_json(self) -> str:
        return json.dumps({"id": self.id, "name": self.name,
                           "nids": self.node_ids}, separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "Group":
        d = json.loads(s)
        return cls(id=d.get("id", ""), name=d.get("name", ""),
                   node_ids=list(d.get("nids") or []))


@dataclasses.dataclass
class Node:
    """Machine identity + liveness (reference node.go:25-35)."""
    id: str = ""                 # IP in the reference; any stable id here
    pid: int = 0
    ip: str = ""
    hostname: str = ""
    version: str = ""
    up_ts: float = 0.0
    alived: bool = False

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "Node":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def hash_password(password: str, salt: str) -> str:
    """Double sha256(pwd+salt) — same shape as the reference's double-MD5
    (web/authentication.go:54-58) with a modern hash."""
    h1 = hashlib.sha256((password + salt).encode()).hexdigest()
    return hashlib.sha256((h1 + salt).encode()).hexdigest()


@dataclasses.dataclass
class Account:
    """Web user (reference account.go:14-25)."""
    email: str = ""
    password: str = ""           # hash_password output
    salt: str = ""
    role: int = ROLE_DEVELOPER
    status: int = 1              # 1 enabled, 0 banned
    session: str = ""
    unchangeable: bool = False
    # multi-tenant control plane: a non-empty tenant PINS this
    # account's jobs to that tenant (admins may set any tenant)
    tenant: str = ""

    def check_password(self, password: str) -> bool:
        return hash_password(password, self.salt) == self.password

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "Account":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# SLO scopes — which slice of the fleet's executions a spec covers.
# The scope string doubles as the counter key agents publish in their
# metrics snapshots ("" global, "t:<tenant>", "c:<group>/<job>").
SLO_SCOPE_GLOBAL = ""


@dataclasses.dataclass
class SloSpec:
    """Declarative service-level objective, stored under
    ``slo/<name>``.  ``target`` is the good-fire ratio (e.g. 0.999);
    ``latency_ms`` > 0 additionally counts an execution as bad when its
    run time exceeds the threshold (snapped DOWN to a histogram bucket
    bound — pick thresholds from trace.BUCKETS_MS for exactness).

    ``scope`` picks the slice: "" = every execution fleet-wide;
    ``tenant:<name>`` = one tenant's executions; ``chain:<group>/<job>``
    = one DAG chain, keyed by its terminal (dep-triggered) job.

    The web tier evaluates each spec as multi-window multi-burn-rate
    alerts (Google SRE workbook): fast page at burn >= 14.4 over BOTH
    5m and 1h, slow page at burn >= 6 over BOTH 30m and 6h, where
    burn = bad_fraction / (1 - target)."""
    name: str = ""
    scope: str = SLO_SCOPE_GLOBAL
    target: float = 0.999
    latency_ms: float = 0.0

    def validate(self):
        self.name = _clean(self.name)
        if not self.name:
            raise ValidationError("slo name required")
        if "/" in self.name:
            raise ValidationError("slo name must not contain '/'")
        self.scope = _clean(self.scope)
        if self.scope:
            kind, _, rest = self.scope.partition(":")
            if kind not in ("tenant", "chain") or not rest:
                raise ValidationError(
                    f"slo scope {self.scope!r}: expected '', "
                    "'tenant:<name>' or 'chain:<group>/<job>'")
            if kind == "chain" and "/" not in rest:
                raise ValidationError(
                    f"slo chain scope {rest!r}: expected <group>/<job>")
        if not (0.0 < self.target < 1.0):
            raise ValidationError("slo target must be in (0, 1)")
        if self.latency_ms < 0:
            raise ValidationError("slo latency_ms must be >= 0")

    @property
    def counter_scope(self) -> str:
        """The agent-snapshot counter key this spec reads."""
        if not self.scope:
            return ""
        kind, _, rest = self.scope.partition(":")
        return ("t:" + rest) if kind == "tenant" else ("c:" + rest)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self),
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "SloSpec":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class TenantQuota:
    """Per-tenant admission limits, stored under ``tenant/<id>/quota``.

    Zero means unlimited for every field.  ``rate``/``burst`` feed the
    scheduler's per-tenant token bucket (fires admitted per scheduled
    second, evaluated inside the batched tick); ``max_jobs`` is enforced
    at ``set_job`` (429 over quota); ``max_running`` caps concurrently
    outstanding EXCLUSIVE executions (orders + procs); ``weight`` is the
    fair-share weight when aggregate exclusive demand exceeds agent
    capacity (weighted max-min, default 1.0)."""
    tenant: str = ""
    max_jobs: int = 0
    rate: float = 0.0            # sustained fires/second
    burst: float = 0.0           # bucket depth; defaults to max(rate, 1)
    max_running: int = 0
    weight: float = 1.0

    def validate(self):
        self.tenant = _clean(self.tenant)
        if not self.tenant:
            raise ValidationError("tenant name required")
        if "/" in self.tenant:
            raise ValidationError("tenant name must not contain '/'")
        if self.max_jobs < 0 or self.max_running < 0:
            raise ValidationError("quota counts must be >= 0")
        if self.rate < 0 or self.burst < 0:
            raise ValidationError("rate/burst must be >= 0")
        if self.burst == 0 and self.rate > 0:
            # a zero-depth bucket never admits; default to one second's
            # worth (and at least 1 so sub-1/s rates can ever fire)
            self.burst = max(self.rate, 1.0)
        if self.weight <= 0:
            raise ValidationError("weight must be > 0")

    @property
    def limited(self) -> bool:
        """Whether the scheduler's token bucket applies at all."""
        return self.rate > 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "TenantQuota":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
