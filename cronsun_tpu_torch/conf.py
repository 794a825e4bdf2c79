"""Configuration: JSON with @extend composition, token substitution,
defaults, and hot-reload.

Mirrors the reference's config system (conf/conf.go:45-213,
utils/confutil.go:43-93): a root JSON file may name a base file in an
``"@extend:"`` key (the base is loaded first, the child overrides);
``@pwd@`` and ``@root@`` tokens expand to the config file's directory and
its parent; defaults are applied after parsing; a polling watcher detects
mtime changes (3s debounce like the reference's fsnotify path) and emits a
reload event — connection-level settings (store endpoints, web bind) are
deliberately excluded from reload (conf/conf.go:200-213).

Copy of ``cronsun_tpu/conf.py``; the only difference: comments that dated a
behaviour by the JAX package's history now say what it is.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Callable, List, Optional

from .tlsutil import Tls

EXTEND_KEY = "@extend:"


@dataclasses.dataclass
class Security:
    open: bool = False
    users: List[str] = dataclasses.field(default_factory=list)
    exts: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Mail:
    enable: bool = False
    host: str = ""
    port: int = 25
    user: str = ""
    password: str = ""
    to: List[str] = dataclasses.field(default_factory=list)
    keepalive: int = 30
    http_api: str = ""


@dataclasses.dataclass
class Web:
    host: str = "0.0.0.0"
    port: int = 7079
    session_ttl: int = 8 * 3600
    auth_enabled: bool = True   # reference Web.Auth.Enabled (base.go:98);
                                # False = every request is an implicit admin


@dataclasses.dataclass
class Config:
    prefix: str = "/cronsun"
    node_ttl: int = 10          # node lease ttl (conf.Ttl)
    lock_ttl: int = 300
    proc_ttl: int = 600
    proc_req: int = 5           # short-run suppression threshold, seconds
    timezone: str = "UTC"
    window_s: int = 4           # planner window per dispatch
    pipelined_step: bool = True  # two-stage scheduler step (plan ∥
                                # build+publish); False = serial path
                                # (rollback switch; mesh planners are
                                # always serial)
    job_capacity: int = 65536
    node_capacity: int = 1024
    default_node_cap: int = 1 << 20
    log_db: str = "cronsun.db"
    log_addr: str = ""          # "host:port" of cronsun-logd; when set the
                                # networked result store replaces log_db
                                # (the reference's Mgo.Hosts, db/mgo.go:24-49)
    log_token: str = ""         # shared secret for log_addr (Mgo credentials)
    store_token: str = ""       # shared secret for the coordination store
                                # (the reference's etcd username/password,
                                # conf/conf.go:66-67)
    store_tls: Tls = dataclasses.field(default_factory=Tls)
    log_tls: Tls = dataclasses.field(default_factory=Tls)
                                # per-channel TLS material (the reference
                                # threads etcd TLS through clientv3.Config,
                                # conf/conf.go:66-67); empty = plaintext.
                                # Clients use ca(+cert/key for mutual TLS);
                                # servers use cert/key(+ca to demand client
                                # certs).  See tlsutil.py.
    checkpoint_dir: str = ""    # scheduler checkpoint directory: the
                                # leader (and warm standbys) persist
                                # their built state there and a restart
                                # restores it + replays the watch delta
                                # instead of cold-loading the store.
                                # "" disables (cold loads only).
    checkpoint_interval: int = 0
                                # seconds between periodic scheduler
                                # checkpoint saves (0 = only on the
                                # `cronsun-ctl checkpoint` trigger)
    checkpoint_delta: bool = True
                                # incremental scheduler checkpoints: a
                                # periodic full (base) save plus small
                                # delta records of the applied watch
                                # events since the last save — save cost
                                # proportional to CHANGE, not state, so
                                # the cadence can tighten at 1M jobs.
                                # False = every save is a full image
                                # (the rollback switch).
    checkpoint_rebase_chain: int = 64
                                # auto-rebase: a full save replaces the
                                # delta chain once it reaches this many
                                # elements (restore folds the whole
                                # chain, so length bounds takeover time)
    checkpoint_rebase_bytes: int = 64 << 20
                                # ... or once the chain's on-disk bytes
                                # cross this bound
    trace_sample_shift: int = 8
                                # fire-lifecycle tracing: head-sample
                                # fires whose trace id's low SHIFT bits
                                # are zero (8 = 1/256).  0 samples every
                                # fire, -1 disables scheduler stamping;
                                # CRONSUN_TRACE=off kills the whole
                                # plane.  Per-job ``trace: true`` and
                                # failed executions sample regardless.
    slo_eval_s: int = 15        # web-tier SLO engine evaluation cadence
                                # (burn-rate windows are 5m/30m/1h/6h;
                                # the scrape ring keeps ~6h of samples)
    compile_cache: str = "~/.cache/cronsun-tpu/xla"
                                # persistent XLA compilation cache: a
                                # restarted scheduler (or a cold failover
                                # standby on the same host) reloads its
                                # compiled planner programs from disk
                                # instead of recompiling (~27 s of a cold
                                # boot measured on CPU; 20-40 s per
                                # program on TPU).  "" disables.
    security: Security = dataclasses.field(default_factory=Security)
    mail: Mail = dataclasses.field(default_factory=Mail)
    web: Web = dataclasses.field(default_factory=Web)

    # dynamic-reload exclusions, like the reference
    _RELOAD_EXCLUDE = ("prefix", "web", "log_db", "log_addr", "log_token",
                       "store_token", "store_tls", "log_tls")


def _substitute(text: str, path: str) -> str:
    pwd = os.path.dirname(os.path.abspath(path))
    return text.replace("@pwd@", pwd).replace("@root@", os.path.dirname(pwd))


def load_file(path: str) -> dict:
    """Load JSON with recursive @extend composition (child overrides base)."""
    with open(path) as f:
        data = json.loads(_substitute(f.read(), path))
    base_name = data.pop(EXTEND_KEY, None)
    if base_name:
        base_path = base_name if os.path.isabs(base_name) else \
            os.path.join(os.path.dirname(os.path.abspath(path)), base_name)
        base = load_file(base_path)
        base.update(data)
        data = base
    return data


def _merge(cfg: Config, data: dict, reload_only: bool = False) -> Config:
    for f in dataclasses.fields(Config):
        name = f.name
        if name.startswith("_") or name not in data:
            continue
        if reload_only and name in Config._RELOAD_EXCLUDE:
            continue
        v = data[name]
        if name == "security":
            v = Security(**v)
        elif name == "mail":
            v = Mail(**v)
        elif name == "web":
            v = Web(**v)
        elif name in ("store_tls", "log_tls"):
            v = Tls(**v)
        setattr(cfg, name, v)
    return cfg


def parse(path: Optional[str] = None) -> Config:
    cfg = Config()
    if path:
        _merge(cfg, load_file(path))
    if cfg.node_ttl <= 0:
        cfg.node_ttl = 10
    if cfg.lock_ttl < 2:
        cfg.lock_ttl = 300
    if cfg.mail.keepalive <= 0:
        cfg.mail.keepalive = 30
    return cfg


class ConfigWatcher:
    """Poll the file's mtime; on change (debounced 3s) re-parse and call
    ``on_reload(cfg)`` with reload-excluded fields preserved."""

    def __init__(self, path: str, cfg: Config,
                 on_reload: Callable[[Config], None],
                 poll_s: float = 1.0, debounce_s: float = 3.0):
        self.path = path
        self.cfg = cfg
        self.on_reload = on_reload
        self.poll_s = poll_s
        self.debounce_s = debounce_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        def run():
            try:
                last_mtime = os.stat(self.path).st_mtime
            except OSError:
                last_mtime = 0
            debounce_left = None
            while not self._stop.wait(self.poll_s):
                try:
                    m = os.stat(self.path).st_mtime
                except OSError:
                    continue
                if m != last_mtime:
                    last_mtime = m
                    debounce_left = self.debounce_s
                if debounce_left is not None:
                    debounce_left -= self.poll_s
                    if debounce_left <= 0:
                        debounce_left = None
                        try:
                            _merge(self.cfg, load_file(self.path),
                                   reload_only=True)
                            self.on_reload(self.cfg)
                        except (OSError, json.JSONDecodeError):
                            pass
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="conf-watcher")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3)
