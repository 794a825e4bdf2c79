"""Web/API server + noticer host (reference bin/web/server.go:24-88).

    python -m cronsun_tpu_torch.bin.web --store H:P [--port P] [--conf F]

Copy of ``cronsun_tpu/bin/web.py``.
"""

from __future__ import annotations

import sys

from .. import events, log
from ..noticer import HttpNoticer, MailNoticer, Notice, NoticerHost
from ..web import ApiServer
from .common import base_parser, connect_store, make_sink, setup_common


class LogSender:
    """Fallback noticer: failures land in the log instead of the void."""

    def send(self, notice: Notice):
        log.warnf("notice: %s — %s", notice.subject, notice.body)


def main(argv=None) -> int:
    ap = base_parser(__doc__)
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)
    cfg, ks, watcher = setup_common(args)

    store = connect_store(args.store, token=cfg.store_token, tls=cfg.store_tls,
                          prefix=cfg.prefix)
    sink = make_sink(cfg, args.logsink)
    # SLO engine: multi-window burn-rate evaluation over the agents'
    # scraped execution counters, paging through the noticer this
    # process hosts (web/slo.py)
    from ..web.slo import SloEngine
    slo = SloEngine(store, ks=ks, interval_s=cfg.slo_eval_s).start()
    api = ApiServer(store, sink, ks=ks, security=cfg.security,
                    alarm=cfg.mail.enable,
                    auth_enabled=cfg.web.auth_enabled,
                    host=args.host or cfg.web.host,
                    port=cfg.web.port if args.port is None else args.port,
                    slo_engine=slo)
    api.start()

    if cfg.mail.enable and cfg.mail.host:
        sender = MailNoticer(cfg.mail.host, cfg.mail.port, cfg.mail.user,
                             cfg.mail.password, default_to=cfg.mail.to,
                             keepalive=cfg.mail.keepalive)
    elif cfg.mail.enable and cfg.mail.http_api:
        sender = HttpNoticer(cfg.mail.http_api)
    else:
        sender = LogSender()
    noticer = NoticerHost(store, sink, sender, ks=ks)
    noticer.start()

    log.infof("cronsun-web on %s:%d (store %s)", api.host, api.port,
              args.store)
    print(f"READY {api.host}:{api.port}", flush=True)
    events.on(events.EXIT, noticer.stop, api.stop, slo.stop, store.close)
    if watcher:
        events.on(events.EXIT, watcher.stop)
    events.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
