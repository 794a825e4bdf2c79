"""TLS for the wire protocols (coordination store + result store).

The reference passes transport security through config: etcd gets a full
``clientv3.Config`` (TLS + username/password, conf/conf.go:66-67) and
Mongo gets credentials (db/mgo.go:33-36).  The rebuild's line-JSON
transport carries the shared-secret handshake (store/wire.py) for
authentication; this module adds the encryption half — flag-gated TLS on
both Python servers and both clients, with optional mutual TLS (the
server demands a client certificate signed by the fleet CA).

Deployment model: one private CA per fleet (``scripts/gen_certs.sh``),
server certs with SAN entries for every address agents dial, client
certs only when mutual TLS is on.  The native C++ servers
(cronsun-stored / cronsun-logd) speak plaintext and deploy behind a TLS
terminator (stunnel/haproxy) or on a trusted network — see
native/README.md.

Config surface (conf.py): ``store_tls`` / ``log_tls`` sections with
``ca``, ``cert``, ``key``, ``hostname``, ``client_ca``.  Clients use
``ca`` to verify the server (+ ``cert``/``key`` to present under mutual
TLS); servers use ``cert``/``key`` to serve and ``client_ca`` to demand
client certificates.  The client trust anchor and the server's
demand-client-certs knob are deliberately SEPARATE fields so one
section can be shared by every process in a fleet conf without
accidentally flipping on mutual TLS (a TLS client only sends its cert
when the server asks).  An empty section means plaintext — TLS never
turns on by accident — and a PARTIAL section raises at startup rather
than silently downgrading (a client with a cert but no CA must not
connect in clear).

Concurrency contract: every wire endpoint in this codebase touches its
socket from at most one reader thread plus mutex-serialized writers
(RemoteStore._read_loop vs _call under _wlock; the server handler
thread vs _pump under wlock).  That single-reader/locked-writer
discipline is what makes full-duplex TLS sound here: OpenSSL forbids
arbitrary concurrent use of one SSL*, but with renegotiation disabled
(OP_NO_RENEGOTIATION, set below) the read path never writes and the
write path never reads, so the two halves touch disjoint cipher state.
Neither endpoint ever initiates a TLS 1.3 KeyUpdate (CPython exposes no
API for it), so the read-path write-back that KeyUpdate would require
cannot occur between our own endpoints.  Code adding a second reader
thread per socket would break this contract — don't.
"""

from __future__ import annotations

import dataclasses
import ssl
from typing import Optional


@dataclasses.dataclass
class Tls:
    """One channel's TLS material.  All paths; "" disables that piece."""
    ca: str = ""         # client: fleet CA bundle the server must chain to
    cert: str = ""       # this endpoint's certificate chain
    key: str = ""        # this endpoint's private key
    hostname: str = ""   # client only: expected server SAN; "" skips
                         # hostname binding (IP fleets with a private CA)
    client_ca: str = ""  # server only: demand client certs chaining to
                         # this CA (mutual TLS)

    @property
    def client_enabled(self) -> bool:
        return bool(self.ca)

    @property
    def server_enabled(self) -> bool:
        return bool(self.cert)


def server_context(tls: Tls) -> Optional[ssl.SSLContext]:
    """Server-side context, or None when the section is empty.
    ``tls.client_ca`` set => mutual TLS (client certs required).  A
    partial section (key/client_ca without cert) raises instead of
    serving plaintext."""
    if not tls.server_enabled:
        if tls.key or tls.client_ca:
            raise ValueError(
                "TLS section has key/client_ca but no cert: refusing to "
                "serve plaintext on a half-configured channel")
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.options |= ssl.OP_NO_RENEGOTIATION   # see module docstring
    ctx.load_cert_chain(tls.cert, tls.key or None)
    if tls.client_ca:
        ctx.load_verify_locations(tls.client_ca)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(tls: Tls) -> Optional[ssl.SSLContext]:
    """Client-side context, or None when the section is empty.  The
    server cert is always verified against ``tls.ca``; hostname binding
    only when ``tls.hostname`` names the expected SAN.  A partial
    section (cert/key/hostname without ca) raises instead of silently
    connecting plaintext — that downgrade would put the shared token on
    the wire in clear."""
    if not tls.client_enabled:
        if tls.cert or tls.key or tls.hostname:
            raise ValueError(
                "TLS section has cert/key/hostname but no ca: refusing "
                "the silent plaintext downgrade")
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.options |= ssl.OP_NO_RENEGOTIATION   # see module docstring
    ctx.load_verify_locations(tls.ca)
    ctx.verify_mode = ssl.CERT_REQUIRED
    ctx.check_hostname = bool(tls.hostname)
    if tls.cert:
        ctx.load_cert_chain(tls.cert, tls.key or None)
    return ctx


def wrap_client(sock, ctx: Optional[ssl.SSLContext], hostname: str = ""):
    """Wrap an outbound socket; no-op when ctx is None."""
    if ctx is None:
        return sock
    return ctx.wrap_socket(sock, server_hostname=hostname or None)
