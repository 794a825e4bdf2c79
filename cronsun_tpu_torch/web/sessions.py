"""Sessions in the coordination store (reference web/session/session.go:53-150:
gob blobs under /cronsun/sess/<key> with an expiration lease; JSON here).

Copy of ``cronsun_tpu/web/sessions.py``.
"""

from __future__ import annotations

import json
import secrets
from typing import Optional

from ..core import Keyspace
from ..store.memstore import MemStore


class Session(dict):
    @property
    def email(self) -> str:
        return self.get("email", "")

    @property
    def role(self) -> int:
        return int(self.get("role", 0))


class SessionStore:
    def __init__(self, store: MemStore, ks: Optional[Keyspace] = None,
                 ttl: float = 8 * 3600):
        self.store = store
        self.ks = ks or Keyspace()
        self.ttl = ttl

    def create(self, email: str, role: int) -> str:
        sid = secrets.token_hex(16)
        lease = self.store.grant(self.ttl)
        self.store.put(self.ks.sess_key(sid),
                       json.dumps({"email": email, "role": role}),
                       lease=lease)
        return sid

    def get(self, sid: str) -> Optional[Session]:
        """Resolve a session; expiry slides on use (the reference
        re-stores the session after every request, base.go deferred
        todos).  The lease keepalive only fires once the remaining TTL
        drops below half, so hot sessions cost one extra RPC rarely."""
        if not sid:
            return None
        kv = self.store.get(self.ks.sess_key(sid))
        if kv is None:
            return None
        if kv.lease:
            rem = self.store.lease_ttl_remaining(kv.lease)
            if rem is not None and rem < self.ttl / 2:
                self.store.keepalive(kv.lease)
        try:
            return Session(json.loads(kv.value))
        except json.JSONDecodeError:
            return None

    def destroy(self, sid: str):
        self.store.delete(self.ks.sess_key(sid))

    def destroy_email(self, email: str):
        """Force-logout every session of an account (reference
        administrator.go force-logout on edit)."""
        for kv in self.store.get_prefix(self.ks.sess):
            try:
                if json.loads(kv.value).get("email") == email:
                    self.store.delete(kv.key)
            except json.JSONDecodeError:
                continue
