"""Chaos plane: in-process fault points of the wire clients.

Part of ``cronsun_tpu/chaos/``: only :mod:`.hooks`, which the store
client (``store/remote.py``) calls on every RPC.  The TCP fault proxy
(``faultproxy``) and the invariant audits (``invariants``) are not in
this package.
"""

from .hooks import ChaosAction, hooks  # noqa: F401
