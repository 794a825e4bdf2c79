"""Chaos plane: deterministic fault injection + global invariant audits
(copy of ``cronsun_tpu/chaos/``).

- :mod:`.hooks` — in-process fault points compiled into the store and
  logsink CLIENTS (``store/remote.py``, ``logsink/serve.py``): reply-lost,
  timeout, delay and error injection per RPC op, seed-driven and
  env-gated off in production (``CRONSUN_CHAOS``).
- :mod:`.faultproxy` — a TCP-level proxy that sits in front of any
  store/logd address and drops, delays, duplicates, reorders, severs or
  black-holes traffic per connection on a scripted, seed-deterministic
  schedule.  Works against BOTH backends (py and native) because it
  operates on the shared line-JSON wire.
- :mod:`.invariants` — machine-checked global invariants (exactly-once,
  zero acked-record loss, clean fixpoint) used by the drill harness
  (``cronsun_tpu_torch/scripts/bench_chaos.py``).
"""

from .hooks import ChaosAction, hooks  # noqa: F401
from .faultproxy import (  # noqa: F401
    FaultProxy, FaultRule, FaultSchedule)
from .invariants import (  # noqa: F401
    Finding, check_acked_records, check_exactly_once, check_fixpoint,
    fsck)
