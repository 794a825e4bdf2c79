"""Scheduler service: the central planning loop (copy of
``cronsun_tpu/sched/``, running on the port's planner).

The TPU-native inversion of the reference's architecture: instead of every
node running a full cron loop over its eligible jobs (node/node.go:121-158,
node/cron/cron.go:210-275), ONE leader scheduler owns the device-resident
schedule table and eligibility matrix, plans windows of seconds in single
TPU dispatches, and publishes per-(node, second, job) execution orders to
the coordination store.  Agents are thin watch-and-exec shells.

Failure modes map onto store primitives: leader election by
create-if-absent + lease keepalive (standbys take over on expiry); dispatch
keys are leased (orphaned orders expire); exclusive executions are fenced by
a per-(job, second) lock txn on the agent side, so even a double-dispatched
order runs once.
"""

from .service import SchedulerService  # noqa: F401
