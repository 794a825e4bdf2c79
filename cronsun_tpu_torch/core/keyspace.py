"""Key layout — identical shape to the reference's etcd keyspace
(SURVEY.md appendix; conf normalizes the prefixes, conf/conf.go:124-157),
plus the new ``dispatch`` prefix: the central planner's per-node execution
orders, which replace the per-node cron loops.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Keyspace:
    prefix: str = "/cronsun"

    @property
    def cmd(self) -> str:        # job JSON, /cmd/<group>/<jobID>
        return f"{self.prefix}/cmd/"

    @property
    def node(self) -> str:       # node liveness, /node/<id> (leased)
        return f"{self.prefix}/node/"

    @property
    def proc(self) -> str:       # running executions (leased)
        return f"{self.prefix}/proc/"

    @property
    def once(self) -> str:       # run-now triggers
        return f"{self.prefix}/once/"

    @property
    def lock(self) -> str:       # execution fence tokens
        return f"{self.prefix}/lock/"

    @property
    def group(self) -> str:      # node groups
        return f"{self.prefix}/group/"

    @property
    def noticer(self) -> str:    # failure messages node -> web
        return f"{self.prefix}/noticer/"

    @property
    def sess(self) -> str:       # web sessions (leased)
        return f"{self.prefix}/sess/"

    @property
    def dispatch(self) -> str:   # planner -> agent execution orders (leased)
        return f"{self.prefix}/dispatch/"

    @property
    def leader(self) -> str:     # scheduler leader election
        return f"{self.prefix}/leader"

    # -- key builders ------------------------------------------------------

    def job_key(self, group: str, job_id: str) -> str:
        return f"{self.cmd}{group}/{job_id}"

    def node_key(self, node_id: str) -> str:
        return f"{self.node}{node_id}"

    def group_key(self, gid: str) -> str:
        return f"{self.group}{gid}"

    def once_key(self, group: str, job_id: str) -> str:
        return f"{self.once}{group}/{job_id}"

    def lock_key(self, job_id: str, epoch_s: int) -> str:
        """Per-(job, second) execution dedup fence.  ``epoch_s`` is the
        SCHEDULED epoch as emitted by the planner — for jobs with
        ``jitter`` set that is the smeared epoch
        (``s + fnv1a64("<group>/<id>|<s>") % (jitter+1)``), so a
        replayed or
        re-planned window fences against exactly the same key."""
        return f"{self.lock}{job_id}/{epoch_s}"

    @property
    def alone_lock(self) -> str:
        """Prefix of the fleet-wide KindAlone running locks."""
        return f"{self.lock}alone/"

    def alone_lock_key(self, job_id: str) -> str:
        """Fleet-wide running lock for KindAlone jobs — held with keepalive
        for the execution's whole lifetime (reference job.go:87-123), unlike
        the per-(job, second) dedup fence of :meth:`lock_key`."""
        return f"{self.alone_lock}{job_id}"

    @property
    def hwm(self) -> str:        # scheduler planning high-water mark
        return f"{self.prefix}/hwm"

    def hwm_partition_key(self, partition: int) -> str:
        """Per-partition planning high-water mark (partitioned
        scheduler plane): each partition leader resumes from ITS mark.
        The unpartitioned (P=1) scheduler keeps the bare :attr:`hwm`
        key — pure passthrough."""
        return f"{self.prefix}/hwm/p{partition}"

    # -- partitioned scheduler plane --------------------------------------

    def partition_leader_key(self, partition: int) -> str:
        """Leader-election key for ONE scheduler partition.  P
        independent leases, one per job-space slice; the unpartitioned
        scheduler keeps the bare :attr:`leader` key."""
        return f"{self.lock}sched/p{partition}"

    @property
    def partmap(self) -> str:
        """Partition-topology pin (sched/partition.py): the first
        partition leader publishes ``{"p": P, "hash": SCHEME}``; every
        later scheduler verifies its configured partition count against
        it and refuses loudly on mismatch — the shardmap pattern (PR 6)
        lifted to the scheduler plane."""
        return f"{self.prefix}/sched/partmap"

    @property
    def sched_acct(self) -> str:
        """Per-partition node-demand summaries (leased): each partition
        leader periodically publishes its per-node outstanding
        exclusive slots + running load under ``.../acct/p<i>``; every
        other partition folds the summaries into its capacity view, so
        shared node rem_cap stays reconciled without cross-partition
        coordination on the fire path."""
        return f"{self.prefix}/sched/acct/"

    def sched_acct_key(self, partition: int) -> str:
        return f"{self.sched_acct}p{partition}"

    @property
    def shardmap(self) -> str:
        """Shard-topology pin (store/sharded.py): lives on shard 0 by
        fiat; clients verify their configured shard count against it."""
        return f"{self.prefix}/shardmap"

    @property
    def metrics(self) -> str:    # leased per-process metric snapshots
        return f"{self.prefix}/metrics/"

    def metrics_key(self, component: str, instance: str) -> str:
        return f"{self.metrics}{component}/{instance}"

    @property
    def ckpt(self) -> str:       # checkpoint plane control keys
        return f"{self.prefix}/ckpt/"

    @property
    def ckpt_req(self) -> str:
        """Operator checkpoint trigger (``cronsun-ctl checkpoint`` via
        the web API): schedulers watch the ckpt prefix and save on a
        PUT here."""
        return f"{self.ckpt}request"

    @property
    def ckpt_barrier(self) -> str:
        """Watch-quiesce barrier: the scheduler writes a nonce here and
        drains its watches until the nonce arrives, which proves every
        event at or before the write's revision is applied to its
        mirrors — the revision a checkpoint is tagged with."""
        return f"{self.ckpt}barrier"

    def ckpt_done_key(self, node_id: str) -> str:
        """Per-scheduler checkpoint result (JSON: rev/ms/path) written
        after an operator-requested save."""
        return f"{self.ckpt}done/{node_id}"

    @property
    def phase(self) -> str:      # @every phase anchors, survive failover
        return f"{self.prefix}/phase/"

    def phase_key(self, group: str, job_id: str, rule_id: str) -> str:
        return f"{self.phase}{group}/{job_id}/{rule_id}"

    @property
    def dep(self) -> str:
        """Workflow DAG completion events: one persistent key per job,
        last completed round.  Agents write it at execution end; the
        scheduler watches the prefix and folds the events into the
        on-device success-epoch vectors (the dep-trigger edge signal)."""
        return f"{self.prefix}/dep/"

    def dep_key(self, group: str, job_id: str) -> str:
        """Value wire format: ``"<scheduled epoch>|ok"`` or ``"...|fail"``
        — the SCHEDULED second, not completion wall time, so every node
        of a Common fan-out writes the same value for one round
        (last-write-wins is idempotent per round)."""
        return f"{self.dep}{group}/{job_id}"

    def proc_key(self, node_id: str, group: str, job_id: str, pid) -> str:
        return f"{self.proc}{node_id}/{group}/{job_id}/{pid}"

    def noticer_key(self, node_id: str) -> str:
        return f"{self.noticer}{node_id}"

    def dispatch_key(self, node_id: str, epoch_s: int, group: str,
                     job_id: str) -> str:
        """Legacy per-(node, second, job) exclusive order key — still
        consumed by both agents for rollout tolerance; the scheduler
        publishes :meth:`dispatch_bundle_key` for in-window fires, but
        late smeared arrivals (spill-ring entries whose carrying window
        has moved on) are emitted on this per-job form.  ``epoch_s`` is
        always the SMEARED scheduled epoch when the job sets jitter."""
        return f"{self.dispatch}{node_id}/{epoch_s}/{group}/{job_id}"

    @staticmethod
    def split_bundle_epoch(segment: str):
        """Parse a coalesced bundle key's epoch segment — ``<epoch>``
        plain, or the partitioned scheduler's ``<epoch>.<partition>``
        form.  Returns ``(epoch, partition-or-None)``, or None when
        the segment is neither — THE one home of the suffix grammar
        (agents, fsck, mirrors and benches all parse through here;
        native/agentd.cc mirrors it)."""
        ep, dot, part = segment.partition(".")
        if not ep.isdigit() or (dot and not part.isdigit()):
            return None
        return int(ep), (int(part) if part else None)

    def dispatch_bundle_key(self, node_id: str, epoch_s: int) -> str:
        """Coalesced exclusive order: ONE key per (node, second), value =
        JSON array of "group/job_id" strings.  A minute-boundary cron
        herd publishes at most one key per active node instead of one
        per fire (~20x fewer keys at the 1M x 10k scale); the key doubles
        as the scheduler's outstanding-capacity reservation for
        len(value) exclusive slots until the per-job proc keys exist.
        ``epoch_s`` is the scheduled second AFTER herd smearing: a
        jittered job's order coalesces under its smeared epoch, which is
        exactly what flattens the (node, second) key herd."""
        return f"{self.dispatch}{node_id}/{epoch_s}"

    # Common-kind fan-out: ONE broadcast order per (second, job); each
    # agent decides eligibility locally (the reference's IsRunOn,
    # job.go:616-630) instead of the scheduler writing one key per node —
    # a 1M-job burst to 10k nodes must not be 10^10 store writes.
    BROADCAST = "_all"

    @property
    def dispatch_all(self) -> str:
        return f"{self.dispatch}{self.BROADCAST}/"

    def dispatch_all_key(self, epoch_s: int, group: str, job_id: str) -> str:
        """Broadcast Common-kind order.  Like every dispatch/fence key,
        ``epoch_s`` is the smeared scheduled epoch for jittered jobs."""
        return f"{self.dispatch_all}{epoch_s}/{group}/{job_id}"

    def sess_key(self, sid: str) -> str:
        return f"{self.sess}{sid}"

    # -- multi-tenant control plane ---------------------------------------

    @property
    def tenant(self) -> str:
        """Tenancy keyspace family: per-tenant quota records and the
        per-tenant job index markers the web tier maintains so
        ``set_job``'s max_jobs check is one ``count_prefix``, not a
        full ``cmd/`` scan."""
        return f"{self.prefix}/tenant/"

    def tenant_quota_key(self, tenant: str) -> str:
        """Quota record (core.models.TenantQuota JSON); the scheduler
        watches the tenant prefix and folds these into the per-tenant
        token-bucket columns."""
        return f"{self.tenant}{tenant}/quota"

    def tenant_jobs(self, tenant: str) -> str:
        """Prefix of one tenant's job index markers."""
        return f"{self.tenant}{tenant}/job/"

    def tenant_job_key(self, tenant: str, group: str, job_id: str) -> str:
        return f"{self.tenant_jobs(tenant)}{group}/{job_id}"

    # -- SLO engine (trace plane) ------------------------------------------

    @property
    def slo(self) -> str:
        """Declarative SLO records (core.models.SloSpec JSON): the web
        tier lists the prefix each evaluation tick and alerts on
        multi-window burn rates over the scraped execution counters."""
        return f"{self.prefix}/slo/"

    def slo_key(self, name: str) -> str:
        return f"{self.slo}{name}"
