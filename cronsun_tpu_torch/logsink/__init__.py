"""Result store: execution logs, latest-status, counters, accounts.

The reference keeps these in MongoDB (job_log, job_latest_log, stat, node,
account collections — db/mgo.go, job_log.go).  This rebuild uses SQLite
(stdlib, zero-dependency, single file) with the same logical schema and the
same write pattern per execution: insert log + upsert latest + bump overall
and per-day counters (job_log.go:84-133).

Copy of ``cronsun_tpu/logsink/__init__.py``.
"""

from .joblog import JobLogStore, LogRecord  # noqa: F401
from .serve import LogSinkError, LogSinkServer, RemoteJobLogStore  # noqa: F401
