"""Job execution: fork/exec with setuid, timeout, retry, concurrency gate.

The Python analogue of the reference's execution tail (job.go:404-470 run,
job.go:134-187 retry + Parallels gate):

- commands are tokenized with shell quoting (shlex) — a deliberate
  improvement over the reference's whitespace-only split (job.go:391-393),
  which cannot express arguments containing spaces;
- ``user`` demotes the child via setuid/setgid before exec (reference
  job.go:413-434) — requires running as root, otherwise recorded as failure;
- timeout kills the whole process group (reference uses CommandContext,
  job.go:437-443);
- stdout+stderr are captured combined, truncated at ``max_output`` bytes;
- a per-job concurrency gate mirrors ``Parallels`` (job.go:165-187): when
  the cap is reached the run is *skipped*, not queued;
- retries re-run after ``interval`` seconds, up to ``retry`` times
  (job.go:149-162); a success stops the loop.

Copy of ``cronsun_tpu/node/executor.py``.
"""

from __future__ import annotations

import dataclasses
import os
import pwd
import shlex
import signal
import subprocess
import threading
import time
from typing import Callable, Dict, Optional

DEFAULT_MAX_OUTPUT = 1 << 20  # 1 MiB


@dataclasses.dataclass
class ExecResult:
    success: bool
    output: str
    begin_ts: float
    end_ts: float
    exit_code: int = 0
    error: str = ""
    retries_used: int = 0
    skipped: bool = False        # concurrency gate refused the run

    @property
    def seconds(self) -> float:
        return max(0.0, self.end_ts - self.begin_ts)


class _Gate:
    """Per-job concurrent-execution counter (reference job.go:165-187)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def enter(self, job_id: str, limit: int) -> bool:
        if limit <= 0:
            return True
        with self._lock:
            cur = self._counts.get(job_id, 0)
            if cur >= limit:
                return False
            self._counts[job_id] = cur + 1
            return True

    def leave(self, job_id: str, limit: int):
        if limit <= 0:
            return
        with self._lock:
            cur = self._counts.get(job_id, 0)
            if cur <= 1:
                self._counts.pop(job_id, None)
            else:
                self._counts[job_id] = cur - 1


def _demote(user: str) -> Callable[[], None]:
    info = pwd.getpwnam(user)

    def fn():
        os.setgid(info.pw_gid)
        os.setuid(info.pw_uid)
    return fn


class Executor:
    def __init__(self, max_output: int = DEFAULT_MAX_OUTPUT,
                 clock: Callable[[], float] = time.time):
        self.max_output = max_output
        self.clock = clock
        self._gate = _Gate()

    # -- single run --------------------------------------------------------

    def run_once(self, command: str, user: str = "", timeout: int = 0,
                 env: Optional[dict] = None) -> ExecResult:
        begin = self.clock()
        try:
            argv = shlex.split(command)
        except ValueError as e:
            return ExecResult(False, "", begin, self.clock(),
                              error=f"bad command: {e}")
        if not argv:
            return ExecResult(False, "", begin, self.clock(),
                              error="empty command")
        # the child leads its own session (the timeout kills its group).
        # With no user to switch to, start_new_session does that without a
        # preexec_fn, so CPython spawns with vfork, not fork: a fork copies
        # the page tables of a process holding a CUDA context (the demo's
        # agents share the scheduler's), 0.2-1.0 s a run of `true` on an
        # H100 host
        preexec = None
        if user:
            try:
                demote = _demote(user)
            except KeyError:
                return ExecResult(False, "", begin, self.clock(),
                                  error=f"user {user!r} not found")

            def preexec():  # noqa: F811
                os.setsid()
                demote()

        try:
            proc = subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                env=env, preexec_fn=preexec,
                start_new_session=preexec is None)
        except (OSError, PermissionError) as e:
            return ExecResult(False, "", begin, self.clock(), error=str(e))

        try:
            out, _ = proc.communicate(timeout=timeout or None)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()
            out, _ = proc.communicate()
            return ExecResult(
                False, self._trunc(out), begin, self.clock(),
                exit_code=-9, error=f"timeout after {timeout}s")
        end = self.clock()
        return ExecResult(
            success=proc.returncode == 0,
            output=self._trunc(out),
            begin_ts=begin, end_ts=end, exit_code=proc.returncode,
            error="" if proc.returncode == 0
            else f"exit status {proc.returncode}")

    def _trunc(self, out: bytes) -> str:
        if out is None:
            return ""
        if len(out) > self.max_output:
            out = out[:self.max_output] + b"\n...[truncated]"
        return out.decode(errors="replace")

    # -- full job semantics ------------------------------------------------

    def run_job(self, job_id: str, command: str, user: str = "",
                timeout: int = 0, retry: int = 0, interval: int = 0,
                parallels: int = 0, env: Optional[dict] = None,
                sleep: Callable[[float], None] = time.sleep) -> ExecResult:
        """Parallels gate + retry loop around run_once."""
        if not self._gate.enter(job_id, parallels):
            now = self.clock()
            return ExecResult(False, "", now, now, skipped=True,
                              error="parallels limit reached, run skipped")
        try:
            result = self.run_once(command, user, timeout, env)
            attempts = 0
            while not result.success and attempts < retry:
                if interval > 0:
                    sleep(interval)
                attempts += 1
                nxt = self.run_once(command, user, timeout, env)
                nxt.retries_used = attempts
                nxt.begin_ts = result.begin_ts  # whole-run span
                result = nxt
                if result.success:
                    break
            return result
        finally:
            self._gate.leave(job_id, parallels)
