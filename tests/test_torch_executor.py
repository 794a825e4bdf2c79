"""The port's executor, ``cronsun_tpu_torch.node.executor.Executor``,
against the JAX package's, on the CPU.

Each case runs one real command through both executors (fork and exec):
the same success, exit code, captured output and error.  The port spawns
a run that switches no user without a ``preexec_fn`` (``start_new_session``
makes it lead its own session, as the JAX executor's ``os.setsid`` does),
so CPython can vfork: a fork copies the page tables of a process holding a
CUDA context, which is slow (the demo's agents run in the scheduler's
process on the card).
"""

import pytest

from cronsun_tpu.node.executor import Executor as JaxExecutor
from cronsun_tpu_torch.node.executor import Executor as PortExecutor


def outcome(r):
    """Everything but the wall stamps."""
    return (r.success, r.exit_code, r.output, r.error, r.retries_used)


CASES = {
    "stdout": ("echo hello world", {}),
    "exit_code": ("sh -c 'exit 3'", {}),
    "stderr": ("sh -c 'echo out; echo err >&2'", {}),
    "quoted": ("echo 'one two'  three", {}),
    "missing_binary": ("definitely-not-a-real-binary-xyz", {}),
    "empty": ("", {}),
    "unknown_user": ("echo hi", {"user": "no-such-user-xyz"}),
    "timeout": ("sh -c 'sleep 30'", {"timeout": 1}),
    "session_leader": ("python3 -c 'import os; print(os.getsid(0) == "
                       "os.getpid())'", {}),
    "timeout_kills_the_group": ("sh -c 'sleep 30 & sleep 30'",
                                {"timeout": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_once_matches_the_jax_executor(case):
    cmd, kw = CASES[case]
    ref = JaxExecutor().run_once(cmd, **kw)
    got = PortExecutor().run_once(cmd, **kw)
    assert outcome(got) == outcome(ref)


def test_output_truncation_matches():
    cmd = "sh -c 'yes x | head -c 10000'"
    ref = JaxExecutor(max_output=100).run_once(cmd)
    got = PortExecutor(max_output=100).run_once(cmd)
    assert outcome(got) == outcome(ref)
    assert "[truncated]" in got.output


def test_retries_match(tmp_path):
    out = []
    for ex in (JaxExecutor(), PortExecutor()):
        slept = []
        flag = tmp_path / f"flag-{len(out)}"
        cmd = (f"sh -c 'test -f {flag} && exit 0 || "
               f"{{ touch {flag}; exit 1; }}'")
        ok = ex.run_job("j1", cmd, retry=3)
        failed = ex.run_job("j2", "false", retry=2, interval=1,
                            sleep=slept.append)
        out.append((outcome(ok), outcome(failed), slept))
    assert out[1] == out[0]
    assert out[0][0][4] == 1 and out[0][1][4] == 2


def test_a_run_with_no_user_is_spawned_without_a_preexec_fn(monkeypatch):
    import subprocess
    seen = []
    real = subprocess.Popen

    class Recording(real):
        def __init__(self, *a, **kw):
            seen.append((kw.get("preexec_fn"), kw.get("start_new_session")))
            super().__init__(*a, **kw)
    monkeypatch.setattr(subprocess, "Popen", Recording)
    got = PortExecutor().run_once("python3 -c 'import os; "
                                  "print(os.getsid(0) == os.getpid())'")
    assert got.output.strip() == "True"
    assert seen == [(None, True)]
