"""The native (C++) servers, ``native/cronsun-stored`` and
``native/cronsun-logd``, as child processes.

``native/stored.cc`` speaks the wire protocol of
:class:`~cronsun_tpu_torch.store.remote.StoreServer` with memstore
semantics.  The port's one launcher for both servers, the counterpart of
``cronsun_tpu/store/native.py`` and ``cronsun_tpu/native_launcher.py``:
locate or build a binary, spawn it with ``--die-with-parent`` (secrets
in a 0600 temp file: argv is world-readable), read its READY line,
watch it, stop it.  The result store's launcher
(:mod:`cronsun_tpu_torch.logsink.native`) is built on it.
"""

from __future__ import annotations

import os
import pathlib
import select
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Callable, List, Optional, Sequence

from .. import log

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
NAME = "cronsun-stored"
READY_TIMEOUT_S = 10.0


def find_binary(name: str = NAME,
                env_var: str = "CRONSUN_STORED") -> Optional[str]:
    """``$<env_var>``, then ``native/<name>`` (built with ``make`` when it
    is missing or older than its sources), then ``$PATH``; None when none
    of them is there.  ``cronsun-stored`` unless ``name`` says otherwise."""
    env = os.environ.get(env_var)
    if env and os.access(env, os.X_OK):
        return env
    cand = NATIVE_DIR / name
    srcs = [NATIVE_DIR / f"{name.split('-', 1)[1]}.cc",
            NATIVE_DIR / "njson.h"]
    if srcs[0].exists() and (not cand.exists() or any(
            s.exists() and cand.stat().st_mtime < s.stat().st_mtime
            for s in srcs)):
        try:
            subprocess.run(["make", "-C", str(NATIVE_DIR), name],
                           check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, OSError) as e:
            log.warnf("native build of %s failed: %s", name, e)
    if cand.exists() and os.access(cand, os.X_OK):
        return str(cand)
    return shutil.which(name)


class NativeServer:
    """A native server serving at ``host``:``port`` (port 0: a free one;
    ``host`` and ``port`` as its READY line gives them) until
    :meth:`stop`.  ``argv_tail`` are the server's own flags; ``token``
    reaches it through a temp file removed once it is READY."""

    def __init__(self, binary: str, argv_tail: Sequence[str] = (),
                 host: str = "127.0.0.1", port: int = 0, token: str = ""):
        argv = [binary, "--host", host, "--port", str(port),
                *argv_tail, "--die-with-parent"]
        token_path = None
        if token:
            tfd, token_path = tempfile.mkstemp(prefix="cronsun-tok-")
            os.write(tfd, token.encode())
            os.close(tfd)
            argv += ["--token-file", token_path]
        self._name = os.path.basename(binary)
        self._stopping = False
        try:
            # stderr merged into stdout, so a failed start says why
            self._proc = subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            addr = self._read_ready().split(" ", 1)[1]
        finally:
            if token_path:
                try:
                    os.unlink(token_path)
                except OSError:
                    pass
        self.host, port_s = addr.rsplit(":", 1)
        self.port = int(port_s)

    def _read_ready(self) -> str:
        fd = self._proc.stdout.fileno()
        deadline = time.monotonic() + READY_TIMEOUT_S
        lines: List[str] = []
        while time.monotonic() < deadline:
            if not select.select([fd], [], [],
                                 max(0.0, deadline - time.monotonic()))[0]:
                break
            line = self._proc.stdout.readline()
            if not line:                    # the child exited
                break
            lines.append(line)
            if line.startswith("READY "):
                return line.strip()
        self.stop()
        raise RuntimeError(f"{self._name} did not start within "
                           f"{READY_TIMEOUT_S}s: {''.join(lines).strip()!r}")

    def monitor(self, on_exit: Callable[[int], None]) -> None:
        """Call ``on_exit(rc)`` if the child dies without :meth:`stop`, so
        a supervising process does not sit healthy-looking in front of a
        dead server."""
        def run():
            rc = self._proc.wait()
            if not self._stopping:
                on_exit(rc)
        threading.Thread(target=run, daemon=True,
                         name="native-server-monitor").start()

    def start(self) -> "NativeServer":
        return self     # already serving (READY consumed in __init__)

    def stop(self) -> None:
        self._stopping = True
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        self._proc.stdout.close()


class NativeStoreServer(NativeServer):
    """``cronsun-stored`` (``binary``, else :func:`find_binary`) with the
    flags of ``cronsun_tpu/store/native.py``'s launcher."""

    def __init__(self, binary: Optional[str] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 history: int = 65536, wal: Optional[str] = None,
                 token: str = "", stripes: int = 0,
                 compact_wal_bytes: int = -1,
                 snapshot_staggered: bool = True):
        binary = binary or find_binary()
        if binary is None:
            raise FileNotFoundError(
                "cronsun-stored not found (set $CRONSUN_STORED or build "
                "native/)")
        argv = ["--history", str(history)]
        if stripes > 0:
            argv += ["--stripes", str(stripes)]
        if wal:
            argv += ["--wal", wal]
        if compact_wal_bytes >= 0:
            # size-triggered WAL compaction threshold; 0 disables it,
            # negative keeps the server default
            argv += ["--compact-wal-bytes", str(compact_wal_bytes)]
        if not snapshot_staggered:
            # rollback switch: full-lock snapshot imaging
            argv += ["--snapshot-staggered", "0"]
        super().__init__(binary, argv, host=host, port=port, token=token)
