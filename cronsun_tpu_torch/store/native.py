"""The native (C++) coordination store, ``native/cronsun-stored``, as a
child process.

``native/stored.cc`` speaks the wire protocol of
:class:`~cronsun_tpu_torch.store.remote.StoreServer` with memstore
semantics.  This is the part of ``cronsun_tpu/store/native.py`` and
``cronsun_tpu/native_launcher.py`` that the port's benches use: locate or
build the binary, spawn it on a free port with ``--die-with-parent``, read
its READY line, stop it.
"""

from __future__ import annotations

import os
import pathlib
import select
import shutil
import subprocess
import time
from typing import List, Optional

from .. import log

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
NAME = "cronsun-stored"
READY_TIMEOUT_S = 10.0


def find_binary() -> Optional[str]:
    """``$CRONSUN_STORED``, then ``native/cronsun-stored`` (built with
    ``make`` when it is missing or older than its sources), then
    ``$PATH``; None when none of them is there."""
    env = os.environ.get("CRONSUN_STORED")
    if env and os.access(env, os.X_OK):
        return env
    cand = NATIVE_DIR / NAME
    srcs = [NATIVE_DIR / "stored.cc", NATIVE_DIR / "njson.h"]
    if srcs[0].exists() and (not cand.exists() or any(
            s.exists() and cand.stat().st_mtime < s.stat().st_mtime
            for s in srcs)):
        try:
            subprocess.run(["make", "-C", str(NATIVE_DIR), NAME],
                           check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, OSError) as e:
            log.warnf("native build of %s failed: %s", NAME, e)
    if cand.exists() and os.access(cand, os.X_OK):
        return str(cand)
    return shutil.which(NAME)


class NativeStoreServer:
    """``cronsun-stored`` serving on the loopback at a free port (``host``
    and ``port`` as its READY line gives them) until :meth:`stop`."""

    def __init__(self, binary: str):
        # stderr merged into stdout, so a failed start says why
        self._proc = subprocess.Popen(
            [binary, "--host", "127.0.0.1", "--port", "0",
             "--die-with-parent"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        addr = self._read_ready().split(" ", 1)[1]
        self.host, port = addr.rsplit(":", 1)
        self.port = int(port)

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
        raise RuntimeError(f"{NAME} did not start within {READY_TIMEOUT_S}s:"
                           f" {''.join(lines).strip()!r}")

    def stop(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        self._proc.stdout.close()
