"""The native (C++) servers, ``native/cronsun-stored`` and
``native/cronsun-logd``, as child processes.

``native/stored.cc`` speaks the wire protocol of
:class:`~cronsun_tpu_torch.store.remote.StoreServer` with memstore
semantics.  This is the part of ``cronsun_tpu/store/native.py`` and
``cronsun_tpu/native_launcher.py`` that the port's benches and drills use:
locate or build a binary, spawn it on a free port with
``--die-with-parent``, read its READY line, stop it.  The result store's
launcher (:mod:`cronsun_tpu_torch.logsink.native`) is built on it.
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
    """A native server serving on the loopback at a free port (``host``
    and ``port`` as its READY line gives them) until :meth:`stop`."""

    def __init__(self, binary: str):
        # stderr merged into stdout, so a failed start says why
        self._proc = subprocess.Popen(
            [binary, "--host", "127.0.0.1", "--port", "0",
             "--die-with-parent"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._name = os.path.basename(binary)
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
        raise RuntimeError(f"{self._name} did not start within "
                           f"{READY_TIMEOUT_S}s: {''.join(lines).strip()!r}")

    def stop(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        self._proc.stdout.close()


# ``cronsun-stored`` with its default flags
NativeStoreServer = NativeServer
