"""The port's one-process demo (``cronsun_tpu_torch.demo``) against the JAX
package's (``cronsun_tpu.demo``), each run as a process for a few seconds
on the CPU (the port's with ``--device cpu``) over one small conf.

Both must seed the same jobs, run the Alone job at most once a second and
the Common job on every agent each of its seconds (``chip_smoke.
check_demo_runs``, which the card's ``demo_ctl`` phase holds too), print
the same lines (up to the port and the counts) and exit 0.  Left at its
default device, the port's demo refuses to start without a card."""

import json
import re
import socket
import threading
import time

import pytest
import torch

from chip_smoke import Proc, WebClient, check_demo_runs

NODES = 3
PERIOD = 5              # the demo's seeded jobs are ``*/5 * * * * *``
RUN_S = 30
UP = re.compile(r"cronsun-tpu demo up: (\d+) agents, scheduler leader=True,"
                r" UI http://127\.0\.0\.1:(\d+)/ui/ \(admin@admin\.com / "
                r"admin\)\n")
SUMMARY = re.compile(r"executed (\d+) runs across (\d+) nodes\n")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_demo(mod, conf, extra, out):
    port = _free_port()
    p = Proc(mod, "--nodes", str(NODES), "--port", str(port), "--conf",
             conf, "--seconds", str(RUN_S), *extra)
    try:
        deadline = time.monotonic() + 120
        while not any(UP.fullmatch(ln) for ln in p.lines):
            p.check_alive()
            assert time.monotonic() < deadline, p.output()
            time.sleep(0.1)
        t_up = time.time()
        web = WebClient(f"127.0.0.1:{port}")
        jobs = web.call("GET", "/v1/jobs")
        time.sleep(max(0.0, t_up + RUN_S - 4 - time.time()))
        t_read = time.time()
        records = web.call("GET", "/v1/logs?pageSize=500")["list"]
        rc = p.wait(60)
        out[mod] = dict(rc=rc, jobs=jobs, records=records, t_read=t_read,
                        lines=list(p.lines), port=port)
    finally:
        p.stop(timeout=30)


def _job_shape(j):
    return (j["name"], j["command"], j["kind"], j.get("fail_notify"),
            [(r["timer"], sorted(r["nids"])) for r in j["rules"]])


def test_port_demo_runs_like_the_jax_demo(tmp_path):
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"job_capacity": 2048, "node_capacity": 64,
                                "window_s": 2}))
    out = {}
    runs = [threading.Thread(target=_run_demo, args=(
        mod, str(conf), extra, out)) for mod, extra in (
            ("cronsun_tpu.demo", ()),
            ("cronsun_tpu_torch.demo", ("--device", "cpu")))]
    for t in runs:
        t.start()
    for t in runs:
        t.join(RUN_S + 200)
    assert set(out) == {"cronsun_tpu.demo", "cronsun_tpu_torch.demo"}
    jax, port = out["cronsun_tpu.demo"], out["cronsun_tpu_torch.demo"]
    assert port["rc"] == jax["rc"] == 0
    assert sorted(map(_job_shape, port["jobs"])) == \
        sorted(map(_job_shape, jax["jobs"]))
    nodes = [f"node-{i}" for i in range(NODES)]
    for r in (jax, port):
        kinds = {j["id"]: j["kind"] for j in r["jobs"]}
        got = check_demo_runs(r["records"], kinds, nodes, PERIOD,
                              r["t_read"])
        assert got["job_seconds_checked"] >= len(kinds)
        shapes = [("up", UP.fullmatch(ln).group(1)) if UP.fullmatch(ln)
                  else ("summary", SUMMARY.fullmatch(ln).group(2))
                  if SUMMARY.fullmatch(ln) else ln
                  for ln in r["lines"] if not ln.startswith("[notice]")]
        r["shapes"] = [s for s in shapes if isinstance(s, tuple) or
                       s == "shutting down...\n"]
    assert port["shapes"] == jax["shapes"] == [
        ("up", str(NODES)), "shutting down...\n", ("summary", str(NODES))]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is here")
def test_the_port_demo_needs_a_card_unless_asked(capsys):
    from cronsun_tpu_torch import demo
    before = set(threading.enumerate())
    assert demo.main(["--port", "0", "--seconds", "1"]) == 1
    cap = capsys.readouterr()
    assert "--device cuda" in cap.err and "device='cpu'" in cap.err
    assert "demo up" not in cap.out and cap.out == ""
    assert set(threading.enumerate()) <= before     # nothing started
