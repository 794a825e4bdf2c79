"""The port's bench, ``cronsun_tpu_torch.scripts.bench``, against the repo's
``bench.py``, on the CPU.

- The in-process keys are ``bench.py``'s, read from its own text (its
  ``detail[...]`` keys, literal and f-string, expanded by walking its
  ``main`` with ``quick`` bound), in quick and full runs.
- Each subprocess plane's script, argv, timeout, environment, error key and
  merge rule are ``bench.py``'s: its plane section is executed from its
  AST with ``subprocess.run`` replaced by a recorder, beside the port's
  :func:`run_planes`, for failing, raising and succeeding children.
- Config 2 draws ``bench.py``'s specs and its next-fire values and resolved
  count equal the JAX ``next_fire``'s, exactly.
- A ladder rung and the headline cell plan, window by window, what the JAX
  planner plans from the same state (``convert``).
- The kernel cell's comparison fails on a planted difference; the module
  exits 1 with no card.
"""

import ast
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cronsun_tpu.cron.parser import parse as jax_parse
from cronsun_tpu.ops import schedule_table as jax_st
from cronsun_tpu.ops import tick as jax_tick
from cronsun_tpu_torch.convert import planner_to_numpy
from cronsun_tpu_torch.ops import kernels
from cronsun_tpu_torch.scripts import bench as port
from cronsun_tpu_torch.synth import bench_mixed_specs
from torch_parity import (assert_plans_equal, jax_planner_from_state,
                          one_torch_thread)  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BENCH_PY = ROOT / "bench.py"
CPU = torch.device("cpu")

# cells at a size the CPU runs in seconds: every key and step kept
TINY = port.Shapes(
    k_eq=64, n_eq=256, n_wide=512,
    ladders=(("c3_10kx1k", 500, 64, 0.5, 1 << 20, 1024),
             ("c4_100kx1k", 1000, 64, 0.2, 64, 2048),
             ("c5_1Mx10k", 4096, 256, 0.02, 1 << 20, 4096)),
    headline_jobs=4096, headline_nodes=256, headline_bucket=4096,
    sla=(2048, 2048))

# smaller still for the key runs, whose full run plans 120 + 52 windows
KEYS = port.Shapes(
    k_eq=32, n_eq=64, n_wide=128, c2_specs=100,
    ladders=(("c3_10kx1k", 256, 32, 0.5, 1 << 20, 512),
             ("c4_100kx1k", 256, 32, 0.2, 64, 512),
             ("c5_1Mx10k", 512, 64, 0.02, 1 << 20, 1024)),
    headline_jobs=512, headline_nodes=64, headline_bucket=1024,
    sla=(512, 512))

# keys the port adds: what ``pallas`` and ``jnp`` are here, and the card
PORT_ONLY = {"kernel_impls", "nvidia_smi", "torch_version", "cuda_version"}


def _main() -> ast.FunctionDef:
    tree = ast.parse(BENCH_PY.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _logs(st, text) -> bool:
    """``st`` is ``log("<text>...")``."""
    return (isinstance(st, ast.Expr) and isinstance(st.value, ast.Call)
            and getattr(st.value.func, "id", None) == "log"
            and isinstance(st.value.args[0], ast.Constant)
            and st.value.args[0].value.startswith(text))


def _sections():
    """``main``'s statements: the in-process cells, then the planes."""
    body = _main().body
    start = next(i for i, st in enumerate(body)
                 if _logs(st, "dispatch plane"))
    end = next(i for i, st in enumerate(body) if isinstance(st, ast.With))
    return body[:start], body[start:end]


# ---- (a) in-process keys ---------------------------------------------------

class _Any:
    """Stands for any value the key walk does not need."""

    def __getattr__(self, name):
        return self

    def __call__(self, *a, **kw):
        return self

    def __getitem__(self, k):
        return self

    def __iter__(self):
        return iter(())

    __add__ = __radd__ = __mul__ = __rmul__ = __truediv__ = __sub__ = \
        __call__


class _Env(dict):
    def __missing__(self, name):
        return __builtins__[name] if name in dir(__builtins__) else _Any()


def _eval(node, env):
    return eval(compile(ast.Expression(node), str(BENCH_PY), "eval"), {}, env)


def _bind(target, value, env):
    env["__v"] = value
    stmt = ast.Assign([target], ast.Name("__v", ast.Load()))
    exec(compile(ast.fix_missing_locations(ast.Module([stmt], [])), "",
                 "exec"), {}, env)


def _ladder_stub(fn: ast.FunctionDef):
    """``ladder(name, ...)`` as the keys its returned dict literal names."""
    ret = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Return))

    def stub(name, *a, **kw):
        return {_eval(k, _Env(name=name)): 0 for k in ret.keys}
    return stub


def _walk(stmts, env, keys):
    """Run ``stmts`` far enough to name every ``detail`` key: assignments
    that evaluate, ``for`` loops over what evaluates, ``if`` branches on
    ``quick``; ``detail[...]``, ``detail = {...}`` and ``detail.update``
    record keys."""
    for st in stmts:
        if isinstance(st, ast.FunctionDef) and st.name == "ladder":
            env["ladder"] = _ladder_stub(st)
        elif isinstance(st, ast.If):
            try:
                cond = bool(_eval(st.test, env))
                _walk(st.body if cond else st.orelse, env, keys)
            except Exception:  # noqa: BLE001 — a branch on a value
                _walk(st.body + st.orelse, env, keys)
        elif isinstance(st, ast.For):
            try:
                items = list(_eval(st.iter, env))
            except Exception:  # noqa: BLE001
                items = []
            for item in items:
                try:
                    _bind(st.target, item, env)
                except Exception:  # noqa: BLE001
                    continue
                _walk(st.body, env, keys)
        elif isinstance(st, (ast.Try, ast.With)):
            _walk(st.body, env, keys)
        elif isinstance(st, ast.Assign):
            for t in st.targets:
                if isinstance(t, ast.Subscript) and isinstance(t.value,
                                                               ast.Name):
                    key = _eval(t.slice, env)
                    if t.value.id == "detail":
                        keys.add(key)
                    elif isinstance(env.get(t.value.id), dict):
                        env[t.value.id][key] = _Any()
                elif isinstance(t, ast.Name) and t.id != "quick":  # bound
                    if t.id == "detail" and isinstance(st.value, ast.Dict):
                        keys.update(k.value for k in st.value.keys)
                    try:
                        env[t.id] = _eval(st.value, env)
                    except Exception:  # noqa: BLE001
                        env[t.id] = _Any()
        elif isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
            f = st.value.func
            if isinstance(f, ast.Attribute) and f.attr == "update" and \
                    getattr(f.value, "id", None) == "detail":
                keys.update(_eval(st.value.args[0], env))


def bench_py_cell_keys(quick: bool) -> set:
    keys = set()
    _walk(_sections()[0], _Env(quick=quick), keys)
    return keys


@pytest.fixture(scope="module")
def tiny_runs():
    """The port's in-process cells at KEYS, quick and full, with fewer
    timed calls (the keys do not depend on them)."""
    nbig = port.NBIG
    port.NBIG = 3
    try:
        return {q: port.run_cells(q, CPU, KEYS, port.header(CPU))
                for q in (True, False)}
    finally:
        port.NBIG = nbig


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_in_process_keys_are_bench_py_s(quick, tiny_runs):
    want = bench_py_cell_keys(quick)
    assert "c5_1Mx10k_fired_per_tick" in want and "rtt_p99_ms" in want
    assert ("w32_window_samples" in want) is not quick
    assert ("kernel_bid_wide_jnp_ms" in want) is not quick
    detail, p99 = tiny_runs[quick]
    assert set(detail) - PORT_ONLY == want, set(detail) ^ want
    assert p99 > 0 and detail["kernels_equal"] is True
    assert detail["backend"] == "cpu"
    assert all(detail[k] > 0 for k in want if k.endswith("_fired_per_tick"))


def test_result_line_is_bench_py_s(tiny_runs):
    """The last line's keys and metric text are ``bench.py``'s
    (``bench.py:776-781``)."""
    call = next(n for n in ast.walk(_main()) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "print"
                and isinstance(n.args[0], ast.Call))
    lit = call.args[0].args[0]
    want = {k.value: v for k, v in zip(lit.keys, lit.values)}
    line = port.result_line(tiny_runs[True][1])
    assert set(line) == set(want)
    assert line["metric"] == want["metric"].value
    assert line["unit"] == want["unit"].value
    assert line["vs_baseline"] == round(port.TARGET_MS / tiny_runs[True][1], 3)


# ---- (b) the subprocess planes ---------------------------------------------

class _Child:
    """A recorder standing in for ``subprocess.run``: every call's argv and
    keywords; its n-th child fails, raises or prints a JSON object that
    names n and carries the keys every merge rule reads."""

    def __init__(self, mode):
        self.mode, self.calls = mode, []

    def __call__(self, argv, **kw):
        n = len(self.calls)
        self.calls.append((list(argv), kw))
        if self.mode == "raise":
            raise OSError(f"child {n} did not start")
        out = {"git_rev": f"child{n}", "generated_at_utc": f"t{n}",
               f"plane_{n}_key": n, "dispatch_plane_backend": f"b{n}",
               "dispatch_plane_orders_per_sec": n,
               "dispatch_plane_agent_curve": [n],
               "dispatch_plane_exec_lag_p99_s": n / 10,
               "dispatch_plane_records_dropped": 0}
        return types.SimpleNamespace(
            returncode=1 if self.mode == "fail" else 0,
            stdout=json.dumps(out), stderr=f"child {n} failed " + "x" * 600)


def bench_py_planes(quick: bool, child: _Child) -> dict:
    """``bench.py``'s plane section run with ``child`` as
    ``subprocess.run``; returns its detail."""
    stmts = [st for st in _sections()[1] if not isinstance(st, ast.Import)]
    ns = {"quick": quick, "detail": {}, "log": lambda *a: None, "os": os,
          "sys": sys, "json": json, "__file__": str(BENCH_PY),
          "subprocess": types.SimpleNamespace(run=child)}
    exec(compile(ast.Module(stmts, []), str(BENCH_PY), "exec"), ns)
    return ns["detail"]


def _env_delta(kw) -> dict:
    env = kw.get("env")
    return {} if env is None else {
        k: v for k, v in env.items() if os.environ.get(k) != v}


@pytest.mark.parametrize("mode", ["fail", "raise", "ok"])
@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_planes_are_bench_py_s(quick, mode, tmp_path):
    ref, got = _Child(mode), _Child(mode)
    ref_detail = bench_py_planes(quick, ref)
    got_detail = {}
    port.run_planes(got_detail, quick, str(tmp_path), "cuda", run=got)
    assert len(got.calls) == len(ref.calls) == (6 if quick else 15)
    for (rargv, rkw), (gargv, gkw) in zip(ref.calls, got.calls):
        script = Path(rargv[1]).stem
        assert gargv[1:3] == ["-m", f"cronsun_tpu_torch.scripts.{script}"]
        rargs, gargs = rargv[2:], gargv[3:]
        if "--out" in rargs:        # the sidecar: beside the detail file
            i = rargs.index("--out")
            assert Path(rargs[i + 1]).parent == ROOT
            assert Path(gargs[i + 1]) == tmp_path / Path(rargs[i + 1]).name
            rargs, gargs = rargs[:i] + rargs[i + 2:], gargs[:i] + gargs[i + 2:]
        assert gargs == rargs
        assert gkw["timeout"] == rkw["timeout"]
        assert Path(gkw["cwd"]) == Path(rkw["cwd"]) == ROOT
        assert _env_delta(gkw) == _env_delta(rkw)
        assert gkw["capture_output"] and gkw["text"]
    assert got_detail == ref_detail
    if mode != "ok":                # one error key per plane, in order
        errors = [p.error for p in port.PLANES
                  if port.plane_argv(p, quick, "") is not None]
        assert list(got_detail) == errors


def test_only_planes_with_a_device_flag_get_the_cpu(tmp_path):
    """``--device cpu`` goes to the planes whose script takes it, and only
    on a CPU run."""
    for plane in port.PLANES:
        src = (ROOT / "cronsun_tpu_torch" / "scripts"
               / f"{plane.script}.py").read_text()
        assert plane.device == ('"--device"' in src), plane.name
        argv = port.plane_argv(plane, False, str(tmp_path), "cpu")
        assert (argv[-2:] == ["--device", "cpu"]) is plane.device
        assert "--device" not in port.plane_argv(plane, False,
                                                 str(tmp_path), "cuda")


# ---- (c) config 2 ----------------------------------------------------------

def _bench_py_specs(quick: bool) -> list:
    """Config 2's specs as ``bench.py:171-302`` draws them: default_rng(0),
    then w_eq, the equality loads per scale, and per timed scale its loads
    and weights, then the mix."""
    ref = np.random.default_rng(0)
    ref.random(2048)
    scales = [10240] + ([] if quick else [102400])
    for n in scales:
        ref.integers(0, 4, n)
    for n in scales:
        ref.integers(0, 4, n)
        ref.random(2048)
    return bench_mixed_specs(10_000, rng=ref)


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_config2_specs_are_drawn_in_bench_py_s_order(quick, monkeypatch):
    drawn = []
    monkeypatch.setattr(port, "config2",
                        lambda specs, q, dev: (drawn.append(specs) or {}, []))
    for name in ("stream_sync_floor", "kernel_cells", "config1"):
        monkeypatch.setattr(port, name, lambda *a, **kw: {})
    monkeypatch.setattr(port, "kernel_impls", lambda dev: {})
    monkeypatch.setattr(port, "ladder_planner", _Stop.raise_)
    with pytest.raises(_Stop):
        port.run_cells(quick, CPU, detail={"kernels_equal": True,
                                           "rtt_floor_ms": 0.0})
    assert drawn == [_bench_py_specs(quick)]


class _Stop(Exception):
    @staticmethod
    def raise_(*a, **kw):
        raise _Stop


def test_config2_matches_jax_next_fire():
    specs = _bench_py_specs(True)
    keys, values = port.config2(specs, True, CPU)
    table = jax_st.build_table([jax_parse(s) for s in specs],
                               phase_epoch_s=port.T0)
    assert len(values) == 3
    for i, got in enumerate(values):
        want = np.asarray(jax_tick.next_fire(table, port.T0 + i * 37))
        np.testing.assert_array_equal(got, want)
    assert keys["c2_10k_nextfire_resolved"] == int((want >= 0).sum())
    assert set(keys) == {"c2_10k_nextfire_p50_ms", "c2_10k_nextfire_resolved"}


# ---- (d) ladder and headline against the JAX planner -----------------------

class Recorder:
    """Records a port planner's window dispatches and gathers, in order,
    to replay them on a JAX planner."""

    def __init__(self, p):
        self.events, self._ids = [], {}
        # every handle is held, so no two of them share an id()
        self._held = []
        dispatch, gather = p.plan_window_async, p.gather_window

        def plan_window_async(epoch_s, window_s, sla_bucket=None):
            h = dispatch(epoch_s, window_s, sla_bucket)
            self._held.append(h)
            self._ids[id(h)] = len(self._ids)
            self.events.append(("dispatch", self._ids[id(h)],
                                (epoch_s, window_s, sla_bucket)))
            return h

        def gather_window(h):
            plans = gather(h)
            self.events.append(("gather", self._ids[id(h)], plans))
            return plans
        p.plan_window_async, p.gather_window = plan_window_async, \
            gather_window

    def replay(self, jp) -> int:
        """The same calls on ``jp``; every window's plans equal.  Returns
        the planned seconds compared."""
        handles, seconds = {}, 0
        for kind, i, arg in self.events:
            if kind == "dispatch":
                epoch_s, window_s, sla = arg
                handles[i] = jp.plan_window_async(epoch_s, window_s,
                                                  sla_bucket=sla)
            else:
                assert_plans_equal(jp.gather_window(handles.pop(i)), arg)
                seconds += len(arg)
        assert not handles
        return seconds


def test_ladder_fires_what_the_jax_planner_fires():
    rng = np.random.default_rng(0)
    _, J, N, rate, caps, bucket = TINY.ladders[1]
    bucket = port.split_bucket(bucket)
    p = port.ladder_planner(rng, J, N, rate, caps, bucket, CPU)
    jp = jax_planner_from_state(planner_to_numpy(p),
                                max_fire_bucket=max(bucket))
    rec = Recorder(p)
    keys = port.ladder("c4_100kx1k", p, bucket, 6)
    assert keys["c4_100kx1k_fired_per_tick"] > 0
    # 3 warm-up, 6 sustained and 5 sync ticks, then the counted one
    assert rec.replay(jp) == 15


def test_headline_fires_what_the_jax_planner_fires():
    rng = np.random.default_rng(0)
    p = port.headline_planner(rng, CPU, TINY)
    assert (p.J, p.N) == (4096, 256)
    jp = jax_planner_from_state(planner_to_numpy(p),
                                max_fire_bucket=TINY.headline_bucket)
    rec = Recorder(p)
    keys, p99 = port.headline(p, True, TINY.sla)
    assert keys["headline_window_samples"] == 9 and p99 > 0
    # 2 warm-up and 12 timed windows of 8 s, then the counted second
    assert rec.replay(jp) == 14 * 8 + 1


# ---- (e) the kernel cell's comparison, (f) no card ------------------------

def _planted(kind):
    bid, fan = kernels.bid_argmin, kernels.fanout_add

    def bid_argmin(packed, load):
        best, choice = bid(packed, load)
        if kind == "choice":
            choice = choice.clone()
            choice[3] += 1
        elif kind == "best":
            best = best.clone()
            best[3] += 1e-3
        return best, choice

    def fanout_add(packed, w):
        out = fan(packed, w)
        if kind == "fanout":
            out = out.clone()
            out[5] += 0.5
        return out
    return bid_argmin, fanout_add


@pytest.mark.parametrize("kind", ["none", "choice", "best", "fanout"])
def test_kernels_equal_reports_a_planted_difference(kind, monkeypatch):
    rng = np.random.default_rng(3)
    eq, _ = port.kernel_inputs(rng, True, CPU, TINY)
    bid, fan = _planted(kind)
    monkeypatch.setattr(kernels, "bid_argmin", bid)
    monkeypatch.setattr(kernels, "fanout_add", fan)
    _, packed, load, w = eq[0]
    assert port.kernels_equal(packed, load, w) is (kind == "none")


def test_no_card_exits_1_with_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "cronsun_tpu_torch.scripts.bench", "--quick",
         "--detail", os.devnull], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    assert proc.returncode == 1, proc.stderr
    assert proc.stdout == "" and "device='cpu'" in proc.stderr


def test_main_refuses_cuda_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port.main(["--quick"]) == 1
    assert capsys.readouterr().out == ""
