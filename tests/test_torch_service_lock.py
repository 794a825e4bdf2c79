"""The port planner serializes window dispatch against state writes.

The scheduler service dispatches windows on its plan-dispatch thread (and
warms on another) while its step thread scatters watch deltas into the
planner.  The port writes its state in place and issues a window op by op,
so without the planner's lock a write issued mid-window lands between two
of its seconds: the window plans half on the old state and half on the
new, which the JAX planner (whose setters build new arrays) never does.

Here a setter thread hammers ``set_eligibility_rows`` and
``update_table_rows`` between two states of each while the main thread
dispatches windows: every gathered window must equal the plan of one of
the four states it can see whole.  ``tests/test_torch_cuda.py`` runs the
same check on the card, where the writes and the windows share the
planner's stream.
"""

import sys
import threading

import numpy as np

from cronsun_tpu_torch.ops.planner import TickPlanner
from cronsun_tpu_torch.ops.schedule_table import make_row
from torch_parity import one_torch_thread  # noqa: F401

J, N, W, K = 128, 64, 8, 128
WINDOWS = 40
TABLE_ROWS = 16    # rows the table writes switch (each write is per row)
T = 1_753_000_000


def _planner(device):
    p = TickPlanner(J, N, device=device, max_fire_bucket=K)
    rows = np.arange(J)
    p.update_table_rows(rows, [make_row("@every 1s")] * J)
    p.set_job_meta(rows, np.ones(J, bool), np.ones(J, np.float32))
    return p, rows


# two states each of eligibility (the low or the high half of the nodes)
# and of the table (every row each second, or every other second)
ELIG = [np.tile(np.array(w, np.uint32), (J, 1))
        for w in ([0xFFFFFFFF, 0], [0, 0xFFFFFFFF])]
TABLE = [[make_row(spec)] * TABLE_ROWS for spec in ("@every 1s", "@every 2s")]


def _window(p):
    """Plan one window from fresh capacities; its (fired, assigned) per
    second."""
    p.set_load(np.zeros(N, np.float32))
    p.set_node_capacity(np.arange(N), np.full(N, 1 << 20))
    plans = p.gather_window(p.plan_window_async(T, W, sla_bucket=K))
    return tuple((pl.fired.tobytes(), pl.assigned.tobytes()) for pl in plans)


def check_windows_see_writes_whole(device):
    p, rows = _planner(device)
    snapshots = {}
    for e in range(2):
        for t in range(2):
            p.set_eligibility_rows(rows, ELIG[e])
            p.update_table_rows(rows[:TABLE_ROWS], TABLE[t])
            snapshots[_window(p)] = (e, t)
    assert len(snapshots) == 4
    stop = threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            p.set_eligibility_rows(rows, ELIG[(i + 1) // 2 % 2])
            p.update_table_rows(rows[:TABLE_ROWS], TABLE[i // 2 % 2])
            i += 1
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    th = threading.Thread(target=hammer, daemon=True)
    th.start()
    seen, torn = set(), 0
    try:
        for _ in range(WINDOWS):
            got = _window(p)
            if got in snapshots:
                seen.add(snapshots[got])
            else:
                torn += 1
    finally:
        stop.set()
        th.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not th.is_alive()
    assert torn == 0, f"{torn} of {WINDOWS} windows planned on a torn state"
    assert len(seen) >= 2, "the setter never ran between dispatches"


def test_a_window_sees_each_write_whole():
    check_windows_see_writes_whole("cpu")
