"""The planner's spans against the profiler on the card: one window of the
headline shape (2^20 jobs x 10240 nodes, buckets of 16384, two rounds,
W = 8) counts as many ``cronsun.sync`` spans as the profiler counts
``cudaStreamSynchronize`` calls inside its ``cronsun.plan.dispatch`` — one,
the window's upload of its field matrix, since every accept round is one
kernel launch that reads nothing back — so a new read-back on the path
fails here; and every span lies on the profiler's clock.  Needs an NVIDIA GPU; without one every test here skips.
On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_spans_cuda.py
"""

import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cronsun_tpu_torch.convert import planner_from_numpy
from cronsun_tpu_torch.ops import spans
from cronsun_tpu_torch.synth import synth_state
from test_torch_spans import assert_on_profiler_clock

pytestmark = pytest.mark.cuda

T0 = 1_753_000_000
W = 8


@pytest.fixture(scope="module")
def headline():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    state = synth_state(1 << 20, 10240, seed=3, specs=None, node_cap=1 << 20)
    p = planner_from_numpy(state, device="cuda", max_fire_bucket=1 << 20)
    del state
    for i in range(2):          # builds the kernels, fills the caches
        p.gather_window(p.plan_window_async(T0 + W * i, W,
                                            sla_bucket=(16384, 16384)))
    torch.cuda.synchronize()
    return p


def _traced_window(p, tmp_path, epoch):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p.gather_window(p.plan_window_async(epoch, W,
                                            sla_bucket=(16384, 16384)))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    win = p.spans.windows()[-1]
    assert win.id[1] == epoch and win.profiled
    return doc, win


def test_each_stream_wait_in_a_dispatch_is_a_sync_span(headline, tmp_path):
    doc, win = _traced_window(headline, tmp_path, T0 + 2 * W)
    ev = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    dispatch = sorted((e["ts"], e["ts"] + e["dur"], e.get("tid")) for e in ev
                      if e.get("cat") == "user_annotation"
                      and e["name"] == "cronsun.plan.dispatch")
    assert len(dispatch) == 1
    a, b, tid = dispatch[0]
    calls = collections.Counter(
        e["name"] for e in ev if e.get("cat") == "cuda_runtime"
        and e.get("tid") == tid and a <= e["ts"] <= b)
    n_sync = sum(1 for s in win.spans() if s.name == spans.SYNC)
    assert n_sync == calls["cudaStreamSynchronize"], calls
    assert n_sync == 1


def test_spans_lie_on_the_profilers_clock(headline, tmp_path):
    doc, win = _traced_window(headline, tmp_path, T0 + 3 * W)
    assert_on_profiler_clock(headline.spans, [win], doc)
