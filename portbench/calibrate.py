"""The readings the limits of ``correct`` are set from, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3
        --seconds 51 [--control-seeds 4,5,6] [--controls bf16_bid,...]
        [--out PATH]

Each of ``--seeds`` is one whole run of the cell (as ``python3 -m
portbench`` makes it) with its checks; then, for each of ``--controls``
(names of :data:`portbench.reference.CONTROLS`), each of
``--control-seeds`` runs that control (the reference in the program's
place with one guarantee broken) over as many seconds as the last program
run planned, through the same checks.  One JSON line per run, to standard
output and ``--out``.  Not part of a benchmark run: the benchmark's
command never calls it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import torch

from . import gen, harness, reference


def _emit(rec: dict, out):
    line = json.dumps(rec)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def control(spec, seed: int, span, device, kind: str = "bf16_load"):
    """The control ``kind`` of a planner cell on ``seed`` over the seconds
    [lo, hi)."""
    cfg, mix = spec.config, spec.traffic
    lo, hi = span
    inp = gen.planner_inputs(cfg, mix, seed, device)
    bucket = tuple(int(x) for x in mix["sla_bucket"])
    seconds, load, rem = reference.control_planner(
        inp, bucket, list(range(lo, hi)), **reference.CONTROLS[kind])
    return reference.check_planner(inp, bucket, seconds, load, rem,
                                   cfg["limits"], seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="bf16_load")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    out = open(args.out, "a") if args.out else None
    dev = torch.device("cuda:0")
    span = None
    try:
        for s in [int(x) for x in args.seeds.split(",") if x]:
            t0 = time.perf_counter()
            line, checks, info = harness.run_cell(
                args.workload, s, args.seconds, False, device=dev, t0=t0)
            span = tuple(info["checked_seconds"])
            _emit({"workload": args.workload, "seed": s, "side": "program",
                   "correct": line["correct"], "checks": line["checks"],
                   "metrics": line["metrics"], "info": info,
                   "device": line["device"],
                   "wall_s": time.perf_counter() - t0}, out)
        spec = harness.cell_spec(args.workload)
        kinds = [k for k in args.controls.split(",") if k]
        seeds = [int(x) for x in args.control_seeds.split(",") if x]
        for kind, s in itertools.product(kinds, seeds):
            t0 = time.perf_counter()
            checks, att, bad = control(spec, s, span, dev, kind)
            _emit({"workload": args.workload, "seed": s, "side": kind,
                   "correct": all(v <= lim for _n, v, lim in checks),
                   "checks": {n: {"value": v, "limit": lim}
                              for n, v, lim in checks},
                   "attempted": att, "failed": bad, "span": list(span),
                   "wall_s": time.perf_counter() - t0}, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
