"""Store server throughput: Python StoreServer vs native cronsun-stored.

Aggregate put/get throughput from N concurrent client *processes* (each
agent in a real deployment is its own process; a single-process client
bench measures the client GIL, not the server).

    python -m cronsun_tpu_torch.scripts.bench_store [--clients 8]
        [--n 3000]

Snapshot write-stall probe — the staggered-imaging claim measured:

    python -m cronsun_tpu_torch.scripts.bench_store --stall-probe
        [--stall-keys 200000]

seeds a WAL-backed store, drives writers at full rate, triggers a
snapshot mid-load and reports the p99 client-visible put latency DURING
the snapshot window (``snapshot_write_stall_p99_ms_*``) for the
full-lock hold vs the staggered per-stripe path, on both backends.
bench.py merges the JSON keys into bench_detail.json.

Copy of ``scripts/bench_store.py`` on the port's modules: the same flags,
JSON keys and output.
"""

import argparse
import json
import multiprocessing as mp
import os
import sys
import tempfile
import threading
import time



def worker(host, port, k, n, q):
    from ..store.remote import RemoteStore
    c = RemoteStore(host, port)
    t0 = time.perf_counter()
    for i in range(n):
        c.put(f"/c{k}/{i % 50}", "x" * 64)
    for i in range(n):
        c.get(f"/c{k}/{i % 50}")
    q.put(2 * n / (time.perf_counter() - t0))
    c.close()


def bench(host, port, label, nclients, n):
    q = mp.Queue()
    ps = [mp.Process(target=worker, args=(host, port, k, n, q))
          for k in range(nclients)]
    t0 = time.perf_counter()
    for p in ps:
        p.start()
    for p in ps:
        p.join()
    total = 2 * nclients * n / (time.perf_counter() - t0)
    print(f"{label}: {total:.0f} ops/s aggregate "
          f"({nclients} client processes)")
    return total


def _stall_server(backend, staggered, wal):
    """A WAL-backed store server of the given backend/imaging mode."""
    if backend == "native":
        from ..store.native import NativeStoreServer, \
            find_binary
        if find_binary() is None:
            return None
        return NativeStoreServer(wal=wal,
                                 snapshot_staggered=staggered)
    from ..store.memstore import MemStore
    from ..store.remote import StoreServer
    store = MemStore(snapshot_staggered=staggered)
    store.open_wal(wal)
    return StoreServer(store=store).start()


def run_stall_probe(backend="py", staggered=True, n_keys=100_000,
                    writers=2, val_bytes=128, on_log=print):
    """One rung: seed ``n_keys``, drive ``writers`` client threads at
    full rate, snapshot mid-load, report the p99 put latency of writes
    that landed INSIDE the snapshot window (the operator-facing stall
    the full-lock hold causes and the staggered path bounds to one
    stripe's copy).  Returns None when the backend is unavailable."""
    from ..store.remote import RemoteStore
    d = tempfile.mkdtemp(prefix="cronsun-stall-")
    srv = _stall_server(backend, staggered, os.path.join(d, "s.wal"))
    if srv is None:
        return None
    lat = []          # (t_start, seconds) per put, all writers
    lat_mu = threading.Lock()
    stop = threading.Event()
    try:
        c = RemoteStore(srv.host, srv.port, timeout=120)
        val = "x" * val_bytes
        items = []
        for i in range(n_keys):
            items.append((f"/seed/{i:07d}", val))
            if len(items) >= 20_000:
                c.put_many(items)
                items = []
        if items:
            c.put_many(items)

        def writer(tid):
            wc = RemoteStore(srv.host, srv.port, timeout=120)
            try:
                i = 0
                mine = []
                while not stop.is_set():
                    t0 = time.perf_counter()
                    wc.put(f"/w/{tid}/{i % 1000}", val)
                    mine.append((t0, time.perf_counter() - t0))
                    i += 1
                with lat_mu:
                    lat.extend(mine)
            finally:
                wc.close()
        ts = [threading.Thread(target=writer, args=(t,))
              for t in range(writers)]
        for t in ts:
            t.start()
        time.sleep(0.5)                    # steady-state write load
        t_snap0 = time.perf_counter()
        rev = c.snapshot()
        t_snap1 = time.perf_counter()
        time.sleep(0.2)
        stop.set()
        for t in ts:
            t.join()
        c.close()
        # the stall signal: puts whose service time OVERLAPS the
        # snapshot window (started before its end, ended after its
        # start)
        window = [dt * 1e3 for (t0, dt) in lat
                  if t0 < t_snap1 and t0 + dt > t_snap0]
        window.sort()
        out = {
            "backend": backend,
            "staggered": bool(staggered),
            "keys": n_keys,
            "snapshot_ms": round((t_snap1 - t_snap0) * 1e3, 1),
            "rev": rev,
            "puts_in_window": len(window),
            "stall_p99_ms": round(
                window[int(len(window) * 0.99)] if window else 0.0, 2),
            "stall_max_ms": round(window[-1] if window else 0.0, 2),
        }
        on_log(f"stall probe {backend} "
               f"{'staggered' if staggered else 'full-lock'}: "
               f"snapshot {out['snapshot_ms']}ms, write stall "
               f"p99 {out['stall_p99_ms']}ms / max "
               f"{out['stall_max_ms']}ms over {len(window)} puts")
        return out
    finally:
        stop.set()
        srv.stop()
        import shutil
        shutil.rmtree(d, ignore_errors=True)


def run_stall_suite(n_keys=100_000, writers=2, on_log=print):
    """All four rungs (backend x imaging mode) -> flat bench keys."""
    out = {}
    for backend in ("py", "native"):
        rungs = {}
        for staggered in (False, True):
            r = run_stall_probe(backend, staggered, n_keys=n_keys,
                                writers=writers, on_log=on_log)
            if r is None:
                on_log(f"stall probe: {backend} backend unavailable")
                break
            mode = "staggered" if staggered else "full"
            rungs[mode] = r
            out[f"snapshot_write_stall_p99_ms_{backend}_{mode}"] = \
                r["stall_p99_ms"]
            out[f"snapshot_ms_{backend}_{mode}"] = r["snapshot_ms"]
        if len(rungs) == 2 and rungs["full"]["stall_p99_ms"] > 0:
            out[f"snapshot_stall_ratio_{backend}"] = round(
                rungs["staggered"]["stall_p99_ms"]
                / rungs["full"]["stall_p99_ms"], 3)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--stall-probe", action="store_true",
                    help="run the snapshot write-stall probe instead of "
                         "the throughput sweep; prints JSON")
    ap.add_argument("--stall-keys", type=int, default=100_000)
    ap.add_argument("--stall-writers", type=int, default=2)
    args = ap.parse_args()

    if args.stall_probe:
        res = run_stall_suite(args.stall_keys, args.stall_writers,
                              on_log=lambda *a: print(*a,
                                                      file=sys.stderr,
                                                      flush=True))
        print(json.dumps(res, indent=1))
        return 0

    from ..store.native import NativeStoreServer
    from ..store.remote import StoreServer

    py = StoreServer().start()
    p = bench(py.host, py.port, "python", args.clients, args.n)
    py.stop()
    nt = NativeStoreServer()
    n = bench(nt.host, nt.port, "native", args.clients, args.n)
    nt.stop()
    print(f"native/python: {n / p:.2f}x")


if __name__ == "__main__":
    mp.set_start_method("fork")
    sys.exit(main())
