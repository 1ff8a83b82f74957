"""The knee sweep of a ``serve`` cell: one set-up, then one open-loop
window at each offered rate, in the order given.

    python3 -m rag_bench.sweep --workload msmarco-serve --seed 7 \\
        --seconds 10 --rates 100,200,400 [--out chiprun_out/sweep.jsonl]

For each rate it prints one JSON line: requests, failures, p50/p95/p99
latency (from when each was due), the generator's largest lag, the
mean queries a batch, and the backlog's growth: the median latency of the
window's last fifth of requests over its first fifth. A rate whose
backlog grows reads a growth well above 1 and a p95 that climbs with the
window's length. The knee is the highest rate that does not.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    from rag_bench import program
    from rag_bench.probe import Probe
    from rag_bench.run import cell_files, load_by_path, manifest

    ap = argparse.ArgumentParser(prog="python3 -m rag_bench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("rag_bench.sweep: no CUDA device", file=sys.stderr)
        return 2
    files = cell_files(manifest(), args.workload)
    with open(files["config"]) as f:
        cfg = json.load(f)
    with open(files["traffic"]) as f:
        tr = json.load(f)
    serve = load_by_path(files["mode"], "rag_bench_mode_serve")
    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    _, encoder, shard, engine, batcher = serve.build(cfg, tr, args.seed, dev)
    print(json.dumps({"setup_s": time.perf_counter() - t, "live_rows": len(shard),
                      "kind": torch.cuda.get_device_name(0)}), flush=True)
    out = open(args.out, "a") if args.out else None
    for j, rate in enumerate(float(r) for r in args.rates.split(",")):
        texts, offsets, _ = serve.schedule(cfg, dict(tr, rate_qps=rate),
                                           args.seed + 1 + j, args.seconds)
        probe = Probe(cfg)
        probe.wrap_engine(engine)
        t0, lat, _, failed, lag, _ = serve.drive(batcher, texts, offsets,
                                                 tr["clients"], tr["timeout_s"])
        span = time.perf_counter() - t0
        probe.close()
        fifth = max(1, len(lat) // 5)
        row = {
            "workload": args.workload, "rate_qps": rate, "seconds": args.seconds,
            "requests": len(texts), "failed": int(failed.sum()),
            "completed_qps": float((~failed).sum() / span),
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "lag_ms": lag * 1e3,
            "queries_per_batch": float(np.mean(probe.batches)) if probe.batches else 0.0,
            "growth": float(np.median(lat[-fifth:]) / np.median(lat[:fifth])),
        }
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
    batcher.close()
    program.synchronize(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
