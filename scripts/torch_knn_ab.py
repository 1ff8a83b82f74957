#!/usr/bin/env python3
"""Time the port's KNN kernel pair of two checkouts on one card, in turns.

    python3 scripts/torch_knn_ab.py --root A --root B [--order ABBA] [--out F]

Each turn is its own process (``--child ROOT``): it imports
``pathway_tpu_torch`` from ROOT (building ROOT's kernels there), makes the
kernels phase's index of ``chip_smoke.py`` (cap 2^20 unit rows of d 384
from a seeded ``torch.Generator``, 1 % invalid) and times, at each case
(Q, k) and precision, the partial kernel on ROOT's own plan, the merge's
device time (torch.profiler) and the pair ``fused_topk_scores`` on CUDA
events; the partial kernel alone over k at one plan (``SWEEP``); and a
four-shard gather search beside one shard's (``SHARDED``), with the
kernels that took most. Each turn also reports the registers and spill
bytes that ptxas gave each partial-kernel instance in ROOT's build log. The parent prints one JSON line a turn, then a
summary: each root's median a case and the ratio to the first root.
Order the turns parent, change, change, parent (``ABBA``) so that a
drift of the card over the call falls on both sides.

It needs one CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAP, DIM = 1 << 20, 384
CASES = ((1, 10), (32, 10), (256, 10), (32, 1024), (1, 8192))
PRECISIONS = ("highest", "default")
# the partial kernel alone at one plan (128 splits of 8,192 rows, that of
# Q = 1 and 32 at every k) over k: what grows with k at a fixed read
SWEEP_ROWS = 8192
SWEEP = tuple((q, k) for q in (1, 32) for k in (10, 64, 256, 1024, 2048, 4096, 8192))
# the four-shard gather beside one shard, at the large-k cases
SHARDS = 4
SHARDED = ((1, 8192), (32, 1024))


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, names: tuple, reps: int) -> float:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)) / reps


def partial_usage(root: str) -> dict:
    """"queries a CTA,passes" (and ",1" or ",0" where ROOT's kernel has
    the k > 32 flag) -> registers and spill bytes of ROOT's partial-kernel
    instances, from its build log (parsed by this checkout's
    ``chip_smoke.py``, loaded by path so that ROOT's package stays the one
    imported)."""
    spec = importlib.util.spec_from_file_location("_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    usage = smoke.partial_usage(os.path.join(root, "pathway_tpu_torch", "_build"))
    return {",".join(str(int(x)) for x in key): use for key, use in sorted(usage.items())}


def kernel_sums(fn, reps: int = 10) -> tuple[float, dict]:
    """Device ms of one call (torch.profiler): the sum over its kernels,
    and the six kernels that took most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name[:48]] = by.get(e.name[:48], 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return sum(by.values()), dict(sorted(by.items(), key=lambda kv: -kv[1])[:6])


def sharded_rows(db, gen) -> list:
    """``chip_smoke.py``'s sharded phase in small: a ``KnnShard`` and a
    four-shard ``ShardedKnnIndex`` on the one card over the same rows,
    every 100th removed; at each ``SHARDED`` case the single shard's
    ``topk`` and ``sharded_topk`` with the gather merge, on CUDA events
    and as the sum of their kernels' device time, with the kernels that
    took most."""
    import torch

    import pathway_tpu_torch as pt
    from pathway_tpu_torch.parallel import ShardedKnnIndex, make_mesh
    from pathway_tpu_torch.parallel import sharded_knn as sk

    mesh = make_mesh(devices=["cuda:0"] * SHARDS, axes=("dp",), shape=(SHARDS,))
    sharded = ShardedKnnIndex(DIM, mesh)
    single = pt.KnnShard(DIM, "cos", capacity=CAP)
    step = 1 << 16
    for start in range(0, CAP, step):
        for index in (single, sharded):
            index.add(range(start, start + step), db[start:start + step])
    removed = list(range(0, CAP, 100))
    single.remove(removed)
    sharded.remove(removed)
    used = sharded.rows_in_use()
    out = []
    for Q, k in SHARDED:
        q = torch.randn((Q, DIM), generator=gen, device="cuda")
        q = (q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)).contiguous()
        fns = {
            "sharded_single": lambda: single.topk(q, k, "dot"),
            "sharded_gather": lambda: sk.sharded_topk(
                q, [v[:u] for v, u in zip(sharded.vectors, used)],
                [m[:u] for m, u in zip(sharded.valid, used)], k,
                merge="gather", local_cap=sharded.local_cap),
        }
        for name, fn in fns.items():
            total, top = kernel_sums(fn)
            out.append({"Q": Q, "k": k, "precision": name, "events_ms": cuda_ms(fn, 10),
                        "kernel_sum_ms": total, "top": top})
    return out


def child(root: str, seed: int) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_knn_ab: no CUDA device")
    sys.path.insert(0, os.path.abspath(root))
    from pathway_tpu_torch.ops import fused_knn as fk

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((CAP, DIM), generator=gen, device="cuda")
    db = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    del x
    valid = torch.rand(CAP, generator=gen, device="cuda") > 0.01
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    merges = ("merge_kernel", "cut_kernel", "place_kernel")
    rows_out = []
    for Q, k in CASES:
        q = torch.randn((Q, DIM), generator=gen, device="cuda")
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        rows, splits = fk.plan_splits(Q, CAP, k, n_sm)
        for precision in PRECISIONS:
            p = {"precision": precision}
            part_v, part_i = fk.knn_partial(q, db, valid, k, rows, **p)
            row = {"Q": Q, "k": k, "precision": precision, "splits": splits,
                   "partial_ms": cuda_ms(lambda: fk.knn_partial(q, db, valid, k, rows, **p), 10),
                   "pair_ms": cuda_ms(lambda: fk.fused_topk_scores(q, db, valid, k, **p), 10)}
            if splits > 1:
                row["merge_device_ms"] = device_ms(
                    lambda: fk.topk_merge(part_v, part_i, k), merges, 20)
            rows_out.append(row)
            del part_v, part_i
    for Q, k in SWEEP:
        q = torch.randn((Q, DIM), generator=gen, device="cuda")
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        rows_out.append({"Q": Q, "k": k, "precision": f"sweep_rows_{SWEEP_ROWS}",
                         "partial_ms": cuda_ms(
                             lambda: fk.knn_partial(q, db, valid, k, SWEEP_ROWS), 10)})
    rows_out += sharded_rows(db, gen)
    return {"root": root, "device": torch.cuda.get_device_name(0),
            "partial_usage": partial_usage(root), "rows": rows_out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=[])
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--child")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.seed)), flush=True)
        return 0
    if len(args.root) < 2:
        ap.error("give two --root checkouts")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    turns = []
    for letter in args.order:
        root = args.root[ord(letter) - ord("A")]
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                              "--seed", str(args.seed)],
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            sys.stderr.write(out.stderr)
            raise SystemExit(f"torch_knn_ab: the turn on {root} failed")
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    summary = {}
    for turn in turns:
        for r in turn["rows"]:
            key = f'{r["Q"]},{r["k"]},{r["precision"]}'
            for metric in ("partial_ms", "pair_ms", "merge_device_ms", "events_ms",
                           "kernel_sum_ms"):
                if metric in r:
                    summary.setdefault(key, {}).setdefault(metric, {}).setdefault(
                        turn["root"], []).append(r[metric])
    import statistics

    table = {}
    for key, metrics in summary.items():
        table[key] = {}
        for metric, by_root in metrics.items():
            med = {root: statistics.median(v) for root, v in by_root.items()}
            base = med.get(args.root[0])
            table[key][metric] = {**med, **({"ratio": {r: m / base for r, m in med.items()}}
                                            if base else {})}
    usage = {turn["root"]: turn["partial_usage"] for turn in turns}
    result = {"card": smi, "order": args.order, "roots": args.root,
              "partial_usage": usage, "summary": table}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"turns": turns, **result}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
