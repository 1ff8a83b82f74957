"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m rag_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names its configuration (``configs/<config>.json``) and its
traffic (``traffic/<traffic>.json``); the traffic names its mode
(``modes/<mode>.py``), whose ``run`` sets up, warms up, measures for
``--seconds`` and checks the outputs against the plain reference. With
``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, each read by ``metrics/<name>.py``.
Every number compared is printed beside its limit, last on standard
error and last in the line, under ``checks``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pathway_tpu")


def load_by_path(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_files(m: dict, workload: str, here: str = HERE) -> dict:
    """The cell's entry and the paths of its configuration, traffic and
    mode files, found by name."""
    cell = next((w for w in m["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = next(c for c in m["configs"] if c["name"] == cell["config"])
    traffic = os.path.join(here, "traffic", f"{cell['traffic']}.json")
    with open(traffic) as f:
        mode = json.load(f)["mode"]
    return {
        "cell": cell,
        "config": os.path.join(os.path.dirname(here), conf["file"]),
        "traffic": traffic,
        "mode": os.path.join(here, "modes", f"{mode}.py"),
    }


def end_to_end(m: dict, workload: str) -> list[dict]:
    return [e for e in m["end_to_end"] if workload in e.get("workloads", [workload])]


def per_layer(m: dict, workload: str) -> list[dict]:
    """The per-layer metrics whose ``workloads`` list this cell."""
    return [p for p in m["per_layer"] if workload in p["workloads"]]


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m rag_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    m = manifest()
    files = cell_files(m, args.workload)
    cell = files["cell"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"rag_bench: cell {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with open(files["config"]) as f:
        cfg = json.load(f)
    with open(files["traffic"]) as f:
        traffic = json.load(f)
    return execute(m, args, cfg, traffic, torch.device("cuda", 0),
                   torch.cuda.get_device_name(0), t_start)


def execute(m: dict, args, cfg: dict, traffic: dict, device, kind: str,
            t_start: float) -> int:
    """Everything of a run after the look for a card: the cell's mode,
    the look for JAX, the result line. ``kind``: the device's name."""
    files = cell_files(m, args.workload)
    mode = load_by_path(files["mode"], f"rag_bench_mode_{traffic['mode']}")
    ctx = SimpleNamespace(workload=args.workload, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), cfg=cfg, traffic=traffic, device=device,
              kind=kind, t_start=t_start, chips=files["cell"]["chips"])
    out = mode.run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"rag_bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    return report(m, args, ctx, out)


def report(m: dict, args, ctx, out: dict) -> int:
    checks = out["checks"]  # name -> (value, limit)
    correct = all(v <= lim for v, lim in checks.values())
    metrics = {}
    if ctx.trace:
        probe = out["probe"]
        for p in per_layer(m, args.workload):
            reader = load_by_path(os.path.join(HERE, "metrics", f"{p['name']}.py"),
                                  "rag_bench_metric_" + p["name"].replace(".", "_"))
            v = reader.read(probe)
            if v is not None:
                metrics[p["name"]] = {"value": v, "unit": p["unit"]}
    else:
        for e in end_to_end(m, args.workload):
            metrics[e["name"]] = {"value": out["metrics"][e["name"]], "unit": e["unit"]}
    device = {
        "platform": "gpu",
        "kind": ctx.kind,
        "count": ctx.chips,
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if ctx.trace:
        prof = out["probe"].profile
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        if prof.get("device_ops"):
            line["breakdown"] = {"device_ops": prof["device_ops"],
                                 "idle_gaps": prof["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
