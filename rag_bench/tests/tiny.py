"""A cell cut to a geometry the CPU runs in seconds, for the tests only:
its numbers are never written under a device metric's name."""

from __future__ import annotations

import json
import time

import torch

from rag_bench import run


def cell(workload: str, *, seconds: float = 1.5, trace: bool = False):
    """(manifest, args, cfg, traffic) of ``workload`` at a tiny size."""
    m = run.manifest()
    files = run.cell_files(m, workload)
    with open(files["config"]) as f:
        cfg = json.load(f)
    with open(files["traffic"]) as f:
        tr = json.load(f)
    cfg.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128)
    cfg["deployment"].update(rows=3000, capacity=4096)
    if tr["mode"] == "serve":
        tr.update(rate_qps=40, clients=8, warm_queries=32, timeout_s=3)
        tr["warm"] = {"seq": [16, 32], "batch": [8]}
        tr["check"]["sample"] = 24
    else:
        tr.update(batch=16, warm_batches=1)
        tr["warm"] = {"seq": [128, 160]}
        tr["check"].update(sample=24, prefill_sample=48)
    args = run.parse(["--workload", workload, "--seed", str(2**31 + 77),
                      "--seconds", str(seconds), "--trace", str(int(trace))])
    return m, args, cfg, tr


def execute(workload: str, capsys, **kw) -> tuple[int, dict]:
    """Run the cell on the CPU through ``run.execute``; (exit code, the
    printed result line)."""
    m, args, cfg, tr = cell(workload, **kw)
    rc = run.execute(m, args, cfg, tr, torch.device("cpu"), "cpu", time.perf_counter())
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else {}
