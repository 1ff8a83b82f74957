#!/usr/bin/env python3
"""One run of a benchmark cell (``rag_bench``) with the port's own spans,
or with the device plane and its flight recorder armed and the profiler
off, for the cost of the spans.

    python3 scripts/rag_spans.py traced --workload W --seed N --seconds S [--out F]
    python3 scripts/rag_spans.py armed  --workload W --seed N --seconds S

``traced`` runs the cell as ``--trace 1`` does, with three changes to the
harness made here, in this process: the probe arms the device plane with
an in-memory ``FlightRecorder`` and keeps its events at ``close`` as
``probe.program``; the idle gaps of the device are named after the
program's thread-bound spans too (``rag_bench/spans.py thread_spans``).
It prints the cell's result line, then one JSON line of what the spans
show (also written to ``--out``): each span's count, mean, median, 95th
percentile and off-CPU share; the readers of ``rag_bench/metrics`` that
read the spans; the program's tokenizer span and batch size beside the
harness's; a served request's time split at the batch's spans; the depth
of the device queue at launch; the mean rows a search scanned
(``knn.launch``'s ``rows``) and their share of the shard's capacity; and,
by second of the window, the batches' sizes, host times, encoder buckets,
query-tile instances and rows scanned.

``armed`` runs the cell as ``--trace 0`` does, with the plane and a
recorder armed from the start: its end-to-end metrics beside a plain
``--trace 0`` run of the same seed are the spans' and records' cost.

``--tiny`` runs the cell at the tests' CPU geometry
(``rag_bench/tests/tiny.py``), for the tests; without it the cell needs a
CUDA card.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SPAN_READERS = ("batcher.queue_wait_p95_ms.serve", "dispatch.host_ms.serve",
                "dispatch.offcpu_pct.serve", "encoder.h2d_ms.serve",
                "readback.wait_ms.serve", "finish.keymap_ms.serve",
                "device.queue_depth.serve", "ingest.starved_ms",
                "ingest.blocked_ms")


def patch_harness(state: dict):
    """The probe arms the plane with a recorder and keeps its events; the
    device's idle gaps are named after the program's spans too. Returns
    the function that takes the patches off."""
    from pathway_tpu_torch.internals.device import PLANE
    from pathway_tpu_torch.internals.flight import FlightRecorder
    from pathway_tpu_torch.internals.monitoring import ProberStats
    from rag_bench import devtrace, spans
    from rag_bench.probe import Probe

    arm0, close, read = Probe.arm, Probe.close, devtrace.Profile.read

    def arm(self):
        self._stats = ProberStats()
        self._recorder = FlightRecorder("")
        PLANE.arm(self._recorder, self._stats)
        self._undo.append(PLANE.disarm)
        state["probe"] = self

    def kept(self):
        close(self)  # the plane delivers its pending records first
        self.program = list(self._recorder.events)

    def named(self, own=()):
        return read(self, list(own) + spans.thread_spans(state["probe"]))

    Probe.arm, Probe.close, devtrace.Profile.read = arm, kept, named

    def undo():
        Probe.arm, Probe.close, devtrace.Profile.read = arm0, close, read

    return undo


def _quantiles(xs: list[float]) -> dict:
    import numpy as np

    if not xs:
        return {"count": 0}
    a = np.asarray(xs)
    return {"count": len(xs), "mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)), "sum_s": float(a.sum()) / 1e3}


def summary(probe, workload: str) -> dict:
    """What the program's spans of a traced window show (module doc)."""
    from rag_bench import run, spans

    by_name: dict[str, list] = collections.defaultdict(list)
    for e in probe.program:
        if e[0] == "span":
            by_name[e[1]].append(e[3:])
    per_span = {}
    for name, got in sorted(by_name.items()):
        row = _quantiles([(t1 - t0) / 1e6 for t0, t1, *_ in got])
        wall = sum(t1 - t0 for t0, t1, *_ in got)
        if got[0][2] is not None and wall > 0:
            row["offcpu_pct"] = 100.0 * sum(
                (t1 - t0) - min(c, t1 - t0) for t0, t1, c, *_ in got) / wall
        per_span[name] = row
    readers = {}
    for name in SPAN_READERS:
        mod = run.load_by_path(os.path.join(run.HERE, "metrics", f"{name}.py"),
                               "spans_" + name.replace(".", "_"))
        readers[name] = mod.read(probe)
    disp = [e for e in probe.program if e[0] == "disp"]
    out = {
        "workload": workload,
        "spans": per_span,
        "readers": readers,
        "queue_depth_at_launch": dict(sorted(collections.Counter(
            f"{e[1]}:{e[11]}" for e in disp).items())),
        "dispatch_records_with_trace_id": sum(e[-1] is not None for e in disp),
        "dispatch_records": len(disp),
        "idle_gaps": (probe.profile or {}).get("idle_gaps"),
        "busy_s": (probe.profile or {}).get("busy_s"),
        "window_s": (probe.profile or {}).get("window_s"),
    }
    if probe.tokenize:
        out["agreement"] = {
            "tokenize_ms": [spans.mean_ms(probe, "serve.tokenize")
                            or spans.mean_ms(probe, "ingest.tokenize"),
                            1e3 * sum(t for t, _ in probe.tokenize) / len(probe.tokenize)],
        }
    dispatch = by_name.get("serve.dispatch", [])
    if dispatch and probe.batches:
        out["agreement"]["queries_per_batch"] = [
            sum(a["n"] for *_, a in dispatch) / len(dispatch),
            sum(probe.batches) / len(probe.batches)]
        out["request"] = request_split(by_name)
        out["by_second"] = by_second(by_name)
    rows = _mean([a["rows"] for *_, a in by_name.get("knn.launch", [])])
    if rows is not None:
        cap = probe.cfg["deployment"]["capacity"]
        out["knn_scan"] = {"rows": rows, "capacity": cap, "scanned_share": rows / cap}
    return out


def _mean(xs: list) -> float | None:
    return sum(xs) / len(xs) if xs else None


def request_split(by_name: dict) -> dict:
    """Mean milliseconds of a served request in each stretch between the
    batch's spans: queued, the rest of the batching window after it was
    taken, the dispatch, the wait for a readback thread, the finish, the
    hand-off to the client, and the whole from its queueing to its
    hand-off."""
    one = {name: {s[3]: s for s in by_name.get(name, [])}
           for name in ("serve.collect", "serve.dispatch", "serve.ticket_wait",
                        "serve.finish")}
    hand = collections.defaultdict(list)
    for s in by_name.get("serve.handoff", []):
        hand[s[3]].append(s)
    parts = collections.defaultdict(list)
    for t0, t1, _, b, _ in by_name.get("serve.queue_wait", []):
        if not all(b in v for v in one.values()) or not hand[b]:
            continue
        col, dis, tic, fin = (one[n][b] for n in ("serve.collect", "serve.dispatch",
                                                  "serve.ticket_wait", "serve.finish"))
        h = hand[b].pop()
        parts["queued"].append(t1 - t0)
        parts["window_rest"].append(col[1] - t1)
        parts["dispatch"].append(dis[1] - col[1])
        parts["ticket_wait"].append(tic[1] - dis[1])
        parts["finish"].append(fin[1] - tic[1])
        parts["handoff"].append(h[1] - fin[1])
        parts["whole"].append(h[1] - t0)
    return {k: sum(v) / len(v) / 1e6 for k, v in parts.items()} | {
        "requests": len(parts["whole"])}


def by_second(by_name: dict) -> list[dict]:
    """By second of the window: batches, mean queries a batch, mean
    dispatch and readback ms, the dispatch's off-CPU share, and the
    batches of each encoder bucket and query-tile instance, and the mean
    rows a search scanned."""
    dispatch = by_name.get("serve.dispatch", [])
    t_start = min(s[0] for s in dispatch)
    pad = {s[3]: (s[4]["nb"], s[4]["Lb"]) for s in by_name.get("encoder.pad", [])}
    tile = {s[3]: s[4]["tile"] for s in by_name.get("knn.launch", [])}
    scan = {s[3]: s[4]["rows"] for s in by_name.get("knn.launch", [])}
    readback = {s[3]: s[1] - s[0] for s in by_name.get("serve.readback", [])}
    rows = collections.defaultdict(list)
    for s in dispatch:
        rows[int((s[0] - t_start) // 1_000_000_000)].append(s)
    out = []
    for sec in sorted(rows):
        got = rows[sec]
        wall = sum(t1 - t0 for t0, t1, *_ in got)
        out.append({
            "s": sec, "batches": len(got),
            "queries": round(sum(a["n"] for *_, a in got) / len(got), 2),
            "dispatch_ms": round(wall / len(got) / 1e6, 3),
            "offcpu_pct": round(100.0 * sum((t1 - t0) - min(c, t1 - t0)
                                            for t0, t1, c, *_ in got) / wall, 1),
            "readback_ms": round(sum(readback.get(s[3], 0) for s in got)
                                 / len(got) / 1e6, 3),
            "buckets": dict(collections.Counter(
                f"{pad[s[3]][0]}x{pad[s[3]][1]}" for s in got if s[3] in pad)),
            "tiles": dict(collections.Counter(str(tile.get(s[3])) for s in got)),
            "rows": _mean([scan[s[3]] for s in got if s[3] in scan]),
        })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 scripts/rag_spans.py")
    ap.add_argument("how", choices=("traced", "armed"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    cell = ["--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(int(args.how == "traced"))]
    state: dict = {}
    undo = None
    if args.how == "traced":
        undo = patch_harness(state)
    else:
        from pathway_tpu_torch.internals.device import PLANE
        from pathway_tpu_torch.internals.flight import FlightRecorder
        from pathway_tpu_torch.internals.monitoring import ProberStats

        recorder = FlightRecorder("")
        PLANE.arm(recorder, ProberStats())
    from rag_bench import run

    try:
        if args.tiny:
            import torch

            from rag_bench.tests import tiny

            m, parsed, cfg, tr = tiny.cell(args.workload, seconds=args.seconds,
                                           trace=args.how == "traced")
            parsed.seed = args.seed
            rc = run.execute(m, parsed, cfg, tr, torch.device("cpu"), "cpu", _T0)
        else:
            rc = run.main(cell, t_start=_T0)
    finally:
        if undo is not None:
            undo()
    if args.how == "armed":
        PLANE.disarm()
        print(json.dumps({"armed": True, "recorded_events": len(recorder.events),
                          "dropped": recorder.dropped}), flush=True)
        return rc
    got = summary(state["probe"], args.workload)
    text = json.dumps(got)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
