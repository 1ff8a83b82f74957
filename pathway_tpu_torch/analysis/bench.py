"""Canonical bench pipeline builders shared by the plan-doctor CLI
(``--bench`` verdict annotation), the analyzer-vs-runtime agreement tests
and ad-hoc triage. Each builder clears the global ParseGraph, constructs
the same graph SHAPE as scripts/bench_relational.py (same schemas, same
operators — sizes are parameters) and returns the pipeline handle; the
caller decides whether to analyze it statically, run it, or both.

The point: when a perf regression lands, ``python -m pathway_tpu_torch.analysis
--bench`` says whether the plan still lowers fused — "plan degraded" vs
"engine slower" triage without re-running the full bench.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class BenchPipeline:
    name: str
    out: Any                       # the terminal table
    subjects: list = field(default_factory=list)
    collected: dict = field(default_factory=dict)


def _subscribe_counting(pw, table, collected):
    state: dict = {}

    def on_change(key, row, time_, is_add):
        if is_add:
            state[key] = row
        else:
            state.pop(key, None)

    pw.io.subscribe(table, on_change=on_change)
    collected["rows"] = state
    return state


def build_wordcount(n_rows: int = 600, distinct: int = 7) -> BenchPipeline:
    """parse → groupby(count) — the flagship fused chain."""
    import pathway_tpu_torch as pw

    pw.internals.parse_graph.G.clear()
    words = [f"word{i}" for i in range(distinct)]
    rows = [
        {"data": words[(i * 2654435761) % distinct]} for i in range(n_rows)
    ]

    class Source(pw.io.python.ConnectorSubject):
        _deletions_enabled = False
        _distributed_partitioned = True

        def run(self):
            for s in range(0, len(rows), 200):
                self.next_batch(rows[s : s + 200])
                self.commit()

    class S(pw.Schema):
        data: str

    src = Source()
    t = pw.io.python.read(src, schema=S, autocommit_duration_ms=3_600_000)
    counts = t.groupby(pw.this.data).reduce(
        word=pw.this.data, c=pw.reducers.count()
    )
    bp = BenchPipeline("wordcount", counts, [src])
    _subscribe_counting(pw, counts, bp.collected)
    return bp


def build_stream_join(n_rows: int = 400, n_keys: int = 20) -> BenchPipeline:
    """parse → join → plain-column select — the fused delta-join chain."""
    import pathway_tpu_torch as pw

    pw.internals.parse_graph.G.clear()

    class L(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        j: int
        v: int

    class R(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        j: int
        w: int

    left_rows = [
        {"k": i, "j": (i * 2654435761) % n_keys, "v": i}
        for i in range(n_rows)
    ]
    right_rows = [{"k": i, "j": i % n_keys, "w": i} for i in range(n_keys * 2)]

    class LS(pw.io.python.ConnectorSubject):
        _deletions_enabled = False
        _distributed_partitioned = True

        def run(self):
            for s in range(0, len(left_rows), 100):
                self.next_batch(left_rows[s : s + 100])
                self.commit()

    class RS(pw.io.python.ConnectorSubject):
        _deletions_enabled = False
        _distributed_partitioned = True

        def run(self):
            self.next_batch(right_rows)
            self.commit()

    ls, rs = LS(), RS()
    lt = pw.io.python.read(ls, schema=L, autocommit_duration_ms=None)
    rt = pw.io.python.read(rs, schema=R, autocommit_duration_ms=None)
    out = lt.join(rt, pw.left.j == pw.right.j).select(
        v=pw.left.v, w=pw.right.w
    )
    bp = BenchPipeline("stream_join", out, [ls, rs])
    _subscribe_counting(pw, out, bp.collected)
    return bp


def build_groupby(n_rows: int = 500, distinct: int = 9) -> BenchPipeline:
    """parse → groupby(sum+count) — multi-reducer abelian store."""
    import pathway_tpu_torch as pw

    pw.internals.parse_graph.G.clear()
    rows = [
        {"g": f"g{(i * 31) % distinct}", "v": i % 100} for i in range(n_rows)
    ]

    class Source(pw.io.python.ConnectorSubject):
        _deletions_enabled = False
        _distributed_partitioned = True

        def run(self):
            for s in range(0, len(rows), 150):
                self.next_batch(rows[s : s + 150])
                self.commit()

    class S(pw.Schema):
        g: str
        v: int

    src = Source()
    t = pw.io.python.read(src, schema=S, autocommit_duration_ms=3_600_000)
    agg = t.groupby(pw.this.g).reduce(
        g=pw.this.g, s=pw.reducers.sum(pw.this.v), c=pw.reducers.count()
    )
    bp = BenchPipeline("groupby", agg, [src])
    _subscribe_counting(pw, agg, bp.collected)
    return bp


def build_transform(n_rows: int = 300) -> BenchPipeline:
    """static table → 4-expression select — the rowwise expression plane
    (a TUPLE plan by construction: static sources have no columnar
    door; its bench verdict documents exactly that)."""
    import pathway_tpu_torch as pw

    pw.internals.parse_graph.G.clear()
    rows = [(i, i % 1000, (i * 7) % 997 + 1) for i in range(n_rows)]
    t = pw.debug.table_from_rows(
        pw.schema_from_types(i=int, a=int, b=int), rows
    )
    out = t.select(
        s=pw.this.a + pw.this.b,
        d=pw.this.a - pw.this.b,
        q=pw.this.a // pw.this.b,
        c=(pw.this.a > pw.this.b) & (pw.this.b > 10),
    )
    bp = BenchPipeline("transform", out, [])
    _subscribe_counting(pw, out, bp.collected)
    return bp


def build_serving() -> BenchPipeline:
    """rest-gateway serving shape: REST source → select → batched
    response sink (graph construction only — the webserver binds no
    port until run). The verdict documents the serving plan's relational
    shape (a tuple source: request rows are Python dicts with removes;
    the device work lives in the index adapter, not the fused chain) and
    pins that the response egress is the BATCHED sink — a
    ``sink.row-expanding`` diagnostic here is a serving regression."""
    import pathway_tpu_torch as pw

    pw.internals.parse_graph.G.clear()

    class S(pw.Schema):
        value: int

    webserver = pw.io.http.PathwayWebserver(host="127.0.0.1", port=0)
    queries, writer = pw.io.http.rest_connector(
        webserver=webserver, schema=S
    )
    out = queries.select(result=pw.this.value)
    writer(out)
    return BenchPipeline("serving", out, [])


BENCH_PIPELINES: dict[str, Callable[[], BenchPipeline]] = {
    "wordcount": build_wordcount,
    "stream_join": build_stream_join,
    "groupby": build_groupby,
    "transform": build_transform,
    "serving": build_serving,
}

# BENCH_full.json metric name -> (pipeline, analysis world size)
BENCH_METRIC_PLANS: dict[str, tuple[str, int]] = {
    "wordcount_rows_per_s": ("wordcount", 1),
    "wordcount_2rank_rows_per_s": ("wordcount", 2),
    "stream_join_rows_per_s": ("stream_join", 1),
    "transform_rows_per_s": ("transform", 1),
    "rag_colocated_qps": ("serving", 1),
}

# BENCH_full.json DEVICE metric name -> Device Doctor chain whose static
# verdict annotates the line: the ingest lanes dispatch
# through ingest.fused, the query/recall lanes through the KNN scan,
# and the trace-overhead lane through the bare encoder forward
BENCH_DEVICE_METRIC_CHAINS: dict[str, str] = {
    "preflight_ingest": "ingest",
    "embed_ingest_docs_per_s_per_chip": "ingest",
    "embed_ingest_fused_docs_per_s_per_chip": "ingest",
    "rag_query_p50_ms": "knn",
    "rag_under_load_p50_ms": "knn",
    "rag_qps_vs_clients": "knn",
    "rag_latency_model": "knn",
    "rag_colocated_qps": "knn",
    "rag_update_while_serving_p50_ms": "knn",
    "ann_recall_at_10": "knn",
    "device_trace_overhead": "encoder",
}


def device_chain_verdicts() -> dict[str, str]:
    """One Device Doctor run; per-chain verdict keyed by chain name."""
    from pathway_tpu_torch.analysis.device_plan import analyze_device_plan

    return dict(analyze_device_plan().chains)


def bench_verdicts() -> dict[str, str]:
    """Plan verdict for every (pipeline, world) the bench artifact
    records, keyed "name@Nrank"."""
    from pathway_tpu_torch.analysis.analyzer import analyze

    out: dict[str, str] = {}
    seen: dict[tuple[str, int], str] = {}
    for metric, (name, world) in BENCH_METRIC_PLANS.items():
        key = (name, world)
        if key not in seen:
            bp = BENCH_PIPELINES[name]()
            seen[key] = analyze(bp.out, processes=world).verdict
        out[f"{name}@{world}rank"] = seen[key]
    # pipelines not in the artifact mapping still get a verdict line
    for name, build in BENCH_PIPELINES.items():
        if not any(n == name for n, _ in BENCH_METRIC_PLANS.values()):
            bp = build()
            out[f"{name}@1rank"] = analyze(bp.out, processes=1).verdict
    return out


def write_artifact_atomic(path: str, artifact: list[dict]) -> None:
    """Rewrite a bench artifact via temp-file + rename so a crash
    mid-write can never truncate previously recorded metrics (the port's
    copy of the repository's ``bench_util`` writer). A failed write (full
    disk, permissions) is logged loudly and the temp file is cleaned up;
    the previous artifact version stays intact either way."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".bench_full_", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(artifact, f, indent=1)
        os.replace(tmp, path)
    except OSError as exc:
        import logging

        logging.getLogger(__name__).warning(
            "bench artifact write failed (%s stays stale): %s", path, exc
        )
        try:
            os.unlink(tmp)
        except OSError:
            pass
