"""The port's plan doctor (``pathway_tpu_torch/analysis/``) against the JAX
package's, on the CPU.

The same programs are built with both packages in one process and
analyzed by each package's ``pw.analyze``: plan verdicts, per-node
verdicts and the diagnostics' codes, severities and node labels must be
equal (only ``where`` paths and the ``schema`` string may differ). The
port's runtime then runs its plan and its fallback counters must agree
with its verdicts (``audit_runtime``), on one rank in process and on two
and four ranks over real loopback meshes. The knob registry, strict mode,
the CLI, the bench verdicts, the FLOP model and the trace analyzers
(``profile``, ``critical_path``) are held the same way.

Hygiene: every test clears both packages' graphs and knob memos, sets
environment variables only through ``monkeypatch``, restores what it
patches on ``Runtime`` in ``finally``, writes only under ``tmp_path``, and
takes its rank ports from this xdist worker's own range.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.analysis import analyzer as jpa
from pathway_tpu.analysis import knobs as jknobs
from pathway_tpu_torch.analysis import analyzer as tpa
from pathway_tpu_torch.analysis import bench as tpb
from pathway_tpu_torch.analysis import eligibility as telig
from pathway_tpu_torch.analysis import knobs as tknobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": jpw, "torch": tpw}


def _nb_toolchain() -> bool:
    try:
        from pathway_tpu.native import get_pwexec as jget
        from pathway_tpu_torch.native import get_pwexec as tget

        return all(
            ex is not None and hasattr(ex, "parse_upserts_nb")
            for ex in (jget(), tget())
        )
    except Exception:
        return False


needs_nb = pytest.mark.skipif(
    not _nb_toolchain(), reason="native toolchain (pwexec) unavailable"
)


def _clear():
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
    for knobs in (jknobs, tknobs):
        knobs._checked = None


@pytest.fixture(autouse=True)
def _fresh():
    _clear()
    yield
    _clear()


# -- the programs, built with either package ---------------------------------


def _connector_pair(pw):
    class L(pw.Schema):
        a: int
        v: int

    class R(pw.Schema):
        b: int
        w: int

    class LS(pw.io.python.ConnectorSubject):
        _deletions_enabled = False

        def run(self):
            self.next_batch([{"a": i, "v": i} for i in range(10)])
            self.commit()

    class RS(pw.io.python.ConnectorSubject):
        _deletions_enabled = False

        def run(self):
            self.next_batch([{"b": i, "w": i} for i in range(10)])
            self.commit()

    lt = pw.io.python.read(LS(), schema=L, autocommit_duration_ms=None)
    rt = pw.io.python.read(RS(), schema=R, autocommit_duration_ms=None)
    return lt, rt


def _source_table(pw, extra_cols=None):
    cols = {"g": str, "v": int}
    cols.update(extra_cols or {})
    schema = pw.schema_from_types(**cols)

    class Src(pw.io.python.ConnectorSubject):
        _deletions_enabled = False

        def run(self):
            self.commit()

    return pw.io.python.read(Src(), schema=schema, autocommit_duration_ms=None)


def _stamp(v):
    import time as _time

    return _time.time() + v


def _label(v):
    return f"x{v}"


PLANS = {
    # name: (build(pw) -> table, analyze kwargs, needs the native toolchain)
    "join_id_expression": (
        lambda pw: (lambda lt, rt: lt.join(rt, lt.a == rt.b, id=lt.v).select(
            v=pw.left.v, w=pw.right.w))(*_connector_pair(pw)), {}, True),
    "multi_arg_reducer": (
        lambda pw: _source_table(pw).groupby(pw.this.g).reduce(
            g=pw.this.g, s=pw.reducers.sum(pw.this.v, pw.this.v)), {}, True),
    "expression_key_exchange": (
        lambda pw: _source_table(pw).groupby(pw.this.g + "!").reduce(
            c=pw.reducers.count()), {"processes": 2}, True),
    "outer_join_pads": (
        lambda pw: (lambda lt, rt: lt.join_left(rt, lt.a == rt.b).select(
            v=pw.left.v, w=pw.right.w))(*_connector_pair(pw)), {}, True),
    "join_right_key_expression": (
        lambda pw: (lambda lt, rt: lt.join(rt, lt.a == rt.b + 1).select(
            v=pw.left.v, w=pw.right.w))(*_connector_pair(pw)),
        {"processes": 2}, True),
    "object_key_source": (
        lambda pw: _source_table(pw, {"meta": tuple}).groupby(pw.this.g).reduce(
            c=pw.reducers.count()), {}, True),
    "fused_join_2rank": (
        lambda pw: (lambda lt, rt: lt.join(rt, lt.a == rt.b).select(
            v=pw.left.v, w=pw.right.w))(*_connector_pair(pw)),
        {"processes": 2}, True),
    "nondeterministic_udf_exchanged": (
        lambda pw: (lambda t: t.select(g=pw.this.g, lab=pw.udf(_label)(pw.this.v))
                    .groupby(pw.this.lab).reduce(c=pw.reducers.count()))(
            _source_table(pw)), {"processes": 2}, False),
    "nondeterministic_udf_one_rank": (
        lambda pw: _source_table(pw).select(
            g=pw.this.g, lab=pw.udf(_label)(pw.this.v)), {}, False),
    "nondeterministic_udf_persisted": (
        lambda pw: _source_table(pw).select(
            g=pw.this.g, lab=pw.udf(_label)(pw.this.v)),
        {"persistence": True}, False),
    "suspicious_deterministic_udf": (
        lambda pw: _source_table(pw).select(s=pw.apply(_stamp, pw.this.v)),
        {}, False),
    "static_rows_select": (
        lambda pw: pw.debug.table_from_rows(
            pw.schema_from_types(a=int), [(1,), (2,)]).select(b=pw.this.a + 1),
        {}, False),
    "groupby_mesh_pass_4rank": (
        lambda pw: pw.debug.table_from_rows(
            pw.schema_from_types(data=str), [("a",), ("b",), ("a",)]
        ).groupby(pw.this.data).reduce(c=pw.reducers.count()),
        {"processes": 4}, False),
}


def _shape(report) -> dict:
    """What both packages' reports must agree on."""
    return {
        "verdict": report.verdict,
        "processes": report.processes,
        "nodes": [
            (n["node"], n["kind"], n["verdict"], tuple(n["reasons"]))
            for n in report.nodes
        ],
        "diagnostics": [(d.code, d.severity, d.node) for d in report.diagnostics],
    }


def _analyze_both(build, **kw):
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        out[name] = pw.analyze(build(pw), **kw)
        pw.internals.parse_graph.G.clear()
    return out["jax"], out["torch"]


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_report_matches_the_jax_package(name, monkeypatch):
    build, kw, nb = PLANS[name]
    if nb and not _nb_toolchain():
        pytest.skip("native toolchain (pwexec) unavailable")
    monkeypatch.setenv("PATHWAY_MESHCHECK_ROUNDS", "1")
    # the reasons name tables by a per-process counter in each package
    # (<table_N>): both start at 0 here, so that tables an earlier test file
    # built in this process do not set the two reports apart
    import importlib
    import itertools

    for pw in PACKAGES.values():
        table_mod = importlib.import_module(pw.__name__ + ".internals.table")
        monkeypatch.setattr(table_mod, "_table_counter", itertools.count())
    j, t = _analyze_both(build, **kw)
    assert _shape(t) == _shape(j), t.render()
    jd, td = j.to_dict(), t.to_dict()
    assert jd["schema"] == "pathway_tpu.analysis/v1"
    assert td["schema"] == "pathway_tpu_torch.analysis/v1"
    assert td["summary"] == jd["summary"]
    for node in td["nodes"]:
        assert {"node_id", "node", "kind", "verdict", "reasons", "where"} <= set(node)


@needs_nb
def test_blame_names_the_user_line():
    lt, rt = _connector_pair(tpw)
    out = lt.join(rt, lt.a == rt.b, id=lt.v).select(  # JOIN-ID-LINE
        v=tpw.left.v, w=tpw.right.w
    )
    [d] = [d for d in tpw.analyze(out).diagnostics if d.code == "fusion.join"]
    assert "id=" in d.message and "computed" in d.message
    assert "test_torch_analysis.py" in d.where and "JOIN-ID-LINE" in d.where


@pytest.mark.parametrize("check_off", [False, True])
def test_unknown_knob_matches_the_jax_package(check_off, monkeypatch):
    monkeypatch.setenv("PATHWAY_THREDS", "8")  # typo'd PATHWAY_THREADS
    if check_off:
        monkeypatch.setenv("PATHWAY_KNOB_CHECK", "0")
    j, t = _analyze_both(lambda pw: _source_table(pw))
    assert _shape(t) == _shape(j)
    [d] = [d for d in t.diagnostics if d.code == "knob.unknown"]
    assert "PATHWAY_THREDS" in d.message and "PATHWAY_THREADS" in d.hint
    assert d.severity == ("warning" if check_off else "error")
    assert bool(t.errors()) is not check_off


def test_mesh_pass_off_and_one_rank(monkeypatch):
    """1-rank plans never pay for the mesh pass, and
    PATHWAY_MESHCHECK_DOCTOR=0 turns it off at 4 ranks too."""
    build = PLANS["groupby_mesh_pass_4rank"][0]
    monkeypatch.setenv("PATHWAY_MESHCHECK_ROUNDS", "1")
    rep = tpw.analyze(build(tpw), processes=4)
    [mesh] = [d for d in rep.diagnostics if d.code.startswith("mesh.")]
    assert mesh.code == "mesh.verified" and "4 ranks" in mesh.message
    assert not [d for d in tpw.analyze(build(tpw), processes=1).diagnostics
                if d.code.startswith("mesh.")]
    monkeypatch.setenv("PATHWAY_MESHCHECK_DOCTOR", "0")
    assert not [d for d in tpw.analyze(build(tpw), processes=4).diagnostics
                if d.code.startswith("mesh.")]


def test_mesh_pass_reports_violations_as_errors(monkeypatch):
    from pathway_tpu_torch.analysis import meshcheck

    orig = meshcheck.check_runtime_mesh

    def broken(runtime, **kw):
        return orig(runtime, mutate="drop_rollback_retraction", **kw)

    monkeypatch.setattr(meshcheck, "check_runtime_mesh", broken)
    monkeypatch.setenv("PATHWAY_MESHCHECK_ROUNDS", "2")
    t = tpw.debug.table_from_rows(tpw.schema_from_types(data=str), [("a",), ("b",)])
    rep = tpw.analyze(t.groupby(tpw.this.data).reduce(c=tpw.reducers.count()),
                      processes=3)
    errs = [d for d in rep.diagnostics if d.code.startswith("mesh.")]
    assert errs and errs[0].severity == "error"
    assert errs[0].code == "mesh.exactly-once"
    assert "PATHWAY_FAULT_PLAN" in (errs[0].hint or "")


# -- the knob registry -------------------------------------------------------

def test_knob_registry_covers_every_env_read():
    import re

    found = set()
    for root, _dirs, files in os.walk(os.path.join(REPO, "pathway_tpu_torch")):
        for fn in files:
            if fn.endswith(".py") and fn != "knobs.py":
                with open(os.path.join(root, fn), encoding="utf-8") as f:
                    found.update(re.findall(r"PATHWAY_[A-Z0-9_]+", f.read()))
    assert not found - set(tknobs.KNOBS), sorted(found - set(tknobs.KNOBS))


@pytest.mark.parametrize("name,value,problem", [
    ("PATHWAY_THREADS", "zero", "PATHWAY_THREADS"),
    ("PATHWAY_THREADS", "-3", "below the minimum"),
    ("PATHWAY_SNAPSHOT_ACCESS", "recrod", "one of"),
    ("PATHWAY_DEVICE_HBM_BYTES", "0", "below the minimum"),
    ("PATHWAY_MESHCHECK_RANKS", "1", "below the minimum"),
])
def test_knob_validation_matches_the_jax_package(name, value, problem, monkeypatch):
    monkeypatch.setenv(name, value)
    found = tknobs.validate_environment()
    # the hints quote each package's own help text
    assert [f[:2] for f in found] == [f[:2] for f in jknobs.validate_environment()]
    assert any(problem in n or problem in p for n, p, _ in found)


def test_runtime_rejects_unknown_knob_at_startup(monkeypatch):
    from pathway_tpu_torch.engine.runtime import Runtime

    monkeypatch.setenv("PATHWAY_NO_NB_JION", "1")  # typo'd NO_NB_JOIN
    with pytest.raises(tknobs.KnobError, match="PATHWAY_NO_NB_JION"):
        Runtime()
    monkeypatch.setenv("PATHWAY_KNOB_CHECK", "0")
    tknobs._checked = None
    Runtime()


def test_knob_table_markdown_lists_all():
    table = tknobs.knob_table_markdown()
    for name in tknobs.KNOBS:
        assert f"`{name}`" in table


# -- strict mode + fallback accounting ---------------------------------------

@needs_nb
def test_nb_strict_raises_with_blame_on_demotion(monkeypatch):
    from pathway_tpu_torch.internals.graph_runner import GraphRunner

    def build():
        tpw.internals.parse_graph.G.clear()
        t = tpw.debug.table_from_rows(
            tpw.schema_from_types(g=str, v=int), [(0, "a", 2**70), (1, "a", 1)],
        )
        return t.groupby(tpw.this.g).reduce(g=tpw.this.g, s=tpw.reducers.sum(tpw.this.v))

    rows = list(GraphRunner().run_tables(build())[0].state.rows.values())
    assert rows == [("a", 2**70 + 1)]
    monkeypatch.setenv("PATHWAY_NB_STRICT", "1")
    with pytest.raises(telig.NBStrictError, match="GroupByNode"):
        GraphRunner().run_tables(build())


def _spy_runtimes():
    """Instances of the port's Runtime made while the spy is installed;
    the caller restores ``Runtime.__init__`` in ``finally``."""
    import pathway_tpu_torch.engine.runtime as rt_mod

    insts: list = []
    orig = rt_mod.Runtime.__init__

    def spy(self, *a, **k):
        orig(self, *a, **k)
        insts.append(self)

    rt_mod.Runtime.__init__ = spy
    return insts, orig


@needs_nb
def test_fallback_counted_once_on_demotion_not_per_batch():
    import pathway_tpu_torch.engine.runtime as rt_mod
    from pathway_tpu_torch.engine.nodes import GroupByNode
    from pathway_tpu_torch.internals.graph_runner import GraphRunner

    class S(tpw.Schema):
        g: str
        v: int

    class Src(tpw.io.python.ConnectorSubject):
        _deletions_enabled = False

        def run(self):
            self.next_batch([{"g": "a", "v": 1}] * 5)
            self.commit()
            self.next_batch([{"g": "a", "v": 2**70}])
            self.commit()
            for _ in range(3):
                self.next_batch([{"g": "b", "v": 2}] * 4)
                self.commit()

    t = tpw.io.python.read(Src(), schema=S, autocommit_duration_ms=None)
    agg = t.groupby(tpw.this.g).reduce(g=tpw.this.g, s=tpw.reducers.sum(tpw.this.v))
    insts, orig = _spy_runtimes()
    try:
        [cap] = GraphRunner().run_tables(agg)
    finally:
        rt_mod.Runtime.__init__ = orig
    assert sorted(dict(cap.state.rows).values()) == [("a", 2**70 + 5), ("b", 24)]
    [gb] = [n for n in insts[0].scope.nodes if isinstance(n, GroupByNode)]
    assert gb._fallback_demoted and gb._nb_fallbacks == 1
    assert insts[0].stats.nb_fallbacks == 1


def test_executor_decisions_come_from_eligibility(monkeypatch):
    from pathway_tpu_torch.engine.nodes import JoinNode
    from pathway_tpu_torch.engine.runtime import Runtime
    from pathway_tpu_torch.internals.graph_runner import GraphRunner

    calls = []
    orig = telig.decide_join_nb

    def spy(**kw):
        d = orig(**kw)
        calls.append(d)
        return d

    monkeypatch.setattr(telig, "decide_join_nb", spy)
    lt, rt = _connector_pair(tpw)
    out = lt.join(rt, lt.a == rt.b).select(v=tpw.left.v)
    g = tpw.internals.parse_graph.G
    runtime = Runtime()
    GraphRunner()._lower(g.reachable_operators([out._source]), runtime)
    [jn] = [n for n in runtime.scope.nodes if isinstance(n, JoinNode)]
    assert calls and jn.nb_decision is calls[-1]
    assert jn._nb_ok == jn.nb_decision.ok


# -- verdicts against the port's runtime counters (1 rank) -------------------


def _lower_analyze_run(out_table):
    """Lower the port's captured graph once, analyze that runtime
    statically, then run it; returns (runtime, report, capture)."""
    from pathway_tpu_torch.engine.runtime import Runtime
    from pathway_tpu_torch.internals.graph_runner import GraphRunner

    g = tpw.internals.parse_graph.G
    ops = g.reachable_operators([out_table._source] + g.output_operators())
    runtime = Runtime()
    ctx = GraphRunner()._lower(ops, runtime)
    report = tpa.analyze_scope(runtime)
    cap = runtime.scope.capture(ctx.engine_table(out_table))
    runtime.run()
    return runtime, report, cap


def _static_jax_verdict(builder_name: str) -> str:
    from pathway_tpu.analysis import bench as jpb

    bp = getattr(jpb, builder_name)()
    try:
        return jpa.analyze(bp.out).verdict
    finally:
        jpw.internals.parse_graph.G.clear()


@needs_nb
@pytest.mark.parametrize(
    "builder", ["build_wordcount", "build_stream_join", "build_groupby"])
def test_fused_verdict_matches_zero_fallbacks_1rank(builder):
    from pathway_tpu_torch.engine import nodes as N

    bp = getattr(tpb, builder)()
    runtime, report, cap = _lower_analyze_run(bp.out)
    assert report.verdict == "fused" == _static_jax_verdict(builder)
    assert tpa.audit_runtime(runtime, report) == []
    assert runtime.stats.nb_fallbacks == 0 == runtime.stats.exchange_fallbacks
    for n in runtime.scope.nodes:
        if isinstance(n, (N.JoinNode, N.GroupByNode)):
            assert n._nb_batches > 0, f"{type(n).__name__} never ran columnar"
    assert len(cap.state.rows) > 0


@needs_nb
def test_degraded_verdict_matches_fallback_counters_1rank():
    from pathway_tpu_torch.engine import nodes as N

    rows = [{"data": "abc"[i % 3]} for i in range(120)]

    class Src(tpw.io.python.ConnectorSubject):
        _deletions_enabled = False

        def run(self):
            for s in range(0, len(rows), 40):
                self.next_batch(rows[s:s + 40])
                self.commit()

    class S(tpw.Schema):
        data: str

    t = tpw.io.python.read(Src(), schema=S, autocommit_duration_ms=None)
    agg = t.groupby(tpw.this.data + "!").reduce(c=tpw.reducers.count())
    runtime, report, _ = _lower_analyze_run(agg)
    assert report.verdict == "degraded"
    [gb] = [n for n in runtime.scope.nodes if isinstance(n, N.GroupByNode)]
    assert gb._nb_batches == 0 and gb._nb_fallbacks > 0
    assert runtime.stats.nb_fallbacks == gb._nb_fallbacks
    assert tpa.audit_runtime(runtime, report) == []


@needs_nb
def test_forced_tuple_env_matches_degraded_verdict(monkeypatch):
    from pathway_tpu_torch.engine import nodes as N

    monkeypatch.setenv("PATHWAY_NO_NB_JOIN", "1")
    bp = tpb.build_stream_join()
    runtime, report, _ = _lower_analyze_run(bp.out)
    assert report.verdict == "degraded"
    [entry] = [n for n in report.nodes if n["kind"] == "join"]
    assert any("PATHWAY_NO_NB_JOIN" in r for r in entry["reasons"])
    [join] = [n for n in runtime.scope.nodes if isinstance(n, N.JoinNode)]
    assert join._nb_batches == 0 and join._nb_fallbacks > 0
    assert tpa.audit_runtime(runtime, report) == []


def _egress_pipeline(consumer: str):
    class L(tpw.Schema):
        k: int = tpw.column_definition(primary_key=True)
        j: int
        v: int

    class R(tpw.Schema):
        k: int = tpw.column_definition(primary_key=True)
        j: int
        w: int

    lrows = [{"k": i, "j": i % 9, "v": i} for i in range(180)]
    rrows = [{"k": i, "j": i % 9, "w": i} for i in range(18)]

    class LS(tpw.io.python.ConnectorSubject):
        _deletions_enabled = False

        def run(self):
            for s in range(0, len(lrows), 60):
                self.next_batch(lrows[s:s + 60])
                self.commit()

    class RS(tpw.io.python.ConnectorSubject):
        _deletions_enabled = False

        def run(self):
            self.next_batch(rrows)
            self.commit()

    lt = tpw.io.python.read(LS(), schema=L, autocommit_duration_ms=None)
    rt = tpw.io.python.read(RS(), schema=R, autocommit_duration_ms=None)
    out = lt.join(rt, tpw.left.j == tpw.right.j).select(v=tpw.left.v, w=tpw.right.w)
    if consumer == "arrow":
        tpw.io.subscribe(out, on_batch=lambda *a: None, batch_format="arrow")
    elif consumer == "rows_batch":
        tpw.io.subscribe(out, on_batch=lambda *a: None)
    else:
        tpw.io.subscribe(out, on_change=lambda *a: None)
    return out


@needs_nb
@pytest.mark.parametrize("consumer,env,expect", [
    ("arrow", {}, "fused"),
    ("rows_batch", {}, "row-expanding"),
    ("on_change", {}, "row-expanding"),
    ("arrow", {"PATHWAY_NO_NB_CAPTURE": "1"}, "forced-off"),
])
def test_egress_verdict_matches_runtime_counters(consumer, env, expect, monkeypatch):
    pytest.importorskip("pyarrow")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    runtime, report, _ = _lower_analyze_run(_egress_pipeline(consumer))
    sink = [d for d in report.diagnostics if d.code == "sink.row-expanding"]
    if expect == "fused":
        assert not sink, [d.message for d in sink]
        assert runtime.stats.capture_arrow_batches > 0
        assert runtime.stats.capture_rows_expanded == 0
    else:
        assert len(sink) == 1, [d.message for d in sink]
        if expect == "forced-off":
            assert "NO_NB_CAPTURE" in sink[0].message
        else:
            assert "arrow" in (sink[0].hint or "")
        assert runtime.stats.capture_rows_expanded > 0
        assert runtime.stats.capture_arrow_batches == 0


@needs_nb
def test_egress_degraded_chain_not_blamed_on_sink():
    pytest.importorskip("pyarrow")
    runtime, report, _ = _lower_analyze_run(tpb.build_wordcount().out)
    assert runtime.stats.capture_rows_expanded == 0
    assert runtime.stats.capture_arrow_batches == 0
    [d] = [d for d in report.diagnostics if d.code == "sink.row-expanding"]
    assert "not columnar" in d.message


# -- verdicts against real 2- and 4-rank meshes ------------------------------

_RANK_PROGRAM = """
import json, os, sys
sys.path.insert(0, {repo!r})
import pathway_tpu_torch as pw
import pathway_tpu_torch.engine.runtime as rt_mod
from pathway_tpu_torch.analysis import analyzer as pa
from pathway_tpu_torch.engine import nodes as N

_insts = []
_orig = rt_mod.Runtime.__init__
def _spy(self, *a, **k):
    _orig(self, *a, **k)
    _insts.append(self)
rt_mod.Runtime.__init__ = _spy

rank = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
P = int(os.environ.get("PATHWAY_PROCESSES", "1"))
words = [f"w{{i}}" for i in range(5)]
rows = [{{"data": words[i % 5], "v": i % 50}} for i in range(rank, 300, P)]

class Src(pw.io.python.ConnectorSubject):
    _deletions_enabled = False
    _distributed_partitioned = True
    def run(self):
        for s in range(0, len(rows), 50):
            self.next_batch(rows[s : s + 50])
            self.commit()

class S(pw.Schema):
    data: str
    v: int

t = pw.io.python.read(Src(), schema=S, autocommit_duration_ms=3_600_000)
counts = t.groupby(pw.this.data).reduce(
    word=pw.this.data, c=pw.reducers.count(), s=pw.reducers.sum(pw.this.v)
)
rrows = [{{"j": w, "m": i + 1}} for i, w in enumerate(words)]
class RSrc(pw.io.python.ConnectorSubject):
    _deletions_enabled = False
    def run(self):
        self.next_batch(rrows)
        self.commit()
class R(pw.Schema):
    j: str
    m: int
rt = pw.io.python.read(RSrc(), schema=R, autocommit_duration_ms=3_600_000)
joined = t.join(rt, pw.left.data == pw.right.j).select(
    d=pw.left.data, v=pw.left.v, m=pw.right.m
)
pw.io.subscribe(counts, on_change=lambda *a: None)
pw.io.subscribe(joined, on_change=lambda *a: None)
pw.run(monitoring_level=pw.MonitoringLevel.NONE)

runtime = _insts[0]
report = pa.analyze_scope(runtime)
joins = [n for n in runtime.scope.nodes if isinstance(n, N.JoinNode)]
gbs = [n for n in runtime.scope.nodes if isinstance(n, N.GroupByNode)]
xs = runtime.scope.exchange_nodes
print(json.dumps({{
    "verdict": report.verdict,
    "problems": pa.audit_runtime(runtime, report),
    "diagnostics": [[d.code, d.severity, d.node] for d in report.diagnostics],
    "nb_fallbacks": runtime.stats.nb_fallbacks,
    "exchange_fallbacks": runtime.stats.exchange_fallbacks,
    "join_nb_batches": sum(n._nb_batches for n in joins),
    "gb_nb_batches": sum(n._nb_batches for n in gbs),
    "x_nb_batches": sum(x._nb_batches for x in xs),
    "n_exchanges": len(xs),
    "mesh_rollbacks": runtime.stats.mesh_rollbacks,
    "mesh_heartbeats_missed": runtime.stats.mesh_heartbeats_missed,
    "mesh_rank_restarts": runtime.stats.mesh_rank_restarts,
}}))
"""


def reserve_ports(n: int):
    """``n`` consecutive loopback ports from this xdist worker's own slice
    of 24000-31999 — below the kernel's ephemeral range, which the other
    tests' bind-to-port-0 probes draw from — returned with their sockets
    still bound; the caller closes them right before it spawns the ranks
    that listen there."""
    wid = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    idx = int(wid[2:]) if wid[2:].isdigit() else 0
    lo = 24000 + (idx % 8) * 1000
    for base in range(lo, lo + 1000 - n, n):
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                s.bind(("127.0.0.1", base + i))
                socks.append(s)
            return base, socks
        except OSError:
            for s in socks:
                s.close()
    raise RuntimeError("no free ports in this worker's range")


def _static_rank_plans(world: int):
    """The rank program's static plan at ``world`` ranks under each
    package's ``pw.analyze`` (the program up to its ``pw.run``)."""
    body = _RANK_PROGRAM.split("pw.run(")[0].format(repo=REPO)
    out = {}
    for name, pw in PACKAGES.items():
        src = body.replace("pathway_tpu_torch", pw.__name__)
        scope: dict = {"__name__": "rank_plan"}
        exec(compile(src, "rank_plan", "exec"), scope)
        try:
            out[name] = pw.analyze(processes=world)
        finally:
            # the program's Runtime spy
            sys.modules[pw.__name__ + ".engine.runtime"].Runtime.__init__ = scope["_orig"]
            pw.internals.parse_graph.G.clear()
    return out["jax"], out["torch"]


@needs_nb
@pytest.mark.parametrize("world", [2, 4], ids=["2rank", "4rank"])
def test_fused_verdict_matches_zero_fallbacks_multirank(world, tmp_path, monkeypatch):
    """Each rank of a real loopback mesh audits its own fallback counters
    against its static verdicts, and its Plan Doctor's mesh pass (the
    model checker over this plan's exchanges) reports verified in
    agreement with the run: no rollback, no restart. The verdicts equal
    the JAX package's static plan of the same program."""
    monkeypatch.setenv("PATHWAY_MESHCHECK_ROUNDS", "1")
    jplan, tplan = _static_rank_plans(world)
    assert _shape(tplan) == _shape(jplan)
    prog = tmp_path / "prog.py"
    prog.write_text(_RANK_PROGRAM.format(repo=REPO))
    base, socks = reserve_ports(world)
    env = {k: v for k, v in os.environ.items() if k != "PATHWAY_LANE_PROCESSES"}
    env.update(PATHWAY_PROCESSES=str(world), PATHWAY_FIRST_PORT=str(base),
               PYTHONPATH=REPO, PATHWAY_MESHCHECK_ROUNDS="1")
    for s in socks:
        s.close()
    procs = [
        subprocess.Popen(
            [sys.executable, str(prog)], env=dict(env, PATHWAY_PROCESS_ID=str(r)),
            cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err.decode()[-2000:]
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.communicate()
    for r in outs:
        assert r["verdict"] == jplan.verdict == "fused", r
        mesh = [d for d in r["diagnostics"] if d[0].startswith("mesh.")]
        assert mesh == [[d.code, d.severity, d.node] for d in jplan.diagnostics
                        if d.code.startswith("mesh.")], r
        assert [c for c, _, _ in mesh] == ["mesh.verified"]
        assert r["problems"] == [] and r["n_exchanges"] > 0
        assert r["nb_fallbacks"] == 0 == r["exchange_fallbacks"]
        assert r["mesh_rollbacks"] == 0 == r["mesh_rank_restarts"]
        assert r["mesh_heartbeats_missed"] == 0
    assert sum(r["x_nb_batches"] for r in outs) > 0
    assert sum(r["gb_nb_batches"] for r in outs) > 0
    assert sum(r["join_nb_batches"] for r in outs) > 0


# -- the CLI -----------------------------------------------------------------

def _cli(args, monkeypatch):
    """The port's doctor CLI in this process, with the interpreter state
    it touches (argv, path) restored afterwards."""
    from pathway_tpu_torch.analysis.__main__ import main

    monkeypatch.setattr(sys, "argv", list(sys.argv))
    monkeypatch.setattr(sys, "path", list(sys.path))
    return main(args)


PROGRAM = (
    "import pathway_tpu_torch as pw\n"
    "t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1,)])\n"
    "out = t.select(b=pw.this.a + 1)\n"
    "pw.io.subscribe(out, on_change=lambda *a: None)\n"
    "pw.run(monitoring_level=pw.MonitoringLevel.NONE)\n"
)


def test_cli_program_mode_gate_and_program_argv(tmp_path, monkeypatch, capsys):
    from pathway_tpu_torch.engine.runtime import Runtime

    run, init = Runtime.run, Runtime.__init__
    prog = tmp_path / "prog.py"
    prog.write_text(PROGRAM)
    assert _cli(["--json", str(prog)], monkeypatch) == 0
    assert json.loads(capsys.readouterr().out)["verdict"] == "tuple"
    tpw.internals.parse_graph.G.clear()
    assert _cli(["--require-fused", str(prog)], monkeypatch) == 1
    assert "not fused" in capsys.readouterr().err
    tpw.internals.parse_graph.G.clear()
    argprog = tmp_path / "argprog.py"
    argprog.write_text("import sys\nassert sys.argv[1:] == ['--limit', '5'], sys.argv\n"
                       + PROGRAM)
    assert _cli(["--json", str(argprog), "--limit", "5"], monkeypatch) == 0
    assert json.loads(capsys.readouterr().out)["verdict"] == "tuple"
    # the stubs the CLI puts on Runtime are gone again
    assert (Runtime.run, Runtime.__init__) == (run, init)


def test_cli_program_mode_sees_persistence(tmp_path, monkeypatch, capsys):
    prog = tmp_path / "prog.py"
    prog.write_text(
        "import pathway_tpu_torch as pw\n"
        "t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1,)])\n"
        "lab = pw.udf(lambda v: f'x{v}')\n"
        "out = t.select(b=lab(pw.this.a))\n"
        "pw.io.subscribe(out, on_change=lambda *a: None)\n"
        "pw.run(persistence_config=pw.persistence.Config(\n"
        f"    backend=pw.persistence.Backend.filesystem({str(tmp_path / 'p')!r})))\n"
    )
    assert _cli(["--json", str(prog)], monkeypatch) == 0
    data = json.loads(capsys.readouterr().out)
    replay = [d for d in data["diagnostics"] if d["code"] == "replay.nondeterministic-udf"]
    assert replay and "persisted" in replay[0]["message"]


def test_cli_diagnoses_bad_config_backed_knob(tmp_path):
    prog = tmp_path / "prog.py"
    prog.write_text(PROGRAM)
    env = dict(os.environ, PYTHONPATH=REPO, PATHWAY_PROCESSES="abc")
    res = subprocess.run(
        [sys.executable, "-m", "pathway_tpu_torch.analysis", str(prog)],
        capture_output=True, text=True, env=env, timeout=180, cwd=tmp_path,
    )
    assert res.returncode == 2, res.stderr
    assert "knob.invalid" in res.stderr and "PATHWAY_PROCESSES" in res.stderr
    assert "Traceback" not in res.stderr
    assert "jax" not in res.stderr.lower()


def test_cli_bench_verdicts_and_artifact_under_a_given_path(tmp_path, monkeypatch, capsys):
    """``--bench`` gives the JAX package's verdicts; ``--update-artifact``
    writes the artifact it is given and no file of the repository."""
    from pathway_tpu.analysis.bench import bench_verdicts as jax_verdicts

    repo_artifact = os.path.join(REPO, "BENCH_full.json")
    before = os.stat(repo_artifact).st_mtime_ns if os.path.exists(repo_artifact) else None
    artifact = tmp_path / "bench.json"
    artifact.write_text(json.dumps([
        {"metric": "wordcount_rows_per_s", "value": 1.0},
        {"metric": "rag_query_p50_ms", "value": 2.0},
        {"metric": "unrelated", "value": 3.0},
    ]))
    assert _cli(["--bench", "--json", "--update-artifact", str(artifact)],
                monkeypatch) == 0
    out = capsys.readouterr().out
    verdicts = json.loads(out[: out.rindex("}") + 1])
    try:
        assert verdicts == jax_verdicts()
    finally:
        jpw.internals.parse_graph.G.clear()
    lines = json.loads(artifact.read_text())
    assert lines[0]["plan_verdict"] == verdicts["wordcount@1rank"]
    assert lines[1]["device_plan_verdict"] == "device-clean"
    assert "plan_verdict" not in lines[2]
    after = os.stat(repo_artifact).st_mtime_ns if os.path.exists(repo_artifact) else None
    assert after == before
    # no path, no write
    assert _cli(["--bench"], monkeypatch) == 0
    assert "annotated" not in capsys.readouterr().out


# -- the FLOP model ----------------------------------------------------------

def test_flops_model_matches_the_traced_forward():
    """The analytic ``forward_flops_per_token`` (the MFU numerator) against
    torch's own count of the traced forward (``FlopCounterMode`` on meta
    tensors — the port's counterpart of XLA's cost analysis), within the
    25 % the JAX package allows for the omitted elementwise work; and the
    model itself equals the JAX package's."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from pathway_tpu.models.encoder import EncoderConfig as JCfg
    from pathway_tpu.models.encoder import forward_flops_per_token as jflops
    from pathway_tpu_torch.models.encoder import (
        EncoderConfig,
        TransformerEncoder,
        forward_flops_per_token,
    )

    cfg = EncoderConfig.tiny()
    n, L = 8, 64
    with torch.device("meta"):
        model = TransformerEncoder(cfg)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros(n, L, dtype=torch.int64, device="meta"),
              torch.ones(n, L, dtype=torch.int32, device="meta"))
    counted = counter.get_total_flops()
    assert counted > 0
    assert forward_flops_per_token(cfg, L) * n * L == pytest.approx(counted, rel=0.25)
    for name in ("tiny", "bge_small", "bge_base"):
        for seq in (16, 128, 512):
            assert forward_flops_per_token(getattr(EncoderConfig, name)(), seq) == (
                jflops(getattr(JCfg, name)(), seq))


def test_flops_model_scales_with_geometry():
    from pathway_tpu_torch.models.encoder import EncoderConfig, forward_flops_per_token

    small = forward_flops_per_token(EncoderConfig.bge_small(), 128)
    base = forward_flops_per_token(EncoderConfig.bge_base(), 128)
    assert 3.0 < base / small < 4.5
    longer = forward_flops_per_token(EncoderConfig.bge_small(), 512)
    assert small < longer < 1.5 * small


# -- the trace analyzers -----------------------------------------------------

def _device_trace(path: str) -> dict:
    """A flight-recorder trace of KNN writes and searches on the port's
    CPU path, with the device plane armed."""
    import numpy as np

    from pathway_tpu_torch.internals import device as tdev
    from pathway_tpu_torch.internals.flight import FlightRecorder
    from pathway_tpu_torch.internals.monitoring import ProberStats
    from pathway_tpu_torch.ops import fused_knn
    from pathway_tpu_torch.ops.knn import KnnShard

    rec, stats = FlightRecorder(path), ProberStats()
    seen = set(fused_knn._SEEN_BUCKETS)  # process-wide: restored below
    fused_knn._SEEN_BUCKETS.clear()
    tdev.PLANE.arm(rec, stats)
    try:
        shard = KnnShard(16, "cos", device="cpu")
        x = np.random.default_rng(0).normal(size=(300, 16)).astype(np.float32)
        shard.add(range(300), x)
        for q in (1, 4, 4):
            shard.search(x[:q], 5)
        import torch

        fused_knn.fused_topk_scores(torch.from_numpy(x[:8]), shard.vectors,
                                    shard.valid, 5)
    finally:
        tdev.PLANE.disarm()
        fused_knn._SEEN_BUCKETS.clear()
        fused_knn._SEEN_BUCKETS.update(seen)
    rec.dump()
    return dict(stats.device_recompiles)


def test_profile_and_critical_path_match_the_jax_package(tmp_path, monkeypatch):
    """Both packages' analyzers read the port's trace alike: the same
    per-site dispatch totals, MFU and roofline verdicts; the port's
    critical path adds the per-site device verdicts a one-rank trace
    otherwise lacks."""
    from pathway_tpu.analysis.critical_path import critical_path as jcp
    from pathway_tpu.analysis.profile import profile_trace as jprofile
    from pathway_tpu_torch.analysis.critical_path import (
        critical_path as tcp,
        render_critical_path,
    )
    from pathway_tpu_torch.analysis.profile import profile_trace, render_profile

    for k in ("PATHWAY_DEVICE_PEAK_FLOPS", "PATHWAY_DEVICE_PEAK_GBPS",
              "PATHWAY_DEVICE_HOST_BOUND_SHARE"):
        monkeypatch.delenv(k, raising=False)
    path = str(tmp_path / "trace.json")
    recompiles = _device_trace(path)
    t, j = profile_trace(path), jprofile(path)
    assert t["valid"] and t == j
    sites = {s["site"]: s for s in t["device"]["sites"]}
    assert {"knn.write", "knn.search", "knn.fused"} <= set(sites)
    for s in sites.values():
        assert s["verdict"] in ("host-bound", "compute-bound", "bandwidth-bound")
    assert "knn.fused" in render_profile(t)
    tc, jc = tcp(path), jcp(path)
    assert tc["valid"] and tc.pop("device") == t["device"]
    assert tc == jc
    assert "knn.fused" in render_critical_path(tcp(path))
    assert recompiles["knn.fused"] == 1


@pytest.mark.parametrize("flag", ["--profile", "--critical-path"])
def test_cli_trace_modes(flag, tmp_path, monkeypatch, capsys):
    path = str(tmp_path / "trace.json")
    _device_trace(path)
    assert _cli([flag, path, "--json"], monkeypatch) == 0
    assert json.loads(capsys.readouterr().out)["valid"]
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert _cli([flag, str(bad)], monkeypatch) == 2


# -- the slice as a whole: the RAG template's plan, static and run ----------

_RAG_PROGRAM = r"""
import json, os, sys, threading, time
sys.path.insert(0, {repo!r})
import pathway_tpu_torch as pw
from pathway_tpu_torch.analysis import analyzer as pa
from pathway_tpu_torch.engine.runtime import Runtime
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
from pathway_tpu_torch.xpacks.llm.mocks import IdentityMockChat
from pathway_tpu_torch.xpacks.llm.question_answering import (
    BaseRAGQuestionAnswerer, RAGClient,
)
from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

folder, port = sys.argv[1], int(sys.argv[2])
runtimes = []
init = Runtime.__init__
def spy(self, *a, **k):
    init(self, *a, **k)
    runtimes.append(self)
Runtime.__init__ = spy
docs = pw.io.fs.read(folder, format="binary", with_metadata=True,
                     mode="streaming", autocommit_duration_ms=100)
store = VectorStoreServer(docs, embedder=SentenceTransformerEmbedder("tiny", device="cpu"),
                          index_params={{"device": "cpu"}})
rag = BaseRAGQuestionAnswerer(llm=IdentityMockChat(), indexer=store, search_topk=6)
rag.build_server(host="127.0.0.1", port=port)
static = pa.analyze(device=True)
threading.Thread(target=pw.run, daemon=True).start()
client = RAGClient(host="127.0.0.1", port=port, timeout=60)
deadline = time.time() + 120
while time.time() < deadline:
    try:
        if int(client.statistics().get("file_count") or 0) >= 4:
            break
    except OSError:
        pass
    time.sleep(0.2)
hits = client.retrieve("doc number 2 about cats and dogs 2\n", k=2)
Runtime.__init__ = init
real = pa.analyze_scope(runtimes[0], device=True)
shape = lambda r: [r.verdict, [[n["node"], n["kind"], n["verdict"]] for n in r.nodes],
                   [[d.code, d.severity, d.node] for d in r.diagnostics]]
print(json.dumps({{
    "static": shape(static), "real": shape(real),
    "audit": pa.audit_runtime(runtimes[0], real),
    "device": [static.device["verdict"], static.device["reachable_sites"]],
    "hits": [os.path.basename(h["metadata"]["path"]) for h in hits],
    "jax": [m for m in sys.modules if m == "jax" or m.startswith("pathway_tpu.")],
}}), flush=True)
os._exit(0)
"""


def test_rag_program_plan_matches_the_jax_package_and_its_run(tmp_path):
    """The live-RAG template (fs.read -> VectorStoreServer -> REST gateway):
    the port's static plan equals the JAX package's, and equals the plan
    of the port's own running program, whose fallback counters agree with
    it; the Device Doctor reaches the index's write and search sites."""
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu.xpacks.llm.mocks import IdentityMockChat
    from pathway_tpu.xpacks.llm.question_answering import BaseRAGQuestionAnswerer
    from pathway_tpu.xpacks.llm.vector_store import VectorStoreServer

    folder = tmp_path / "docs"
    folder.mkdir()
    for i in range(4):
        (folder / f"d{i}.txt").write_text(f"doc number {i} about cats and dogs {i}\n")
    base, socks = reserve_ports(1)
    docs = jpw.io.fs.read(str(folder), format="binary", with_metadata=True,
                          mode="streaming", autocommit_duration_ms=100)
    store = VectorStoreServer(docs, embedder=SentenceTransformerEmbedder("tiny"))
    rag = BaseRAGQuestionAnswerer(llm=IdentityMockChat(), indexer=store, search_topk=6)
    rag.build_server(host="127.0.0.1", port=base)
    jax_static = jpa.analyze(device=True)
    jpw.internals.parse_graph.G.clear()
    prog = tmp_path / "rag.py"
    prog.write_text(_RAG_PROGRAM.format(repo=REPO))
    for s in socks:
        s.close()
    res = subprocess.run(
        [sys.executable, str(prog), str(folder), str(base)],
        capture_output=True, text=True, timeout=240, cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PATHWAY_LANE_PROCESSES"},
    )
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    want = [jax_static.verdict,
            [[n["node"], n["kind"], n["verdict"]] for n in jax_static.nodes],
            [[d.code, d.severity, d.node] for d in jax_static.diagnostics]]
    assert out["static"] == want
    assert out["real"] == out["static"]
    assert out["audit"] == []
    assert out["device"] == [jax_static.device["verdict"],
                             jax_static.device["reachable_sites"]]
    assert out["device"] == ["device-clean", ["knn.search", "knn.write"]]
    # the served path answers (the tiny random encoder ranks near-ties)
    assert len(out["hits"]) == 2 and set(out["hits"]) <= {f"d{i}.txt" for i in range(4)}
    assert out["jax"] == []
