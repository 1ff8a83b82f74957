"""The port's host spans on the serve and ingest paths (the flight
recorder's ``note_span``), on the CPU: the span tree of a MicroBatcher
batch under one trace id, nothing recorded while the device plane is off,
the spans on a torch.profiler trace's clock, the device queue depth, and
the ingest pipeline's starved and blocked waits."""

import collections
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pathway_tpu_torch.analysis.profile import validate_trace
from pathway_tpu_torch.internals import device as device_mod
from pathway_tpu_torch.internals.device import PLANE
from pathway_tpu_torch.internals.flight import (
    CLOCK_MARK,
    PROFILER_PID_BASE,
    FlightRecorder,
    _ts_sorted,
)
from pathway_tpu_torch.internals.monitoring import ProberStats
from pathway_tpu_torch.internals.parse_graph import G as PORT_G
from pathway_tpu_torch.models import EncoderConfig, SentenceEncoder
from pathway_tpu_torch.ops import IngestPipeline, KnnShard, MicroBatcher, QueryEngine

CPU = "cpu"
SERVE_CHILDREN = ("serve.tokenize", "encoder.pad", "encoder.h2d",
                  "encoder.launch", "knn.lock_wait", "knn.launch")
FINISH_CHILDREN = ("serve.readback", "serve.keymap")
N_CLIENTS = 4 * (os.cpu_count() or 2)


@pytest.fixture(autouse=True)
def _disarmed_plane():
    PLANE.disarm()
    PORT_G.clear()
    yield
    PLANE.disarm()
    PORT_G.clear()


def _engine(rows=64):
    enc = SentenceEncoder(EncoderConfig.tiny(), device=CPU, batch_size=16)
    shard = KnnShard(enc.embed_dim, "cos", device=CPU)
    vecs = np.random.default_rng(0).standard_normal((rows, enc.embed_dim))
    shard.add(list(range(rows)), vecs.astype(np.float32))
    return QueryEngine(enc, shard, k=3, device=CPU)


def _fire(batcher, n):
    out, threads = [], []
    for i in range(n):
        t = threading.Thread(
            target=lambda i=i: out.append(batcher.query(f"query {i} about cats")))
        threads.append(t)
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return out


def _spans(rec, name=None):
    """(name, thread ident, t0, t1, cpu, trace id, args) of the recorder's
    spans."""
    return [e[1:] for e in rec.events
            if e[0] == "span" and (name is None or e[1] == name)]


def _armed():
    rec = FlightRecorder("")
    stats = ProberStats()
    PLANE.arm(rec, stats)
    return rec, stats


# -- (a) the span tree of a batch -----------------------------------------

def test_serve_spans_nest_under_their_batch_and_share_its_trace_id():
    engine = _engine()
    batcher = MicroBatcher(engine, max_wait_ms=5.0)
    rec, _ = _armed()
    # more clients than cores, switching often: a lost note breaks the counts
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        answers = _fire(batcher, N_CLIENTS)
    finally:
        sys.setswitchinterval(interval)
        batcher.close()
        PLANE.disarm()
    assert len(answers) == N_CLIENTS and all(len(a) == 3 for a in answers)

    dispatch = {s[5]: s for s in _spans(rec, "serve.dispatch")}
    assert dispatch and None not in dispatch
    # every request's queue wait and hand-off are under its batch's id, and
    # a batch's requests are the n its dispatch carried
    for wait in ("serve.queue_wait", "serve.handoff"):
        per = collections.Counter(s[5] for s in _spans(rec, wait))
        assert per == {b: s[6]["n"] for b, s in dispatch.items()}, wait
        assert all(s[4] is None for s in _spans(rec, wait))  # no thread's own
    assert sum(s[6]["n"] for s in dispatch.values()) == N_CLIENTS

    def inside(child, parent):
        return (child[1] == parent[1] and parent[2] <= child[2]
                and child[3] <= parent[3])

    finish = {s[5]: s for s in _spans(rec, "serve.finish")}
    collect = {s[5]: s for s in _spans(rec, "serve.collect")}
    assert set(finish) == set(collect) == set(dispatch)
    idle = {s[5]: s for s in _spans(rec, "serve.idle")}
    assert set(idle) <= set(dispatch)  # the first batch may open unarmed
    assert all(idle[b][1] == collect[b][1] and idle[b][3] <= collect[b][2]
               for b in idle)
    assert {s[5] for s in _spans(rec, "serve.ticket_wait")} == set(dispatch)
    for b, parent in dispatch.items():
        assert collect[b][1] == parent[1] and collect[b][3] <= parent[2]
        assert collect[b][6]["closed_by"] in ("full", "timeout", "close")
        for name in SERVE_CHILDREN:
            kids = [s for s in _spans(rec, name) if s[5] == b]
            assert len(kids) == 1 and inside(kids[0], parent), name
        for name in FINISH_CHILDREN:
            kids = [s for s in _spans(rec, name) if s[5] == b]
            assert len(kids) == 1 and inside(kids[0], finish[b]), name
        # the encoder record's own cost, opened and closed in the dispatch
        for name in ("plane.begin", "plane.end"):
            kids = [s for s in _spans(rec, name) if s[5] == b]
            assert len(kids) == 1 and inside(kids[0], parent), name
        assert finish[b][1] != parent[1]  # a readback thread
    pads = [s for s in _spans(rec, "encoder.pad")]
    assert all(s[6]["nb"] >= 1 and s[6]["Lb"] >= 16 for s in pads)
    # on the CPU the search has no query-tile instance
    assert all(s[6]["tile"] is None for s in _spans(rec, "knn.launch"))

    # a thread's CPU time over a span is never above its wall
    for s in _spans(rec):
        if s[4] is not None:
            assert 0 <= s[4] <= s[3] - s[2] + 1_000, s

    # the batch's encoder dispatch record carries its id
    disp = [e for e in rec.events if e[0] == "disp" and e[1] == "encoder.forward"]
    assert sorted(e[-1] for e in disp) == sorted(dispatch)

    events = rec.chrome_events()
    assert validate_trace({"traceEvents": _ts_sorted(events),
                           "pathway": {"schema": 1}}) == []
    for e in events:
        if e.get("cat") == "span":
            assert 0 <= e["args"]["offcpu_us"] <= e["dur"]
        if e.get("cat") == "device":
            assert e["args"]["trace_id"] in dispatch


def test_engine_query_alone_records_spans_without_a_trace_id():
    engine = _engine()
    rec, _ = _armed()
    try:
        engine.query(["a query", "another query"])
    finally:
        PLANE.disarm()
    names = {s[0] for s in _spans(rec)}
    assert set(SERVE_CHILDREN + FINISH_CHILDREN) <= names
    assert "serve.dispatch" not in names  # the batcher's span
    assert {s[5] for s in _spans(rec)} == {None}


# -- (b) off means off ------------------------------------------------------

def test_a_disarmed_plane_records_nothing_and_reads_no_clock(monkeypatch):
    engine = _engine()
    batcher = MicroBatcher(engine)
    enc, shard = engine.encoder, KnnShard(engine.encoder.embed_dim, device=CPU)
    pipe = IngestPipeline(enc, shard, device=CPU)
    rec = FlightRecorder("")

    def thread_time_ns():
        raise AssertionError("a span site read the CPU clock while off")

    # a recorder is attached, but the plane is off: the one check fails
    monkeypatch.setattr(PLANE, "recorder", rec)
    monkeypatch.setattr(time, "thread_time_ns", thread_time_ns)
    assert not PLANE.on
    try:
        assert len(_fire(batcher, 6)) == 6
        engine.query(["one more"])
        pipe.run([([f"k{i}" for i in range(4)], [f"text {i}" for i in range(4)])
                  for _ in range(3)])
    finally:
        batcher.close()
    assert len(rec.events) == 0


# -- (c) one clock with torch.profiler ---------------------------------------

def _profiled_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _within(op, span, eps_us=25.0):
    a, b = op["ts"], op["ts"] + op["dur"]
    return span[0] - eps_us <= a and b <= span[1] + eps_us


def test_spans_placed_by_the_clock_anchor_hold_the_ops_they_issued(tmp_path):
    engine = _engine()
    engine.query(["warm the memo and the buckets"])
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        rec, _ = _armed()
        try:
            engine.query(["a query about cats", "dogs and more dogs here"])
        finally:
            PLANE.disarm()
    path = str(tmp_path / "prof.json")
    prof.export_chrome_trace(path)
    events = _profiled_events(path)
    mark = [e for e in events if e.get("name") == CLOCK_MARK]
    assert len(mark) == 1 and rec.clock_anchor_ns is not None
    shift = mark[0]["ts"] - rec.clock_anchor_ns / 1e3
    placed = {}
    for name, _, t0, t1, _, _, _ in _spans(rec):
        placed.setdefault(name, []).append((t0 / 1e3 + shift, t1 / 1e3 + shift))
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and str(e.get("name", "")).startswith("aten::")]

    def held(op_name, span_name):
        hits = [op for op in ops if op["name"] == op_name]
        assert hits, op_name
        return all(any(_within(op, s) for s in placed[span_name]) for op in hits)

    # the forward's matrix products lie in encoder.launch, one forward each
    assert len(placed["encoder.launch"]) == 1
    assert held("aten::linear", "encoder.launch")
    # the packing of values and slots lies in knn.launch
    assert held("aten::cat", "knn.launch")
    # and the spans nest in the engine's order on the profiler's clock
    order = [placed[n][0] for n in ("serve.tokenize", "encoder.pad", "encoder.h2d",
                                    "encoder.launch", "knn.lock_wait", "knn.launch",
                                    "serve.readback", "serve.keymap")]
    assert all(a[1] <= b[0] + 1.0 for a, b in zip(order, order[1:]))


def test_pw_run_profile_writes_the_recorders_spans_into_its_trace(tmp_path, monkeypatch):
    import pathway_tpu_torch as pw

    monkeypatch.setenv("PATHWAY_TRACE", str(tmp_path / "trace.json"))
    engine = _engine()
    engine.query(["warm"])
    t = pw.debug.table_from_markdown("""
    q
    cats
    dogs
    """)
    r = t.select(hit=pw.apply_with_type(
        lambda q: engine.query([q])[0][0][0], int, pw.this.q))
    pw.io.subscribe(r, on_change=lambda *a, **k: None)
    prof_dir = tmp_path / "prof"
    pw.run(profile=str(prof_dir), monitoring_level=pw.MonitoringLevel.NONE)
    files = os.listdir(prof_dir)
    assert len(files) == 1
    events = _profiled_events(str(prof_dir / files[0]))
    ours = [e for e in events if isinstance(e.get("pid"), int)
            and e["pid"] >= PROFILER_PID_BASE]
    cats = collections.Counter(e.get("cat") for e in ours)
    assert cats["node"] >= 3 and cats["span"] >= 2 * 8
    launches = [e for e in ours if e.get("name") == "encoder.launch"]
    assert len(launches) == 2
    linear = [e for e in events if e.get("name") == "aten::linear"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in launches]
    assert linear and all(any(_within(op, s) for s in spans) for op in linear)


# -- (d) the device queue depth ------------------------------------------------

class _Event:
    """A CUDA event's surface for the plane, passed or not by hand."""

    def __init__(self, passed=False):
        self.passed = passed

    def query(self):
        return self.passed

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 0.5


def _pending(site):
    d = device_mod._Dispatch(site, 0, None, None, time.perf_counter_ns(), 1,
                             _Event(True))
    d.ev1 = _Event(False)
    return d


def test_queue_depth_counts_pending_end_events_the_device_has_not_passed():
    stats = ProberStats()
    PLANE.arm(None, stats)
    try:
        p1, p2 = _pending("knn.fused"), _pending("knn.fused")
        PLANE._pending.extend([p1, p2])
        d1 = PLANE.begin("encoder.forward")
        assert d1.depth == 3  # itself, open, and two launches queued ahead
        PLANE.end(d1, None, block=False)  # host-only: no end event
        p1.ev1.passed = True  # delivered at the next begin
        d2 = PLANE.begin("encoder.forward")
        assert d2.depth == 2  # itself and p2; not p1, not host-only d1
        p2.ev1.passed = True
        PLANE.end(d2, None, block=False)
        d3 = PLANE.begin("encoder.forward")
        assert d3.depth == 1
        PLANE.end(d3, None, block=False)
    finally:
        PLANE.disarm()
    assert stats.device_sites["encoder.forward"][7] == 3 + 2 + 1
    assert stats.device_sites["knn.fused"][0] == 2


def test_queue_depth_counts_records_open_on_the_host():
    stats = ProberStats()
    PLANE.arm(None, stats)
    try:
        d1 = PLANE.begin("knn.search")
        d2 = PLANE.begin("encoder.forward")
        assert d2.depth == 2  # two dispatches in flight at launch
        PLANE.end(d2, None, block=False)
        PLANE.end(d1, None, block=False)
    finally:
        PLANE.disarm()
    assert stats.device_queue_depth in (1, 2)
    assert stats.device_sites["encoder.forward"][0] == 1
    assert 'device_site_queue_depth_total{site="encoder.forward"} 2' in (
        stats.render_openmetrics())


# -- (e) ingest: starved against blocked -------------------------------------

DELAY_S = 0.1
N_BATCHES = 5


def _ingest(monkeypatch, slow):
    enc = SentenceEncoder(EncoderConfig.tiny(), device=CPU, batch_size=8)
    shard = KnnShard(enc.embed_dim, "cos", device=CPU)
    pipe = IngestPipeline(enc, shard, depth=1, device=CPU)
    pipe.ingest(["warm"], ["a passage that takes the batch's bucket"])
    if slow == "tokenizer":
        inner = enc.tokenizer

        def tokenizer(texts, *a, **kw):
            time.sleep(DELAY_S)
            return inner(texts, *a, **kw)

        monkeypatch.setattr(enc, "tokenizer", tokenizer)
        # and a consumer that takes no time, however loaded the host
        monkeypatch.setattr(enc, "forward", lambda ids, mask, **kw: torch.ones(
            (ids.shape[0], enc.embed_dim)))
    else:
        write = shard._write_slots

        def slow_write(*a, **kw):
            time.sleep(DELAY_S)
            return write(*a, **kw)

        monkeypatch.setattr(shard, "_write_slots", slow_write)
    batches = [([f"k{b}-{i}" for i in range(8)], [f"passage {b} {i}" for i in range(8)])
               for b in range(N_BATCHES)]
    rec, _ = _armed()
    try:
        assert pipe.run(batches) == 8 * N_BATCHES
    finally:
        PLANE.disarm()
    total = {name: sum(s[3] - s[2] for s in _spans(rec, name)) / 1e9
             for name in ("ingest.wait_staged", "ingest.put_staged")}
    ids = {name: sorted(s[5] for s in _spans(rec, name))
           for name in ("ingest.stage", "ingest.put_staged", "ingest.dispatch",
                        "ingest.assign_slots")}
    assert all(v == list(range(1, N_BATCHES + 1)) for v in ids.values()), ids
    disp = sorted(e[-1] for e in rec.events if e[0] == "disp")
    assert disp == list(range(1, N_BATCHES + 1))
    return total


def test_a_slow_tokenizer_shows_as_the_consumer_starved(monkeypatch):
    t = _ingest(monkeypatch, "tokenizer")
    assert t["ingest.wait_staged"] >= 0.8 * N_BATCHES * DELAY_S
    assert t["ingest.put_staged"] < t["ingest.wait_staged"]


def test_a_slow_consumer_shows_as_the_producer_blocked(monkeypatch):
    t = _ingest(monkeypatch, "consumer")
    # the sleep is a floor under each dispatch, whatever else it costs
    assert t["ingest.put_staged"] >= 0.8 * (N_BATCHES - 2) * DELAY_S
    assert t["ingest.wait_staged"] < t["ingest.put_staged"]
