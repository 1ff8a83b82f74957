"""The readers of the program's spans and queue depth, on a probe filled
by hand with flight-recorder events, and on probes that lack them."""

import os

import numpy as np
import pytest

from rag_bench import run, spans
from rag_bench.probe import Probe

MS = 1_000_000  # ns
SPAN_READERS = ["batcher.queue_wait_p95_ms.serve", "dispatch.host_ms.serve",
                "dispatch.offcpu_pct.serve", "encoder.h2d_ms.serve",
                "readback.wait_ms.serve", "finish.keymap_ms.serve",
                "ingest.starved_ms", "ingest.blocked_ms"]


def _reader(name):
    return run.load_by_path(os.path.join(run.HERE, "metrics", f"{name}.py"),
                            "t_" + name.replace(".", "_"))


def _span(name, t0_ms, wall_ms, cpu_ms, trace_id, ident=7, **args):
    cpu = None if cpu_ms is None else int(cpu_ms * MS)
    return ("span", name, ident, int(t0_ms * MS), int((t0_ms + wall_ms) * MS), cpu,
            trace_id, args)


def _probe():
    p = Probe({})
    p.program = [
        _span("serve.queue_wait", 0, 1.0, None, 1, ident=1),
        _span("serve.queue_wait", 0, 2.0, None, 1, ident=2),
        _span("serve.queue_wait", 5, 3.0, None, 2, ident=3),
        _span("serve.queue_wait", 5, 4.0, None, 2, ident=4),
        _span("serve.dispatch", 2, 6.0, 2.0, 1, n=2),
        _span("serve.dispatch", 9, 4.0, 3.0, 2, n=2),
        _span("encoder.h2d", 3, 1.5, 0.1, 1),
        _span("encoder.h2d", 10, 0.5, 0.1, 2),
        _span("serve.readback", 9, 7.0, 0.2, 1, ident=8),
        _span("serve.readback", 14, 5.0, 0.2, 2, ident=9),
        _span("serve.keymap", 16, 0.25, 0.25, 1, ident=8),
        _span("serve.keymap", 19, 0.75, 0.7, 2, ident=9),
        _span("serve.handoff", 17, 0.1, None, 1, ident=1),
        ("disp", "encoder.forward", 1, None, None, 3 * MS, 3 * MS, 8 * MS, 0.0, 0.0,
         0, 1, 0.0, 1),
    ]
    p.sites = {"encoder.forward": [2, 0.1, 0.01, 0, 0, 0, 0, 3],
               "knn.fused": [2, 0.1, 0.01, 0, 0, 0, 0, 5]}
    return p


def test_serve_span_readers():
    p = _probe()
    waits = [1.0, 2.0, 3.0, 4.0]
    assert _reader("batcher.queue_wait_p95_ms.serve").read(p) == pytest.approx(
        float(np.percentile(waits, 95)))
    assert _reader("dispatch.host_ms.serve").read(p) == pytest.approx(5.0)
    # off-CPU: (6 - 2) + (4 - 3) of 10 ms of wall
    assert _reader("dispatch.offcpu_pct.serve").read(p) == pytest.approx(50.0)
    assert _reader("encoder.h2d_ms.serve").read(p) == pytest.approx(1.0)
    assert _reader("readback.wait_ms.serve").read(p) == pytest.approx(6.0)
    assert _reader("finish.keymap_ms.serve").read(p) == pytest.approx(0.5)
    # mean depth over both sites' four launches
    assert _reader("device.queue_depth.serve").read(p) == pytest.approx(2.0)


def test_offcpu_share_never_counts_cpu_above_wall():
    p = Probe({})
    p.program = [_span("serve.dispatch", 0, 2.0, 2.001, 1)]
    assert _reader("dispatch.offcpu_pct.serve").read(p) == 0.0


def test_ingest_span_readers():
    p = Probe({})
    p.program = [
        _span("ingest.wait_staged", 0, 30.0, 0.1, 1, ident=2),
        _span("ingest.put_staged", 5, 1.0, 0.1, 1),
        _span("ingest.wait_staged", 40, 10.0, 0.1, 2, ident=2),
        _span("ingest.put_staged", 45, 3.0, 0.1, 2),
        # the wait that met the end of the stream belongs to no batch
        _span("ingest.wait_staged", 60, 99.0, 0.1, None, ident=2),
    ]
    assert _reader("ingest.starved_ms").read(p) == pytest.approx(20.0)
    assert _reader("ingest.blocked_ms").read(p) == pytest.approx(2.0)


@pytest.mark.parametrize("name", SPAN_READERS + ["device.queue_depth.serve"])
def test_a_probe_without_the_programs_spans_reads_nothing(name):
    p = Probe({})
    # what an accepted probe keeps of a program without spans or depth sums
    p.sites = {"encoder.forward": [2, 0.1, 0.01, 0, 0, 0, 0]}
    assert _reader(name).read(p) is None
    p.program = []
    assert _reader(name).read(p) is None


def test_thread_spans_leave_out_the_requests_waits():
    p = _probe()
    got = spans.thread_spans(p)
    names = {name for _, _, name in got}
    assert names == {"serve.dispatch", "encoder.h2d", "serve.readback", "serve.keymap"}
    assert (2 * MS, 8 * MS, "serve.dispatch") in got


@pytest.mark.parametrize("cell", ["msmarco-serve", "nq-ingest"])
def test_the_spans_script_walks_a_tiny_cell(cell, capsys, tmp_path):
    """``scripts/rag_spans.py traced`` at the tests' CPU geometry: the
    result line stays correct and the program's spans are read."""
    import json

    script = run.load_by_path(os.path.join(run.ROOT, "scripts", "rag_spans.py"),
                              "t_rag_spans")
    out = tmp_path / "spans.json"
    arm, close = Probe.arm, Probe.close
    rc = script.main(["traced", "--workload", cell, "--seed", str(2**31 + 5),
                      "--seconds", "1.5", "--tiny", "--out", str(out)])
    assert (Probe.arm, Probe.close) == (arm, close)  # the harness put back
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and json.loads(lines[-2])["correct"] is True
    got = json.loads(out.read_text())
    assert got == json.loads(lines[-1])
    if cell == "msmarco-serve":
        assert got["readers"]["dispatch.host_ms.serve"] > 0
        assert got["agreement"]["queries_per_batch"][0] == pytest.approx(
            got["agreement"]["queries_per_batch"][1])
        assert got["request"]["requests"] > 0
    else:
        assert got["readers"]["ingest.blocked_ms"] is not None
    assert got["dispatch_records_with_trace_id"] == got["dispatch_records"] > 0
