"""The yardstick's arithmetic on known shapes, and the metric readers on
a probe filled by hand."""

import os

import pytest

from rag_bench import arith, run
from rag_bench.probe import Probe


def _reader(name):
    return run.load_by_path(os.path.join(run.HERE, "metrics", f"{name}.py"),
                            "t_" + name.replace(".", "_"))


def test_encoder_flops_per_sequence():
    # one layer, h = 2, mlp = 4, one sequence of 3 tokens:
    # 3 * (8*4 + 4*2*4) + 4*9*2 = 3 * 64 + 72 = 264
    assert arith.encoder_flops(1, 2, 4, [3]) == 264.0
    assert arith.encoder_flops(12, 384, 1536, [10, 20]) == pytest.approx(
        12 * (30 * (8 * 384**2 + 4 * 384 * 1536) + 4 * (100 + 400) * 384))


def test_knn_bound_bytes_and_operations():
    n, d = 8_841_823, 384
    # one query: bytes bound, the live rows read once
    b1 = arith.knn_bound_s(1, n, d, 10, "highest")
    assert b1 == pytest.approx((4 * n * d + 4 * d + n + 80) / 3.35e12)
    assert b1 == pytest.approx(4.05e-3, rel=0.01)
    # 256 queries at three TF32 passes: operations bound
    ops = arith.knn_bound_s(256, n, d, 10, "highest")
    assert ops == pytest.approx(3 * 2 * 256 * n * d / 495e12)
    assert arith.knn_bound_s(256, n, d, 10, "default") == pytest.approx(ops / 3, rel=0.35)


def _probe():
    cfg = {"hidden_size": 384, "num_hidden_layers": 12, "intermediate_size": 1536,
           "deployment": {"k": 10, "precision": "highest"}}
    p = Probe(cfg)
    p.live_rows = 1_000_000
    p.batches = [4, 12]
    p.tokenize = [(0.002, [8, 10, 9, 7]), (0.004, [8] * 12)]
    p.sites = {"encoder.forward": [2, 0.01, 0.003, 0, 0, 0, 0],
               "knn.fused": [2, 0.02, 0.004, 0, 0, 0, 0]}
    p.window_s = 2.0
    p.profile = {"busy_s": 1.5, "window_s": 2.0, "device_ops": [], "idle_gaps": []}
    return p


def test_serve_readers():
    p = _probe()
    assert _reader("batcher.queries_per_batch.serve").read(p) == 8.0
    assert _reader("tokenize.host_ms.serve").read(p) == pytest.approx(3.0)
    assert _reader("encoder.device_ms.serve").read(p) == pytest.approx(1.5)
    assert _reader("knn.device_ms.serve").read(p) == pytest.approx(2.0)
    bound = sum(arith.knn_bound_s(q, 1_000_000, 384, 10, "highest") for q in (4, 12))
    assert _reader("fused_knn_roofline").read(p) == pytest.approx(100 * bound / 0.004)
    flops = arith.encoder_flops(12, 384, 1536, [8, 10, 9, 7] + [8] * 12) \
        + 2 * 16 * 1_000_000 * 384
    assert _reader("serve.mfu").read(p) == pytest.approx(100 * flops / (0.007 * 989e12))
    assert _reader("device.idle_share.serve").read(p) == pytest.approx(25.0)


def test_ingest_readers():
    p = _probe()
    p.sites = {"ingest.fused": [4, 1.0, 0.2, 0, 0, 0, 0]}
    assert _reader("ingest.device_ms").read(p) == pytest.approx(50.0)
    lengths = [8, 10, 9, 7] + [8] * 12
    assert _reader("ingest.mfu").read(p) == pytest.approx(
        100 * arith.encoder_flops(12, 384, 1536, lengths) / (2.0 * 989e12))
    assert _reader("device.idle_share.ingest").read(p) == pytest.approx(25.0)
    assert _reader("tokenize.host_ms.ingest").read(p) == pytest.approx(3.0)


@pytest.mark.parametrize("name", ["batcher.queries_per_batch.serve", "encoder.device_ms.serve",
                                  "knn.device_ms.serve", "fused_knn_roofline", "serve.mfu",
                                  "ingest.device_ms", "ingest.mfu", "device.idle_share.serve",
                                  "tokenize.host_ms.ingest"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    p = Probe({"hidden_size": 384, "num_hidden_layers": 12, "intermediate_size": 1536,
               "deployment": {"k": 10, "precision": "highest"}})
    assert _reader(name).read(p) is None


def test_roofline_reader_refuses_unmatched_launch_counts():
    p = _probe()
    p.batches = [4]
    assert _reader("fused_knn_roofline").read(p) is None
