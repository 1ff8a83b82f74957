"""The port's device plane on the CPU, against the JAX package's.

Error classification, supervised dispatch (retry, abort, OOM brownout,
watchdog) and the ``knn.grow`` fault point behave the same in both
packages; the port's dispatch records, card table and allocator view are
checked on their own (the CUDA-event records are in
tests/test_torch_cuda.py).
"""

import time

import numpy as np
import pytest
import torch

from pathway_tpu.internals import device as jdev
from pathway_tpu.internals import faults as jfaults
from pathway_tpu.internals.monitoring import ProberStats as JStats
from pathway_tpu.ops.knn import KnnShard as JShard
from pathway_tpu_torch.internals import device as tdev
from pathway_tpu_torch.internals import faults as tfaults
from pathway_tpu_torch.internals.monitoring import ProberStats as TStats
from pathway_tpu_torch.ops.knn import KnnShard as TShard

PACKAGES = {
    "jax": (jdev, jfaults, JStats, lambda d: JShard(d, "cos")),
    "torch": (tdev, tfaults, TStats, lambda d: TShard(d, "cos", device="cpu")),
}


@pytest.fixture(autouse=True)
def _isolate():
    for dev, faults, _, _ in PACKAGES.values():
        faults.reset()
        dev.PLANE.disarm()
    yield
    for dev, faults, _, _ in PACKAGES.values():
        faults.reset()
        dev.PLANE.disarm()


def _errors(faults):
    return [
        (MemoryError("full"), "oom"),
        (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), "oom"),
        (RuntimeError("UNAVAILABLE: try again"), "transient"),
        (RuntimeError("buffer was donated"), "permanent"),
        (ValueError("shape"), "permanent"),
        (faults.InjectedFault("device.dispatch", 1, retryable=True), "transient"),
        (faults.InjectedFault("device.dispatch", 1, retryable=False), "permanent"),
        (faults.InjectedFault("device.oom", 1), "oom"),
    ]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_classify_device_error(pkg):
    dev, faults, _, _ = PACKAGES[pkg]
    for exc, kind in _errors(faults):
        assert dev.classify_device_error(exc) == kind, exc
    assert dev.classify_device_error(dev.WatchdogTimeout("hung")) == "permanent"


def test_port_classifies_cuda_oom():
    exc = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")
    assert tdev.classify_device_error(exc) == "oom"


def _retry_then_succeed(dev, faults, stats_cls, monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_RETRIES", "3")
    faults.install_plan({"rules": [
        {"point": "device.dispatch", "hits": [1, 2], "action": "raise"},
    ]})
    stats = stats_cls()
    dev.PLANE.arm(None, stats)
    calls = []
    out = dev.supervised_dispatch("t.site", lambda: calls.append(1) or 42)
    return out, len(calls), stats.device_dispatch_retries, stats.device_dispatch_failures


def _abort(dev, faults, stats_cls, monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_RETRIES", "1")
    faults.install_plan({"rules": [{"point": "device.dispatch", "action": "raise"}]})
    stats = stats_cls()
    dev.PLANE.arm(None, stats)
    with pytest.raises(faults.InjectedFault):
        dev.supervised_dispatch("t.site", lambda: 1)
    return stats.device_dispatch_retries, stats.device_dispatch_failures


def _brownout(dev, faults, stats_cls, monkeypatch):
    seen = []
    dev.on_oom(seen.append)
    stats = stats_cls()
    dev.PLANE.arm(None, stats)
    try:
        def boom():
            raise MemoryError("device memory full")

        with pytest.raises(dev.DeviceOom):
            dev.supervised_dispatch("t.oom", boom)
    finally:
        dev.remove_oom_listener(seen.append)
    return seen, stats.device_oom_events, stats.device_dispatch_failures


def _watchdog(dev, faults, stats_cls, monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_DISPATCH_TIMEOUT_S", "0.15")
    stats = stats_cls()
    dev.PLANE.arm(None, stats)
    t0 = time.monotonic()
    with pytest.raises(dev.WatchdogTimeout):
        dev.supervised_dispatch("t.hang", lambda: time.sleep(3))
    assert time.monotonic() - t0 < 2.5
    return stats.device_watchdog_trips, stats.device_dispatch_retries


def _grow_oom(dev, faults, make_shard):
    rng = np.random.default_rng(11)
    idx = make_shard(8)  # 128 slots
    first = rng.normal(size=(128, 8)).astype(np.float32)
    idx.add(list(range(128)), first)
    faults.install_plan({"rules": [{"point": "device.oom", "action": "raise"}]})
    more = rng.normal(size=(8, 8)).astype(np.float32)
    with pytest.raises(dev.DeviceOom):
        idx.add(list(range(200, 208)), more)
    served = (len(idx), idx.capacity, idx.search(first[:1], 1)[0][0][0])
    faults.clear_plan()
    idx.add(list(range(200, 208)), more)
    return served, len(idx), idx.capacity


SUPERVISION = {
    "retry_then_succeed": _retry_then_succeed,
    "exhausted_budget_aborts": _abort,
    "oom_browns_out": _brownout,
    "watchdog_trips": _watchdog,
}


@pytest.mark.parametrize("name", sorted(SUPERVISION))
def test_supervised_dispatch_matches_the_jax_package(name, monkeypatch):
    results = {}
    for pkg, (dev, faults, stats_cls, _) in PACKAGES.items():
        results[pkg] = SUPERVISION[name](dev, faults, stats_cls, monkeypatch)
        dev.PLANE.disarm()
        faults.reset()
    assert results["torch"] == results["jax"]


def test_grow_oom_refuses_growth_and_keeps_serving_as_the_jax_package():
    results = {
        pkg: _grow_oom(dev, faults, make)
        for pkg, (dev, faults, _, make) in PACKAGES.items()
    }
    assert results["jax"] == ((128, 128, 0), 136, 256)
    assert results["torch"] == results["jax"]


def test_cpu_dispatch_records():
    """On the CPU a launch is synchronous: its device time is its host
    span, and a host-only record has none."""
    stats = TStats()
    tdev.PLANE.arm(None, stats)
    shard = TShard(16, "cos", device="cpu")
    x = torch.randn(300, 16, generator=torch.Generator().manual_seed(0))
    shard.add(range(300), x)
    assert shard.search(x[:3], 5)[1][0][0] == 1
    d = tdev.PLANE.begin("serve.window")
    tdev.PLANE.end(d, None, block=False)
    tdev.PLANE.disarm()
    sites = stats.device_sites
    assert set(sites) == {"knn.write", "knn.search", "serve.window"}
    for name in ("knn.write", "knn.search"):
        count, wall_s, device_s = sites[name][:3]
        assert count == 1 and wall_s > 0 and device_s == wall_s
    assert sites["serve.window"][2] == 0.0
    # flops_effective: live rows over the pow2 capacity
    assert 0 < sites["knn.search"][6] < sites["knn.search"][3]
    assert not stats.device_hbm_available  # no CUDA: no allocator story


def test_registered_sites():
    import pathway_tpu_torch.models.encoder  # noqa: F401

    sites = tdev.registered_sites()
    import pathway_tpu_torch.ops.ingest  # noqa: F401

    assert {"knn.write", "knn.search", "encoder.forward", "ingest.fused"} <= set(sites)
    assert sites["knn.search"].cost_model(1, 1024, 384, 10)[0] > 0


@pytest.mark.parametrize("kind,bf16,tf32,bw", [
    ("NVIDIA H100 80GB HBM3", 989e12, 495e12, 3.35e12),
    ("NVIDIA H100 PCIe", 756e12, 378e12, 2.0e12),
])
def test_card_table(kind, bf16, tf32, bw, monkeypatch):
    monkeypatch.delenv("PATHWAY_DEVICE_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("PATHWAY_DEVICE_PEAK_GBPS", raising=False)
    assert tdev.peak_flops(kind) == bf16
    assert tdev.peak_bandwidth(kind) == bw
    rates = tdev.peak_rates(kind)
    assert rates["tf32"] == tf32 and rates["fp32"] < rates["tf32"]
    assert tdev.peak_rates("some other card") is None


def test_no_device_story_without_cuda():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        pytest.skip("CUDA is initialised in this process")
    assert tdev.memory_stats() is None
    assert tdev.platform_info() is None
    assert tdev.device_kind() == ""


# -- supervised ingest and the recompile counter -----------------------------

TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "pack my box with five dozen liquor jugs",
    "sphinx of black quartz judge my vow",
    "how vexingly quick daft zebras jump",
    "a live dataflow framework for tpu pods",
]


def _pipeline(pkg, capacity=128):
    """(encoder, shard, IngestPipeline) of the tiny encoder in ``pkg``."""
    if pkg == "jax":
        from pathway_tpu.models.encoder import EncoderConfig, SentenceEncoder
        from pathway_tpu.ops.ingest import IngestPipeline

        enc = SentenceEncoder(EncoderConfig.tiny())
        shard = JShard(enc.embed_dim, "cos", capacity=capacity)
        return enc, shard, IngestPipeline(enc, shard)
    from pathway_tpu_torch.models.encoder import EncoderConfig, SentenceEncoder
    from pathway_tpu_torch.ops.ingest import IngestPipeline

    enc = SentenceEncoder(EncoderConfig.tiny(), device="cpu")
    shard = TShard(enc.embed_dim, "cos", capacity=capacity, device="cpu")
    return enc, shard, IngestPipeline(enc, shard, device="cpu")


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_ingest_producer_restarts_through_classifier(pkg):
    dev, faults, Stats, _ = PACKAGES[pkg]
    _, shard, pipe = _pipeline(pkg)
    texts = ["alpha beta", "gamma delta", "epsilon zeta", "eta theta"]
    batches = [(["a", "b"], texts[:2]), (["c", "d"], texts[2:])]
    # transient staging failures (device.h2d) restart the producer on the
    # SAME batch with backoff; the run completes with no loss
    faults.install_plan({"rules": [
        {"point": "device.h2d", "hits": [1, 3], "action": "raise"},
    ]})
    stats = Stats()
    dev.PLANE.arm(None, stats)
    try:
        assert pipe.run(iter(batches)) == 4
    finally:
        dev.PLANE.disarm()
    assert len(shard) == 4
    assert stats.device_dispatch_retries.get("ingest.fused") == 2
    if pkg == "torch":
        # each row equals a fault-free ingest of the same batch, and no
        # slot was assigned twice
        faults.clear_plan()
        _, clean, clean_pipe = _pipeline(pkg)
        clean_pipe.run(iter(batches))
        assert shard.key_to_slot == clean.key_to_slot
        assert torch.equal(shard.vectors, clean.vectors)
        assert torch.equal(shard.valid, clean.valid)
    # a permanent staging failure surfaces raw: no endless restart
    faults.clear_plan()
    faults.install_plan({"rules": [
        {"point": "device.h2d", "action": "raise", "retryable": False},
    ]})
    with pytest.raises(faults.InjectedFault):
        pipe.run(iter([(["e"], ["iota kappa"])]))
    assert len(shard) == 4


def test_ingest_fault_fires_before_the_copy_is_staged():
    """The ``device.h2d`` point fires before anything of the batch is
    staged, and a fault in the chain itself (``device.dispatch``) retries
    the launch under ``supervised_dispatch`` without a second slot."""
    _, shard, pipe = _pipeline("torch")
    tfaults.install_plan({"rules": [
        {"point": "device.dispatch", "hits": [1], "action": "raise"},
    ]})
    stats = TStats()
    tdev.PLANE.arm(None, stats)
    try:
        pipe.ingest(["a", "b"], TEXTS[:2])
    finally:
        tdev.PLANE.disarm()
    assert len(shard) == 2 and shard.key_to_slot == {"a": 0, "b": 1}
    assert stats.device_dispatch_retries.get("ingest.fused") == 1
    tfaults.clear_plan()
    tfaults.install_plan({"rules": [
        {"point": "device.h2d", "action": "raise", "retryable": False},
    ]})
    with pytest.raises(tfaults.InjectedFault):
        pipe._stage(["c"], TEXTS[2:3])
    assert len(shard) == 2


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_ingest_recompile_counter_counts_new_buckets_once(pkg):
    dev, _, Stats, _ = PACKAGES[pkg]
    _, _, pipe = _pipeline(pkg)
    stats = Stats()
    dev.PLANE.arm(None, stats)
    try:
        keys = [f"doc{i}" for i in range(len(TEXTS))]
        pipe.ingest(keys, TEXTS)        # a new (batch, seq, cap) bucket
        pipe.ingest(keys, TEXTS)        # the same bucket
        # 20 docs land in a larger pow2 batch bucket
        pipe.ingest([f"n{i}" for i in range(20)], TEXTS * 4)
    finally:
        dev.PLANE.disarm()
    assert stats.device_recompiles == {"ingest.fused": 2}
    text = stats.render_openmetrics()
    assert "device_recompiles_total 2" in text
    assert 'device_site_recompiles_total{site="ingest.fused"} 2' in text


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_encoder_bucket_cache_notes_recompiles(pkg):
    dev, _, Stats, _ = PACKAGES[pkg]
    enc, _, _ = _pipeline(pkg)
    stats = Stats()
    dev.PLANE.arm(None, stats)
    try:
        enc.encode(TEXTS)       # a fresh (batch, seq) bucket
        enc.encode(TEXTS)       # cached: no new note
        enc.encode(TEXTS * 4)   # a larger batch bucket
    finally:
        dev.PLANE.disarm()
    assert stats.device_recompiles == {"encoder.forward": 2}
    assert "device_recompiles_total 2" in stats.render_openmetrics()


def test_ingest_site_records_effective_flops():
    _, _, pipe = _pipeline("torch")
    stats = TStats()
    tdev.PLANE.arm(None, stats)
    try:
        pipe.ingest([f"d{i}" for i in range(len(TEXTS))], TEXTS)
    finally:
        tdev.PLANE.disarm()
    agg = stats.device_sites.get("ingest.fused")
    assert agg is not None and agg[0] == 1
    # 5 real docs in a pow2 batch bucket with padded seq: the effective
    # share is the real-token fraction, strictly below 1
    assert 0 < agg[6] < agg[3]
    assert ('device_site_flops_effective_total{site="ingest.fused"}'
            in stats.render_openmetrics())


def test_knn_sites_note_the_buckets_the_jax_package_notes():
    rng = np.random.default_rng(0)
    counts = {}
    for pkg, (dev, _, Stats, make) in PACKAGES.items():
        shard = make(16)
        stats = Stats()
        dev.PLANE.arm(None, stats)
        try:
            for n in (3, 3, 5, 200):  # 200 rows grow the capacity
                shard.add([f"{n}-{i}" for i in range(n)],
                          rng.normal(size=(n, 16)).astype(np.float32))
            for q, k in ((1, 5), (1, 5), (3, 5), (3, 7), (9, 5)):
                shard.search(rng.normal(size=(q, 16)).astype(np.float32), k)
        finally:
            dev.PLANE.disarm()
        counts[pkg] = dict(stats.device_recompiles)
    assert counts["torch"] == counts["jax"]
    assert counts["torch"] == {"knn.write": 3, "knn.search": 4}
