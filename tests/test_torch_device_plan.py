"""The port's Device Doctor (``pathway_tpu_torch/analysis/device_plan.py``)
against the JAX package's, on the CPU.

Both packages analyze the same declared workloads in one process. Their
verdicts, chain verdicts, diagnostic codes/severities/nodes, per-site
shape-bucket predictions and device-memory budgets (bytes exactly) must
be equal, under the port's names for the kernel site and its chain
(``knn.fused`` / ``fused`` for the JAX package's ``pallas.topk`` /
``pallas``). The port's own contract is checked beside: its chains are
traced on meta tensors (no launch, no allocation, no dispatch record),
they are the very functions the runtime launches (identity pins), and
the predictions equal the shape buckets a real run meets.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from pathway_tpu.analysis import device_plan as jdp
from pathway_tpu.analysis import knobs as jknobs
from pathway_tpu.internals import device as jdev
from pathway_tpu.internals.monitoring import ProberStats as JStats
from pathway_tpu.models import encoder as jenc
from pathway_tpu_torch.analysis import device_plan as tdp
from pathway_tpu_torch.analysis import knobs as tknobs
from pathway_tpu_torch.internals import device as tdev
from pathway_tpu_torch.internals.monitoring import ProberStats as TStats
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.ops import fused_knn

# the port's names for the JAX package's kernel site and chain
SITE = {"pallas.topk": "knn.fused"}
CHAIN = {"pallas": "fused"}


@pytest.fixture(autouse=True)
def _fresh():
    """Knob memos reset, planes off, and the kernel site's process-wide
    seen-bucket set empty for the test and as it was afterwards."""
    seen = set(fused_knn._SEEN_BUCKETS)
    fused_knn._SEEN_BUCKETS.clear()
    for knobs in (jknobs, tknobs):
        knobs._checked = None
    for dev in (jdev, tdev):
        dev.PLANE.disarm()
    yield
    for knobs in (jknobs, tknobs):
        knobs._checked = None
    for dev in (jdev, tdev):
        dev.PLANE.disarm()
    fused_knn._SEEN_BUCKETS.clear()
    fused_knn._SEEN_BUCKETS.update(seen)


def _agreed(d: dict, site=lambda s: s, chain=lambda c: c) -> dict:
    """The parts of a device-plan dict both packages must agree on, under
    the port's names. The kernel site's buckets differ in shape (the
    JAX key carries the Pallas block), so it is held by its count."""
    preds = {}
    for s, p in d["predictions"].items():
        name = site(s)
        preds[name] = (
            p["recompiles"] if name == "knn.fused"
            else (p["buckets"], p["recompiles"])
        )
    return {
        "verdict": d["verdict"],
        "world": d["world"],
        "chains": {chain(c): v for c, v in d["chains"].items()},
        "predictions": preds,
        "hbm": d["hbm"],
        "diagnostics": [
            (x["code"], x["severity"], site(x["node"])) for x in d["diagnostics"]
        ],
        "summary": d["summary"],
    }


def _both(config="tiny", world=1, mutant=None, **spec):
    jcfg = getattr(jenc.EncoderConfig, config)()
    tcfg = getattr(tenc.EncoderConfig, config)()
    j = jdp.analyze_device_plan(
        workload=jdp.WorkloadSpec(**spec), world=world, config=jcfg,
        mutant=mutant,
    )
    t = tdp.analyze_device_plan(
        workload=tdp.WorkloadSpec(**spec), world=world, config=tcfg,
        mutant=mutant,
    )
    return j, t


def _assert_agree(j, t):
    jd, td = j.to_dict(), t.to_dict()
    assert jd["schema"] == "pathway_tpu.analysis.device/v1"
    assert td["schema"] == "pathway_tpu_torch.analysis.device/v1"
    want = _agreed(jd, site=lambda s: SITE.get(s, s),
                   chain=lambda c: CHAIN.get(c, c))
    assert _agreed(td) == want


# -- the two doctors agree ---------------------------------------------------

@pytest.mark.parametrize("mutant", [None, *tdp.MUTANTS])
def test_doctor_matches_the_jax_package(mutant):
    assert tdp.MUTANTS == jdp.MUTANTS
    j, t = _both(mutant=mutant)
    _assert_agree(j, t)
    assert t.verdict == ("device-clean" if mutant is None else "device-dirty")


WORKLOADS = {
    "world3_tree_merge": (
        dict(world=3), {"PATHWAY_INDEX_MERGE": "tree"}, "device-degraded"),
    "world4_tree_merge": (
        dict(world=4), {"PATHWAY_INDEX_MERGE": "tree"}, "device-clean"),
    "sharded_corpus_world8": (
        dict(world=8, corpus_rows=2**22), {}, "device-clean"),
    "one_card_corpus_over_8gib": (
        dict(world=1, corpus_rows=2**25), {}, "device-dirty"),
    "tiny_budget": (dict(), {"PATHWAY_DEVICE_HBM_BYTES": "1000000"}, "device-dirty"),
    "large_budget": (
        dict(corpus_rows=2**27), {"PATHWAY_DEVICE_HBM_BYTES": str(10**15)},
        "device-clean"),
    "excessive_buckets": (
        dict(ingest_batches=tuple((8 * (i + 1), 32 * (i + 1)) for i in range(4))),
        {"PATHWAY_DEVICE_PLAN_MAX_BUCKETS": "2"}, "device-degraded"),
    "equal_shapes": (
        dict(ingest_batches=((64, 40), (64, 40)), write_batches=(64, 64),
             query_batches=(1, 1)), {}, "device-clean"),
    "capacity_growth": (
        dict(ingest_batches=((64, 40),) * 3, write_batches=(64,) * 3),
        {}, "device-clean"),
    "bge_small_full_corpus": (
        dict(config="bge_small", corpus_rows=2**20, initial_capacity=2**20,
             query_batches=(1, 32, 256), ingest_batches=((256, 150), (256, 190))),
        {"PATHWAY_DEVICE_HBM_BYTES": str(80 * 10**9)}, "device-clean"),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_doctor_matches_the_jax_package_on_workloads(name, monkeypatch):
    kw, env, verdict = WORKLOADS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j, t = _both(**kw)
    _assert_agree(j, t)
    assert t.verdict == verdict


def test_sharding_amortizes_the_footprint():
    one = tdp.analyze_device_plan(workload=tdp.WorkloadSpec(corpus_rows=2**22))
    eight = tdp.analyze_device_plan(
        workload=tdp.WorkloadSpec(corpus_rows=2**22), world=8)
    assert eight.hbm["per_chip_capacity"] < one.hbm["per_chip_capacity"]
    assert eight.hbm["footprint_bytes"] < one.hbm["footprint_bytes"]


# -- zero execution ----------------------------------------------------------

def test_shipped_chains_analyze_clean_with_zero_execution():
    """Verdicts before a single dispatch runs: the port's plane is armed
    during the analysis, and a chain that executed would leave a dispatch
    record, a recompile tick or a kernel launch behind."""
    stats = TStats()
    tdev.PLANE.arm(None, stats)
    launches = dict(fused_knn.LAUNCHES)
    try:
        report = tdp.analyze_device_plan()
    finally:
        tdev.PLANE.disarm()
    assert report.verdict == "device-clean" and report.device_clean
    assert set(report.chains) == {"ingest", "knn", "sharded", "encoder", "fused"}
    assert all(v == "clean" for v in report.chains.values())
    assert stats.device_sites == {}, "analysis must not dispatch"
    assert stats.device_recompiles == {}, "analysis must not capture"
    assert fused_knn.LAUNCHES == launches and not fused_knn._SEEN_BUCKETS
    d = report.to_dict()
    for site in ("ingest.fused", "knn.write", "knn.search", "knn.sharded_write",
                 "knn.sharded_search", "encoder.forward", "knn.fused"):
        assert d["predictions"][site]["recompiles"] >= 1
    assert d["hbm"]["footprint_bytes"] > 0 and d["hbm"]["budget_bytes"] > 0
    json.loads(report.to_json())
    assert "device plan verdict: DEVICE-CLEAN" in report.render()


# -- the seeded defects, with the port's provenance --------------------------

MUTANT_BLAME = {
    "undonated_write": ("device.donation", "ingest.fused", "ops/ingest.py",
                        "MB", "in place"),
    "host_sync": ("device.host_sync", "ingest.fused", "ops/ingest.py",
                  ".item()", "device"),
    "unbounded_buckets": ("device.retrace.unbounded", "ingest.fused",
                          "ops/ingest.py", "CUDA graph", "cap"),
    "over_budget": ("device.hbm.over_budget", "knn.write", "sharded_knn.py",
                    "OOMs", "PATHWAY_DEVICE_HBM_BYTES"),
}


@pytest.mark.parametrize("mutant", sorted(MUTANT_BLAME))
def test_mutant_blame_and_provenance(mutant):
    code, node, where, in_message, in_hint = MUTANT_BLAME[mutant]
    report = tdp.analyze_device_plan(mutant=mutant)
    assert report.verdict == "device-dirty"
    [d] = [x for x in report.diagnostics if x.code == code][:1]
    assert d.severity == "error" and d.node == node
    assert where in d.where
    assert in_message in d.message and in_hint in d.hint
    if mutant in ("undonated_write", "host_sync"):
        # the defect is localized to its chain
        assert report.chains["ingest"] == "dirty"
        assert report.chains["knn"] == "clean"
    if mutant == "over_budget":
        assert report.hbm["footprint_bytes"] > report.hbm["budget_bytes"]


def test_unknown_mutant_rejected():
    with pytest.raises(ValueError, match="unknown device mutant"):
        tdp.analyze_device_plan(mutant="nope")


# -- the audits read real signals --------------------------------------------

def _buffers(cap=128, d=16, rows=4):
    m = tdp.meta
    return (m((cap, d), torch.float32), m((cap,), torch.bool),
            m((cap,), torch.float32), m((rows,), torch.int64),
            m((rows, d), torch.float32))


def test_inplace_audit_sees_the_shipped_write_and_a_copy():
    """Positive half: the shipped ``write_slots`` writes each of the three
    buffer inputs in place; negative half: the same write into clones
    writes none of them."""
    from pathway_tpu_torch.ops.knn import write_slots

    def shipped(v, m, s, idx, rows):
        write_slots(v, m, s, idx, rows, True, normalize=True)

    def copied(v, m, s, idx, rows):
        write_slots(v.clone(), m.clone(), s.clone(), idx, rows, True)

    assert tdp.written_inputs(tdp.trace_chain(shipped, _buffers())) == {0, 1, 2}
    assert tdp.written_inputs(tdp.trace_chain(copied, _buffers())) == set()


@pytest.mark.parametrize("read", ["item", "tolist", "cpu", "bool", "float"])
def test_host_sync_audit_catches_every_host_read(read):
    def chain(v, m, s, idx, rows):
        x = rows.sum()
        if read == "item":
            x = x.item()
        elif read == "tolist":
            x = rows.tolist()[0][0]
        elif read == "cpu":
            x = rows.cpu()
        elif read == "bool":
            x = float(bool(x))
        else:
            x = float(x)
        return rows * (x if not torch.is_tensor(x) else x.sum())

    diags: list = []
    assert tdp._host_sync_check(chain, _buffers(), "knn.write", "w", diags) is None
    [d] = diags
    assert d.code == "device.host_sync" and d.severity == "error"


def test_no_cuda_is_initialised_by_the_doctor():
    tdp.analyze_device_plan(config=tenc.EncoderConfig.tiny())
    assert not torch.cuda.is_initialized()


# -- the traced chains are the runtime's functions ---------------------------

def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(a[0] if a else None)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _drive_knn():
    from pathway_tpu_torch.ops.knn import KnnShard

    shard = KnnShard(16, "cos", device="cpu")
    x = torch.randn(40, 16, generator=torch.Generator().manual_seed(0))
    shard.add(range(40), x)
    shard.search(x[:3], 4)


def _drive_ingest():
    from pathway_tpu_torch.models.encoder import EncoderConfig, SentenceEncoder
    from pathway_tpu_torch.ops.ingest import IngestPipeline
    from pathway_tpu_torch.ops.knn import KnnShard

    enc = SentenceEncoder(EncoderConfig.tiny(), device="cpu")
    shard = KnnShard(enc.embed_dim, "cos", device="cpu")
    IngestPipeline(enc, shard, device="cpu").ingest(["a", "b"], ["x y", "z"])


def _drive_sharded():
    from pathway_tpu_torch.parallel import ShardedKnnIndex, make_mesh

    idx = ShardedKnnIndex(16, make_mesh(devices=["cpu"] * 2, axes=("dp",)))
    x = torch.randn(40, 16, generator=torch.Generator().manual_seed(1))
    idx.add(range(40), x)
    idx.search(x[:3], 4)


PINS = {
    "knn.write_slots": ("pathway_tpu_torch.ops.knn", "write_slots", _drive_knn),
    "knn.search_topk": ("pathway_tpu_torch.ops.knn", "search_topk", _drive_knn),
    "ingest.fused_chain": ("pathway_tpu_torch.ops.ingest", "fused_chain", _drive_ingest),
    "sharded.sharded_write_slots": (
        "pathway_tpu_torch.parallel.sharded_knn", "sharded_write_slots", _drive_sharded),
    "sharded.sharded_topk": (
        "pathway_tpu_torch.parallel.sharded_knn", "sharded_topk", _drive_sharded),
}


@pytest.mark.parametrize("pin", sorted(PINS))
def test_doctor_traces_the_function_the_runtime_launches(pin, monkeypatch):
    """One module-level function per chain: replacing it replaces what
    the runtime launches AND what the doctor traces, so the two cannot
    drift (the JAX package pins ``make_fused``/``_write_slots`` so)."""
    import importlib

    mod_name, name, drive = PINS[pin]
    calls = _spy(monkeypatch, importlib.import_module(mod_name), name)
    drive()
    runtime_calls = len(calls)
    assert runtime_calls >= 1, f"the runtime does not launch {name}"
    tdp.analyze_device_plan()
    assert len(calls) > runtime_calls, f"the doctor does not trace {name}"


# -- predictions: the same bucket functions as the runtime -------------------

def test_bucket_simulations_match_the_jax_package():
    for kw, n_ingest, n_write, n_search in (
        (dict(ingest_batches=((64, 40), (64, 40)), write_batches=(64, 64),
              query_batches=(1, 1), ks=(10,)), 1, 1, 1),
        (dict(ingest_batches=((64, 40),) * 3, write_batches=(64,) * 3), 2, 2, 2),
    ):
        js, ts = jdp.WorkloadSpec(**kw), tdp.WorkloadSpec(**kw)
        ti = tdp.simulate_ingest_buckets(ts, tenc.EncoderConfig.tiny())
        assert ti == jdp.simulate_ingest_buckets(js, jenc.EncoderConfig.tiny())
        assert len(ti) == n_ingest
        tw, tsb = tdp.simulate_knn_buckets(ts)
        assert (tw, tsb) == jdp.simulate_knn_buckets(js)
        assert (len(tw), len(tsb)) == (n_write, n_search)
        for world in (1, 2, 4):
            assert tdp.simulate_sharded_buckets(ts, world) == (
                jdp.simulate_sharded_buckets(js, world))


def test_predicted_ingest_recompiles_equal_the_runtime():
    """The fused ingest chain driven with the declared batches meets
    exactly the predicted bucket set (its recompile counter and the
    encoder's per-bucket entries), as the JAX package's pipeline does."""
    from pathway_tpu_torch.models.encoder import EncoderConfig, SentenceEncoder
    from pathway_tpu_torch.ops.ingest import IngestPipeline
    from pathway_tpu_torch.ops.knn import KnnShard

    cfg = EncoderConfig.tiny()
    enc = SentenceEncoder(cfg, device="cpu")
    shard = KnnShard(cfg.hidden, capacity=128, device="cpu")
    pipe = IngestPipeline(enc, shard, device="cpu")
    word = "retrieval"
    batches = [
        [" ".join([word] * 3)] * 4,
        [" ".join([word] * 3)] * 4,
        [" ".join([word] * 20)] * 4,
        [" ".join([word] * 3)] * 12,
    ]
    declared = tuple(
        (len(texts), enc.tokenizer(list(texts))[0].shape[1]) for texts in batches
    )
    spec = tdp.WorkloadSpec(ingest_batches=declared, batch_cap=enc.batch_size,
                            initial_capacity=shard.capacity)
    predicted = tdp.simulate_ingest_buckets(spec, cfg)
    stats = TStats()
    tdev.PLANE.arm(None, stats)
    try:
        for i, texts in enumerate(batches):
            pipe.ingest([f"k{i}-{j}" for j in range(len(texts))], texts)
    finally:
        tdev.PLANE.disarm()
    assert stats.device_recompiles["ingest.fused"] == len(predicted)
    assert {b for s, b in enc._graphs if s == "ingest.fused"} == predicted
    joined = tdp.join_profile(
        tdp.analyze_device_plan(workload=spec),
        {"device_recompiles": dict(stats.device_recompiles)},
    )
    assert joined.predictions["ingest.fused"]["drift"] == "ok"
    assert joined.verdict == "device-clean"


def test_predicted_knn_recompiles_equal_the_runtime():
    from pathway_tpu_torch.ops.knn import KnnShard

    write_batches, query_batches, ks = (16, 16, 48, 96), (1, 3, 8), (5, 10)
    spec = tdp.WorkloadSpec(write_batches=write_batches,
                            query_batches=query_batches, ks=ks,
                            initial_capacity=128)
    pred_write, pred_search = tdp.simulate_knn_buckets(spec)
    shard = KnnShard(8, capacity=128, device="cpu")
    rng = np.random.default_rng(7)
    stats = TStats()
    tdev.PLANE.arm(None, stats)
    try:
        seq = 0
        for b in write_batches:
            shard.add([f"k{seq + j}" for j in range(b)],
                      rng.normal(size=(b, 8)).astype(np.float32))
            seq += b
        for q in query_batches:
            for k in ks:
                shard.search(rng.normal(size=(q, 8)).astype(np.float32), k=k)
        # the fused pair's site, called as the card's searches call it
        for q in query_batches:
            for k in ks:
                k_eff = min(k, shard.capacity)
                fused_knn.fused_topk_scores(
                    torch.zeros(q, 8), shard.vectors, shard.valid, k_eff)
    finally:
        tdev.PLANE.disarm()
    assert stats.device_recompiles["knn.write"] == len(pred_write)
    assert stats.device_recompiles["knn.search"] == len(pred_search)
    assert shard._seen_buckets == pred_write | pred_search
    # the kernel site meets exactly the predicted launch plans
    assert fused_knn._SEEN_BUCKETS == tdp.simulate_fused_buckets(spec, 8)
    assert stats.device_recompiles["knn.fused"] == len(fused_knn._SEEN_BUCKETS)


def test_join_profile_drift_matches_the_jax_package():
    for pkg in (jdp, tdp):
        predicted = pkg.analyze_device_plan().predictions["ingest.fused"]["recompiles"]
        bad = pkg.join_profile(pkg.analyze_device_plan(),
                               {"device_recompiles": {"ingest.fused": predicted + 5}})
        assert bad.verdict == "device-dirty"
        [d] = [x for x in bad.diagnostics if x.code == "device.retrace.drift"]
        assert d.node == "ingest.fused"
        assert bad.predictions["ingest.fused"]["drift"] == "exceeded"
        ok = pkg.join_profile(pkg.analyze_device_plan(),
                              {"device_recompiles": {"ingest.fused": predicted}})
        assert ok.verdict == "device-clean"
        assert ok.predictions["ingest.fused"]["drift"] == "ok"


# -- the device-memory model -------------------------------------------------

def test_budget_model_matches_the_jax_package(monkeypatch):
    monkeypatch.delenv("PATHWAY_DEVICE_HBM_BYTES", raising=False)
    assert tdev.device_hbm_bytes() == jdev.device_hbm_bytes() == 8 * 1024**3
    monkeypatch.setenv("PATHWAY_DEVICE_HBM_BYTES", "123456789")
    assert tdev.device_hbm_bytes() == jdev.device_hbm_bytes() == 123456789
    for cap, dim in ((128, 64), (2**20, 384), (2**22, 768)):
        for donated in (True, False):
            assert tdev.index_shard_bytes(cap, dim, donated=donated) == (
                jdev.index_shard_bytes(cap, dim, donated=donated))
        assert tdev.snapshot_staging_bytes(cap, dim) == (
            jdev.snapshot_staging_bytes(cap, dim))
    for nb, lb, item, depth in ((8, 16, 2, 2), (256, 192, 4, 3)):
        assert tdev.ingest_staging_bytes(nb, lb, item, depth=depth) == (
            jdev.ingest_staging_bytes(nb, lb, item, depth=depth))
    for name in ("tiny", "bge_small", "bge_base"):
        assert tenc.encoder_param_bytes(getattr(tenc.EncoderConfig, name)()) == (
            jenc.encoder_param_bytes(getattr(jenc.EncoderConfig, name)()))


@pytest.mark.parametrize("wall,dev,flops,acc", [
    (1.0, 0.1, 1e12, 1e9),     # host-bound
    (1.0, 0.9, 1e12, 1e6),     # compute-bound
    (1.0, 0.9, 1e9, 1e9),      # bandwidth-bound
    (1.0, 0.9, 0.0, 1e9),      # no modeled arithmetic
    (1.0, 0.9, 1e9, 0.0),      # no modeled bytes
])
def test_roofline_and_mfu_match_the_jax_package(wall, dev, flops, acc, monkeypatch):
    monkeypatch.delenv("PATHWAY_DEVICE_HOST_BOUND_SHARE", raising=False)
    pk = (989e12, 3.35e12)
    assert tdev.roofline_verdict(wall, dev, flops, acc, *pk) == (
        jdev.roofline_verdict(wall, dev, flops, acc, *pk))
    assert tdev.mfu(flops, dev, pk[0]) == jdev.mfu(flops, dev, pk[0])
    monkeypatch.setenv("PATHWAY_DEVICE_HOST_BOUND_SHARE", "0.05")
    assert tdev.roofline_verdict(wall, dev, flops, acc, *pk) == (
        jdev.roofline_verdict(wall, dev, flops, acc, *pk))


# -- the doctor inside pw.analyze and the CLI --------------------------------

def test_analyze_device_kwarg_attaches_the_subreport():
    import pathway_tpu as jpw
    import pathway_tpu_torch as tpw

    reports = {}
    for name, pw in (("jax", jpw), ("torch", tpw)):
        pw.internals.parse_graph.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,), (2,)])
        reports[name] = (pw.analyze(t, device=True), pw.analyze(t))
        pw.internals.parse_graph.G.clear()
    (jr, jplain), (tr, tplain) = reports["jax"], reports["torch"]
    assert tr.device["verdict"] == jr.device["verdict"] == "device-clean"
    assert tr.device["reachable_sites"] == jr.device["reachable_sites"] == []
    assert tr.to_dict()["device"]["schema"] == "pathway_tpu_torch.analysis.device/v1"
    assert tplain.device is None and "device" not in tplain.to_dict()
    assert tr.verdict == jr.verdict


def test_device_doctor_gate_knob(monkeypatch):
    import pathway_tpu_torch as pw

    monkeypatch.setenv("PATHWAY_DEVICE_DOCTOR", "0")
    pw.internals.parse_graph.G.clear()
    t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(3,)])
    assert pw.analyze(t, device=True).device is None
    pw.internals.parse_graph.G.clear()


@pytest.mark.parametrize("mutant", [None, *tdp.MUTANTS])
def test_cli_device_plan_exit_codes_match_the_jax_package(mutant, capsys):
    from pathway_tpu.analysis.__main__ import main as jmain
    from pathway_tpu_torch.analysis.__main__ import main as tmain

    args = ["--device-plan"] + (
        ["--device-mutant", mutant] if mutant else ["--require-device-clean"])
    rc = tmain(args)
    out = capsys.readouterr().out
    assert rc == jmain(args) == (2 if mutant else 0)
    if mutant is None:
        assert "DEVICE-CLEAN" in out


def test_cli_device_plan_json(capsys):
    from pathway_tpu_torch.analysis.__main__ import main

    assert main(["--device-plan", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema"] == "pathway_tpu_torch.analysis.device/v1"
    assert doc["verdict"] == "device-clean"


def test_cli_profile_join(tmp_path, capsys):
    from pathway_tpu_torch.analysis.__main__ import main

    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"device_recompiles": {"ingest.fused": 10_000}}))
    assert main(["--device-plan", "--profile", str(trace)]) == 2
    assert "drift" in capsys.readouterr().out


# -- the site registry -------------------------------------------------------

def test_registry_covers_every_dispatch_site():
    import pathway_tpu.io.http._server  # noqa: F401
    import pathway_tpu.ops.ingest  # noqa: F401
    import pathway_tpu.ops.knn  # noqa: F401
    import pathway_tpu.ops.pallas_knn  # noqa: F401
    import pathway_tpu.parallel.sharded_knn  # noqa: F401
    import pathway_tpu_torch.io.http._server  # noqa: F401
    import pathway_tpu_torch.ops.ingest  # noqa: F401
    import pathway_tpu_torch.parallel.sharded_knn  # noqa: F401

    sites = tdev.registered_sites()
    assert set(sites) == {SITE.get(s, s) for s in jdev.registered_sites()}
    for name, site in sites.items():
        assert callable(site.cost_model), name
        assert isinstance(site.dtypes, tuple), name
        assert site.where.startswith("pathway_tpu_torch/"), name
    # the kernel's cost model is the JAX package's, term for term
    from pathway_tpu.ops.pallas_knn import pallas_knn_cost

    assert sites["knn.fused"].cost_model(32, 2**20, 384, 10, 256) == (
        pallas_knn_cost(32, 2**20, 384, 10, 256))


def test_fused_site_records_and_ticks_once_per_bucket():
    stats = TStats()
    tdev.PLANE.arm(None, stats)
    try:
        q, db = torch.zeros(2, 8), torch.zeros(64, 8)
        valid = torch.ones(64, dtype=torch.bool)
        fused_knn.fused_topk_scores(q, db, valid, 4)
        fused_knn.fused_topk_scores(q, db, valid, 4)
        assert stats.device_recompiles["knn.fused"] == 1
        fused_knn.fused_topk_scores(q, db, valid, 5)
        assert stats.device_recompiles["knn.fused"] == 2
    finally:
        tdev.PLANE.disarm()
    count, wall_s, device_s = stats.device_sites["knn.fused"][:3]
    # on the CPU the plain version runs inside the host span
    assert count == 3 and device_s == wall_s > 0


def test_external_index_node_exposes_adapter_sites():
    from pathway_tpu_torch.engine.external_index import ExternalIndexNode
    from pathway_tpu_torch.ops.knn import KnnShard

    shard = KnnShard(8, capacity=128, device="cpu")
    assert shard.device_sites == ("knn.write", "knn.search")

    class _Node:
        device_sites = ExternalIndexNode.device_sites

        def __init__(self, adapter):
            self.adapter = adapter

    assert _Node(shard).device_sites() == ("knn.write", "knn.search")
    assert _Node(object()).device_sites() == ()
