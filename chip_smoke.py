#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's live-RAG main path once on the card.

    python3 chip_smoke.py [--seed N]

Phases (each prints one JSON line; any failure exits non-zero):

1. build    compile every kernel in ``pathway_tpu_torch/csrc`` with nvcc
            (in parallel) and print the card's name and power limit;
2. kernels  hold each kernel against its plain PyTorch version on the card
            at the main path's shapes (cap = 2^20 rows, d = 384, k = 10,
            Q in {1, 32, 256}, and Q = 32 at k = 1024; seeded unit vectors,
            some slots invalid, one exact three-way tie) and time kernel,
            plain version and a library yardstick; the partial kernel at
            Q = 256 is also timed under torch.profiler;
3. main     a bge-small ``SentenceEncoder`` (seeded random weights) and a
            cos ``KnnShard`` of 2^20 slots: ``IngestPipeline.run`` over
            16,384 seeded documents, a fill to 1,048,576 live rows through
            ``KnnShard.add``, then ``QueryEngine.query`` on 256 ingested
            texts and 64 client threads through ``MicroBatcher.query``;
            checks recall of each query's own document, agreement with the
            plain search, and that serving launched the kernels; then a
            per-stage breakdown of one query and one ingest batch and a
            ``torch.profiler`` trace of them (device time by kernel, busy
            share);
4. dataflow the repo's live-RAG template (examples/demo-question-answering)
            on the port: 16,384 seeded documents written as files,
            ``pw.io.fs.read`` (streaming) -> ``VectorStoreServer`` with
            ``SentenceTransformerEmbedder("bge-small")`` (seeded weights)
            -> ``BaseRAGQuestionAnswerer`` with a mock LLM -> ``pw.run()``
            behind the REST gateway on a free port; ingest docs/s until
            ``/v1/statistics`` counts every file, then 256 ``/v1/retrieve``
            requests (k = 10) from 16 client threads and 16 ``/v2/answer``
            requests; checks recall of each query's own document, that
            every search the engine made agrees with the plain scan over
            the index's own vectors, that the phase launched the KNN
            kernel, and that JAX was never imported; prints the device
            plane's per-site record over the serving window;
5. report   the ``kernels`` JSON line, then the device line.

It needs one CUDA card and the rest of the repository beside it; without
either it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

CAP = 1 << 20
DIM = 384
K = 10
# (Q, k) of the kernels phase: the main path's k at three batch sizes,
# and a large k
CASES = ((1, K), (32, K), (256, K), (32, 1024))
N_DOCS = 16384
DOC_BATCH = 256
N_CLIENTS = 64
QUERIES_PER_CLIENT = 8
RECALL_MIN = 0.99
# the dataflow phase: corpus, clients and requests. The corpus is cut from
# 65,536 documents (a team's document store) to 16,384: on an H100 host
# the engine had not ingested 65,536 within 300 s, its host-side steps
# growing with the corpus (PERF.md)
DF_DOCS = 16384
DF_CLIENTS = 16
DF_RETRIEVES = 256
DF_ANSWERS = 16
DF_INGEST_TIMEOUT_S = 300


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def native_status() -> dict:
    """Which of the engine's native host extensions loaded; each falls
    back to pure Python when its build fails."""
    from pathway_tpu_torch import native

    return {"lib": native.get_lib() is not None,
            "fastpath": native.get_fastpath() is not None,
            "pwexec": native.get_pwexec() is not None}


def phase_build(pt_build):
    t0 = time.perf_counter()
    # the engine's host extensions build beside nvcc, so that the dataflow
    # phase's ingest does not pay for their first use
    native: dict = {}
    host = threading.Thread(target=lambda: native.update(native_status()))
    host.start()
    libs = pt_build.build_all()
    host.join()
    secs = time.perf_counter() - t0
    for name in libs:
        log = os.path.join(pt_build.BUILD_DIR, f"{name}.log")
        if os.path.exists(log):
            with open(log) as f:
                sys.stderr.write(f.read())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "build", "kernels": sorted(libs), "native": native, "seconds": secs})
    print(smi, flush=True)
    return smi


def unit_rows(gen, n: int, d: int):
    import torch

    x = torch.randn((n, d), generator=gen, device="cuda")
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def profiled_ms(fn, name: str, reps: int = 1) -> float:
    """Device time per call of the kernels whose name holds ``name`` over
    ``reps`` calls of ``fn`` under torch.profiler (after a warm-up call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(
        e.time_range.elapsed_us() / 1e3 for e in prof.events()
        if e.device_type == DeviceType.CUDA and name in e.name
    ) / reps


def phase_kernels(fk, topk, peaks, seed: int):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    db = unit_rows(gen, CAP, DIM)
    valid = torch.rand(CAP, generator=gen, device="cuda") > 0.01
    tie_slots = (1000, CAP // 2, CAP - 1)
    bw, fp32_peak, tf32_peak = peaks
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows_out = {}
    for Q, k in CASES:
        q = unit_rows(gen, Q, DIM)
        # a deliberate exact three-way tie at the top of query 0
        for s in tie_slots:
            db[s] = q[0]
            valid[s] = True
        mask = torch.where(valid, 0.0, float("-inf"))
        rows, splits = fk.plan_splits(Q, CAP, k, n_sm)
        tile = fk.plan_tile(Q, k)

        part_v, part_i = fk.knn_partial(q, db, valid, k, rows)
        plain_pv, plain_pi = fk.knn_partial_plain(q, db, valid, k, rows)
        merged_v, merged_i = fk.topk_merge(part_v, part_i, k)
        plain_mv, plain_mi = fk.topk_merge_plain(part_v, part_i, k)
        torch.cuda.synchronize()
        if not torch.equal(merged_i, plain_mi) or not torch.equal(merged_v, plain_mv):
            fail(f"topk_merge disagrees with its plain version at Q={Q}, k={k}")

        # end to end: the fused pair against the plain scan; slots must be
        # equal wherever the plain gap to a neighbour exceeds 1e-5
        vals, idx = fk.fused_topk_scores(q, db, valid, k)
        pv, pi = topk.chunked_topk_scores(q, db, valid, k + 1)
        torch.cuda.synchronize()
        if vals.shape != (Q, k) or not torch.isfinite(vals).all():
            fail(f"fused_topk_scores gave bad values at Q={Q}, k={k}")
        if not torch.allclose(vals, pv[:, :k], rtol=1e-5, atol=0.0):
            fail(f"values disagree at Q={Q}, k={k}: max err "
                 f"{(vals - pv[:, :k]).abs().max().item()}")
        gap = pv[:, :-1] - pv[:, 1:]                       # [Q, k]
        left = torch.cat([torch.full((Q, 1), float("inf"), device="cuda"),
                          gap[:, :k - 1]], 1)
        clear = torch.minimum(left, gap) > 1e-5
        # exact ties: lower slot first, where the kernel ties too (two other
        # rows that the plain product happens to round to one value are
        # rounded apart by the kernel's 3xTF32 sums: fp32 can tie them)
        kgap = vals[:, :-1] - vals[:, 1:]
        kleft = torch.cat([torch.ones((Q, 1), device="cuda"), kgap], 1)
        kright = torch.cat([kgap, torch.ones((Q, 1), device="cuda")], 1)
        tied = ((left == 0) & (kleft == 0)) | ((gap == 0) & (kright == 0))
        must = clear | tied
        # query 0's deliberate tie has its own check below: the plain
        # product may round the three equal rows apart
        must[0, :3] = False
        bad = (idx != pi[:, :k]) & must
        if bad.any():
            r, c = (int(x) for x in bad.nonzero()[0])
            fail(f"slots disagree at Q={Q}, k={k} on {int(bad.sum())} entries; first at "
                 f"[{r}, {c}]: kernel {idx[r, c - 1:c + 2].tolist()} "
                 f"{vals[r, c - 1:c + 2].tolist()}, plain {pi[r, c - 1:c + 2].tolist()} "
                 f"{pv[r, c - 1:c + 2].tolist()}")
        # the kernel scores equal rows bit-equally, so its tie is exact
        plain_tied = bool((pv[0, :3] == pv[0, 0]).all())
        if idx[0, :3].tolist() != list(tie_slots) or (
            plain_tied and pi[0, :3].tolist() != list(tie_slots)
        ):
            fail(f"exact tie not broken to the lower slot at Q={Q}, k={k}: "
                 f"{idx[0, :3].tolist()} vs {pi[0, :3].tolist()}")
        part_err = torch.where(
            torch.isfinite(plain_pv), (part_v - plain_pv).abs(), 0.0
        ).max().item()
        if not torch.equal(torch.isfinite(part_v), torch.isfinite(plain_pv)):
            fail(f"fused_knn partials disagree on missing entries at Q={Q}, k={k}")

        ms = cuda_ms(lambda: fk.knn_partial(q, db, valid, k, rows), reps=10)
        merge_ms = cuda_ms(lambda: fk.topk_merge(part_v, part_i, k), reps=50)
        pair_ms = cuda_ms(lambda: fk.fused_topk_scores(q, db, valid, k), reps=10)
        plain_ms = cuda_ms(
            lambda: fk.knn_partial_plain(q, db, valid, k, rows), reps=3)
        plain_merge_ms = cuda_ms(
            lambda: fk.topk_merge_plain(part_v, part_i, k), reps=20)
        scan_ms = cuda_ms(
            lambda: topk.chunked_topk_scores(q, db, valid, k), reps=3)
        library_ms = cuda_ms(lambda: torch.topk(q @ db.T + mask, k), reps=3)
        merge_library = lambda: torch.topk(part_v.permute(1, 0, 2).reshape(Q, -1), k)
        merge_library_ms = cuda_ms(merge_library, reps=20)
        # the merge is short enough that the host's launch path bounds the
        # back-to-back timing: its device time and the yardstick's, apart
        merge_device_ms = profiled_ms(
            lambda: fk.topk_merge(part_v, part_i, k), "merge_kernel", reps=20)
        merge_library_device_ms = profiled_ms(merge_library, "", reps=20)

        # least time: each input read once, each output written once, or
        # the operations at peak -- the lesser of FP32 on the CUDA cores and
        # 3xTF32 (three TF32 products) on the tensor cores -- whichever is
        # larger
        in_bytes = 4.0 * CAP * DIM + 4.0 * Q * DIM + CAP
        part_bytes = 8.0 * splits * Q * k
        t_bytes = (in_bytes + part_bytes) / bw
        flops = 2.0 * Q * CAP * DIM
        t_fp32 = flops / fp32_peak
        t_ops = min(t_fp32, 3.0 * flops / tf32_peak)
        bound_ms = 1e3 * max(t_bytes, t_ops)
        merge_bound_ms = 1e3 * (part_bytes + 8.0 * Q * k) / bw
        cm_flops, cm_bytes = fk.fused_knn_cost(Q, CAP, DIM, k, 1024)
        row = {
            "phase": "kernels", "Q": Q, "cap": CAP, "d": DIM, "k": k,
            "query_tile": tile[0], "queries_per_cta": tile[1],
            "splits": splits, "rows_per_split": rows,
            "fused_knn_ms": ms, "fused_knn_plain_ms": plain_ms,
            "fused_knn_bound_ms": bound_ms,
            "fused_knn_bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fused_knn_fp32_bound_ms": 1e3 * max(t_bytes, t_fp32),
            "fused_knn_max_abs_err": part_err,
            "topk_merge_ms": merge_ms, "topk_merge_plain_ms": plain_merge_ms,
            "topk_merge_bound_ms": merge_bound_ms,
            "topk_merge_library_ms": merge_library_ms,
            "topk_merge_device_ms": merge_device_ms,
            "topk_merge_library_device_ms": merge_library_device_ms,
            "search_ms": pair_ms, "search_plain_ms": scan_ms,
            "library_ms": library_ms,
            "launches_per_search": {"fused_knn": 1, "topk_merge": int(splits > 1)},
            "cost_model_bound_ms": 1e3 * max(cm_bytes / bw, cm_flops / fp32_peak),
        }
        if Q == 256:
            # the same launch under torch.profiler, beside the CUDA events
            row["fused_knn_profiler_ms"] = profiled_ms(
                lambda: fk.knn_partial(q, db, valid, k, rows), "partial_kernel")
        emit(row)
        rows_out[(Q, k)] = row
        del part_v, part_i, plain_pv, plain_pi
    del db, valid
    torch.cuda.empty_cache()
    return rows_out


def make_docs(words, rng, n):
    lens = rng.integers(8, 97, size=n)
    picks = rng.integers(0, len(words), size=int(lens.sum()))
    docs, pos = [], 0
    for L in lens:
        docs.append(" ".join(words[j] for j in picks[pos:pos + L]))
        pos += L
    return docs


def phase_main(pt, fk, seed: int):
    import dataclasses

    import torch

    from pathway_tpu_torch.models.tokenizer import VOCAB_ASSET

    with open(VOCAB_ASSET, encoding="utf-8") as f:
        words = [w.strip() for w in f if w.strip().isalpha()]
    rng = np.random.default_rng(seed)
    docs = make_docs(words, rng, N_DOCS)
    keys = [f"doc{i}" for i in range(N_DOCS)]

    cfg = pt.EncoderConfig.bge_small()
    t0 = time.perf_counter()
    params = pt.init_params(cfg, seed)
    enc = pt.SentenceEncoder(cfg, params=params, batch_size=DOC_BATCH)
    shard = pt.KnnShard(cfg.hidden, "cos", capacity=CAP)
    pipe = pt.IngestPipeline(enc, shard)
    engine = pt.QueryEngine(enc, shard, k=K)
    setup_s = time.perf_counter() - t0

    # the bf16 encoder against an f32 copy on the same weights
    ref = pt.SentenceEncoder(
        dataclasses.replace(cfg, dtype=torch.float32), params=params,
        batch_size=DOC_BATCH,
    )
    a = torch.from_numpy(enc.encode(docs[:64]))
    b = torch.from_numpy(ref.encode(docs[:64]))
    enc_cos = float((a * b).sum(-1).min())
    del ref
    if not torch.isfinite(a).all() or a.shape != (64, cfg.hidden) or enc_cos < 0.999:
        fail(f"encoder: bf16 vs f32 min cosine {enc_cos}")

    for name in fk.LAUNCHES:  # counts of the main path only
        fk.LAUNCHES[name] = 0
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    batches = [
        (keys[i:i + DOC_BATCH], docs[i:i + DOC_BATCH])
        for i in range(0, N_DOCS, DOC_BATCH)
    ]
    rows = pipe.run(iter(batches))
    ingest_s = time.perf_counter() - t0
    if rows != N_DOCS or len(shard) != N_DOCS:
        fail(f"ingest wrote {rows} rows, index holds {len(shard)}")

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    t0 = time.perf_counter()
    fill = CAP - N_DOCS
    step = 1 << 16
    for start in range(0, fill, step):
        n = min(step, fill - start)
        shard.add(range(start, start + n), unit_rows(gen, n, cfg.hidden))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    if len(shard) != CAP:
        fail(f"index holds {len(shard)} rows, expected {CAP}")

    # serve: one QueryEngine batch of 256 ingested texts
    qi = rng.choice(N_DOCS, size=256, replace=False)
    texts = [docs[i] for i in qi]
    engine.query(texts[:8])  # first launch of this batch shape
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        res = engine.query(texts)
        lat.append(1e3 * (time.perf_counter() - t0))
    hit = [f"doc{i}" in [key for key, _ in r] for i, r in zip(qi, res)]
    recall = float(np.mean(hit))
    if len(res) != 256 or any(len(r) != K for r in res):
        fail("QueryEngine returned the wrong number of hits")
    if not all(np.isfinite(s) for r in res for _, s in r):
        fail("QueryEngine returned non-finite scores")

    # the served answers against the plain search on the same embeddings
    emb = enc.encode_device(texts).contiguous()
    pv, pi = pt.chunked_topk_scores(emb, shard.vectors, shard.valid, K + 1)
    pv, pi = pv.cpu().numpy(), pi.cpu().numpy()
    agree = 0
    for r, v, i in zip(res, pv, pi):
        # the same key at every rank whose score stands 1e-5 clear of its
        # neighbours (the kernels phase's rule)
        want = [shard.slot_to_key[int(s)] for s in i[:K]]
        got = [key for key, _ in r]
        gap = v[:-1] - v[1:]
        clear = np.minimum(np.r_[np.inf, gap[:K - 1]], gap) > 1e-5
        agree += len(got) == K and all(
            g == w for g, w, c in zip(got, want, clear) if c)
    if agree != 256:
        fail(f"served top-{K} disagrees with the plain search on {256 - agree} queries")

    # 64 concurrent clients through the micro-batcher
    mb = pt.MicroBatcher(engine)
    client_lat: list[float] = []
    client_hits: list[bool] = []
    errors: list[BaseException] = []
    lock = threading.Lock()

    def client(c):
        crng = np.random.default_rng(seed * 1000 + c)
        try:
            for i in crng.choice(N_DOCS, size=QUERIES_PER_CLIENT, replace=False):
                t0 = time.perf_counter()
                r = mb.query(docs[i], timeout=120)
                dt = 1e3 * (time.perf_counter() - t0)
                with lock:
                    client_lat.append(dt)
                    client_hits.append(f"doc{i}" in [key for key, _ in r])
        except BaseException as e:
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    mb_s = time.perf_counter() - t0
    mb.close()
    if errors or any(t.is_alive() for t in threads):
        fail(f"MicroBatcher clients failed: {errors[:1]}")
    mb_recall = float(np.mean(client_hits))
    torch.cuda.synchronize()
    launches = dict(fk.LAUNCHES)

    emit({
        "phase": "main", "config": "bge_small", "docs": N_DOCS,
        "live_rows": len(shard), "capacity": shard.capacity,
        "setup_s": setup_s, "encoder_bf16_vs_f32_min_cos": enc_cos,
        "ingest_s": ingest_s, "ingest_docs_per_s": N_DOCS / ingest_s,
        "real_tokens": pipe.real_tokens, "padded_tokens": pipe.padded_tokens,
        "fill_s": fill_s, "fill_rows_per_s": fill / fill_s,
        "query_batch": 256, "query_batch_ms": lat,
        "query_batch_ms_p50": float(np.median(lat)),
        "recall_own_doc_top10": recall,
        "microbatcher_clients": N_CLIENTS,
        "microbatcher_queries": len(client_lat),
        "microbatcher_p50_ms": float(np.percentile(client_lat, 50)),
        "microbatcher_p99_ms": float(np.percentile(client_lat, 99)),
        "microbatcher_qps": len(client_lat) / mb_s,
        "microbatcher_recall_own_doc_top10": mb_recall,
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "native": native_status(),
    })
    if recall < RECALL_MIN or mb_recall < RECALL_MIN:
        fail(f"recall of the own document {recall} / {mb_recall} < {RECALL_MIN}")
    if not all(launches.values()):
        fail(f"serving did not launch every kernel: {launches}")
    emit(breakdown(pipe, engine, docs, keys, texts))
    emit(trace(pipe, engine, docs, keys, texts))
    return launches


def breakdown(pipe, engine, docs, keys, texts):
    """Where the time of one query batch and of ingest batches goes: each
    stage run alone and closed with a synchronize (host clock, ms)."""
    import torch

    from pathway_tpu_torch.models.encoder import (
        compact_tokens, expand_compact, pad_batch,
    )

    enc, shard = engine.encoder, engine.shard
    sync = torch.cuda.synchronize
    out = {"phase": "breakdown"}
    stages = {"tokenize": [], "h2d": [], "encoder": [], "search": [],
              "readback_resolve": []}
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        ids, mask = enc.tokenizer(texts)
        ids_p, mask_p, n = pad_batch(ids, mask, enc.config.max_len, enc.batch_size)
        wire = compact_tokens(ids_p, mask_p, enc.config.vocab_size)
        t1 = time.perf_counter()
        ids_t, mask_t = expand_compact(*(torch.from_numpy(a).cuda() for a in wire))
        sync()
        t2 = time.perf_counter()
        emb = enc.forward(ids_t, mask_t)[:n].contiguous()
        sync()
        t3 = time.perf_counter()
        with shard.lock:
            vals, idx = shard.topk(emb, engine.k_eff, engine.metric)
            epoch = shard.remove_epoch
        sync()
        t4 = time.perf_counter()
        engine.finish((torch.cat([vals, idx.view(torch.float32)], 1), n, epoch))
        t5 = time.perf_counter()
        for name, a, b in zip(stages, (t0, t1, t2, t3, t4), (t1, t2, t3, t4, t5)):
            stages[name].append(1e3 * (b - a))
    out["query_batch_ms"] = {k: float(np.median(v)) for k, v in stages.items()}
    out["query_batch_tokens"] = list(ids_p.shape)

    # ingest: upserts of documents already indexed (no growth), 8 batches
    tok, chain = [], []
    for i in range(0, 8 * DOC_BATCH, DOC_BATCH):
        sync()
        t0 = time.perf_counter()
        staged = pipe._stage(keys[i:i + DOC_BATCH], docs[i:i + DOC_BATCH])
        sync()
        t1 = time.perf_counter()
        pipe._dispatch(staged)
        sync()
        t2 = time.perf_counter()
        tok.append(1e3 * (t1 - t0))
        chain.append(1e3 * (t2 - t1))
    out["ingest_batch_ms"] = {
        "tokenize_h2d": float(np.median(tok)), "encode_write": float(np.median(chain)),
    }
    return out


def trace(pipe, engine, docs, keys, texts):
    """torch.profiler over one query batch and one ingest batch: device
    time by kernel and the device's busy share of the window (the union of
    the kernels' intervals over the window's host-clock length)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.query(texts)
        pipe.ingest(keys[:DOC_BATCH], docs[:DOC_BATCH])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name[:90], [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "phase": "profile", "window_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / wall_ms, "kernel_launches": len(kernels),
        "top": [{"name": n, "device_ms": ms, "calls": c} for n, (ms, c) in top],
    }


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dataflow(fk, seed: int):
    """The live-RAG template through the port's dataflow engine and REST
    gateway, on the card."""
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import device as devplane
    from pathway_tpu_torch.internals.monitoring import ProberStats
    from pathway_tpu_torch.models.tokenizer import VOCAB_ASSET
    from pathway_tpu_torch.ops.topk import chunked_topk_scores
    from pathway_tpu_torch.stdlib.indexing import nearest_neighbors as nn_mod
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.mocks import IdentityMockChat
    from pathway_tpu_torch.xpacks.llm.question_answering import (
        BaseRAGQuestionAnswerer, RAGClient,
    )
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    with open(VOCAB_ASSET, encoding="utf-8") as f:
        words = [w.strip() for w in f if w.strip().isalpha()]
    rng = np.random.default_rng(seed + 7)
    docs = make_docs(words, rng, DF_DOCS)
    folder = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_docs_"), "docs")
    os.makedirs(folder)
    names = [f"doc{i:06d}.txt" for i in range(DF_DOCS)]
    for name, text in zip(names, docs):
        with open(os.path.join(folder, name), "w", encoding="utf-8") as f:
            f.write(text)

    # every search the engine makes, with the query vector it was given
    searches: list = []
    search_lock = threading.Lock()
    adapter_search = nn_mod._KnnAdapter.search

    def recording_search(self, queries):
        out = adapter_search(self, queries)
        with search_lock:
            for (qdata, limit, _), (keys, _) in zip(queries, out):
                searches.append((self, np.asarray(qdata, np.float32), limit, keys))
        return out

    nn_mod._KnnAdapter.search = recording_search

    port = free_port()
    docs_table = pw.io.fs.read(
        folder, format="binary", with_metadata=True, mode="streaming",
        autocommit_duration_ms=100,
    )
    store = VectorStoreServer(docs_table, embedder=SentenceTransformerEmbedder("bge-small"))
    rag = BaseRAGQuestionAnswerer(llm=IdentityMockChat(), indexer=store, search_topk=6)
    rag.build_server(host="127.0.0.1", port=port)

    for name in fk.LAUNCHES:  # counts of this phase only
        fk.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run_error: list = []

    def run():
        try:
            pw.run()
        except BaseException as e:
            run_error.append(e)

    t0 = time.perf_counter()
    threading.Thread(target=run, name="pw.run", daemon=True).start()
    client = RAGClient(host="127.0.0.1", port=port, timeout=120)
    count, polls = 0, 0
    while True:
        if run_error:
            fail(f"pw.run raised {run_error[0]!r}")
        if time.perf_counter() - t0 > DF_INGEST_TIMEOUT_S:
            fail(f"ingest of {DF_DOCS} documents did not finish: file_count {count}")
        try:
            count = int(client.statistics().get("file_count") or 0)
        except OSError:
            count = 0  # the gateway is not listening yet
        polls += 1
        if count >= DF_DOCS:
            break
        time.sleep(0.25)
    ingest_s = time.perf_counter() - t0
    if count != DF_DOCS:
        fail(f"statistics count {count} files, wrote {DF_DOCS}")
    ingest_launches = dict(fk.LAUNCHES)

    # serving window: 256 retrieves from 16 threads, then 16 answers
    stats = ProberStats()
    devplane.PLANE.arm(None, stats)
    with search_lock:
        searches.clear()
    qi = np.random.default_rng(seed + 11).choice(DF_DOCS, size=DF_RETRIEVES, replace=False)
    lat: list[float] = []
    hits: list[bool] = []
    errors: list = []
    lock = threading.Lock()

    def retrieve_client(c):
        cl = RAGClient(host="127.0.0.1", port=port, timeout=120)
        try:
            for i in qi[c::DF_CLIENTS]:
                t1 = time.perf_counter()
                res = cl.retrieve(docs[i], k=K)
                dt = 1e3 * (time.perf_counter() - t1)
                paths = [os.path.basename(r["metadata"]["path"]) for r in res]
                with lock:
                    lat.append(dt)
                    hits.append(len(res) == K and names[i] in paths)
        except BaseException as e:
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=retrieve_client, args=(c,)) for c in range(DF_CLIENTS)]
    t1 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    serve_s = time.perf_counter() - t1
    if errors or any(th.is_alive() for th in threads):
        fail(f"retrieve clients failed: {errors[:1]}")
    answers = []
    for i in qi[:DF_ANSWERS]:
        t1 = time.perf_counter()
        out = client.answer(docs[i])
        answers.append((1e3 * (time.perf_counter() - t1), out))
    devplane.PLANE.disarm()
    torch.cuda.synchronize()
    launches = dict(fk.LAUNCHES)

    recall = float(np.mean(hits))
    if len(lat) != DF_RETRIEVES:
        fail(f"{len(lat)} of {DF_RETRIEVES} retrieves answered")
    bad_answers = [o for _, o in answers
                   if not str(o.get("response", "")).startswith("mock,")]
    if bad_answers:
        fail(f"/v2/answer gave {bad_answers[0]!r}")

    # every engine search against the plain scan over the index's own
    # vectors: the same key at every rank whose score stands 1e-5 clear
    # of its neighbours (the kernels phase's rule)
    with search_lock:
        recorded = list(searches)
    if len(recorded) < DF_RETRIEVES + DF_ANSWERS:
        fail(f"the engine made {len(recorded)} index searches for "
             f"{DF_RETRIEVES + DF_ANSWERS} requests")
    agree = 0
    for adapter, qvec, limit, keys in recorded:
        shard = adapter.shard
        q = torch.from_numpy(qvec).to(shard.device)[None]
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-30)
        with shard.lock:
            pv, pi = chunked_topk_scores(q, shard.vectors, shard.valid, limit + 1)
            want = [shard.slot_to_key.get(int(s)) for s in pi[0, :limit].tolist()]
        v = pv[0].cpu().numpy()
        gap = v[:-1] - v[1:]
        clear = np.minimum(np.r_[np.inf, gap[:limit - 1]], gap) > 1e-5
        agree += len(keys) == limit and all(
            g == w for g, w, c in zip(keys, want, clear) if c)
    nn_mod._KnnAdapter.search = adapter_search

    with stats._frame_lock:
        sites = {
            name: {"count": int(agg[0]), "device_ms": 1e3 * agg[2],
                   "wall_ms": 1e3 * agg[1]}
            for name, agg in stats.device_sites.items()
        }
    row = {
        "phase": "dataflow", "config": "bge-small", "docs": DF_DOCS,
        "ingest_s": ingest_s, "ingest_docs_per_s": DF_DOCS / ingest_s,
        "statistics_polls": polls,
        "retrieve_clients": DF_CLIENTS, "retrieves": len(lat), "k": K,
        "retrieve_p50_ms": float(np.percentile(lat, 50)),
        "retrieve_p99_ms": float(np.percentile(lat, 99)),
        "retrieve_qps": len(lat) / serve_s,
        "answer_p50_ms": float(np.median([a for a, _ in answers])),
        "recall_own_doc_top10": recall,
        "engine_searches": len(recorded), "searches_equal_plain": agree,
        "device_sites": sites,
        "launches_ingest": ingest_launches,
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "native": native_status(),
        "jax_loaded": "jax" in sys.modules,
    }
    emit(row)
    if recall < RECALL_MIN:
        fail(f"dataflow recall of the own document {recall} < {RECALL_MIN}")
    if agree != len(recorded):
        fail(f"{len(recorded) - agree} of {len(recorded)} engine searches "
             "disagree with the plain scan")
    if launches.get("fused_knn", 0) <= 0:
        fail(f"the dataflow phase launched no KNN kernel: {launches}")
    if "jax" in sys.modules or any(m.startswith("pathway_tpu.") for m in sys.modules):
        fail("JAX or the JAX package was imported")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import pathway_tpu_torch as pt
        from pathway_tpu_torch.internals.device import peak_rates
        from pathway_tpu_torch.ops import _build, fused_knn as fk, topk
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in IEEE fp32
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_build(_build)
    kind = torch.cuda.get_device_name(0)
    # data-sheet peaks: (bytes/s, FP32 FLOP/s outside the tensor cores,
    # dense TF32 FLOP/s on the tensor cores)
    rates = peak_rates(kind)
    if rates is None:
        fail(f"no data-sheet peaks for {kind!r} in internals/device.py")
    peaks = (rates["bandwidth"], rates["fp32"], rates["tf32"])
    kern = phase_kernels(fk, topk, peaks, args.seed)
    main_launches = phase_main(pt, fk, args.seed)
    df_launches = phase_dataflow(fk, args.seed)
    # the kernels line counts the launches of every path this run drove
    launches = {k: main_launches.get(k, 0) + df_launches.get(k, 0)
                for k in set(main_launches) | set(df_launches)}

    main_q = kern[(256, K)]
    src = "pathway_tpu_torch/csrc/fused_knn.cu"
    replaces = "pathway_tpu/ops/pallas_knn.py:34"
    emit({"kernels": [
        {"name": "fused_knn", "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches["fused_knn"],
         "max_abs_err": main_q["fused_knn_max_abs_err"],
         "ms": main_q["fused_knn_ms"], "plain_ms": main_q["fused_knn_plain_ms"],
         "bound_ms": main_q["fused_knn_bound_ms"],
         "bound_by": main_q["fused_knn_bound_by"],
         "library_ms": main_q["library_ms"]},
        # the merge's times are device times (torch.profiler): launched
        # back to back, it and its yardstick time the host's launch path
        {"name": "topk_merge", "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches["topk_merge"], "max_abs_err": 0.0,
         "ms": main_q["topk_merge_device_ms"], "plain_ms": main_q["topk_merge_plain_ms"],
         "bound_ms": main_q["topk_merge_bound_ms"], "bound_by": "bytes",
         "library_ms": main_q["topk_merge_library_device_ms"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SystemExit as e:  # fail(): the message is the exit code
        if not isinstance(e.code, int):
            print(e.code, file=sys.stderr)
        rc = e.code if isinstance(e.code, int) else 1
    except BaseException:
        import traceback

        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # the dataflow phase's pw.run() serves until the process ends: end it
    # here, with every thread it started
    os._exit(rc)
