#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's live-RAG main path once on the card.

    python3 chip_smoke.py [--seed N]

Phases (each prints one JSON line; any failure exits non-zero):

1. build    compile every kernel in ``pathway_tpu_torch/csrc`` with nvcc
            (in parallel) and print the card's name and power limit;
2. kernels  hold each kernel against its plain PyTorch version on the card
            at the main path's shapes (cap = 2^20 rows, d = 384, k = 10,
            Q in {1, 32, 256}, Q = 32 at k = 1024 and Q = 1 at k = 8192;
            seeded unit vectors, some slots invalid, one exact three-way
            tie) and time kernel, plain version and a library yardstick,
            with each case's plan and share of its bound; the partial
            kernel at Q = 256 is also timed under torch.profiler; every
            case again at precision "default" (the partial kernel's
            one-pass TF32 instance): partials within 3e-5 of the plain
            version, slots equal where its gap exceeds 6e-5, the merge bit
            for bit, the tie to the lower slot, and its times beside its
            bound and a TF32 library yardstick;
3. main     a bge-small ``SentenceEncoder(checkpoint=dir)``: the script
            writes a seeded checkpoint in the HF layout (config.json,
            pytorch_model.bin under BERT's parameter names, vocab.txt,
            tokenizer_config.json) and the encoder must load it bit for
            bit; a cos ``KnnShard`` of 2^20 slots: ``IngestPipeline.run``
            over 16,384 seeded documents, a fill to 1,048,576 live rows
            through ``KnnShard.add``, then ``QueryEngine.query`` on 256
            ingested texts and 64 client threads through
            ``MicroBatcher.query``; checks recall of each query's own
            document, agreement with the plain search, and that serving
            launched the kernels; a second ``KnnShard(precision="default")``
            restored from the index's ``snapshot_state`` and a
            ``QueryEngine`` over it serve the same 256 texts: hits equal to
            its plain version, scores within 1.1e-3 of the "highest"
            engine's, both engines' p50 and the partial launch alone on the
            same embeddings; then a per-stage breakdown of one query
            and one ingest batch and a ``torch.profiler`` trace of them
            (device time by kernel, busy share). The device plane is armed
            throughout: ``device_recompiles_total`` at ``encoder.forward``
            and ``ingest.fused`` must equal the CUDA graphs captured for
            each;
4. supervised ``IngestPipeline.run`` of 1,024 seeded documents into a
            fresh cos ``KnnShard`` under the fault plan ``device.h2d``
            hits [1, 3]: exactly two retries at ``ingest.fused``, every row
            equal to a fault-free ingest of the same batch, searches equal
            to the plain scan; a permanent fault raises within 120 s;
5. dataflow (run last: its engine serves until the process ends) the
            repo's live-RAG template (examples/demo-question-answering)
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
6. sharded  a ``ShardedKnnIndex`` of four shards on the card
            (``make_mesh(devices=[cuda:0] * 4)``) and a ``KnnShard``, both
            filled with the same 1,048,576 seeded unit vectors (1 %
            removed, one exact three-way tie across shards); queries at
            Q = 1 / 32 / 256, k = 10 and Q = 32, k = 1024 under
            ``PATHWAY_INDEX_MERGE=gather`` and ``tree`` must give ids and
            scores bit-identical to the single shard; the same two indexes
            switched to precision "default" at Q = 32, k = 10, bit for bit
            again; median search ms (CUDA events) of both, the device part
            alone, and the launches;
7. snapshot the filled 2^20-row ``KnnShard`` under a filesystem persistence
            backend: cut 1 (the full segment), 10,486 rows removed and
            10,486 new keys added, cut 2 (a delta segment of at most 2 % of
            cut 1's bytes); the chain restored into a fresh ``KnnShard`` and
            into a four-shard ``ShardedKnnIndex`` must answer 256 queries
            (k = 10) bit-identically; bytes and seconds of each cut and
            restore, peak device memory;
8. ring     ``ring_attention`` over eight shards of the one card
            (``make_mesh(devices=[cuda:0] * 8, axes=("sp",))``) against
            ``reference_attention``: the reference test's geometry in f32,
            full and causal, at 2e-5 with TF32 off; one position per shard
            (no NaN); bge-small's heads (h = 12, d = 32) at S = 8192 in
            bf16, causal, at 5e-2: ms (CUDA events) and peak device bytes
            above the inputs of both, the ring's peak below full
            attention's;
9. train    InfoNCE fine-tuning of bge-small (full width and depth) from
            the main phase's checkpoint, through ``create_train_state``
            and ``make_sharded_train_step``: 64 (query, passage) pairs
            (queries padded to 32 tokens, passages to 128, bf16
            activations), ten steps at dp = 1 whose loss must fall (median
            step ms over steps 3-10, pairs/s, tokens/s, MFU against the
            bf16 peak, peak device memory); one step at dp = 2 on the same
            card whose loss must equal the first step's within 1e-2; an
            f32 step of 8 pairs x 32 tokens whose loss (rtol 1e-4) and
            every gradient (1e-4 of each tensor's largest) must equal the
            port's own step on the CPU;
10. spawn   ``python -m pathway_tpu_torch spawn -n 2`` of a program the
            phase writes, then the same program under ``spawn -n 1``: each
            rank calls ``initialize_from_env()`` (gloo: the ranks share
            the one card), reads 4,096 seeded documents as files
            (``pw.io.fs.read``, binary, static), embeds them with
            ``SentenceTransformerEmbedder(encoder=SentenceEncoder(
            checkpoint=dir))`` on the card, joins them to a seeded topic
            table, counts per topic, writes rows and counts with
            ``pw.io.jsonlines.write`` and ``all_reduce``s the rows it
            embedded; the two runs must give the same rows and counts,
            embeddings within cosine 0.999, an all-reduced 4,096, and
            ``encoder.forward`` on the card in every rank; seconds, docs/s
            and peak device memory of each rank;
11. persisted the dataflow template streaming under
            ``persistence_config=Config(Backend.filesystem(dir),
            persistence_mode="OPERATOR_PERSISTING")`` in a subprocess over
            4,096 documents until ``/v1/statistics`` counts them all and
            ``marker/snapshot_commit`` exists; then 512 more files and a
            second subprocess on the same directory, which must count
            4,608 files, write only the new documents' rows to its indexes,
            embed no old document, and answer 64 ``/v1/retrieve`` requests
            with one engine search each, in agreement with the plain scan
            over its indexes (a miss reports why: ``miss_detail``); the
            restart's time to its first answer and the first run's ingest
            time;
12. rerank  (before dataflow: a static program that ``pw.run`` finishes;
            the parse graph is cleared after it) the rerank path that
            upstream Pathway documents for ``pw.xpacks.llm.rerankers``:
            4,096 seeded documents as files (``pw.io.fs.read``, static) ->
            ``VectorStoreServer`` with ``SentenceTransformerEmbedder(
            "bge-small")`` -> ``retrieve_query`` of 256 queries (each the
            first 12 words of a distinct document) at k = 8 -> ``flatten``
            -> ``CrossEncoderReranker`` over a bge-small ``CrossEncoder``
            (seeded weights, bf16 activations, on the card) -> ``groupby(
            query).reduce`` -> ``rerank_topk_filter(docs, scores, 2)``;
            checks that the model and every tensor it scores are on the
            card, that the phase launched the KNN kernel and never
            imported JAX; that the scores hold a cosine of 0.999 to the
            same weights at f32 on the card over all 2,048 pairs, and each
            query keeps f32's pair wherever f32's gap between ranks 2 and
            3 exceeds twice the largest bf16 error; that f32 on the card
            is within 1e-4 of the largest score of f32 on the CPU on 32
            pairs; that every output row equals a re-sort of its
            candidates by the scores of ``CrossEncoder.score`` over the
            batches the UDF was handed, bit for bit; and that every engine
            search equals the plain scan over the index's own vectors.
            Prints the run's seconds and pairs/s, the UDF's batch sizes,
            the forwards and their bucket shapes, ms per 64-pair forward
            (CUDA events), peak device bytes, the own-document recall of
            the candidates and the KNN launches;
13. doctor  the plan doctor and the Device Doctor on the card:
            ``pw.analyze(device=True)`` of the dataflow phase's own program
            must equal ``analyze_scope`` of its running engine, whose
            fallback counters ``audit_runtime`` holds against it;
            ``analyze_device_plan`` of the main phase's workload (bge-small,
            2^20 rows, its ingest batches and fills, queries of 1 / 32 /
            256 at k = 10), budgeted at the card's memory, must be
            device-clean and its ``over_budget`` mutant device-dirty, with
            no kernel launch and no byte allocated; a traced window of the
            main path (a fresh encoder from the checkpoint and a 2^20-row
            ``KnnShard``: one ingest batch and one ``QueryEngine.query`` of
            256 texts per predicted bucket) must capture exactly the
            predicted CUDA graphs at ``encoder.forward`` and
            ``ingest.fused``, and ``profile_trace`` / ``critical_path`` of
            its flight-recorder trace report ``knn.fused`` with its MFU
            and roofline verdict against the card's peaks; ``python -m
            pathway_tpu_torch.analysis --device-plan --json`` exits 0 with
            the card's budget, ``--device-mutant over_budget`` exits 2 and
            a ``--mesh`` check exits 0;
14. report  the ``kernels`` JSON line (launches summed over every phase),
            then the device line.

The phases run in the order build, kernels, main, supervised, sharded,
snapshot, ring, train, spawn, persisted, rerank, dataflow, doctor.

It needs one CUDA card and the rest of the repository beside it; without
either it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
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
# a large k, and the largest (K_MAX: the largest candidate buffer)
CASES = ((1, K), (32, K), (256, K), (32, 1024), (1, 8192))
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
# the sharded phase: four shards on the one card, the kernels phase's cases
SHARDS = 4
SEARCH_REPS = 5
# the snapshot phase: 1 % of the index removed and as many keys added
CHURN = 10486
# the persisted phase: the engine's host-side ingest sets its time (PERF.md),
# so its corpus is 4,096 documents; the snapshot phase holds the index at
# full size
PS_DOCS = 4096
PS_NEW = 512
PS_RETRIEVES = 64
PS_TIMEOUT_S = 420
# the main phase's checkpoint: weights from another seed than the ones an
# encoder falls back to (seed 0), so a silent fall-back fails the bit check
CKPT_SEED = 1000
# the supervised phase
SV_DOCS = 1024
SV_TIMEOUT_S = 120
# the ring phase: eight shards on the one card; bge-small's head geometry
# (12 heads of 32) at long context
RING_SHARDS = 8
RING_HEADS = 12
RING_HEAD_DIM = 32
RING_SEQ = 8192
RING_REPS = 5
# the train phase: 64 (query, passage) pairs, queries padded to 32 tokens
# and passages to 128; the f32 gradient check on 8 pairs of 32 tokens
TR_PAIRS = 64
TR_QUERY_LEN = 32
TR_PASSAGE_LEN = 128
TR_STEPS = 10
TR_CHECK_PAIRS = 8
# the spawn phase
SP_DOCS = 4096
SP_TOPICS = 16
SP_TIMEOUT_S = 300
# the one-pass instance against its plain version (the fp32 product of the
# TF32-rounded operands) on unit rows at d = 384: every product is exact in
# fp32, so the two differ only in the order of their sums. Summing the 384
# products one after another is off by at most 383 * 2^-24 of sum|q_i x_i|
# (<= 1 on unit rows). The kernel's chains are longest in its 64-query
# instance (Q >= 33, the main path's Q = 256), whose 4 wgmmas a stage go to
# 2 accumulators: 16 products on one accumulator (15 truncating adds,
# 2^-23 each), 1 add of the two and 11 of the 12 stages: (383 + 42) * 2^-24
# = 2.53e-5 < 3e-5 (the 8..32-query instances, one wgmma an accumulator:
# (383 + 28) * 2^-24). Slots are held where the plain gap exceeds twice that.
TF32_ERR = 3e-5
# the "default" engine against the "highest" one: each operand's TF32
# rounding moves a unit-vector score by at most 2^-10 * sum|q_i x_i| <=
# 9.8e-4, and the sums' order by the bound above
TF32_VS_FP32 = 1.1e-3
# the rerank phase: the cross-encoder behind the KNN kernel's candidates.
# k = 8 is examples/adaptive-rag/app.yaml's largest document count
# (2 * 2^(3 - 1)) and 2 kept its n_starting_documents; the queries are
# the first 12 words of distinct documents
RR_DOCS = 4096
RR_QUERIES = 256
RR_QUERY_WORDS = 12
RR_K = 8
RR_KEEP = 2
RR_PAIRS = RR_QUERIES * RR_K
# the cross-encoder's weights: init_cross_params at this seed (the data
# follows --seed)
RR_CE_SEED = 0
# bf16 against f32 on the card (tests/test_hf_parity.py's bar for the bf16
# encoder), and f32 on the card against f32 on the CPU
RR_COSINE_MIN = 0.999
RR_CPU_PAIRS = 32
RR_CPU_REL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def zero_launches(fk) -> None:
    for name in fk.LAUNCHES:
        fk.LAUNCHES[name] = 0


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


def kernel_case_default(fk, topk, rates, q, db, valid, mask, k, rows, splits,
                        tie_slots):
    """One kernels-phase case at precision "default": the partial kernel's
    one-pass instance against its plain version, the merge of its partials
    bit for bit, the pair's tie to the lower slot; times beside the bound
    and a TF32 library yardstick."""
    import torch

    Q = q.shape[0]
    p = {"precision": "default"}
    part_v, part_i = fk.knn_partial(q, db, valid, k, rows, **p)
    plain_pv, plain_pi = fk.knn_partial_plain(q, db, valid, k + 1, rows, **p)
    merged_v, merged_i = fk.topk_merge(part_v, part_i, k)
    plain_mv, plain_mi = fk.topk_merge_plain(part_v, part_i, k)
    vals, idx = fk.fused_topk_scores(q, db, valid, k, **p)
    torch.cuda.synchronize()
    if not torch.equal(merged_i, plain_mi) or not torch.equal(merged_v, plain_mv):
        fail(f"topk_merge disagrees with its plain version at Q={Q}, k={k} (default)")
    if not torch.equal(torch.isfinite(part_v), torch.isfinite(plain_pv[..., :k])):
        fail(f"one-pass partials disagree on missing entries at Q={Q}, k={k}")
    fin = torch.isfinite(plain_pv[..., :k])
    err = torch.where(fin, (part_v - plain_pv[..., :k]).abs(), 0.0).max().item()
    if not err <= TF32_ERR:
        fail(f"one-pass partials off by {err} > {TF32_ERR} at Q={Q}, k={k}")
    gap = plain_pv[..., :-1] - plain_pv[..., 1:]
    inf = torch.full_like(gap[..., :1], float("inf"))
    clear = (torch.minimum(torch.cat([inf, gap[..., :k - 1]], -1), gap) > 2 * TF32_ERR) & fin
    if not torch.equal(part_i[clear], plain_pi[..., :k][clear]):
        fail(f"one-pass slots disagree at Q={Q}, k={k} on "
             f"{int((part_i != plain_pi[..., :k])[clear].sum())} entries")
    if vals.shape != (Q, k) or not torch.isfinite(vals).all():
        fail(f"fused_topk_scores (default) gave bad values at Q={Q}, k={k}")
    if idx[0, :3].tolist() != list(tie_slots) or not bool((vals[0, :3] == vals[0, 0]).all()):
        fail(f"one-pass tie not broken to the lower slot at Q={Q}, k={k}: "
             f"{idx[0, :3].tolist()}")

    ms = cuda_ms(lambda: fk.knn_partial(q, db, valid, k, rows, **p), reps=10)
    pair_ms = cuda_ms(lambda: fk.fused_topk_scores(q, db, valid, k, **p), reps=10)
    plain_ms = cuda_ms(lambda: fk.knn_partial_plain(q, db, valid, k, rows, **p), reps=3)
    # the yardstick: one TF32 product and torch.topk, never called by the port
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        library_ms = cuda_ms(lambda: torch.topk(q @ db.T + mask, k), reps=3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    bound_s, bound_by = fk.fused_knn_bound(Q, db.shape[0], db.shape[1], k, "default",
                                           rates, splits)
    return {
        "phase": "kernels", "precision": "default", "Q": Q, "cap": db.shape[0],
        "d": db.shape[1], "k": k, "splits": splits, "rows_per_split": rows,
        "ring_stages": fk.plan_tile(Q, k, "default").stages,
        "smem_buffers": fk.plan_tile(Q, k, "default").smem_buffers,
        "fused_knn_tf32_ms": ms, "fused_knn_tf32_plain_ms": plain_ms,
        "fused_knn_tf32_bound_ms": 1e3 * bound_s,
        "fused_knn_tf32_bound_share": 1e3 * bound_s / ms,
        "fused_knn_tf32_bound_by": bound_by,
        "fused_knn_tf32_max_abs_err": err,
        "search_ms": pair_ms, "library_tf32_ms": library_ms,
    }


def phase_kernels(fk, topk, rates, seed: int):
    """Each kernel against its plain version at the main path's shapes, the
    partial kernel at both precisions."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    db = unit_rows(gen, CAP, DIM)
    valid = torch.rand(CAP, generator=gen, device="cuda") > 0.01
    tie_slots = (1000, CAP // 2, CAP - 1)
    bw, fp32_peak = rates["bandwidth"], rates["fp32"]
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
        parts = fk.plan_parts(Q, splits, rows, k, n_sm)

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
        bound_s, bound_by = fk.fused_knn_bound(Q, CAP, DIM, k, "highest", rates, splits)
        bound_ms = 1e3 * bound_s
        fp32_bound_s, _ = fk.fused_knn_bound(Q, CAP, DIM, k, "highest", rates, splits,
                                             fp32_only=True)
        part_bytes = 8.0 * splits * Q * k
        merge_bound_ms = 1e3 * (part_bytes + 8.0 * Q * k) / bw
        cm_flops, cm_bytes = fk.fused_knn_cost(Q, CAP, DIM, k, 1024)
        row = {
            "phase": "kernels", "Q": Q, "cap": CAP, "d": DIM, "k": k,
            # the partial kernel's plan: queries a CTA (the wgmma N), ring
            # stages, candidate buffers in shared memory or a scratch
            # tensor, CTAs that share a split
            "query_tile": tile.n, "ring_stages": tile.stages,
            "smem_buffers": tile.smem_buffers, "parts": parts,
            "splits": splits, "rows_per_split": rows,
            "fused_knn_ms": ms, "fused_knn_plain_ms": plain_ms,
            "fused_knn_bound_ms": bound_ms,
            "fused_knn_bound_share": bound_ms / ms,
            "fused_knn_bound_by": bound_by,
            "fused_knn_fp32_bound_ms": 1e3 * fp32_bound_s,
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
        row["precision"] = "highest"
        emit(row)
        rows_out[(Q, k)] = row
        del part_v, part_i, plain_pv, plain_pi
        row = kernel_case_default(fk, topk, rates, q, db, valid, mask, k, rows,
                                  splits, tie_slots)
        emit(row)
        rows_out[(Q, k, "default")] = row
    del db, valid
    torch.cuda.empty_cache()
    return rows_out


def vocab_words() -> list[str]:
    from pathway_tpu_torch.models.tokenizer import VOCAB_ASSET

    with open(VOCAB_ASSET, encoding="utf-8") as f:
        return [w.strip() for w in f if w.strip().isalpha()]


def hf_bert_names(layers: int) -> dict[str, str]:
    """The port's module names -> HF ``BertModel``'s, written out here
    rather than taken from the loader, so the checkpoint checks it."""
    names = {
        "tok_embed": "embeddings.word_embeddings",
        "pos_embed": "embeddings.position_embeddings",
        "type_embed": "embeddings.token_type_embeddings",
        "ln_embed": "embeddings.LayerNorm",
    }
    for i in range(layers):
        hf, pt = f"encoder.layer.{i}.", f"blocks.{i}."
        for proj in ("query", "key", "value"):
            names[pt + f"attention.{proj}"] = hf + f"attention.self.{proj}"
        names[pt + "attention.out"] = hf + "attention.output.dense"
        names[pt + "ln_attn"] = hf + "attention.output.LayerNorm"
        names[pt + "mlp_in"] = hf + "intermediate.dense"
        names[pt + "mlp_out"] = hf + "output.dense"
        names[pt + "ln_mlp"] = hf + "output.LayerNorm"
    return names


def write_checkpoint(path: str, cfg, seed: int) -> dict:
    """A seeded checkpoint of ``cfg``'s geometry in the HF layout, written
    without ``transformers``: config.json, pytorch_model.bin (BERT's
    parameter names, plus the pooler the encoder drops), vocab.txt (the
    port's WordPiece asset) and tokenizer_config.json. Returns the
    weights under the port's names."""
    import shutil

    import torch

    from pathway_tpu_torch.models import init_params
    from pathway_tpu_torch.models.tokenizer import VOCAB_ASSET

    os.makedirs(path, exist_ok=True)
    params = init_params(cfg, seed)
    names = hf_bert_names(cfg.layers)
    hf = {}
    for name, t in params.items():
        module, leaf = name.rsplit(".", 1)
        hf[f"{names[module]}.{leaf}"] = t
    gen = torch.Generator().manual_seed(seed)
    hf["pooler.dense.weight"] = 0.02 * torch.randn(cfg.hidden, cfg.hidden, generator=gen)
    hf["pooler.dense.bias"] = torch.zeros(cfg.hidden)
    torch.save(hf, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "architectures": ["BertModel"], "model_type": "bert",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden,
            "num_hidden_layers": cfg.layers, "num_attention_heads": cfg.heads,
            "intermediate_size": cfg.mlp, "max_position_embeddings": cfg.max_len,
            "type_vocab_size": 2, "hidden_act": "gelu", "layer_norm_eps": 1e-12,
            "pad_token_id": 0,
        }, f, indent=2)
    shutil.copy(VOCAB_ASSET, os.path.join(path, "vocab.txt"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "BertTokenizer", "do_lower_case": True,
                   "model_max_length": cfg.max_len}, f, indent=2)
    return params


def agree_with_plain(res, pv, pi, slot_to_key, k, clear_by: float = 1e-5) -> int:
    """Queries whose served top-k has the plain search's key at every rank
    whose score stands ``clear_by`` clear of its neighbours (the kernels
    phase's rule); ``pv``/``pi`` are the plain top-(k + 1) on the host."""
    agree = 0
    for r, v, i in zip(res, pv, pi):
        want = [slot_to_key[int(s)] for s in i[:k]]
        got = [key for key, _ in r]
        gap = v[:-1] - v[1:]
        clear = np.minimum(np.r_[np.inf, gap[:k - 1]], gap) > clear_by
        agree += len(got) == k and all(g == w for g, w, c in zip(got, want, clear) if c)
    return agree


def record_searches():
    """Record every search the engine makes through ``_KnnAdapter.search``
    as (adapter, query vector, limit, keys). Returns the list, the lock
    that guards it, and a function that undoes the patch."""
    from pathway_tpu_torch.stdlib.indexing import nearest_neighbors as nn_mod

    searches: list = []
    lock = threading.Lock()
    search = nn_mod._KnnAdapter.search

    def recording_search(self, queries):
        out = search(self, queries)
        with lock:
            for (qdata, limit, _), (keys, _) in zip(queries, out):
                searches.append((self, np.asarray(qdata, np.float32), limit, keys))
        return out

    nn_mod._KnnAdapter.search = recording_search
    return searches, lock, lambda: setattr(nn_mod._KnnAdapter, "search", search)


def searches_equal_plain(recorded) -> int:
    """Engine searches, recorded as (adapter, query vector, limit, keys),
    whose keys are the plain scan's over the adapter's own vectors at every
    rank whose score stands 1e-5 clear of its neighbours (the kernels
    phase's rule)."""
    import torch

    from pathway_tpu_torch.ops.topk import chunked_topk_scores

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
        agree += len(keys) == limit and all(g == w for g, w, c in zip(keys, want, clear) if c)
    return agree


def make_docs(words, rng, n):
    lens = rng.integers(8, 97, size=n)
    picks = rng.integers(0, len(words), size=int(lens.sum()))
    docs, pos = [], 0
    for L in lens:
        docs.append(" ".join(words[j] for j in picks[pos:pos + L]))
        pos += L
    return docs


def phase_main(pt, fk, ckpt: str, written: dict, seed: int):
    import dataclasses

    import torch

    from pathway_tpu_torch.internals import device as devplane
    from pathway_tpu_torch.internals.monitoring import ProberStats

    rng = np.random.default_rng(seed)
    docs = make_docs(vocab_words(), rng, N_DOCS)
    keys = [f"doc{i}" for i in range(N_DOCS)]

    # the device plane counts every new shape bucket from here on
    stats = ProberStats()
    devplane.PLANE.arm(None, stats)
    cfg = pt.EncoderConfig.bge_small()
    t0 = time.perf_counter()
    enc = pt.SentenceEncoder(checkpoint=ckpt, batch_size=DOC_BATCH)
    load_s = time.perf_counter() - t0
    loaded = enc.model.state_dict()
    differ = [n for n, t in written.items() if not torch.equal(loaded[n].cpu(), t)]
    if loaded.keys() != written.keys() or differ or enc.config != cfg:
        fail(f"the checkpoint did not load bit for bit: {differ[:3]}, "
             f"config {enc.config}")
    shard = pt.KnnShard(cfg.hidden, "cos", capacity=CAP)
    pipe = pt.IngestPipeline(enc, shard)
    engine = pt.QueryEngine(enc, shard, k=K)
    setup_s = time.perf_counter() - t0

    # the bf16 encoder against an f32 copy on the same weights
    ref = pt.SentenceEncoder(
        dataclasses.replace(cfg, dtype=torch.float32), params=loaded,
        batch_size=DOC_BATCH,
    )
    a = torch.from_numpy(enc.encode(docs[:64]))
    b = torch.from_numpy(ref.encode(docs[:64]))
    enc_cos = float((a * b).sum(-1).min())
    ref_graphs = list(ref._graphs)
    del ref
    if not torch.isfinite(a).all() or a.shape != (64, cfg.hidden) or enc_cos < 0.999:
        fail(f"encoder: bf16 vs f32 min cosine {enc_cos}")

    zero_launches(fk)  # counts of the main path only
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
    agree = agree_with_plain(res, pv.cpu().numpy(), pi.cpu().numpy(),
                             shard.slot_to_key, K)
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
    default_row = serve_default(pt, fk, enc, shard, engine, texts, qi, res, lat)
    torch.cuda.synchronize()
    launches = dict(fk.LAUNCHES)

    emit({
        "phase": "main", "config": "bge_small", "docs": N_DOCS,
        "checkpoint": {"tensors": len(written), "bit_identical": True,
                       "load_s": load_s, "tokenizer": type(enc.tokenizer).__name__},
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
    emit(default_row)
    if recall < RECALL_MIN or mb_recall < RECALL_MIN:
        fail(f"recall of the own document {recall} / {mb_recall} < {RECALL_MIN}")
    if not all(launches.values()):
        fail(f"serving did not launch every kernel: {launches}")
    emit(breakdown(pipe, engine, docs, keys, texts))
    emit(trace(pipe, engine, docs, keys, texts))

    # a new bucket at encoder.forward / ingest.fused is exactly one CUDA
    # graph captured for it (the f32 copy's graphs included)
    devplane.PLANE.disarm()
    graphs: dict = {}
    for site, _ in list(enc._graphs) + ref_graphs:
        graphs[site] = graphs.get(site, 0) + 1
    recompiles = dict(stats.device_recompiles)
    text = stats.render_openmetrics()
    emit({"phase": "recompiles", "device_recompiles": recompiles,
          "cuda_graphs": graphs})
    for site in ("encoder.forward", "ingest.fused"):
        line = f'device_site_recompiles_total{{site="{site}"}} {graphs.get(site, 0)}'
        if not graphs.get(site) or recompiles.get(site) != graphs[site] or line not in text:
            fail(f"{site}: {recompiles.get(site)} recompiles noted, "
                 f"{graphs.get(site)} CUDA graphs captured")
    return launches, enc


def serve_default(pt, fk, enc, shard, engine, texts, qi, res, lat):
    """The main index at precision "default": a second ``KnnShard`` restored
    from its ``snapshot_state`` (no re-embedding) and a ``QueryEngine`` over
    it serve the same texts. Its hits must agree with its plain version on
    the card, and its scores rank by rank with the "highest" engine's
    within ``TF32_VS_FP32``. Returns the phase's ``main_default`` line."""
    import torch

    t0 = time.perf_counter()
    fast = pt.KnnShard(shard.dimension, "cos", precision="default", capacity=CAP)
    fast.load_state(shard.snapshot_state())
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if len(fast) != len(shard):
        fail(f"the restored index holds {len(fast)} rows, not {len(shard)}")
    before = dict(fk.LAUNCHES)
    eng = pt.QueryEngine(enc, fast, k=K)
    eng.query(texts[:8])  # first launch of this batch shape
    fast_lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        got = eng.query(texts)
        fast_lat.append(1e3 * (time.perf_counter() - t0))
    if len(got) != len(texts) or any(len(r) != K for r in got) or not all(
            np.isfinite(sc) for r in got for _, sc in r):
        fail("the default engine returned wrong or non-finite hits")
    recall = float(np.mean([f"doc{i}" in [key for key, _ in r] for i, r in zip(qi, got)]))
    emb = enc.encode_device(texts).float().contiguous()
    pv, pi = pt.chunked_topk_scores(emb, fast.vectors, fast.valid, K + 1,
                                    precision="default")
    agree = agree_with_plain(got, pv.cpu().numpy(), pi.cpu().numpy(),
                             fast.slot_to_key, K, clear_by=2 * TF32_ERR)
    if agree != len(texts):
        fail(f"the default engine disagrees with its plain version on "
             f"{len(texts) - agree} queries")
    vs_highest = max(abs(a - b) for r, w in zip(got, res)
                     for (_, a), (_, b) in zip(r, w))
    if not vs_highest <= TF32_VS_FP32:
        fail(f"default scores {vs_highest} from the highest engine's > {TF32_VS_FP32}")
    # the default engine's own queries ran the one-pass instance alone
    torch.cuda.synchronize()
    served = dict(fk.LAUNCHES)
    own = {name: served[name] - before[name] for name in served}
    if not own["fused_knn_tf32"] or own["fused_knn"]:
        fail(f"the default engine's queries launched {own}")
    # the partial kernel alone on these embeddings, both instances; these
    # launches time the kernel and are not the path's: the counts are put
    # back after them
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, _ = fk.plan_splits(emb.shape[0], CAP, K, n_sm)
    partial_ms = {
        prec: cuda_ms(lambda: fk.knn_partial(emb, idx.vectors, idx.valid, K, rows,
                                             precision=prec), reps=10)
        for prec, idx in (("highest", shard), ("default", fast))
    }
    torch.cuda.synchronize()
    fk.LAUNCHES.update(served)
    row = {
        "phase": "main_default", "precision": "default", "live_rows": len(fast),
        "restore_s": restore_s, "query_batch": len(texts),
        "query_batch_ms": fast_lat,
        "query_batch_ms_p50": float(np.median(fast_lat)),
        "highest_query_batch_ms_p50": float(np.median(lat)),
        "recall_own_doc_top10": recall, "agree_with_plain": agree,
        "max_abs_vs_highest": vs_highest,
        "launches": own,
        "knn_partial_own_data_ms": partial_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if recall < RECALL_MIN:
        fail(f"default engine recall {recall} < {RECALL_MIN}")
    del eng, fast
    torch.cuda.empty_cache()
    return row


def breakdown(pipe, engine, docs, keys, texts):
    """Where the time of one query batch and of ingest batches goes: each
    stage run alone and closed with a synchronize (host clock, ms)."""
    import torch

    from pathway_tpu_torch.internals.device import encoder_bucket
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
        emb = enc.forward(ids_t, mask_t, bucket=encoder_bucket(
            *ids_t.shape, True))[:n].contiguous()
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
    # the partial kernel alone on this index and these query embeddings (the
    # kernels phase times it on seeded unit rows): CUDA events, and device
    # time under torch.profiler, to read beside the traced window's
    from pathway_tpu_torch.ops import fused_knn as fk

    q = emb.float().contiguous()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, _ = fk.plan_splits(q.shape[0], shard.vectors.shape[0], engine.k_eff, n_sm)
    partial = lambda: fk.knn_partial(q, shard.vectors, shard.valid, engine.k_eff, rows)
    out["knn_partial_own_data_ms"] = cuda_ms(partial, reps=10)
    out["knn_partial_own_data_profiler_ms"] = profiled_ms(partial, "partial_kernel", reps=3)

    # the checkpoint's tokenizer against the port's memoized WordPiece over
    # the same vocab: the same ids, and each one's time in this call
    from pathway_tpu_torch.models.tokenizer import VOCAB_ASSET
    from pathway_tpu_torch.models.wordpiece import WordPieceTokenizer

    wordpiece = WordPieceTokenizer(VOCAB_ASSET, max_length=enc.config.max_len)
    wp_ids, wp_mask = wordpiece(texts)
    if not (np.array_equal(wp_ids, ids) and np.array_equal(wp_mask, mask)):
        fail(f"{type(enc.tokenizer).__name__} and the WordPiece fallback give "
             "different ids on the query batch")
    tok_ms = {"checkpoint": [], "wordpiece": []}
    for _ in range(3):
        for name, tok in (("checkpoint", enc.tokenizer), ("wordpiece", wordpiece)):
            t0 = time.perf_counter()
            tok(texts)
            tok_ms[name].append(1e3 * (time.perf_counter() - t0))
    out["tokenizer"] = type(enc.tokenizer).__name__
    out["tokenize_ms"] = {k: float(np.median(v)) for k, v in tok_ms.items()}

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
    # the KNN partial kernel in the window: its device time, the gap after
    # the kernel before it, and the kernels (any stream) that overlap it
    knn = [e for e in kernels if "partial_kernel" in e.name]
    knn_window = None
    if knn:
        e = knn[0]
        a, b = e.time_range.start, e.time_range.end
        others = [o for o in kernels if o is not e
                  and o.time_range.start < b and o.time_range.end > a]
        before = [o.time_range.end for o in kernels if o.time_range.end <= a]
        knn_window = {
            "device_ms": (b - a) / 1e3,
            "gap_after_previous_kernel_ms": (a - max(before)) / 1e3 if before else None,
            "overlapping_kernels": len(others),
            "overlap_ms": sum(min(b, o.time_range.end) - max(a, o.time_range.start)
                              for o in others) / 1e3,
            "overlapping_names": sorted({o.name[:60] for o in others})[:5],
        }
    return {
        "phase": "profile", "window_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / wall_ms, "kernel_launches": len(kernels),
        "knn_partial": knn_window,
        "top": [{"name": n, "device_ms": ms, "calls": c} for n, (ms, c) in top],
    }


def phase_supervised(pt, fk, enc, seed: int):
    """``IngestPipeline.run`` under injected H2D staging faults, against a
    fault-free run of the same batches."""
    import torch

    from pathway_tpu_torch.internals import device as devplane
    from pathway_tpu_torch.internals import faults
    from pathway_tpu_torch.internals.monitoring import ProberStats

    docs = make_docs(vocab_words(), np.random.default_rng(seed + 17), SV_DOCS)
    keys = [f"sv{i}" for i in range(SV_DOCS)]
    batches = [(keys[i:i + DOC_BATCH], docs[i:i + DOC_BATCH])
               for i in range(0, SV_DOCS, DOC_BATCH)]
    dim = enc.embed_dim
    clean = pt.KnnShard(dim, "cos", capacity=SV_DOCS, device=enc.device)
    pt.IngestPipeline(enc, clean, device=enc.device).run(iter(batches))
    shard = pt.KnnShard(dim, "cos", capacity=SV_DOCS, device=enc.device)
    pipe = pt.IngestPipeline(enc, shard, device=enc.device)

    zero_launches(fk)  # counts of this phase only
    stats = ProberStats()
    faults.install_plan({"rules": [
        {"point": "device.h2d", "hits": [1, 3], "action": "raise"}]})
    devplane.PLANE.arm(None, stats)
    t0 = time.perf_counter()
    try:
        rows = pipe.run(iter(batches))
    finally:
        devplane.PLANE.disarm()
        faults.clear_plan()
    run_s = time.perf_counter() - t0
    retries = stats.device_dispatch_retries.get("ingest.fused", 0)
    got = shard.vectors[[shard.key_to_slot[k] for k in keys]]
    want = clean.vectors[[clean.key_to_slot[k] for k in keys]]
    max_err = float((got - want).abs().max())
    equal = bool(torch.equal(got, want))

    # searches over the faulted index, through the kernels, against the
    # plain scan
    q = want[:64].contiguous()
    res = shard.search(q, K)
    pv, pi = pt.chunked_topk_scores(q, shard.vectors, shard.valid, K + 1)
    agree = agree_with_plain(res, pv.cpu().numpy(), pi.cpu().numpy(),
                             shard.slot_to_key, K)
    own = float(np.mean([r[0][0] == k for r, k in zip(res, keys)]))
    launches = dict(fk.LAUNCHES)

    # a permanent fault surfaces, and does not hang the pipeline
    faults.install_plan({"rules": [
        {"point": "device.h2d", "action": "raise", "retryable": False}]})
    box: list = []

    def permanent():
        try:
            pipe.run(iter([(["sv-new"], [docs[0]])]))
            box.append(None)
        except faults.InjectedFault as e:
            box.append(e)

    th = threading.Thread(target=permanent, daemon=True)
    th.start()
    th.join(SV_TIMEOUT_S)
    faults.clear_plan()
    row = {
        "phase": "supervised", "docs": SV_DOCS, "rows": rows, "live_rows": len(shard),
        "retries": retries, "run_s": run_s, "equal_to_fault_free": equal,
        "max_abs_err": max_err, "searches_equal_plain": agree, "own_doc_top1": own,
        "permanent_raised": bool(box and box[0] is not None), "launches": launches,
    }
    emit(row)
    if rows != SV_DOCS or len(shard) != SV_DOCS:
        fail(f"supervised ingest wrote {rows} rows, the index holds {len(shard)}")
    if retries != 2:
        fail(f"supervised ingest retried {retries} times at ingest.fused, not 2")
    if not equal:
        fail(f"supervised rows differ from a fault-free ingest: max err {max_err}")
    if agree != len(q) or own < RECALL_MIN:
        fail(f"supervised searches: {agree} of {len(q)} equal the plain scan, "
             f"own document first in {own}")
    if th.is_alive() or not row["permanent_raised"] or len(shard) != SV_DOCS:
        fail("a permanent staging fault did not surface "
             f"(hung: {th.is_alive()}, raised: {row['permanent_raised']})")
    if not launches.get("fused_knn"):
        fail(f"the supervised searches launched no KNN kernel: {launches}")
    return launches


# The spawn phase's program, run by every rank: CKPT FOLDER TOPICS OUT DEVICE
SPAWN_PROGRAM = r"""
import json, os, sys, time
t_start = time.perf_counter()
import torch
import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.config import get_pathway_config
from pathway_tpu_torch.models.encoder import SentenceEncoder
from pathway_tpu_torch.parallel import initialize_from_env
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

stages = {"imports": time.perf_counter() - t_start}
ckpt, folder, topics_file, out, device = sys.argv[1:6]
device = None if device == "cuda" else device
cfg = get_pathway_config()
t0 = time.perf_counter()
grouped = initialize_from_env(device=device)
backend = torch.distributed.get_backend() if grouped else None
stages["process_group"] = time.perf_counter() - t0
t0 = time.perf_counter()
enc = SentenceEncoder(checkpoint=ckpt, device=device)
stages["checkpoint"] = time.perf_counter() - t0
embedded = [0]
encode = enc.encode

def counting_encode(texts):
    embedded[0] += len(texts)
    return encode(texts)

enc.encode = counting_encode

class Topic(pw.Schema):
    name: str
    topic: int

files = pw.io.fs.read(folder, format="binary", mode="static", with_metadata=True)
docs = files.select(
    name=pw.apply_with_type(
        lambda m: os.path.basename(str(m.value["path"])), str, pw.this._metadata),
    text=pw.apply_with_type(lambda b: b.decode("utf-8"), str, pw.this.data),
)
topics = pw.io.jsonlines.read(topics_file, schema=Topic, mode="static")
# static rows enter the engine at rank 0; the join's exchange spreads them
# by name, so every rank embeds the documents it owns
joined = docs.join(topics, pw.left.name == pw.right.name).select(
    name=pw.left.name, text=pw.left.text, topic=pw.right.topic)
embedder = SentenceTransformerEmbedder(encoder=enc)
rows = joined.select(
    pw.this.name, pw.this.topic,
    vec=pw.apply(lambda v: [round(float(x), 6) for x in v], embedder(pw.this.text)),
)
counts = rows.groupby(pw.this.topic).reduce(topic=pw.this.topic, n=pw.reducers.count())
pw.io.jsonlines.write(rows, os.path.join(out, "rows.jsonl"))
pw.io.jsonlines.write(counts, os.path.join(out, "counts.jsonl"))
t_run = time.perf_counter()
pw.run(monitoring_level=pw.MonitoringLevel.NONE)
stages["run"] = time.perf_counter() - t_run
total = embedded[0]
if grouped:
    t = torch.tensor([embedded[0]], dtype=torch.int64,
                     device=enc.device if backend == "nccl" else "cpu")
    torch.distributed.all_reduce(t)
    total = int(t.item())
cuda = enc.device.type == "cuda"
with open(os.path.join(out, f"rank{cfg.process_id}.json"), "w") as f:
    json.dump({
        "rank": cfg.process_id, "processes": cfg.processes, "grouped": grouped,
        "backend": backend, "device": str(enc.device), "embedded": embedded[0],
        "all_reduced": total, "graphs": len([g for g in enc._graphs.values() if g]),
        "buckets": len(enc._graphs), "stages_s": stages,
        "process_s": time.perf_counter() - t_start,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
    }, f)
if grouped:
    torch.distributed.destroy_process_group()
"""


def run_spawn(root: str, processes: int, args: list, timeout: int) -> dict:
    """``python -m pathway_tpu_torch spawn -n processes`` of the spawn
    program; its whole process group is killed if it outlives ``timeout``."""
    import signal

    out = os.path.join(root, f"out{processes}")
    os.makedirs(out)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("PATHWAY_COORDINATOR", None)
    cmd = [sys.executable, "-m", "pathway_tpu_torch", "spawn", "-n", str(processes),
           "--first-port", str(free_port_base(processes + 1)),
           os.path.join(root, "prog.py"), *args[:3], out, args[3]]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"spawn -n {processes} did not end within {timeout} s")
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"spawn -n {processes} exited {proc.returncode}: {stderr[-3000:]}")
    ranks = []
    for r in range(processes):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    rows = {}
    with open(os.path.join(out, "rows.jsonl")) as f:
        for line in f:
            d = json.loads(line)
            if d["diff"] > 0:
                rows[d["name"]] = (d["topic"], np.asarray(d["vec"], np.float32))
    counts = {}
    with open(os.path.join(out, "counts.jsonl")) as f:
        for line in f:
            d = json.loads(line)
            counts[d["topic"]] = counts.get(d["topic"], 0) + d["diff"] * d["n"]
    return {"seconds": seconds, "ranks": ranks, "rows": rows,
            "counts": {t: n for t, n in counts.items() if n}}


def phase_spawn(ckpt: str, seed: int, device: str = "cuda", docs: int = SP_DOCS):
    """Two ranks of ``python -m pathway_tpu_torch spawn`` on the one card
    against the same program under ``spawn -n 1``."""
    import shutil

    rng = np.random.default_rng(seed + 19)
    texts = make_docs(vocab_words(), rng, docs)
    root = tempfile.mkdtemp(prefix="chip_smoke_spawn_")
    folder = os.path.join(root, "docs")
    os.makedirs(folder)
    names = [f"doc{i:06d}.txt" for i in range(docs)]
    for name, text in zip(names, texts):
        with open(os.path.join(folder, name), "w", encoding="utf-8") as f:
            f.write(text)
    topic_of = dict(zip(names, (int(t) for t in rng.integers(0, SP_TOPICS, docs))))
    topics = os.path.join(root, "topics.jsonl")
    with open(topics, "w") as f:
        for name, t in topic_of.items():
            f.write(json.dumps({"name": name, "topic": t}) + "\n")
    with open(os.path.join(root, "prog.py"), "w") as f:
        f.write(SPAWN_PROGRAM)
    args = [ckpt, folder, topics, device]
    two = run_spawn(root, 2, args, SP_TIMEOUT_S)
    one = run_spawn(root, 1, args, SP_TIMEOUT_S)
    shutil.rmtree(root, ignore_errors=True)

    want_counts = {}
    for t in topic_of.values():
        want_counts[t] = want_counts.get(t, 0) + 1
    same_rows = (two["rows"].keys() == one["rows"].keys() == set(names) and all(
        two["rows"][n][0] == one["rows"][n][0] == topic_of[n] for n in names))
    cos = [float(np.dot(two["rows"][n][1], one["rows"][n][1])
                 / (np.linalg.norm(two["rows"][n][1]) * np.linalg.norm(one["rows"][n][1])))
           for n in names if n in two["rows"] and n in one["rows"]]
    row = {
        "phase": "spawn", "docs": docs, "topics": SP_TOPICS,
        "seconds": {"ranks2": two["seconds"], "ranks1": one["seconds"]},
        "docs_per_s": {"ranks2": docs / two["seconds"], "ranks1": docs / one["seconds"]},
        "ranks2": two["ranks"], "ranks1": one["ranks"],
        "rows_equal": same_rows,
        "counts_equal": two["counts"] == one["counts"] == want_counts,
        "min_cos": min(cos) if cos else None,
    }
    emit(row)
    if not same_rows or not row["counts_equal"]:
        fail(f"spawn -n 2 rows/counts differ from spawn -n 1: rows {same_rows}, "
             f"counts {two['counts']} vs {one['counts']}")
    if len(cos) != docs or min(cos) < 0.999:
        fail(f"spawn -n 2 embeddings: {len(cos)} compared, min cosine {row['min_cos']}")
    for r in two["ranks"]:
        if not r["grouped"] or r["backend"] != "gloo" or r["all_reduced"] != docs:
            fail(f"rank {r['rank']}: group {r['grouped']}, backend {r['backend']}, "
                 f"all-reduced rows {r['all_reduced']}")
    for r in two["ranks"] + one["ranks"]:
        if not r["embedded"] or (device == "cuda" and (
                not r["device"].startswith("cuda") or not r["graphs"])):
            fail(f"rank {r['rank']} of {r['processes']} did not run encoder.forward "
                 f"on the card: {r}")
    if one["ranks"][0]["embedded"] != docs:
        fail(f"spawn -n 1 embedded {one['ranks'][0]['embedded']} of {docs} documents")
    return row


def free_port_base(n: int) -> int:
    """A base port with ``n`` consecutive free ports after it."""
    for _ in range(50):
        base = free_port()
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    fail("no range of free ports")


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
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.mocks import IdentityMockChat
    from pathway_tpu_torch.xpacks.llm.question_answering import (
        BaseRAGQuestionAnswerer, RAGClient,
    )
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    rng = np.random.default_rng(seed + 7)
    docs = make_docs(vocab_words(), rng, DF_DOCS)
    folder = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_docs_"), "docs")
    os.makedirs(folder)
    names = [f"doc{i:06d}.txt" for i in range(DF_DOCS)]
    for name, text in zip(names, docs):
        with open(os.path.join(folder, name), "w", encoding="utf-8") as f:
            f.write(text)

    # every search the engine makes, with the query vector it was given
    searches, search_lock, stop_recording = record_searches()
    # the Runtime pw.run builds, for the doctor phase's plan-vs-run audit
    from pathway_tpu_torch.engine.runtime import Runtime

    runtimes: list = []
    runtime_init = Runtime.__init__

    def keeping_runtime(self, *a, **kw):
        runtime_init(self, *a, **kw)
        runtimes.append(self)

    Runtime.__init__ = keeping_runtime

    port = free_port()
    docs_table = pw.io.fs.read(
        folder, format="binary", with_metadata=True, mode="streaming",
        autocommit_duration_ms=100,
    )
    store = VectorStoreServer(docs_table, embedder=SentenceTransformerEmbedder("bge-small"))
    rag = BaseRAGQuestionAnswerer(llm=IdentityMockChat(), indexer=store, search_topk=6)
    rag.build_server(host="127.0.0.1", port=port)

    zero_launches(fk)  # counts of this phase only
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
    Runtime.__init__ = runtime_init
    if len(runtimes) != 1:
        fail(f"pw.run built {len(runtimes)} runtimes")

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
    agree = searches_equal_plain(recorded)
    stop_recording()

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
    return launches, runtimes[0]


def four_shards():
    from pathway_tpu_torch.parallel import make_mesh

    return make_mesh(devices=["cuda:0"] * SHARDS, axes=("dp",), shape=(SHARDS,))


def search_ms(index, q, k) -> float:
    """Median wall time of ``index.search`` (host work included: the
    search returns after its readback), on CUDA events."""
    import torch

    times = []
    for _ in range(SEARCH_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        index.search(q, k)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_sharded(pt, fk, seed: int):
    """Four shards on the card against one KnnShard, bit for bit."""
    import torch

    from pathway_tpu_torch.ops.knn import _normalize
    from pathway_tpu_torch.parallel import ShardedKnnIndex
    from pathway_tpu_torch.parallel import sharded_knn as sk

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    torch.cuda.reset_peak_memory_stats()
    sharded = ShardedKnnIndex(DIM, four_shards())
    single = pt.KnnShard(DIM, "cos", capacity=CAP)
    # an exact three-way tie: three kept keys on three shards hold one vector
    ties: list[int] = []
    for key in range(1, CAP):
        if key % 100 and sharded.owner_shard(key) not in {sharded.owner_shard(t) for t in ties}:
            ties.append(key)
            if len(ties) == 3:
                break
    tie_vec = unit_rows(gen, 1, DIM)[0]
    fill = {"single": 0.0, "sharded": 0.0}
    step = 1 << 16
    for start in range(0, CAP, step):
        rows = unit_rows(gen, step, DIM)
        for t in ties:
            if start <= t < start + step:
                rows[t - start] = tie_vec
        keys = range(start, start + step)
        for name, index in (("single", single), ("sharded", sharded)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index.add(keys, rows)
            torch.cuda.synchronize()
            fill[name] += time.perf_counter() - t0
    removed = list(range(0, CAP, 100))
    single.remove(removed)
    sharded.remove(removed)
    if len(single) != CAP - len(removed) or len(sharded) != len(single):
        fail(f"sharded phase holds {len(sharded)} / {len(single)} rows")
    tie_order = sorted(ties, key=single.key_seq.get)

    cases = []
    for Q, k in CASES:
        q = unit_rows(gen, Q, DIM)
        q[0] = tie_vec
        cases.append((Q, k, q, single.search(q, k)))
    # the path: every case under both merges, counted from zero
    zero_launches(fk)
    torch.cuda.synchronize()
    for Q, k, q, want in cases:
        for merge in ("gather", "tree"):
            os.environ["PATHWAY_INDEX_MERGE"] = merge
            got = sharded.search(q, k)
            if got != want:
                bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
                fail(f"sharded ({merge}) differs from the single shard at Q={Q}, "
                     f"k={k}, query {bad}: {got[bad][:3]} vs {want[bad][:3]}")
            if [key for key, _ in got[0][:3]] != tie_order:
                fail(f"the three-way tie is not in key_seq order at Q={Q}, k={k}")
    # the same two indexes at precision "default" (the attribute each search
    # reads): the one-pass instance per shard, bit for bit with one shard
    _, _, q32, _ = next(c for c in cases if c[:2] == (32, K))
    sharded.precision = single.precision = "default"
    try:
        want_d = single.search(q32, K)
        for merge in ("gather", "tree"):
            os.environ["PATHWAY_INDEX_MERGE"] = merge
            if sharded.search(q32, K) != want_d:
                fail(f"sharded ({merge}) differs from the single shard at precision "
                     f"default, Q=32, k={K}")
        if [key for key, _ in want_d[0][:3]] != tie_order:
            fail("the three-way tie is not in key_seq order at precision default")
    finally:
        sharded.precision = single.precision = "highest"
    torch.cuda.synchronize()
    launches = dict(fk.LAUNCHES)

    rows_out = []
    for Q, k, q, _ in cases:
        row = {"Q": Q, "k": k, "single_ms": search_ms(single, q, k)}
        qn = _normalize(q).contiguous()
        k_eff = min(k, CAP)
        row["single_device_ms"] = cuda_ms(lambda: single.topk(qn, k_eff, "dot"), reps=10)
        used = sharded.rows_in_use()
        for merge in ("gather", "tree"):
            os.environ["PATHWAY_INDEX_MERGE"] = merge
            row[f"{merge}_ms"] = search_ms(sharded, q, k)
            row[f"{merge}_device_ms"] = cuda_ms(lambda: sk.sharded_topk(
                qn, [v[:u] for v, u in zip(sharded.vectors, used)],
                [m[:u] for m, u in zip(sharded.valid, used)], k_eff,
                merge=merge, local_cap=sharded.local_cap), reps=10)
        rows_out.append(row)
    os.environ.pop("PATHWAY_INDEX_MERGE", None)
    emit({
        "phase": "sharded", "shards": SHARDS, "live_rows": len(sharded),
        "local_cap": sharded.local_cap, "rows_used": sharded.rows_used,
        "shard_fill": sharded.shard_fill(), "fill_s": fill,
        "searches": rows_out, "bit_identical": True,
        "default_bit_identical": {"Q": 32, "k": K}, "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    if not all(launches.get(n) for n in ("fused_knn", "fused_knn_tf32", "topk_merge")):
        fail(f"the sharded searches did not launch every kernel: {launches}")
    del sharded
    torch.cuda.empty_cache()
    return launches, single


def phase_snapshot(pt, fk, single, seed: int):
    """Cut, delta cut and restore of the filled 2^20-row KnnShard."""
    import shutil

    import torch

    from pathway_tpu_torch.parallel import ShardedKnnIndex
    from pathway_tpu_torch.persistence import Backend, Config, PersistenceManager
    from pathway_tpu_torch.persistence import index_snapshot as isnap

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    rng = np.random.default_rng(seed + 5)
    pdir = tempfile.mkdtemp(prefix="chip_smoke_snapshot_")
    pm = PersistenceManager(Config(backend=Backend.filesystem(pdir)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(fk)
    row = {"phase": "snapshot", "live_rows": len(single), "capacity": single.capacity}

    def cut(tag):
        t0 = time.perf_counter()
        with isnap.cut(pm, tag):
            state = single.snapshot_state()
        seg = state["segments"][-1]
        row[f"cut{tag}"] = {"s": time.perf_counter() - t0, "bytes": seg["bytes"],
                            "rows": seg["rows"], "removes": seg["removes"]}
        return state

    cut(1)
    live = np.fromiter(single.key_to_slot, np.int64, len(single))
    gone = rng.choice(live, size=CHURN, replace=False).tolist()
    single.remove(gone)
    single.add(range(CAP, CAP + CHURN), unit_rows(gen, CHURN, DIM))
    if single.capacity != CAP:
        fail(f"the churn grew the index to {single.capacity} slots")
    state = cut(2)
    share = row["cut2"]["bytes"] / row["cut1"]["bytes"]
    row["cut2_share_of_cut1"] = share

    q = unit_rows(gen, 256, DIM)
    want = single.search(q, K)
    for name, make in (("single", lambda: pt.KnnShard(DIM, "cos")),
                       ("sharded", lambda: ShardedKnnIndex(DIM, four_shards()))):
        fresh = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with isnap.cut(pm, 0):
            fresh.load_state(state)
        torch.cuda.synchronize()
        row[f"restore_{name}_s"] = time.perf_counter() - t0
        for merge in (("gather", "tree") if name == "sharded" else (None,)):
            if merge:
                os.environ["PATHWAY_INDEX_MERGE"] = merge
            if fresh.search(q, K) != want:
                fail(f"the restored {name} index ({merge}) differs from the live shard")
        del fresh
        torch.cuda.empty_cache()
    os.environ.pop("PATHWAY_INDEX_MERGE", None)
    torch.cuda.synchronize()
    row["launches"] = dict(fk.LAUNCHES)
    row["store_bytes"] = sum(
        os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(pdir) for f in fs)
    row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row["bit_identical"] = True
    shutil.rmtree(pdir, ignore_errors=True)
    emit(row)
    if share > 0.02:
        fail(f"the delta cut wrote {share:.4f} of the full cut's bytes (> 2 %)")
    if not row["launches"].get("fused_knn") or not row["launches"].get("topk_merge"):
        fail(f"the restored searches did not launch both kernels: {row['launches']}")
    return row["launches"]


def close(got, want, tol: float) -> bool:
    """``numpy.allclose`` with rtol = atol = ``tol``, on tensors."""
    import torch

    return bool(torch.isclose(got.float(), want.float(), rtol=tol, atol=tol).all())


def phase_ring(fk, seed: int, device: str = "cuda:0"):
    """Ring attention over eight shards of the one card against full
    attention: the reference test's geometry in f32 (full, causal), one
    position per shard, and bge-small's heads at S = 8192 in bf16."""
    import torch

    from pathway_tpu_torch.parallel import make_mesh
    from pathway_tpu_torch.parallel.ring_attention import reference_attention, ring_attention

    # the f32 checks hold at 2e-5 only with IEEE f32 products
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on in the ring phase")
    zero_launches(fk)
    mesh = make_mesh(devices=[device] * RING_SHARDS, axes=("sp",))
    gen = torch.Generator(device=device).manual_seed(seed + 23)

    def qkv(b, h, s, d, dtype):
        return [torch.randn((b, h, s, d), generator=gen, device=device).to(dtype)
                for _ in range(3)]

    row = {"phase": "ring", "mesh": repr(mesh)}
    for causal in (False, True):
        q, k, v = qkv(2, 4, 64, 16, torch.float32)
        out = ring_attention(q, k, v, mesh, causal=causal)
        ref = reference_attention(q, k, v, causal=causal)
        row[f"f32_{'causal' if causal else 'full'}_max_abs_err"] = float((out - ref).abs().max())
        if out.shape != q.shape or not close(out, ref, 2e-5):
            fail(f"ring attention (f32, causal={causal}) differs from full attention: {row}")
    q, k, v = qkv(1, 1, RING_SHARDS, 4, torch.float32)  # one position per shard
    out = ring_attention(q, k, v, mesh, causal=True)
    if torch.isnan(out).any() or not close(out, reference_attention(q, k, v, causal=True), 2e-5):
        fail("ring attention with one position per shard: NaN or a difference")

    q, k, v = qkv(1, RING_HEADS, RING_SEQ, RING_HEAD_DIM, torch.bfloat16)
    row["long"] = {"b": 1, "h": RING_HEADS, "S": RING_SEQ, "d": RING_HEAD_DIM,
                   "dtype": "bf16", "causal": True}
    outs = {}
    for name, fn in (("ring", lambda: ring_attention(q, k, v, mesh, causal=True)),
                     ("reference", lambda: reference_attention(q, k, v, causal=True))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs[name] = fn()
        torch.cuda.synchronize()
        row["long"][f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        row["long"][f"{name}_ms"] = cuda_ms(fn, reps=RING_REPS)
        # every kernel's device time in one call: the rest is the card idle
        row["long"][f"{name}_device_ms"] = profiled_ms(fn, "")
    ring_out, ref_out = outs["ring"], outs["reference"]
    row["long"]["max_abs_err"] = float((ring_out.float() - ref_out.float()).abs().max())
    row["launches"] = dict(fk.LAUNCHES)
    emit(row)
    if torch.isnan(ring_out).any() or not close(ring_out, ref_out, 5e-2):
        fail(f"ring attention at S = {RING_SEQ} (bf16) differs from full attention")
    if row["long"]["ring_peak_bytes"] >= row["long"]["reference_peak_bytes"]:
        fail(f"the ring's peak memory is not below full attention's: {row['long']}")
    return row["launches"]


# the key bias shifts every score of a softmax row by the same amount: its
# gradient is 0, and what is computed for it is rounding
ANALYTIC_ZERO = ".attention.key.bias"


def grad_mismatches(got: dict, want: dict, rel: float) -> list[str]:
    """The parameters whose gradient in ``got`` differs from ``want`` by
    more than ``rel`` of the tensor's largest |g|; a gradient that is 0
    analytically must be within 1e-6 of the model's largest |g| in both."""
    if got.keys() != want.keys():
        return sorted(got.keys() ^ want.keys())
    top = max(float(w.abs().max()) for w in want.values())
    bad = []
    for name, w in want.items():
        g = got[name].to(w.device)
        if g.shape != w.shape:
            bad.append(name)
        elif name.endswith(ANALYTIC_ZERO):
            if max(float(g.abs().max()), float(w.abs().max())) > 1e-6 * top:
                bad.append(name)
        elif float((g - w).abs().max()) > rel * float(w.abs().max()):
            bad.append(name)
    return bad


def pad_to(ids, mask, L: int):
    out_ids = np.zeros((len(ids), L), np.int32)
    out_mask = np.zeros((len(ids), L), np.int32)
    out_ids[:, :ids.shape[1]] = ids
    out_mask[:, :mask.shape[1]] = mask
    return out_ids, out_mask


def phase_train(pt, fk, ckpt: str, written: dict, seed: int, device: str = "cuda:0"):
    """InfoNCE fine-tuning of bge-small from the main phase's checkpoint:
    ten steps at dp = 1, one at dp = 2 on the same card, and an f32 step
    whose gradients must equal the port's own CPU step."""
    import dataclasses

    import torch

    from pathway_tpu_torch.internals.device import peak_rates
    from pathway_tpu_torch.models import load_bert_encoder
    from pathway_tpu_torch.models.encoder import forward_flops_per_token
    from pathway_tpu_torch.parallel import create_train_state, make_mesh, make_sharded_train_step

    zero_launches(fk)
    cfg, sd, tok = load_bert_encoder(ckpt)
    differ = [n for n, t in written.items() if not torch.equal(sd[n], t)]
    if cfg != pt.EncoderConfig.bge_small() or differ or sd.keys() != written.keys():
        fail(f"the train phase's checkpoint did not load bit for bit: {differ[:3]}")
    rng = np.random.default_rng(seed + 29)
    passages = make_docs(vocab_words(), rng, TR_PAIRS)
    queries = [" ".join(p.split()[:int(rng.integers(4, 13))]) for p in passages]
    q_ids, q_mask = pad_to(*tok(queries, max_length=TR_QUERY_LEN), TR_QUERY_LEN)
    d_ids, d_mask = pad_to(*tok(passages, max_length=TR_PASSAGE_LEN), TR_PASSAGE_LEN)
    batch = {"q_ids": q_ids, "q_mask": q_mask, "d_ids": d_ids, "d_mask": d_mask}

    def fresh(mesh, config):
        state, model, tx = create_train_state(config, mesh)
        model.load_state_dict(sd)
        return state, model, make_sharded_train_step(model, tx, mesh)

    # (a) ten steps at dp = 1
    mesh = make_mesh(devices=[device], axes=("dp", "tp"), shape=(1, 1))
    state, model, step = fresh(mesh, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TR_STEPS + 1)]
    losses = []
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(TR_STEPS):
        state, loss = step(state, batch)
        losses.append(loss)
        marks[i + 1].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(TR_STEPS)]
    losses = torch.stack(losses).tolist()
    med_ms = float(np.median(step_ms[2:]))  # steps 3-10
    tokens = TR_PAIRS * (TR_QUERY_LEN + TR_PASSAGE_LEN)
    flops = 3 * TR_PAIRS * (
        forward_flops_per_token(cfg, TR_QUERY_LEN) * TR_QUERY_LEN
        + forward_flops_per_token(cfg, TR_PASSAGE_LEN) * TR_PASSAGE_LEN)
    peak_bf16 = peak_rates(torch.cuda.get_device_name(0))["bf16"]
    row = {
        "phase": "train", "model": "bge-small", "pairs": TR_PAIRS,
        "query_len": TR_QUERY_LEN, "passage_len": TR_PASSAGE_LEN, "dtype": "bf16",
        "steps": state.step, "losses": losses, "step_ms": step_ms,
        "median_step_ms": med_ms, "wall_s": wall_s,
        "pairs_per_s": TR_PAIRS / (med_ms / 1e3), "tokens_per_s": tokens / (med_ms / 1e3),
        "flops_per_step": flops, "mfu_bf16": flops / (med_ms / 1e3) / peak_bf16,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    if state.step != TR_STEPS or not np.all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        emit(row)
        fail(f"training did not descend in {TR_STEPS} steps: {losses}, step {state.step}")
    # every kernel's device time in one step: the rest is the card idle
    row["step_device_ms"] = profiled_ms(lambda: step(state, batch), "")
    row["device_busy_share"] = row["step_device_ms"] / med_ms
    del state, model, step

    # (b) one step at dp = 2 on the same card, from the same weights
    mesh2 = make_mesh(devices=[device] * 2, axes=("dp", "tp"), shape=(2, 1))
    state, model, step = fresh(mesh2, cfg)
    state, loss = step(state, batch)
    row["dp2_loss"] = float(loss)
    del state, model, step

    # (c) the f32 gradients on the card against the port's CPU step
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    small = {k: v[:TR_CHECK_PAIRS, :TR_QUERY_LEN] for k, v in batch.items()}
    out = {}
    for dev in (device, "cpu"):
        m = make_mesh(devices=[dev], axes=("dp", "tp"), shape=(1, 1))
        state, model, step = fresh(m, cfg32)
        state, loss = step(state, small)
        out[dev] = (float(loss), {n: p.grad for n, p in model.named_parameters()})
        del state, model, step
    (card_loss, card_g), (cpu_loss, cpu_g) = out[device], out["cpu"]
    bad = grad_mismatches(card_g, cpu_g, 1e-4)
    row["f32_check"] = {"pairs": TR_CHECK_PAIRS, "tokens": TR_QUERY_LEN,
                        "card_loss": card_loss, "cpu_loss": cpu_loss,
                        "tensors": len(cpu_g), "mismatched": bad}
    row["launches"] = dict(fk.LAUNCHES)
    del out, card_g, cpu_g
    torch.cuda.empty_cache()
    emit(row)
    if abs(row["dp2_loss"] - losses[0]) > 1e-2:
        fail(f"the dp = 2 step's loss {row['dp2_loss']} differs from dp = 1's {losses[0]}")
    if abs(card_loss - cpu_loss) > 1e-4 * abs(cpu_loss) or bad:
        fail(f"the card's f32 step differs from the CPU's: loss {card_loss} vs "
             f"{cpu_loss}, gradients {bad[:5]}")
    return row["launches"]


PROBE = "a question asked while the index restores"


def miss_detail(adapter, qvec, name: str) -> dict:
    """Why a retrieve missed its own document ``name`` in one index: is
    the document there, its score, and the K-th best score beside it."""
    import torch

    shard = adapter.shard
    key = next((k for k, m in adapter.meta.items()
                if os.path.basename(str(getattr(m, "value", m).get("path", ""))) == name),
               None)
    with shard.lock:
        slot = shard.key_to_slot.get(key) if key is not None else None
        q = torch.from_numpy(qvec).to(shard.device)
        q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-30)
        scores = torch.where(shard.valid, shard.vectors @ q, -torch.inf)
        top = torch.topk(scores, K).values.tolist()
        own = None if slot is None else float(scores[slot])
    return {"rows": len(shard), "in_meta": key is not None, "in_index": slot is not None,
            "own_score": own, "top_scores": top,
            "rank": None if own is None else int((scores > own).sum())}


def persisted_child(folder: str, pdir: str, out: str, n_files: int, queries: list) -> None:
    """One run of the persisted dataflow template (the ``persisted``
    phase's subprocess): serve until ``/v1/statistics`` counts ``n_files``
    and the store holds ``marker/snapshot_commit``, retrieve ``queries``,
    check every engine search against the plain scan over its index, and
    write what it saw to ``out``."""
    t_start = time.perf_counter()
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models.encoder import SentenceEncoder
    from pathway_tpu_torch.ops import fused_knn as fk
    from pathway_tpu_torch.stdlib.indexing import nearest_neighbors as nn_mod
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.mocks import IdentityMockChat
    from pathway_tpu_torch.xpacks.llm.question_answering import (
        BaseRAGQuestionAnswerer, RAGClient,
    )
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    lock = threading.Lock()
    embedded: list = []
    added: list = []
    searches, search_lock, _ = record_searches()
    encode, add_batch = SentenceEncoder.encode, nn_mod._KnnAdapter.add_batch

    def counting_encode(self, texts, *a, **kw):
        with lock:
            embedded.extend(texts)
        return encode(self, texts, *a, **kw)

    def counting_add_batch(self, rows):
        with lock:
            added.extend(k for k, _, _ in rows)
        return add_batch(self, rows)

    SentenceEncoder.encode = counting_encode
    nn_mod._KnnAdapter.add_batch = counting_add_batch
    adapters: list = []
    init = nn_mod._KnnAdapter.__init__

    def keeping_init(self, *a, **kw):
        init(self, *a, **kw)
        adapters.append(self)

    nn_mod._KnnAdapter.__init__ = keeping_init

    docs_table = pw.io.fs.read(folder, format="binary", with_metadata=True,
                               mode="streaming", autocommit_duration_ms=100)
    store = VectorStoreServer(docs_table, embedder=SentenceTransformerEmbedder("bge-small"))
    rag = BaseRAGQuestionAnswerer(llm=IdentityMockChat(), indexer=store, search_topk=6)
    port = free_port()
    rag.build_server(host="127.0.0.1", port=port)
    config = pw.persistence.Config(backend=pw.persistence.Backend.filesystem(pdir),
                                   persistence_mode="OPERATOR_PERSISTING")
    errors: list = []

    def run():
        try:
            pw.run(persistence_config=config)
        except BaseException as e:
            errors.append(repr(e))

    t_run = time.perf_counter()
    threading.Thread(target=run, name="pw.run", daemon=True).start()
    client = RAGClient(host="127.0.0.1", port=port, timeout=120)
    first_answer = None
    count = 0
    marker = os.path.join(pdir, "marker", "snapshot_commit")
    while not errors and time.perf_counter() - t_run < PS_TIMEOUT_S:
        try:
            if first_answer is None and client.retrieve(PROBE, k=K):
                first_answer = time.perf_counter()
            count = int(client.statistics().get("file_count") or 0)
        except OSError:
            time.sleep(0.1)  # the gateway is not listening yet
            continue
        if count >= n_files and os.path.exists(marker):
            break
        time.sleep(0.1)
    ingest_s = time.perf_counter() - t_run
    with lock:
        embedded_ingest = [t for t in embedded if t != PROBE]
    with search_lock:
        searches.clear()
    hits, missed = [], []
    for text, name in queries:
        with search_lock:
            before = len(searches)
        res = client.retrieve(text, k=K) if not errors else []
        got = [os.path.basename(r["metadata"]["path"]) for r in res]
        hits.append(name in got and len(res) == K)
        if not hits[-1]:
            with search_lock:
                mine = searches[before:]
            missed.append({"name": name, "returned": len(res),
                           "indexes": [miss_detail(a, q, name) for a, q, _, _ in mine]})
    with search_lock:
        recorded = list(searches)
    agree = searches_equal_plain(recorded)
    torch.cuda.synchronize()
    with open(out, "w") as f:
        json.dump({
            "count": count, "errors": errors, "marker": os.path.exists(marker),
            "ingest_s": ingest_s,
            "first_answer_s": None if first_answer is None else first_answer - t_start,
            "first_answer_after_run_s": (
                None if first_answer is None else first_answer - t_run),
            "index_rows_written": len(added), "indexes": len(adapters),
            "index_rows": [len(a.shard) for a in adapters],
            "embedded_ingest": embedded_ingest,
            "recall_own_doc_top10": float(np.mean(hits)) if hits else 0.0,
            "missed": missed,
            "engine_searches": len(recorded), "searches_equal_plain": agree,
            "launches": dict(fk.LAUNCHES),
        }, f)
    sys.stdout.flush()
    os._exit(0)


def run_persisted_child(folder, pdir, out, n_files, queries) -> dict:
    spec = os.path.join(os.path.dirname(out), os.path.basename(out) + ".queries.json")
    with open(spec, "w") as f:
        json.dump(queries, f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--persisted-child",
         folder, pdir, out, str(n_files), spec],
        capture_output=True, text=True, timeout=PS_TIMEOUT_S + 120,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(out):
        fail(f"persisted child exited {proc.returncode}: {proc.stderr[-3000:]}")
    with open(out) as f:
        res = json.load(f)
    res["process_s"] = wall
    if res["errors"]:
        fail(f"persisted child: pw.run raised {res['errors'][0]}")
    if res["count"] != n_files or not res["marker"]:
        fail(f"persisted child counted {res['count']} of {n_files} files "
             f"(marker written: {res['marker']}) within {PS_TIMEOUT_S} s")
    return res


def phase_persisted(seed: int):
    """The dataflow template persisted, stopped and restarted on more files."""
    import shutil

    rng = np.random.default_rng(seed + 13)
    texts = make_docs(vocab_words(), rng, PS_DOCS + PS_NEW)
    names = [f"doc{i:06d}.txt" for i in range(PS_DOCS + PS_NEW)]
    root = tempfile.mkdtemp(prefix="chip_smoke_persisted_")
    folder, pdir = os.path.join(root, "docs"), os.path.join(root, "store")
    os.makedirs(folder)

    def write(lo, hi):
        for i in range(lo, hi):
            with open(os.path.join(folder, names[i]), "w", encoding="utf-8") as f:
                f.write(texts[i])

    def pick(lo, hi, n):
        return [(texts[i], names[i]) for i in rng.choice(np.arange(lo, hi), n, replace=False)]

    write(0, PS_DOCS)
    first = run_persisted_child(folder, pdir, os.path.join(root, "run1.json"),
                                PS_DOCS, pick(0, PS_DOCS, PS_RETRIEVES))
    segments = sorted(
        os.path.relpath(os.path.join(d, f), pdir)
        for d, _, fs in os.walk(os.path.join(pdir, "index_segment")) for f in fs)
    write(PS_DOCS, PS_DOCS + PS_NEW)
    half = PS_RETRIEVES // 2
    second = run_persisted_child(
        folder, pdir, os.path.join(root, "run2.json"), PS_DOCS + PS_NEW,
        pick(0, PS_DOCS, half) + pick(PS_DOCS, PS_DOCS + PS_NEW, half))
    n_idx = first["indexes"]
    new_texts = set(texts[PS_DOCS:])
    launches = {k: first["launches"].get(k, 0) + second["launches"].get(k, 0)
                for k in set(first["launches"]) | set(second["launches"])}
    row = {
        "phase": "persisted", "docs": PS_DOCS, "new_docs": PS_NEW,
        "first_ingest_s": first["ingest_s"],
        "first_ingest_docs_per_s": PS_DOCS / first["ingest_s"],
        "restart_first_answer_s": second["first_answer_s"],
        "restart_first_answer_after_run_s": second["first_answer_after_run_s"],
        "restart_ingest_s": second["ingest_s"],
        "process_s": [first["process_s"], second["process_s"]],
        "indexes": n_idx, "index_rows": second["index_rows"],
        "rows_written": [first["index_rows_written"], second["index_rows_written"]],
        "embedded_at_ingest": [len(first["embedded_ingest"]), len(second["embedded_ingest"])],
        "segments_after_first_run": segments[:8], "n_segments": len(segments),
        "recall_own_doc_top10": [first["recall_own_doc_top10"],
                                 second["recall_own_doc_top10"]],
        "searches_equal_plain": [
            f"{r['searches_equal_plain']}/{r['engine_searches']}" for r in (first, second)],
        "launches": launches,
        "missed": [first["missed"], second["missed"]],
    }
    emit(row)
    shutil.rmtree(root, ignore_errors=True)
    if not segments:
        fail("the first run committed no index segment")
    if n_idx < 1 or first["index_rows_written"] != PS_DOCS * n_idx:
        fail(f"the first run wrote {first['index_rows_written']} index rows to {n_idx} indexes")
    if second["index_rows_written"] != PS_NEW * n_idx:
        fail(f"the restart wrote {second['index_rows_written']} index rows, "
             f"not the {PS_NEW} new documents' to each of {n_idx} indexes")
    if set(second["embedded_ingest"]) != new_texts:
        old = len(set(second["embedded_ingest"]) - new_texts)
        fail(f"the restart embedded {old} texts that are not new documents")
    if any(n != PS_DOCS + PS_NEW for n in second["index_rows"]):
        fail(f"the restored indexes hold {second['index_rows']} rows")
    for r in (first, second):
        if r["recall_own_doc_top10"] < RECALL_MIN:
            fail(f"persisted recall of the own document {r['recall_own_doc_top10']}")
        # one engine search per retrieve: a request keyed onto a row the
        # restored state still held would add the searches of that row
        if r["engine_searches"] != PS_RETRIEVES or r["searches_equal_plain"] != PS_RETRIEVES:
            fail(f"persisted searches: {r['searches_equal_plain']} of "
                 f"{r['engine_searches']} equal the plain scan, for {PS_RETRIEVES} retrieves")
    if not launches.get("fused_knn") or not launches.get("topk_merge"):
        fail(f"the persisted runs did not launch both kernels: {launches}")
    return launches


def rerank_program(pw, folder: str, queries: list, embedder, reranker):
    """The rerank dataflow as upstream Pathway documents it for
    ``pw.xpacks.llm.rerankers``: ``retrieve_query`` (k = RR_K) over a
    ``VectorStoreServer`` of the folder's files, ``flatten`` of the
    candidates, a score per (query, document) pair from the reranker,
    ``groupby(query).reduce`` into tuples, ``rerank_topk_filter``."""
    from pathway_tpu_torch.xpacks.llm.rerankers import rerank_topk_filter
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    docs = pw.io.fs.read(folder, format="binary", with_metadata=True, mode="static")
    store = VectorStoreServer(docs, embedder=embedder)
    q = pw.debug.table_from_markdown(
        "query | k\n" + "".join(f"{text} | {RR_K}\n" for text in queries),
        schema=store.RetrieveQuerySchema)
    candidates = q.select(query=pw.this.query, docs=store.retrieve_query(q).result)
    pairs = candidates.flatten(pw.this.docs)
    scored = pairs.with_columns(score=reranker(pw.this.docs, pw.this.query))
    grouped = scored.groupby(pw.this.query).reduce(
        pw.this.query,
        docs=pw.reducers.tuple(pw.this.docs),
        scores=pw.reducers.tuple(pw.this.score),
    )
    return grouped.select(
        pw.this.query, pw.this.docs, pw.this.scores,
        kept=rerank_topk_filter(pw.this.docs, pw.this.scores, RR_KEEP))


def cross_forward_flops(cfg, n: int, L: int) -> float:
    """Operations of one cross-encoder forward over n pairs of L tokens:
    each layer's four projections and two MLP products, its attention
    scores and their product with the values, then the pool and score
    heads."""
    h, layers = cfg.hidden, cfg.layers
    per_layer = 2 * n * L * (4 * h * h + 2 * h * cfg.mlp) + 4 * n * L * L * h
    return layers * per_layer + 2 * n * (h * h + h)


def phase_rerank(fk, seed: int):
    """The rerank path on the card: bge-small's KNN candidates scored by a
    bge-small cross-encoder (seeded weights, bf16 activations) inside a
    static program that ``pw.run`` finishes; the parse graph is cleared
    after it, for the dataflow phase's program."""
    import collections
    import dataclasses

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.device import peak_rates
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.models import CrossEncoder, EncoderConfig
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

    # the f32 twin is held to the CPU at 1e-4 only with IEEE f32 products
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on in the rerank phase")
    rng = np.random.default_rng(seed + 41)
    texts = make_docs(vocab_words(), rng, RR_DOCS)
    names = [f"doc{i:05d}.txt" for i in range(RR_DOCS)]
    folder = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_rerank_"), "docs")
    os.makedirs(folder)
    for name, text in zip(names, texts):
        with open(os.path.join(folder, name), "w", encoding="utf-8") as f:
            f.write(text)
    picks = rng.choice(RR_DOCS, size=RR_QUERIES, replace=False)
    queries = [" ".join(texts[i].split()[:RR_QUERY_WORDS]) for i in picks]
    own = {q: names[i] for q, i in zip(queries, picks)}
    if len(own) != RR_QUERIES:
        fail("the rerank queries are not distinct")

    ce = CrossEncoder(EncoderConfig.bge_small(), seed=RR_CE_SEED)  # the card
    reranker = CrossEncoderReranker(cross_encoder=ce)
    # every batch the UDF hands the model, and every forward it runs
    calls: list = []
    score = ce.score

    def recording_score(pairs):
        out = score(pairs)
        calls.append((list(pairs), out.copy()))
        return out

    ce.score = recording_score
    forwards: list = []
    input_devices: set = set()
    inputs: dict = {}  # the last (ids, mask) of each bucket shape

    def before(module, args):
        input_devices.update(str(a.device) for a in args)
        inputs[tuple(args[0].shape)] = args
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        forwards.append([tuple(args[0].shape), start, None])

    def after(module, args, out):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        forwards[-1][2] = end

    hooks = [ce.model.register_forward_pre_hook(before),
             ce.model.register_forward_hook(after)]
    # every search the engine makes, with the query vector it was given
    searches, _, stop_recording = record_searches()

    out = rerank_program(pw, folder, queries, SentenceTransformerEmbedder("bge-small"),
                         reranker)
    rows: dict = {}

    def on_change(key, row, time, is_addition):
        # the first insertion per query: as-of-now answers are retracted
        # at the next time, as in the JAX package
        if is_addition:
            rows.setdefault(row["query"], row)

    pw.io.subscribe(out, on_change=on_change)
    zero_launches(fk)  # counts of this phase only
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pw.run()
    run_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(fk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for h in hooks:
        h.remove()
    ce.score = score
    stop_recording()
    G.clear()
    # check 5: the candidates are the plain scan's over the index's vectors
    searches_agree = searches_equal_plain(searches)

    forward_ms = [(shape, start.elapsed_time(end)) for shape, start, end in forwards]
    full = [ms for shape, ms in forward_ms if shape[0] == ce.batch_size]
    shapes = collections.Counter(shape for shape, _ in forward_ms)
    # the commonest bucket alone: eager ms (CUDA events), the device time
    # of its kernels, and the least time at the card's bf16 peak
    common = max(shapes, key=shapes.get)

    def forward():
        with torch.inference_mode():
            ce.model(*inputs[common])

    alone_ms = cuda_ms(forward, reps=5)
    alone_device_ms = profiled_ms(forward, "", reps=5)
    bound_ms = 1e3 * cross_forward_flops(ce.config, *common) / peak_rates()["bf16"]
    # check 4: the same batches scored outside the dataflow give the same
    # bits; the insertions' batches come first, so a pair's first score is
    # the one its output row carries
    outside: dict = {}
    batches: list = []
    recomputed_equal = True
    for pairs, got in calls:
        again = score(pairs)
        recomputed_equal &= bool(np.array_equal(again.view(np.uint32), got.view(np.uint32)))
        if any(p not in outside for p in pairs):
            batches.append(pairs)
        for p, s in zip(pairs, again):
            outside.setdefault(p, float(s))
    resort_equal = 0
    recall_hits = 0
    for query, row in rows.items():
        cand = list(row["docs"])
        cand_texts = [d.value["text"] for d in cand]
        paths = [os.path.basename(d.value["metadata"]["path"]) for d in cand]
        recall_hits += own.get(query) in paths
        s = [outside.get((query, t)) for t in cand_texts]
        if len(cand) != RR_K or None in s:
            continue
        order = sorted(range(len(s)), key=lambda i: -s[i])[:RR_KEEP]
        kept_docs, kept_scores = row["kept"]
        resort_equal += (
            [d.value["text"] for d in kept_docs] == [cand_texts[i] for i in order]
            and list(kept_scores) == [s[i] for i in order]
            and list(row["scores"]) == s)
    recall = recall_hits / RR_QUERIES

    # check 2: the same weights at f32 on the card, over the same batches;
    # check 3: f32 on the card against f32 on the CPU on the first pairs
    params = {k: v.detach().cpu() for k, v in ce.model.state_dict().items()}
    f32 = dataclasses.replace(ce.config, dtype=torch.float32)
    card_f32 = CrossEncoder(f32, params=params, device=ce.device)
    cpu_f32 = CrossEncoder(f32, params=params, device="cpu")
    card_f32.tokenizer = cpu_f32.tokenizer = ce.tokenizer
    f32_scores: dict = {}
    for pairs in batches:
        for p, s in zip(pairs, card_f32.score(pairs)):
            f32_scores.setdefault(p, float(s))
    keys = sorted(outside)
    a = np.array([outside[p] for p in keys], np.float64)
    b = np.array([f32_scores[p] for p in keys], np.float64)
    cosine = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    bf16_err = float(np.abs(a - b).max())
    clear_gap, kept_as_f32 = 0, 0
    for query, row in rows.items():
        cand_texts = [d.value["text"] for d in row["docs"]]
        s32 = np.array([f32_scores[(query, t)] for t in cand_texts])
        order = np.argsort(-s32, kind="stable")
        if s32[order[RR_KEEP - 1]] - s32[order[RR_KEEP]] > 2 * bf16_err:
            clear_gap += 1
            kept_as_f32 += ({d.value["text"] for d in row["kept"][0]}
                            == {cand_texts[i] for i in order[:RR_KEEP]})
    first = batches[0][:RR_CPU_PAIRS] if batches else []
    on_card = card_f32.score(first)
    on_cpu = cpu_f32.score(first)
    cpu_err = float(np.abs(on_card - on_cpu).max()) if first else float("inf")
    cpu_bound = RR_CPU_REL * float(np.abs(on_card).max()) if first else 0.0

    row = {
        "phase": "rerank", "config": "bge-small", "docs": RR_DOCS,
        "queries": RR_QUERIES, "k": RR_K, "keep": RR_KEEP, "pairs": len(outside),
        "run_s": run_s, "pairs_per_s": len(outside) / run_s,
        "udf_calls": len(calls),
        "udf_batch_sizes": dict(sorted(collections.Counter(len(p) for p, _ in calls).items())),
        "forwards": len(forwards),
        "forward_ms_64_median": float(np.median(full)) if full else None,
        "forward_ms_total": float(sum(ms for _, ms in forward_ms)),
        "bucket_shapes": {f"{n}x{L}": c for (n, L), c in sorted(shapes.items())},
        "common_bucket": "x".join(map(str, common)),
        "common_alone_ms": alone_ms, "common_alone_device_ms": alone_device_ms,
        "common_bound_ms": bound_ms,
        "peak_device_bytes": peak,
        "launches": launches,
        "model_device": sorted({p.device.type for p in ce.model.parameters()}),
        "input_devices": sorted(input_devices),
        "checks": {
            "engine_searches": len(searches),
            "searches_equal_plain": searches_agree,
            "recall_own_doc_top8": recall,
            "bf16_vs_f32_cosine": cosine, "bf16_vs_f32_max_abs_err": bf16_err,
            "kept_as_f32": f"{kept_as_f32}/{clear_gap}",
            "f32_card_vs_cpu_max_abs_err": cpu_err, "f32_card_vs_cpu_bound": cpu_bound,
            "dataflow_equal_outside": f"{resort_equal}/{len(rows)}",
            "outside_rescore_bit_equal": recomputed_equal,
        },
        "jax_loaded": "jax" in sys.modules,
    }
    emit(row)
    del ce, reranker, card_f32, cpu_f32
    gc.collect()
    torch.cuda.empty_cache()
    # check 1
    if row["model_device"] != ["cuda"] or any(not d.startswith("cuda") for d in input_devices):
        fail(f"the cross-encoder ran off the card: {row['model_device']}, {row['input_devices']}")
    if launches.get("fused_knn", 0) <= 0:
        fail(f"the rerank phase launched no KNN kernel: {launches}")
    if "jax" in sys.modules or any(m.startswith("pathway_tpu.") for m in sys.modules):
        fail("JAX or the JAX package was imported")
    if len(rows) != RR_QUERIES or len(outside) != RR_PAIRS:
        fail(f"the rerank answered {len(rows)} of {RR_QUERIES} queries "
             f"and scored {len(outside)} of {RR_PAIRS} pairs")
    # check 2
    if cosine < RR_COSINE_MIN:
        fail(f"bf16 scores against f32: cosine {cosine} < {RR_COSINE_MIN}")
    if kept_as_f32 != clear_gap:
        fail(f"{clear_gap - kept_as_f32} of {clear_gap} queries with a clear gap "
             "keep other pairs than f32")
    # check 3
    if not cpu_err <= cpu_bound:
        fail(f"f32 on the card against the CPU: {cpu_err} > {cpu_bound}")
    # check 4
    if not recomputed_equal or resort_equal != len(rows):
        fail(f"the dataflow's kept pairs differ from a re-sort of the scores "
             f"computed outside it: {resort_equal} of {len(rows)} equal, "
             f"rescore bit-equal {recomputed_equal}")
    # check 5
    if not searches or searches_agree != len(searches):
        fail(f"{len(searches) - searches_agree} of {len(searches)} engine searches "
             "disagree with the plain scan")
    return launches


# the doctor phase: the Device Doctor's declared workload is the main
# phase's own (its ingest batches, its 64k-row fills, its query batches)
DOCTOR_QUERY_BATCHES = (1, 32, 256)
DOCTOR_FILL_STEP = 1 << 16


def doctor_workload(pt, enc, docs):
    """The main phase's workload as the doctor declares it: every ingest
    batch as (rows, token length) through the encoder's own tokenizer,
    the fill as 64k-row writes, queries of 1 / 32 / 256 at k = 10."""
    from pathway_tpu_torch.analysis.device_plan import WorkloadSpec

    batches = [docs[i:i + DOC_BATCH] for i in range(0, N_DOCS, DOC_BATCH)]
    fill = CAP - N_DOCS
    return batches, WorkloadSpec(
        ingest_batches=tuple(
            (len(b), enc.tokenizer(b)[0].shape[1]) for b in batches),
        write_batches=tuple(
            min(DOCTOR_FILL_STEP, fill - i) for i in range(0, fill, DOCTOR_FILL_STEP)),
        query_batches=DOCTOR_QUERY_BATCHES, ks=(K,), corpus_rows=CAP,
        batch_cap=DOC_BATCH, initial_capacity=CAP,
    )


def run_doctor_cli(*args) -> subprocess.Popen:
    """``python -m pathway_tpu_torch.analysis`` in a fresh process, with
    the card's own budget (no override)."""
    env = {k: v for k, v in os.environ.items() if k != "PATHWAY_DEVICE_HBM_BYTES"}
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-m", "pathway_tpu_torch.analysis", *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def phase_doctor(pt, fk, ckpt: str, seed: int, df_runtime):
    """The plan doctor and the Device Doctor on the card: the dataflow
    program's plan against its running engine, the device plan of the
    main phase's workload at full width (budgeted at the card's memory,
    launching and allocating nothing), its predictions against a traced
    window of the main path, and the CLI."""
    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.analysis import analyzer as pa
    from pathway_tpu_torch.analysis.critical_path import critical_path
    from pathway_tpu_torch.analysis.device_plan import (
        analyze_device_plan, join_profile,
    )
    from pathway_tpu_torch.analysis.profile import profile_trace
    from pathway_tpu_torch.internals import device as devplane
    from pathway_tpu_torch.internals.flight import FlightRecorder
    from pathway_tpu_torch.internals.monitoring import ProberStats

    t_phase = time.perf_counter()
    # the CLI runs in fresh processes beside the phase
    clis = {
        "device_plan": run_doctor_cli("--device-plan", "--json"),
        "over_budget": run_doctor_cli("--device-plan", "--device-mutant", "over_budget"),
        "mesh": run_doctor_cli("--mesh", "--processes", "3", "--mesh-rounds", "1"),
    }
    row: dict = {"phase": "doctor"}

    # -- the plan doctor: the dataflow program, static and running --------
    t0 = time.perf_counter()
    static = pw.analyze(device=True)
    real = pa.analyze_scope(df_runtime, device=True)
    row["plan_s"] = time.perf_counter() - t0

    def shape(r):
        return [r.verdict, [[n["node"], n["kind"], n["verdict"]] for n in r.nodes],
                [[d.code, d.severity, d.node] for d in r.diagnostics]]

    audit = pa.audit_runtime(df_runtime, real)
    row["plan"] = {"verdict": static.verdict, "nodes": len(static.nodes),
                   "diagnostics": len(static.diagnostics),
                   "device": static.device["verdict"],
                   "reachable_sites": static.device["reachable_sites"],
                   "audit_problems": audit}
    if shape(static) != shape(real) or audit:
        fail(f"the dataflow program's static plan and its run disagree: {audit}")
    if static.device["verdict"] != "device-clean" or not {
            "knn.write", "knn.search"} <= set(static.device["reachable_sites"]):
        fail(f"the dataflow program's device sub-report: {static.device['verdict']}, "
             f"{static.device['reachable_sites']}")

    # -- the Device Doctor at full width, launching and allocating nothing -
    enc = pt.SentenceEncoder(checkpoint=ckpt, batch_size=DOC_BATCH)
    docs = make_docs(vocab_words(), np.random.default_rng(seed), N_DOCS)
    batches, spec = doctor_workload(pt, enc, docs)
    cfg = pt.EncoderConfig.bge_small()
    total = torch.cuda.get_device_properties(0).total_memory

    def device_memory():
        # bytes held now, and bytes ever allocated (a counter that only
        # an allocation moves)
        return (torch.cuda.memory_allocated(),
                torch.cuda.memory_stats()["allocated_bytes.all.allocated"])

    # garbage of earlier phases is freed first, and the collector is held
    # off while the doctor runs, so what it frees cannot read as its own
    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize()
        before = (dict(fk.LAUNCHES), device_memory())
        t0 = time.perf_counter()
        report = analyze_device_plan(workload=spec, config=cfg)
        row["device_plan_s"] = time.perf_counter() - t0
        mutant = analyze_device_plan(workload=spec, config=cfg, mutant="over_budget")
        torch.cuda.synchronize()
        after = (dict(fk.LAUNCHES), device_memory())
    finally:
        gc.enable()
    row["device_plan"] = {
        "verdict": report.verdict, "chains": report.chains,
        "predicted": {s: p["recompiles"] for s, p in report.predictions.items()},
        "hbm": report.hbm, "over_budget_verdict": mutant.verdict,
        # the roofline of each predicted knn.fused plan on this card
        "knn_fused_bound_ms": report.predictions["knn.fused"].get("bound_ms"),
        "launches_moved": after[0] != before[0],
        "allocated_moved_bytes": after[1][0] - before[1][0],
        "bytes_allocated_during": after[1][1] - before[1][1],
    }
    if after != before:
        fail(f"the Device Doctor launched or allocated: {before} -> {after}")
    if report.verdict != "device-clean":
        fail(f"the main workload is {report.verdict}:\n{report.render()}")
    if report.hbm["budget_bytes"] != total:
        fail(f"budget {report.hbm['budget_bytes']} is not the card's {total} bytes")
    if mutant.verdict != "device-dirty" or not any(
            d.code == "device.hbm.over_budget" for d in mutant.diagnostics):
        fail(f"the over_budget mutant came back {mutant.verdict}")

    # -- its predictions against a traced window of the main path --------
    # one ingest batch per predicted ingest bucket, one query batch of 256
    # texts per predicted encoder bucket, into a fresh encoder's graphs
    from pathway_tpu_torch.internals.device import (
        batch_bucket, encoder_bucket, ingest_bucket, seq_bucket,
    )

    by_ingest: dict = {}
    by_encoder: dict = {}
    for i, (n, L) in enumerate(spec.ingest_batches):
        nb, Lb = batch_bucket(n, 8, DOC_BATCH), seq_bucket(L, cfg.max_len)
        by_ingest.setdefault(ingest_bucket(nb, Lb, CAP, "uint16"), i)
        by_encoder.setdefault(encoder_bucket(nb, Lb, True), i)
    window = sorted(set(by_ingest.values()))
    if sorted(set(by_encoder.values())) != window:
        fail("the ingest and encoder buckets of the main batches do not pair up")
    shard = pt.KnnShard(cfg.hidden, "cos", capacity=CAP)
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    fill = CAP - DOC_BATCH * len(window)
    for start in range(0, fill, DOCTOR_FILL_STEP):
        n = min(DOCTOR_FILL_STEP, fill - start)
        shard.add(range(start, start + n), unit_rows(gen, n, cfg.hidden))
    pipe = pt.IngestPipeline(enc, shard)
    engine = pt.QueryEngine(enc, shard, k=K)
    trace_path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_trace_"), "trace.json")
    rec, stats = FlightRecorder(trace_path), ProberStats()
    torch.cuda.synchronize()
    devplane.PLANE.arm(rec, stats)
    zero_launches(fk)  # counts of this phase only
    t0 = time.perf_counter()
    try:
        for i in window:
            pipe.ingest([f"doc{i * DOC_BATCH + j}" for j in range(len(batches[i]))],
                        batches[i])
        results = {i: engine.query(batches[i]) for i in window}
        torch.cuda.synchronize()
    finally:
        devplane.PLANE.disarm()
    row["window_ms"] = 1e3 * (time.perf_counter() - t0)
    launches = dict(fk.LAUNCHES)
    rec.dump()
    graphs: dict = {}
    for site, _ in enc._graphs:
        graphs[site] = graphs.get(site, 0) + 1
    joined = join_profile(report, {"device_recompiles": dict(stats.device_recompiles)})
    row["recompiles"] = {
        site: {"predicted": joined.predictions[site]["recompiles"],
               "measured": joined.predictions[site].get("measured_recompiles"),
               "cuda_graphs": graphs.get(site, 0),
               "drift": joined.predictions[site].get("drift")}
        for site in ("encoder.forward", "ingest.fused", "knn.fused")
    }
    for site in ("encoder.forward", "ingest.fused"):
        r = row["recompiles"][site]
        if not r["predicted"] == r["measured"] == r["cuda_graphs"]:
            fail(f"{site}: predicted {r['predicted']} recompiles, noted "
                 f"{r['measured']}, captured {r['cuda_graphs']} CUDA graphs")
    if joined.verdict != "device-clean":
        fail(f"predictions against the window: {joined.verdict}")
    hits = [f"doc{i * DOC_BATCH + j}" in [key for key, _ in r]
            for i, res in results.items() for j, r in enumerate(res)]
    row["recall_own_doc_top10"] = float(np.mean(hits))
    if any(len(r) != K or not all(np.isfinite(s) for _, s in r)
           for res in results.values() for r in res):
        fail("the window's queries returned wrong or non-finite hits")
    if row["recall_own_doc_top10"] < RECALL_MIN:
        fail(f"window recall {row['recall_own_doc_top10']} < {RECALL_MIN}")
    row["launches"] = launches
    if launches.get("fused_knn", 0) <= 0:
        fail(f"the doctor's window launched no KNN kernel: {launches}")

    # -- knn.fused through the trace analyzers, against the card's peaks --
    prof = profile_trace(trace_path)
    cp = critical_path(trace_path)
    if not prof["valid"] or not cp["valid"]:
        fail(f"the window's trace: {prof['problems'][:3]} {cp['problems'][:3]}")
    sites = {s["site"]: s for s in prof["device"]["sites"]}
    cp_sites = {s["site"]: s for s in (cp.get("device") or {}).get("sites", [])}
    fused = sites.get("knn.fused")
    if fused is None or "knn.fused" not in cp_sites:
        fail(f"knn.fused missing from the trace analyzers: {sorted(sites)}")
    row["knn_fused"] = {k: fused[k] for k in (
        "dispatches", "wall_s", "device_s", "flops", "mfu", "mfu_padded", "verdict")}
    row["knn_fused"]["critical_path_verdict"] = cp_sites["knn.fused"]["verdict"]
    row["trace_device"] = {"device_kind": prof["device"]["device_kind"],
                           "peak_flops": prof["device"]["peak_flops"],
                           "peak_bandwidth": prof["device"]["peak_bandwidth"],
                           "mfu": prof["device"]["mfu"]}
    row["sites"] = {s: {"dispatches": v["dispatches"], "device_s": v["device_s"],
                        "mfu": v["mfu"], "verdict": v["verdict"]}
                    for s, v in sites.items()}
    if fused["verdict"] not in ("host-bound", "compute-bound", "bandwidth-bound") \
            or not fused["mfu"] > 0 or fused["verdict"] != cp_sites["knn.fused"]["verdict"]:
        fail(f"knn.fused: mfu {fused['mfu']}, verdict {fused['verdict']}")
    if prof["device"]["device_kind"] != torch.cuda.get_device_name(0):
        fail(f"the trace's peaks are not the card's: {prof['device']['device_kind']}")

    # -- the CLI ----------------------------------------------------------
    outs = {}
    for name, proc in clis.items():
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        outs[name] = (proc.returncode, out, err)
    row["cli_rc"] = {name: rc for name, (rc, _, _) in outs.items()}
    rc, out, err = outs["device_plan"]
    cli_doc = json.loads(out) if rc == 0 else {}
    row["cli_device_plan"] = {"verdict": cli_doc.get("verdict"),
                              "budget_bytes": cli_doc.get("hbm", {}).get("budget_bytes")}
    if rc != 0 or cli_doc["verdict"] != "device-clean" or cli_doc["hbm"]["budget_bytes"] != total:
        fail(f"--device-plan --json: rc {rc}, {row['cli_device_plan']}\n{err[-2000:]}")
    if outs["over_budget"][0] != 2:
        fail(f"--device-mutant over_budget: rc {outs['over_budget'][0]}")
    if outs["mesh"][0] != 0 or "no deadlock" not in outs["mesh"][1]:
        fail(f"--mesh: rc {outs['mesh'][0]}\n{outs['mesh'][2][-2000:]}")
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    if "jax" in sys.modules or any(m.startswith("pathway_tpu.") for m in sys.modules):
        fail("JAX or the JAX package was imported")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # the persisted phase runs this script again as its subprocess:
    # FOLDER STORE OUT N_FILES QUERIES.json
    ap.add_argument("--persisted-child", nargs=5, help=argparse.SUPPRESS)
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
    if args.persisted_child:
        folder, pdir, out, n_files, spec = args.persisted_child
        with open(spec) as f:
            queries = json.load(f)
        persisted_child(folder, pdir, out, int(n_files), queries)

    smi = phase_build(_build)
    kind = torch.cuda.get_device_name(0)
    # data-sheet peaks: bytes/s, FP32 FLOP/s outside the tensor cores,
    # dense TF32 FLOP/s on the tensor cores
    rates = peak_rates(kind)
    if rates is None:
        fail(f"no data-sheet peaks for {kind!r} in internals/device.py")
    kern = phase_kernels(fk, topk, rates, args.seed)
    ckpt = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"), "bge-small")
    written = write_checkpoint(ckpt, pt.EncoderConfig.bge_small(), args.seed + CKPT_SEED)
    main_launches, enc = phase_main(pt, fk, ckpt, written, args.seed)
    per_phase = [main_launches, phase_supervised(pt, fk, enc, args.seed)]
    del enc
    torch.cuda.empty_cache()
    sharded_launches, single = phase_sharded(pt, fk, args.seed)
    per_phase.append(sharded_launches)
    per_phase.append(phase_snapshot(pt, fk, single, args.seed))
    del single
    torch.cuda.empty_cache()
    per_phase.append(phase_ring(fk, args.seed))
    per_phase.append(phase_train(pt, fk, ckpt, written, args.seed))
    phase_spawn(ckpt, args.seed)  # the ranks search no index: no KNN launch
    per_phase.append(phase_persisted(args.seed))
    # a static program that pw.run finishes: before the dataflow phase,
    # whose pw.run serves until the process ends
    per_phase.append(phase_rerank(fk, args.seed))
    # last but one: its pw.run serves (and rescans its folder) until the
    # process ends; the doctor audits that running program
    df_launches, df_runtime = phase_dataflow(fk, args.seed)
    per_phase.append(df_launches)
    per_phase.append(phase_doctor(pt, fk, ckpt, args.seed, df_runtime))
    # the kernels line counts the launches of every path this run drove
    launches = {k: sum(p.get(k, 0) for p in per_phase) for k in fk.LAUNCHES}

    main_q = kern[(256, K)]
    main_d = kern[(256, K, "default")]
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
        # the partial kernel's one-pass TF32 instance (precision "default");
        # its yardstick is the library product in TF32
        {"name": "fused_knn_tf32", "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches["fused_knn_tf32"],
         "max_abs_err": main_d["fused_knn_tf32_max_abs_err"],
         "ms": main_d["fused_knn_tf32_ms"], "plain_ms": main_d["fused_knn_tf32_plain_ms"],
         "bound_ms": main_d["fused_knn_tf32_bound_ms"],
         "bound_by": main_d["fused_knn_tf32_bound_by"],
         "library_ms": main_d["library_tf32_ms"]},
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
