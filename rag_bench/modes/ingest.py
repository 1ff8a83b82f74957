"""Mode ``ingest``: a closed loop of the port's ``IngestPipeline.run`` over
generated passages, in arrival order, into the prefilled index.

Set-up: seeded weights and the encoder, the prefilled index, the
pipeline with its defaults; every (batch, seq) bucket the traffic can
reach (``warm.seq``) is captured by ingesting one batch whose longest
passage fills it, under warm-up keys that stay in the index; the
tokenizer's memo is warmed by passages apart from the window's. The
window: batch b holds the cell's ``batch`` passages of batch b in the
seed's order, keyed after the corpus; the batches are pulled until ``--seconds`` have
passed, and the rate counts the rows ``run`` returns, once the device has
written them, over the time until it returned.

The check: ``map_faults``, window keys missing from the key map, mapped
to a slot that maps back to another key or shares a slot, or marked
invalid, and sampled corpus rows whose key no longer reads its row;
``row_gap``, the largest L2 distance between a sampled passage's row,
read back by its key, and the reference's embedding of its text (float32
encoder), the longest passages in the sample; ``prefill_gap``, the
largest element gap between a sampled corpus row read back by its key
and the row made again from the seed.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from rag_bench import corpus, devtrace, program, textgen, weights
from rag_bench.probe import Probe
from rag_bench.reference import bert
from rag_bench.reference.tokenizer import ReferenceTokenizer


def batch_texts(cfg: dict, tr: dict, seed: int, b: int) -> tuple[list[str], np.ndarray]:
    """Passages of batch ``b`` of the window (b >= 0) or of the warm-up
    stream (b < 0), and their word counts. A batch's passages are the
    cell's own, the same for every seed; the seed orders them."""
    rng = textgen.seed_rng(0, 3, b & (2**32 - 1), int(b < 0))
    words = textgen.shuffled_lengths(rng, cfg["deployment"]["passage_words"], tr["batch"])
    texts = textgen.lexicon(tr["zipf_s"]).texts(rng, words, tr["glued_share"])
    order = textgen.seed_rng(seed, 3, b & (2**32 - 1)).permutation(tr["batch"])
    return [texts[i] for i in order], words[order]


def sample(cfg: dict, tr: dict, seed: int, n_batches: int):
    """(sorted window positions, position -> text) of the check's seeded
    sample of the first ``n_batches`` batches, with the longest passages
    of the batches it draws from."""
    B = tr["batch"]
    rng = textgen.seed_rng(seed, 8)
    pick = rng.choice(n_batches * B, size=min(tr["check"]["sample"], n_batches * B),
                      replace=False)
    words_of, texts_of = {}, {}
    for b in sorted({int(p) // B for p in pick}):
        t, w = batch_texts(cfg, tr, seed, b)
        for j in range(B):
            texts_of[b * B + j], words_of[b * B + j] = t[j], w[j]
    longest = sorted(words_of, key=lambda p: (-words_of[p], p))[:tr["check"]["longest"]]
    return sorted(set(pick.tolist()) | set(longest)), texts_of


def warm_up(pipe, encoder, cfg: dict, tr: dict, seed: int, device) -> int:
    """Capture each warm bucket; returns the warm-up keys' count."""
    lex = textgen.lexicon(tr["zipf_s"])
    rng = np.random.default_rng(0)
    nkeys = 0
    for Lb in tr["warm"]["seq"]:
        # one passage of Lb - 2 single-piece words: the batch pads to Lb
        texts = [" ".join(lex.whole[:Lb - 2])]
        texts += [" ".join(rng.choice(lex.whole, 8)) for _ in range(tr["batch"] - 1)]
        pipe.ingest([-(nkeys + j + 1) for j in range(len(texts))], texts)
        nkeys += len(texts)
    for b in range(1, tr["warm_batches"] + 1):
        encoder.tokenizer(batch_texts(cfg, tr, seed, -b)[0])
    program.synchronize(device)
    return nkeys


def run(ctx) -> dict:
    cfg, tr, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    dep = cfg["deployment"]
    from pathway_tpu_torch.ops.ingest import IngestPipeline

    params = weights.state_dict(cfg, seed, dev)
    encoder = program.encoder(cfg, params, dev)
    shard = program.prefilled_shard(cfg, seed, dev)
    pipe = IngestPipeline(encoder, shard, device=dev)
    warm_up(pipe, encoder, cfg, tr, seed, dev)
    if ctx.trace:
        devtrace.Profile.warm_up(dev)
    gc.collect()  # the window starts from one state of the collector
    setup_s = time.perf_counter() - ctx.t_start

    probe = prof = None
    if ctx.trace:
        probe = Probe(cfg)
        probe.wrap_tokenizer(encoder)
        probe.arm()
    base, B = dep["rows"], tr["batch"]
    fed = [0]

    def batches():
        b = 0
        while time.perf_counter() < deadline:
            if probe is not None:
                with probe.span("rag_bench: passage generator"):
                    texts, _ = batch_texts(cfg, tr, seed, b)
            else:
                texts, _ = batch_texts(cfg, tr, seed, b)
            fed[0] = b + 1
            yield range(base + b * B, base + (b + 1) * B), texts
            b += 1

    if probe is not None:
        prof = devtrace.Profile()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    rows = pipe.run(batches())
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    if probe is not None:
        probe.close()
        probe.window_s = window_s
        probe.profile = prof.read(probe.spans) or probe.event_profile()
    memory_peak = program.peak_bytes(dev)
    n_batches = fed[0]

    # the key map over every window key, and sampled rows read back by key
    keys = list(range(base, base + n_batches * B))
    slots = [shard.key_to_slot.get(k) for k in keys]
    faults = sum(s is None for s in slots)
    found = [(k, s) for k, s in zip(keys, slots) if s is not None]
    faults += sum(shard.slot_to_key.get(s) != k for k, s in found)
    faults += len(found) - len({s for _, s in found})
    if found:
        ok = shard.valid[torch.tensor([s for _, s in found], device=dev)]
        faults += int((~ok).sum())
    pick, texts_of = sample(cfg, tr, seed, n_batches)
    got = torch.stack([
        shard.vectors[shard.key_to_slot[base + p]] if (base + p) in shard.key_to_slot
        else torch.full((cfg["hidden_size"],), float("nan"), device=dev)
        for p in pick]).cpu()
    prefill_keys = textgen.seed_rng(seed, 9).choice(dep["rows"], tr["check"]["prefill_sample"],
                                                    replace=False)
    prefill_keys.sort()
    pre_slots = [shard.key_to_slot.get(int(k)) for k in prefill_keys]
    faults += sum(s is None or shard.slot_to_key.get(s) != int(k)
                  for k, s in zip(prefill_keys, pre_slots))
    pre_got = torch.stack([
        shard.vectors[s] if s is not None
        else torch.full((cfg["hidden_size"],), float("nan"), device=dev)
        for s in pre_slots]).cpu()
    del pipe, shard, encoder
    program.free(dev)

    prefill_gap = 0.0
    d = cfg["hidden_size"]
    for c in corpus.blocks(dep["rows"]):
        lo = c * corpus.BLOCK
        inside = (prefill_keys >= lo) & (prefill_keys < lo + corpus.BLOCK)
        if inside.any():
            want = corpus.rows(seed, c, dep["rows"], d, dev)[
                torch.from_numpy(prefill_keys[inside] - lo).to(dev)].cpu()
            gap = (pre_got[torch.from_numpy(inside)] - want).abs().max()
            prefill_gap = max(prefill_gap, float(torch.nan_to_num(gap, nan=float("inf"))))
    ref = bert.encode_texts(params, cfg["num_attention_heads"], ReferenceTokenizer(),
                            [texts_of[p] for p in pick], dev).cpu()
    row_gap = float(torch.nan_to_num((got - ref).norm(dim=1), nan=float("inf")).max())
    lim = tr["check"]["limits"]
    print(f"rag_bench: {rows} rows in {n_batches} batches over {window_s:.3f} s, "
          f"sample {len(pick)}, prefill sample {len(prefill_keys)}", file=sys.stderr)
    if probe is not None:
        print(f"rag_bench: new buckets in the window {probe.recompiles}", file=sys.stderr)
    return {
        "attempted": n_batches * B,
        "failed": n_batches * B - rows,
        "memory_peak_bytes": memory_peak,
        "metrics": {"ingest_docs_per_s": rows / window_s, "setup_s": setup_s},
        "checks": {
            "map_faults": (faults, 0),
            "row_gap": (row_gap, lim["row_gap"]),
            "prefill_gap": (prefill_gap, lim["prefill_gap"]),
        },
        "probe": probe,
    }
