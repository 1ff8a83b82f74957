"""Mode ``serve``: an open loop of single queries into the port's
``MicroBatcher(QueryEngine(encoder, shard))``, at a fixed Poisson rate.

Set-up: seeded weights and the encoder, the prefilled index, the engine
and the batcher with their defaults; every encoder bucket the traffic can
reach is captured (``warm.seq`` x ``warm.batch``), the search runs once
at each pow2 query count, the tokenizer's memo is warmed by a stream of
queries apart from the window's. The window: request i is due at
t0 + offsets[i] and handed to a pool of client threads, each calling the
public ``MicroBatcher.query``; its latency runs from when it was due to
when its answer came back, so a late generator or a full pool counts.

The check, once the window has closed and the program's state is freed:
a seeded sample of the answered requests, the longest queries in it,
against the plain reference (float32 encoder, exact top-k):
``score_rms``, the root mean square of the gaps between served scores and
the reference's scores of the same keys; ``rank_loss``, the mean by which
the reference's j-th best score exceeds the j-th best of the served keys'
scores; ``search_gap``, the search alone: the widest gap between a served
score and the float32 score of the program's own query embedding (tapped
over the window, ``SearchTap``) against its key's seeded row;
``malformed``, answers without k distinct keys of the corpus;
``unanswered``, requests that failed or never came back.
"""

from __future__ import annotations

import gc
import queue
import sys
import threading
import time

import numpy as np
import torch

from rag_bench import devtrace, program, textgen, weights
from rag_bench.probe import Probe
from rag_bench.reference import bert, knn as ref_knn
from rag_bench.reference.tokenizer import ReferenceTokenizer


def schedule(cfg: dict, tr: dict, seed: int, seconds: float):
    """(texts, due offsets in seconds, word counts) of the window's
    ``rate_qps * seconds`` requests. The texts are the cell's own, the
    same for every seed; the seed orders them and the arrival gaps."""
    n = max(1, int(round(tr["rate_qps"] * seconds)))
    words = textgen.length_quantiles(cfg["deployment"]["query_words"], n)
    texts = textgen.lexicon(tr["zipf_s"]).texts(textgen.seed_rng(0, 1), words,
                                                tr["glued_share"])
    rng = textgen.seed_rng(seed, 1)
    order = rng.permutation(n)
    return ([texts[i] for i in order], textgen.poisson_offsets(rng, tr["rate_qps"], n),
            words[order])


def warm_texts(cfg: dict, tr: dict, n: int) -> list[str]:
    """Queries apart from the window's, the same for every seed."""
    rng = textgen.seed_rng(0, 2)
    words = textgen.shuffled_lengths(rng, cfg["deployment"]["query_words"], n)
    return textgen.lexicon(tr["zipf_s"]).texts(rng, words, tr["glued_share"])


def warm_up(encoder, engine, batcher, cfg: dict, tr: dict, device) -> None:
    warm = tr["warm"]
    vocab = len(ReferenceTokenizer().vocab)
    g = np.random.default_rng(0)
    for Lb in warm["seq"]:
        for nb in warm["batch"]:
            ids = g.integers(5, vocab, size=(nb, Lb)).astype(np.int32)
            encoder.encode_tokens_device(ids, np.ones((nb, Lb), np.int32))
    texts = warm_texts(cfg, tr, tr["warm_queries"])
    encoder.tokenizer(texts)  # the tokenizer's memo, as a serving process has it
    q = 1
    while q <= max(warm["batch"]):
        engine.query(texts[:q])
        q *= 2

    def one(text):
        try:
            batcher.query(text, timeout=tr["timeout_s"])
        except Exception:  # noqa: BLE001 - a failure shows in the window
            pass

    threads = [threading.Thread(target=one, args=(t,)) for t in texts[:64]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    program.synchronize(device)


def drive(batcher, texts, offsets, clients: int, timeout_s: float, keep=(),
          grace_s: float = 60.0):
    """The open loop, from this thread and a pool of ``clients`` threads.
    Returns (t0, latency s, answers, failed flags, max lag s, close time).
    The answers are kept for the requests in ``keep`` alone, so the
    harness holds no more objects for the interpreter's collector to walk
    than a server would. A request that has not come back when the loop
    gives up, ``timeout_s`` + ``grace_s`` after the last was due, is
    failed, and its latency runs to that moment; the arrays are copied
    under the lock then, so a client that returns later writes nothing
    into them."""
    n = len(texts)
    lat = np.full(n, np.nan)
    keep = set(int(i) for i in keep)
    answers: dict = {}
    failed = np.zeros(n, bool)
    work: queue.SimpleQueue = queue.SimpleQueue()
    left = [n]
    closed = [False]
    all_done = threading.Event()
    lock = threading.Lock()

    def client():
        while True:
            item = work.get()
            if item is None:
                return
            i, due = item
            got, bad = None, False
            try:
                got = batcher.query(texts[i], timeout=timeout_s)
            except Exception:  # noqa: BLE001 - a failed request counts as missing
                bad = True
            t = time.perf_counter()
            with lock:
                if closed[0]:
                    return
                lat[i] = t - due
                failed[i] = bad
                if i in keep and not bad:
                    answers[i] = got
                left[0] -= 1
                if not left[0]:
                    all_done.set()

    pool = [threading.Thread(target=client, name=f"rag-bench-client-{j}", daemon=True)
            for j in range(clients)]
    for t in pool:
        t.start()
    t0 = time.perf_counter() + 0.01
    lag = 0.0
    for i in range(n):
        due = t0 + offsets[i]
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        lag = max(lag, time.perf_counter() - due)
        work.put((i, due))
    all_done.wait(timeout=timeout_s + grace_s)
    with lock:
        closed[0] = True
        t_close = time.perf_counter()
        lat, failed, answers = lat.copy(), failed.copy(), dict(answers)
    missing = np.isnan(lat)
    failed |= missing
    lat[missing] = t_close - (t0 + np.asarray(offsets)[missing])
    for _ in pool:
        work.put(None)
    # a client still inside ``query`` ends with its timeout: wait for
    # none of them past one shared deadline
    deadline = time.perf_counter() + 5.0
    for t in pool:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    return t0, lat, answers, failed, lag, t_close


def sample(n: int, words: np.ndarray, seed: int, size: int, longest: int) -> np.ndarray:
    rng = textgen.seed_rng(seed, 7)
    pick = set(rng.choice(n, size=min(size, n), replace=False).tolist())
    pick.update(np.argsort(-words, kind="stable")[:longest].tolist())
    return np.array(sorted(pick))


def _served(answer_lists, rows: int, k: int):
    """(keys [m, k], scores [m, k], well-formed [m], malformed count) of
    ``m`` answers; an answer without k distinct keys of the corpus is
    malformed and its row left NaN."""
    answer_lists = list(answer_lists)
    keys = torch.zeros((len(answer_lists), k), dtype=torch.int64)
    served = torch.full((len(answer_lists), k), float("nan"))
    malformed = 0
    for r, hits in enumerate(answer_lists):
        hits = hits or []
        ks = [h[0] for h in hits]
        if (len(hits) != k or len(set(ks)) != k
                or not all(isinstance(x, int) and 0 <= x < rows for x in ks)):
            malformed += 1
            continue
        keys[r] = torch.tensor(ks)
        served[r] = torch.tensor([float(h[1]) for h in hits])
    return keys, served, ~torch.isnan(served[:, 0]), malformed


def judge(answers, idx, q_ref, seed: int, rows: int, k: int, taps=()) -> dict:
    """The readings of the answers at ``idx`` against the reference over
    the seeded corpus (``q_ref``: the reference's query embeddings of
    those requests, in order). Per served hit, its score's gap to the
    reference's score of its key; per rank j, the reference's j-th best
    score less the j-th best of the served keys' reference scores:
    ``score_rms`` and ``rank_loss`` are their root mean square and mean;
    ``score_gap`` and ``rank_gap`` their widest, printed only (see
    ``PERF.md``: the widest does not separate the program from its
    control by three times). Those hold the encoder and the search
    together. ``search_gap`` holds the search alone: over ``taps``, pairs
    of the query embedding the search was given and the answer it
    served, the widest gap between a served score and the float32 score
    (TF32 off) of that embedding against its key's seeded row.
    ``malformed`` counts answers, sampled or tapped, without k distinct
    keys of the corpus."""
    keys, served, ok, malformed = _served((answers.get(i) for i in idx), rows, k)
    taps = list(taps)
    t_keys, t_served, t_ok, t_bad = _served((h for _, h in taps), rows, k)
    malformed += t_bad
    inf = float("inf")
    got = {"score_rms": inf, "rank_loss": inf, "search_gap": inf,
           "score_gap": inf, "rank_gap": inf, "malformed": malformed}
    if not bool(ok.any()):
        return got
    dev = q_ref.device
    q = [q_ref[ok.to(dev)].float()]
    m = int(ok.sum())
    if bool(t_ok.any()):
        emb = torch.stack([e for (e, _), good in zip(taps, t_ok.tolist()) if good])
        q.append(emb.to(dev).float())
    # one pass over the corpus for both: the top-k rows of the tapped
    # embeddings are not read
    best, _, at = ref_knn.search(torch.cat(q), seed, rows, k,
                                 keys=torch.cat([keys[ok], t_keys[t_ok]]).to(dev))
    at, best = at.cpu(), best[:m].cpu()
    diff = (served[ok] - at[:m]).double()
    lost = (best - torch.sort(at[:m], dim=1, descending=True).values).double()
    got.update(score_rms=float(diff.pow(2).mean().sqrt()), rank_loss=float(lost.mean()),
               score_gap=float(diff.abs().max()), rank_gap=float(lost.max()))
    if len(q) > 1:
        got["search_gap"] = float((t_served[t_ok] - at[m:]).double().abs().max())
    return got


class SearchTap:
    """The query embeddings the search was given, and the answers it
    served, for the queries whose text is in ``texts`` (at most ``limit``
    of them): a float32 copy of the encoder's output row, taken on the
    stream between the forward and the search that reads it, beside the
    hits ``QueryEngine.finish`` returned for it. Installed on the engine and
    its encoder over the window: a set lookup a query, and one row copy
    for a batch that holds such a query. It also notes each batch's size,
    for the timeline of the window printed on standard error."""

    def __init__(self, engine, texts, limit: int):
        self.want = set(texts)
        self.limit = limit
        self.rows: list[tuple[torch.Tensor, list]] = []
        self.batches: list[tuple[float, int]] = []  # (when, queries) a dispatch
        self._pending: dict[int, tuple[list[int], torch.Tensor]] = {}
        self._local = threading.local()
        self._lock = threading.Lock()
        enc = engine.encoder
        encode, dispatch, finish = enc.encode_tokens_device, engine.dispatch, engine.finish

        def tapped_encode(ids, mask):
            emb = encode(ids, mask)
            rows = getattr(self._local, "rows", None)
            if rows:
                self._local.emb = emb[[r for r in rows if r < emb.shape[0]]].float()
            return emb

        def tapped_dispatch(texts):
            self.batches.append((time.perf_counter(), len(texts)))
            with self._lock:
                room = len(self.rows) + len(self._pending) < self.limit
            rows = [j for j, t in enumerate(texts) if t in self.want] if room else []
            self._local.rows, self._local.emb = rows, None
            try:
                ticket = dispatch(texts)
            finally:
                self._local.rows = None
            if rows and self._local.emb is not None:
                with self._lock:
                    self._pending[id(ticket)] = (rows, self._local.emb)
            return ticket

        def tapped_finish(ticket):
            out = finish(ticket)
            with self._lock:
                rows, emb = self._pending.pop(id(ticket), ((), None))
                for e, r in zip(emb if emb is not None else (), rows):
                    if r < len(out):
                        self.rows.append((e, out[r]))
            return out

        enc.encode_tokens_device = tapped_encode
        engine.dispatch, engine.finish = tapped_dispatch, tapped_finish

        def undo():
            del enc.encode_tokens_device, engine.dispatch, engine.finish

        self.close = undo


def build(cfg: dict, tr: dict, seed: int, dev):
    """(params, encoder, shard, engine, batcher), warmed up."""
    from pathway_tpu_torch.ops.query_engine import MicroBatcher, QueryEngine

    params = weights.state_dict(cfg, seed, dev)
    encoder = program.encoder(cfg, params, dev)
    shard = program.prefilled_shard(cfg, seed, dev)
    engine = QueryEngine(encoder, shard, k=cfg["deployment"]["k"], device=dev)
    batcher = MicroBatcher(engine)
    warm_up(encoder, engine, batcher, cfg, tr, dev)
    return params, encoder, shard, engine, batcher


def run(ctx) -> dict:
    cfg, tr, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    dep = cfg["deployment"]
    texts, offsets, words = schedule(cfg, tr, seed, ctx.seconds)
    params, encoder, shard, engine, batcher = build(cfg, tr, seed, dev)
    if ctx.trace:
        devtrace.Profile.warm_up(dev)
    gc.collect()  # the window starts from one state of the collector
    setup_s = time.perf_counter() - ctx.t_start

    n = len(texts)
    idx = sample(n, words, seed, tr["check"]["sample"], tr["check"]["longest"])
    tap = SearchTap(engine, [texts[i] for i in idx], tr["check"]["tap_limit"])
    probe = prof = None
    if ctx.trace:
        probe = Probe(cfg)
        probe.wrap_tokenizer(encoder)
        probe.wrap_engine(engine)
        probe.arm()
        prof = devtrace.Profile()
    pauses = GcPauses()
    t0, lat, answers, failed, lag, _ = drive(batcher, texts, offsets, tr["clients"],
                                             tr["timeout_s"], keep=idx)
    pauses.close()
    t_end = time.perf_counter()
    if prof is not None:
        prof.stop()
    window_s = t_end - t0
    batcher.close()
    program.synchronize(dev)
    if probe is not None:
        probe.close()
        probe.window_s = window_s
        probe.profile = prof.read(probe.spans) or probe.event_profile()
        probe.live_rows = len(shard)
    tap.close()
    memory_peak = program.peak_bytes(dev)
    live_rows = len(shard)
    taps = [(e.cpu(), h) for e, h in tap.rows]
    batches = tap.batches
    del batcher, engine, shard, encoder, tap
    program.free(dev)

    q_ref = bert.encode_texts(params, cfg["num_attention_heads"], ReferenceTokenizer(),
                              [texts[i] for i in idx], dev)
    got = judge(answers, idx, q_ref, seed, dep["rows"], dep["k"], taps)
    checks = {name: (got[name], lim) for name, lim in tr["check"]["limits"].items()}
    checks["malformed"] = (got["malformed"], 0)
    checks["unanswered"] = (int(failed.sum()), 0)
    print(f"rag_bench: widest gaps, not compared: score {got['score_gap']!r}, "
          f"rank {got['rank_gap']!r}; {len(taps)} tapped answers", file=sys.stderr)
    out = {
        "attempted": n,
        "failed": int(failed.sum()),
        "memory_peak_bytes": memory_peak,
        "metrics": {
            "retrieve_p50_ms": float(np.percentile(lat, 50) * 1e3),
            "retrieve_p95_ms": float(np.percentile(lat, 95) * 1e3),
            "setup_s": setup_s,
        },
        "checks": checks,
        "probe": probe,
    }
    print(f"rag_bench: {n} requests over {window_s:.3f} s, generator lag at most "
          f"{lag * 1e3:.3f} ms, {live_rows} live rows, sample {len(idx)}",
          file=sys.stderr)
    p95s, sizes = timeline(offsets, lat, batches, t0)
    print(f"rag_bench: p95 ms by second of the window {p95s}; queries a batch by "
          f"second {sizes}; {pauses}", file=sys.stderr)
    if probe is not None:
        print(f"rag_bench: new buckets in the window {probe.recompiles}", file=sys.stderr)
    return out


def timeline(offsets, lat, batches, t0: float):
    """By second of the window: the 95th percentile of latency, in ms, of
    the requests due in it, and the mean queries a batch dispatched in
    it: where a slow run's tail comes from."""
    sec = np.asarray(offsets).astype(int)
    p95s = [round(float(np.percentile(lat[sec == s], 95) * 1e3), 1)
            for s in range(int(sec.max()) + 1) if np.any(sec == s)]
    when = np.array([t for t, _ in batches]) - t0
    size = np.array([q for _, q in batches], float)
    sizes = [round(float(size[(when >= s) & (when < s + 1)].mean()), 1)
             for s in range(int(sec.max()) + 1) if np.any((when >= s) & (when < s + 1))]
    return p95s, sizes


class GcPauses:
    """The interpreter's collections over the window: how many, of each
    generation, and the longest pause. Printed beside the timeline."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.longest = [0.0, 0.0, 0.0]
        self._t = 0.0
        gc.callbacks.append(self._note)

    def _note(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.count[g] += 1
            self.longest[g] = max(self.longest[g], time.perf_counter() - self._t)

    def close(self) -> None:
        gc.callbacks.remove(self._note)

    def __str__(self) -> str:
        return "collections by generation " + ", ".join(
            f"{c} (longest {t * 1e3:.1f} ms)" for c, t in zip(self.count, self.longest))
