"""The generator: determinism from --seed, the same work for every seed,
the published means, and the reference tokenizer against the port's."""

import json
import os

import numpy as np
import pytest

from rag_bench import run, textgen
from rag_bench.reference.tokenizer import ReferenceTokenizer

M = run.manifest()


def _load(cell):
    files = run.cell_files(M, cell)
    with open(files["config"]) as f:
        cfg = json.load(f)
    with open(files["traffic"]) as f:
        tr = json.load(f)
    return cfg, tr, run.load_by_path(files["mode"], "t_mode_" + tr["mode"])


SEEDS = [3, 2**31 + 5, 2**33 + 1]


def test_serve_schedule_is_determined_by_the_seed():
    cfg, tr, serve = _load("msmarco-serve")
    a = serve.schedule(cfg, tr, SEEDS[1], 2.0)
    b = serve.schedule(cfg, tr, SEEDS[1], 2.0)
    c = serve.schedule(cfg, tr, SEEDS[2], 2.0)
    assert a[0] == b[0] and np.array_equal(a[1], b[1])
    # another seed: the same texts and gaps, in another order
    assert a[0] != c[0] and sorted(a[0]) == sorted(c[0])
    assert sorted(a[2]) == sorted(c[2])
    n, rate = len(a[0]), tr["rate_qps"]
    assert n == round(rate * 2.0)
    # every gap is one of the n stratified exponential quantiles
    q = np.sort(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    for offsets in (a[1], c[1]):
        gaps = np.diff(offsets)
        i = np.clip(np.searchsorted(q, gaps), 1, n - 1)
        nearest = np.minimum(np.abs(q[i] - gaps), np.abs(q[i - 1] - gaps))
        assert nearest.max() < 1e-9


def test_ingest_batches_are_determined_by_the_seed():
    cfg, tr, ingest = _load("nq-ingest")
    a = ingest.batch_texts(cfg, tr, SEEDS[0], 5)
    b = ingest.batch_texts(cfg, tr, SEEDS[0], 5)
    c = ingest.batch_texts(cfg, tr, SEEDS[1], 5)
    assert a[0] == b[0] and a[0] != c[0]
    assert sorted(a[0]) == sorted(c[0]) and sorted(a[1]) == sorted(c[1])
    warm = ingest.batch_texts(cfg, tr, SEEDS[0], -5)
    assert warm[0] != a[0]


@pytest.mark.parametrize("model,mean", [
    ({"dist": "shifted_poisson", "shift": 1, "mean": 5.96}, 5.96),
    ({"dist": "shifted_poisson", "shift": 1, "mean": 9.16}, 9.16),
    ({"dist": "cap_minus_exp", "cap": 100, "mean": 78.88, "min": 5}, 78.88),
])
def test_length_models_keep_the_published_means(model, mean):
    q = textgen.length_quantiles(model, 4096)
    assert abs(q.mean() - mean) < 0.02 * mean
    assert q.min() >= 1


def test_about_one_point_three_pieces_a_word():
    rng = textgen.seed_rng(11)
    words = np.full(400, 10)
    texts = textgen.lexicon().texts(rng, words, 0.3)
    tok = ReferenceTokenizer()
    pieces = sum(len(tok.ids(t)) - 2 for t in texts) / words.sum()
    assert 1.2 < pieces < 1.45


def test_poisson_offsets_have_the_rate():
    off = textgen.poisson_offsets(textgen.seed_rng(1), 200.0, 4000)
    assert off[0] == 0.0 and np.all(np.diff(off) > 0)
    assert abs(off[-1] - 20.0) < 0.5


def test_reference_tokenizer_matches_the_port():
    from pathway_tpu_torch.models.wordpiece import WordPieceTokenizer

    port = WordPieceTokenizer(os.path.join(run.ROOT, "pathway_tpu_torch", "models",
                                           "assets", "wordpiece_vocab.txt"))
    ref = ReferenceTokenizer()
    texts = textgen.lexicon().texts(textgen.seed_rng(5), np.arange(1, 60), 0.3)
    texts += ["Hello, World! It's a naïve café (test) 3.5 — ok?", "", "x" * 150]
    ids, mask = port(texts)
    rids, lengths = ref(texts)
    assert np.array_equal(mask.sum(1), lengths)
    for i, n in enumerate(lengths):
        assert np.array_equal(ids[i, :n], rids[i, :n])


def test_the_vocab_copy_is_the_ports_asset():
    with open(os.path.join(run.ROOT, "pathway_tpu_torch", "models", "assets",
                           "wordpiece_vocab.txt"), "rb") as f:
        port = f.read()
    with open(textgen.VOCAB, "rb") as f:
        assert f.read() == port


def test_a_request_that_never_comes_back_is_failed_at_the_close():
    import threading
    import time

    release = threading.Event()

    class Batcher:
        def query(self, text, timeout=None):
            if text == "stall":
                release.wait()
            return [(0, 1.0)]

    serve = _load("msmarco-serve")[2]
    texts = ["a", "stall", "b", "c"]
    offsets = np.array([0.0, 0.01, 0.02, 0.03])
    t0, lat, answers, failed, _, t_close = serve.drive(
        Batcher(), texts, offsets, clients=4, timeout_s=0.1, keep=[0, 1], grace_s=0.2)
    try:
        assert failed.tolist() == [False, True, False, False]
        assert np.all(np.isfinite(lat))
        assert lat[1] == t_close - (t0 + offsets[1]) and lat[1] >= 0.25
        assert max(lat[[0, 2, 3]]) < lat[1]
        assert set(answers) == {0}
        kept = lat.copy()
    finally:
        release.set()
    time.sleep(0.05)  # the stalled client returns after the close
    assert np.array_equal(lat, kept) and failed[1]
