"""The rerank path through both packages, on the CPU.

The dataflow that upstream Pathway documents for
``pw.xpacks.llm.rerankers``: ``VectorStoreServer.retrieve_query`` at k = 4,
``flatten`` of the candidates, a score per (query, document) pair from
``CrossEncoderReranker``, ``groupby(query).reduce`` of the documents and
scores into tuples, and ``rerank_topk_filter(docs, scores, 2)``. It runs
through ``pathway_tpu`` and ``pathway_tpu_torch`` in this process with
``DeterministicMockEmbedder`` and one seeded Flax cross-encoder, carried
across with ``flax_cross_params_to_torch``, at f32; the port's index and
cross-encoder are asked for the CPU (``device="cpu"``). Both must keep the
same documents, score them within atol 1e-5 (f32 in another summation
order), and hand the reranker the same batches.

Then the cross-encoder at bge-small's widths (hidden 384, 12 heads, MLP
1536, its vocabulary and WordPiece tokenizer) with 2 layers and
``max_len`` 128, against the Flax model: atol 1e-5 at f32, and a cosine
of at least 0.999 between the two score vectors at bf16 (the bar
tests/test_hf_parity.py holds the bf16 encoder to).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.internals.parse_graph import G as JAX_G
from pathway_tpu.models import cross_encoder as jce
from pathway_tpu.models import encoder as jenc
from pathway_tpu_torch.internals.parse_graph import G as PORT_G
from pathway_tpu_torch.models import convert
from pathway_tpu_torch.models import cross_encoder as tce
from pathway_tpu_torch.models import encoder as tenc

TOL = 1e-5
COSINE_MIN = 0.999
K = 4
KEEP = 2
TINY = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp=128, max_len=64)
# bge-small's widths and vocabulary, two of its twelve layers
BGE_WIDTH = dict(vocab_size=30522, hidden=384, layers=2, heads=12, mlp=1536, max_len=128)
CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "pack my box with five dozen liquor jugs",
    "sphinx of black quartz judge my vow",
    "how vexingly quick daft zebras jump",
    "streaming dataflow with retractions and incremental updates",
    "a vector index answers nearest neighbour queries",
    "rerankers score each query and passage pair together",
    "the engine batches rows before it calls a function",
]
QUESTIONS = ["quick zebras", "nearest neighbour index", "liquor box", "score each pair"]


@pytest.fixture(autouse=True)
def _clear_graphs():
    JAX_G.clear()
    PORT_G.clear()
    yield
    JAX_G.clear()
    PORT_G.clear()


def _mod(pw, name):
    return importlib.import_module(f"{pw.__name__}.{name}")


def _plain(v):
    if type(v).__name__ == "Json":
        return _plain(v.value)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _cross_encoders(widths: dict, jax_dtype, torch_dtype, seed: int = 3):
    """One seeded Flax cross-encoder and the port's, with its weights."""
    jcfg = dataclasses.replace(jenc.EncoderConfig(**widths), dtype=jax_dtype)
    tcfg = dataclasses.replace(tenc.EncoderConfig(**widths), dtype=torch_dtype)
    jx = jce.CrossEncoder(jcfg, seed=seed)
    params = jax.tree_util.tree_map(np.asarray, jx.params)
    tx = tce.CrossEncoder(
        tcfg, params=convert.flax_cross_params_to_torch(params, tcfg), device="cpu"
    )
    return jx, tx


def _rerank(pw, cross_encoder):
    """retrieve (k = 4) -> flatten -> CrossEncoderReranker -> groupby
    -> rerank_topk_filter(..., 2); the first insertion per query."""
    mocks = _mod(pw, "xpacks.llm.mocks")
    rerankers = _mod(pw, "xpacks.llm.rerankers")
    vector_store = _mod(pw, "xpacks.llm.vector_store")
    md = "data | path\n" + "".join(f"{d} | doc{i}.txt\n" for i, d in enumerate(CORPUS))
    docs = pw.debug.table_from_markdown(md).select(
        data=pw.this.data,
        _metadata=pw.apply_with_type(lambda p: pw.Json({"path": p}), pw.Json, pw.this.path),
    )
    index_params = {"device": "cpu"} if pw is pathway_tpu_torch else {}
    store = vector_store.VectorStoreServer(
        docs, embedder=mocks.DeterministicMockEmbedder(dimension=16),
        index_params=index_params,
    )
    queries = pw.debug.table_from_markdown(
        "query | k\n" + "".join(f"{q} | {K}\n" for q in QUESTIONS),
        schema=store.RetrieveQuerySchema,
    )
    candidates = queries.select(query=pw.this.query, docs=store.retrieve_query(queries).result)
    pairs = candidates.flatten(pw.this.docs)
    reranker = rerankers.CrossEncoderReranker(cross_encoder=cross_encoder)
    scored = pairs.with_columns(score=reranker(pw.this.docs, pw.this.query))
    grouped = scored.groupby(pw.this.query).reduce(
        pw.this.query,
        docs=pw.reducers.tuple(pw.this.docs),
        scores=pw.reducers.tuple(pw.this.score),
    )
    kept = grouped.select(
        pw.this.query, kept=rerankers.rerank_topk_filter(pw.this.docs, pw.this.scores, KEEP)
    )
    captures = _mod(pw, "internals.graph_runner").GraphRunner().run_tables(kept)
    seen, out = set(), {}
    for key, row, _, diff in captures[0].updates:
        if diff > 0 and key not in seen:
            seen.add(key)
            query, (kept_docs, kept_scores) = row
            out[query] = ([_plain(d) for d in kept_docs], list(kept_scores))
    return out


def _batches(cross_encoder) -> list[int]:
    """Record the size of every batch the reranker hands the model."""
    sizes: list[int] = []
    score = cross_encoder.score

    def recording(pairs):
        sizes.append(len(pairs))
        return score(pairs)

    cross_encoder.score = recording
    return sizes


def test_rerank_dataflow_keeps_the_jax_packages_documents():
    jx, tx = _cross_encoders(TINY, jnp.float32, torch.float32)
    want_batches, got_batches = _batches(jx), _batches(tx)
    want = _rerank(pathway_tpu, jx)
    got = _rerank(pathway_tpu_torch, tx)
    assert sorted(want) == sorted(QUESTIONS)
    assert sorted(got) == sorted(want)
    for query, (want_docs, want_scores) in want.items():
        got_docs, got_scores = got[query]
        assert len(want_docs) == KEEP
        assert [d["text"] for d in got_docs] == [d["text"] for d in want_docs], query
        assert [d["metadata"] for d in got_docs] == [d["metadata"] for d in want_docs]
        np.testing.assert_allclose([d["dist"] for d in got_docs],
                                   [d["dist"] for d in want_docs], atol=TOL, rtol=0)
        np.testing.assert_allclose(got_scores, want_scores, atol=TOL, rtol=0)
        assert want_scores[0] >= want_scores[1]
    # the engine hands the batched UDF the same batches in both packages
    assert got_batches == want_batches
    assert sum(want_batches) >= len(QUESTIONS) * K


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_bge_small_width_cross_encoder_matches_flax(precision):
    dtypes = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
    jx, tx = _cross_encoders(BGE_WIDTH, *dtypes[precision])
    pairs = [(q, d) for q in QUESTIONS for d in CORPUS]
    want = np.asarray(jx.score(pairs), np.float64)
    got = np.asarray(tx.score(pairs), np.float64)
    assert got.shape == want.shape == (len(pairs),)
    assert np.std(want) > 0  # the pairs score apart
    if precision == "f32":
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    else:
        cosine = float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want)))
        assert cosine >= COSINE_MIN, cosine
