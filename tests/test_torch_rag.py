"""The port's RAG slice against the JAX package, on the CPU.

The scenarios of tests/test_vector_store.py, tests/test_rag.py and
tests/test_rag_server.py run through ``pathway_tpu`` and
``pathway_tpu_torch`` in this process with ``DeterministicMockEmbedder``
and must give the same documents and answers; distances agree to 1e-5
(both packages score in f32, in another summation order). The port's KNN
index is asked for the CPU (``device="cpu"``). Then the device models: the
seeded tiny encoder at f32 behind ``SentenceTransformerEmbedder``, carried
across with ``flax_params_to_torch``, gives the same ids and scores
within 1e-5 through ``DataIndex.query_as_of_now``; the cross-encoder's
scores agree with the Flax ``CrossEncoderModel`` to atol 1e-5 at f32.
"""

import dataclasses
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.internals.parse_graph import G as JAX_G
from pathway_tpu_torch.internals.parse_graph import G as PORT_G

TOL = 1e-5


@pytest.fixture(autouse=True)
def _clear_port_graph():
    PORT_G.clear()
    yield
    PORT_G.clear()


def _is_port(pw) -> bool:
    return pw is pathway_tpu_torch


def _cpu(pw) -> dict:
    """The port's index runs on the card by default: ask for the CPU."""
    return {"device": "cpu"} if _is_port(pw) else {}


def _mod(pw, name):
    import importlib

    return importlib.import_module(f"{pw.__name__}.{name}")


def _plain(v):
    """Json -> plain Python, so results of the two packages compare."""
    if hasattr(v, "value") and type(v).__name__ == "Json":
        return _plain(v.value)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _assert_same(got, want, path="result"):
    """Equal structure and values; floats within TOL."""
    if isinstance(want, float) or isinstance(got, float):
        assert abs(float(got) - float(want)) <= TOL, (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got, want)
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def _answered(pw, table):
    """First insertion per key (the serving semantics of the reference
    tests)."""
    captures = _mod(pw, "internals.graph_runner").GraphRunner().run_tables(table)
    seen, out = set(), []
    for key, row, _, d in captures[0].updates:
        if d > 0 and key not in seen:
            seen.add(key)
            out.append(_plain(list(row)))
    return out


def _rows(pw, table):
    captures = _mod(pw, "internals.graph_runner").GraphRunner().run_tables(table)
    return sorted((_plain(list(r)) for r in captures[0].state.rows.values()), key=repr)


def _docs_source(pw, rows=(("the cat sat on the mat", "a.txt"),
                           ("dogs are loyal friendly pets", "b.txt"))):
    md = "data | meta\n" + "".join(f"{d} | {m}\n" for d, m in rows)
    return pw.debug.table_from_markdown(md).select(
        data=pw.this.data,
        _metadata=pw.apply_with_type(
            lambda p: pw.Json({"path": p, "modified_at": 1, "seen_at": 2}),
            pw.Json,
            pw.this.meta,
        ),
    )


RAG_DOCS = (("pathway is a streaming framework", "a.txt"),
            ("the cat sat on the mat", "b.txt"))


def _server(pw, dimension=12, docs=None, **kwargs):
    mocks = _mod(pw, "xpacks.llm.mocks")
    vs = _mod(pw, "xpacks.llm.vector_store")
    return vs.VectorStoreServer(
        docs if docs is not None else _docs_source(pw),
        embedder=mocks.DeterministicMockEmbedder(dimension=dimension),
        index_params=_cpu(pw),
        **kwargs,
    )


# -- tests/test_vector_store.py ----------------------------------------------

def vs_retrieve(pw):
    server = _server(pw)
    queries = pw.debug.table_from_markdown(
        """
        query | k
        the cat sat on the mat | 2
        """,
        schema=server.RetrieveQuerySchema,
    )
    return _answered(pw, server.retrieve_query(queries))


def vs_statistics(pw):
    server = _server(pw)
    queries = pw.debug.table_from_markdown(
        """
        dummy
        1
        """
    ).select()
    return _rows(pw, server.statistics_query(queries))


def vs_inputs_glob(pw):
    server = _server(pw)
    queries = pw.debug.table_from_markdown(
        """
        q
        1
        """
    ).select(
        metadata_filter=pw.apply_with_type(lambda q: None, str, pw.this.q),
        filepath_globpattern=pw.apply_with_type(lambda q: "a*", str, pw.this.q),
    )
    return _rows(pw, server.inputs_query(queries))


def vs_metadata_filter(pw):
    server = _server(pw)
    queries = pw.debug.table_from_markdown(
        """
        query | k
        pets | 5
        """,
        schema=server.RetrieveQuerySchema,
    ).with_columns(filepath_globpattern="b*")
    return _answered(pw, server.retrieve_query(queries))


def vs_splitter(pw):
    splitters = _mod(pw, "xpacks.llm.splitters")
    splitter = splitters.TokenCountSplitter(min_tokens=2, max_tokens=4)
    server = _server(pw, dimension=8, splitter=splitter.func)
    return _rows(pw, server._graph["chunked_docs"].select(pw.this.text))


# -- tests/test_rag.py -------------------------------------------------------

def _answerer(pw, cls_name="BaseRAGQuestionAnswerer", dimension=12, **kwargs):
    qa = _mod(pw, "xpacks.llm.question_answering")
    mocks = _mod(pw, "xpacks.llm.mocks")
    server = _server(pw, dimension=dimension, docs=_docs_source(pw, RAG_DOCS))
    return getattr(qa, cls_name)(llm=mocks.IdentityMockChat(), indexer=server, **kwargs)


def rag_answer(pw):
    rag = _answerer(pw, search_topk=1)
    queries = pw.debug.table_from_markdown(
        """
        prompt
        the cat sat on the mat
        """,
        schema=rag.AnswerQuerySchema,
    )
    return _answered(pw, rag.answer_query(queries))


def rag_summarize(pw):
    rag = _answerer(pw)
    queries = pw.debug.table_from_markdown(
        """
        q
        1
        """
    ).select(
        text_list=pw.apply_with_type(
            lambda q: pw.Json(["text one", "text two"]), pw.Json, pw.this.q
        )
    )
    return _answered(pw, rag.summarize_query(queries))


def rag_adaptive(pw):
    rag = _answerer(
        pw, "AdaptiveRAGQuestionAnswerer",
        n_starting_documents=1, factor=2, max_iterations=2,
    )
    queries = pw.debug.table_from_markdown(
        """
        prompt
        pathway is a streaming framework
        """,
        schema=rag.AnswerQuerySchema,
    )
    return _answered(pw, rag.answer_query(queries))


def _store_retrieve(pw, factory):
    ds = _mod(pw, "xpacks.llm.document_store")
    store = ds.DocumentStore(_docs_source(pw, RAG_DOCS), retriever_factory=factory)
    queries = pw.debug.table_from_markdown(
        """
        query | k
        streaming framework | 2
        """,
        schema=ds.DocumentStore.RetrieveQuerySchema,
    )
    return _answered(pw, store.retrieve_query(queries))


def store_bm25(pw):
    return _store_retrieve(pw, pw.indexing.TantivyBM25Factory())


def store_knn(pw):
    mocks = _mod(pw, "xpacks.llm.mocks")
    factory = pw.indexing.BruteForceKnnFactory(
        embedder=mocks.DeterministicMockEmbedder(dimension=12),
        dimensions=12, **_cpu(pw),
    )
    return _store_retrieve(pw, factory)


SCENARIOS = {
    "vector_store_retrieve": vs_retrieve,
    "vector_store_statistics": vs_statistics,
    "vector_store_inputs_glob": vs_inputs_glob,
    "vector_store_metadata_filter": vs_metadata_filter,
    "vector_store_splitter": vs_splitter,
    "rag_answer": rag_answer,
    "rag_summarize": rag_summarize,
    "rag_adaptive": rag_adaptive,
    "document_store_bm25": store_bm25,
    "document_store_knn": store_knn,
}


def _both(fn):
    JAX_G.clear()
    want = fn(pathway_tpu)
    JAX_G.clear()
    got = fn(pathway_tpu_torch)
    return want, got


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_rag_scenario_matches_the_jax_package(name):
    want, got = _both(SCENARIOS[name])
    assert want, "the scenario produced nothing"
    _assert_same(got, want)


# -- tests/test_rag_server.py: the REST server on a free port ----------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(pw):
    qa = _mod(pw, "xpacks.llm.question_answering")
    rag = _answerer(pw, search_topk=1)
    port = _free_port()
    rag.build_server(host="127.0.0.1", port=port)
    threading.Thread(target=pw.run, daemon=True).start()
    client = qa.RAGClient(host="127.0.0.1", port=port, timeout=30)
    deadline = time.monotonic() + 60
    while True:
        try:
            stats = client.statistics()
            if stats.get("file_count") == len(RAG_DOCS):
                break
        except OSError:
            pass
        assert time.monotonic() < deadline, "the REST server did not come up"
        time.sleep(0.1)
    return {
        "answer": client.answer("pathway is a streaming framework"),
        "retrieve": client.retrieve("framework", k=2),
        "statistics": client.statistics(),
    }


def test_rest_server_round_trip_matches_the_jax_package():
    want, got = _both(_serve)
    assert got["answer"]["response"].startswith("mock,")
    assert "streaming framework" in got["answer"]["response"]
    assert len(got["retrieve"]) == 2
    _assert_same(got, want)


# -- the device models at f32 ------------------------------------------------

TINY = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp=128, max_len=64)
CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "pack my box with five dozen liquor jugs",
    "sphinx of black quartz judge my vow",
    "how vexingly quick daft zebras jump",
    "streaming dataflow with retractions and incremental updates",
    "a vector index answers nearest neighbour queries",
]
QUESTIONS = ["quick zebras", "nearest neighbour index", "liquor box"]


def _encoders(seed=0):
    from pathway_tpu.models import encoder as jenc
    from pathway_tpu_torch.models import convert
    from pathway_tpu_torch.models import encoder as tenc

    jcfg = dataclasses.replace(jenc.EncoderConfig(**TINY), dtype=jnp.float32)
    tcfg = dataclasses.replace(tenc.EncoderConfig(**TINY), dtype=torch.float32)
    je = jenc.SentenceEncoder(jcfg, seed=seed)
    params = jax.tree_util.tree_map(np.asarray, je.params)
    te = tenc.SentenceEncoder(
        tcfg, params=convert.flax_params_to_torch(params, tcfg), device="cpu"
    )
    return je, te


def _knn_query(pw, encoder):
    emb = _mod(pw, "xpacks.llm.embedders").SentenceTransformerEmbedder(encoder=encoder)
    docs = pw.debug.table_from_markdown(
        "text\n" + "".join(f"{t}\n" for t in CORPUS)
    )
    queries = pw.debug.table_from_markdown(
        "q\n" + "".join(f"{t}\n" for t in QUESTIONS)
    )
    factory = pw.indexing.BruteForceKnnFactory(
        embedder=emb, dimensions=emb.get_embedding_dimension(), **_cpu(pw)
    )
    index = pw.indexing.DataIndex(docs, factory.build_inner_index(docs.text))
    res = index.query_as_of_now(queries.q, number_of_matches=3).select(
        q=queries.q, texts=pw.this.text, scores=pw.this._pw_index_reply_score
    )
    rows = _answered(pw, res)
    return sorted(rows, key=lambda r: r[0])


def test_sentence_transformer_embedder_knn_matches_the_jax_package():
    je, te = _encoders()
    JAX_G.clear()
    want = _knn_query(pathway_tpu, je)
    JAX_G.clear()
    got = _knn_query(pathway_tpu_torch, te)
    assert [r[0] for r in want] == sorted(QUESTIONS)
    assert all(len(r[1]) == 3 for r in want)
    for (gq, gt, gs), (wq, wt, ws) in zip(got, want):
        assert gq == wq and gt == wt
        np.testing.assert_allclose(gs, ws, atol=TOL, rtol=0)


def test_cross_encoder_matches_flax():
    from pathway_tpu.models import cross_encoder as jce
    from pathway_tpu.models import encoder as jenc
    from pathway_tpu.xpacks.llm import rerankers as jrr
    from pathway_tpu_torch.models import convert
    from pathway_tpu_torch.models import cross_encoder as tce
    from pathway_tpu_torch.models import encoder as tenc
    from pathway_tpu_torch.xpacks.llm import rerankers as trr

    jcfg = dataclasses.replace(jenc.EncoderConfig(**TINY), dtype=jnp.float32)
    tcfg = dataclasses.replace(tenc.EncoderConfig(**TINY), dtype=torch.float32)
    jx = jce.CrossEncoder(jcfg, seed=3)
    params = jax.tree_util.tree_map(np.asarray, jx.params)
    tx = tce.CrossEncoder(
        tcfg, params=convert.flax_cross_params_to_torch(params, tcfg), device="cpu"
    )
    pairs = [(q, d) for q in QUESTIONS for d in CORPUS]
    want = np.asarray(jx.score(pairs))
    got = tx.score(pairs)
    assert got.shape == want.shape == (len(pairs),)
    assert np.std(want) > 0  # the pairs score apart
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # the rerankers bound to each model agree as well
    docs = [{"text": d} for d in CORPUS[:3]]
    qs = [QUESTIONS[0]] * 3
    want_r = jrr.CrossEncoderReranker(cross_encoder=jx).func(docs, qs)
    got_r = trr.CrossEncoderReranker(cross_encoder=tx).func(docs, qs)
    np.testing.assert_allclose(got_r, want_r, atol=TOL, rtol=0)
