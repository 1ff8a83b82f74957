"""Rerankers (reference: python/pathway/xpacks/llm/rerankers.py:14-346).

Flagship: CrossEncoderReranker wraps this package's PyTorch cross-encoder
(pathway_tpu_torch.models.CrossEncoder, on the card unless
``device="cpu"``), scoring (query, doc) candidate lists in batched device
calls — the reference (:186) runs sentence-transformers CrossEncoder per
pair."""

from __future__ import annotations

from typing import Any

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import apply_with_type
from pathway_tpu_torch.udfs import UDF, AsyncExecutor


def rerank_topk_filter(docs, scores, k: int = 5):
    """Expression: keep top-k docs by score (reference: rerankers.py:15).
    Returns (docs_tuple, scores_tuple)."""

    def run(d, s, kk) -> tuple:
        if not d:
            return ((), ())
        order = sorted(range(len(d)), key=lambda i: -s[i])[: int(kk)]
        return (
            tuple(d[i] for i in order),
            tuple(s[i] for i in order),
        )

    return apply_with_type(run, dt.ANY, docs, scores, k)


class CrossEncoderReranker(UDF):
    """Batched cross-encoder scoring on the card (reference:
    rerankers.py:186). ``device=None`` is the card; ``cross_encoder=``
    takes a ready ``CrossEncoder``."""

    def __init__(
        self,
        model_name: str | None = None,
        *,
        cache_strategy=None,
        batch_size: int = 64,
        cross_encoder=None,
        device=None,
        **init_kwargs,
    ):
        from pathway_tpu_torch.models import CrossEncoder, EncoderConfig

        if cross_encoder is not None:
            self._ce = cross_encoder
        else:
            config = (
                EncoderConfig.tiny()
                if model_name == "tiny"
                else EncoderConfig.bge_small()
            )
            self._ce = CrossEncoder(
                config, tokenizer_path=model_name, batch_size=batch_size,
                device=device,
            )
        ce = self._ce

        def score_batch(docs: list, queries: list) -> list:
            pairs = [(q or "", _doc_text(d)) for q, d in zip(queries, docs)]
            return [float(s) for s in ce.score(pairs)]

        super().__init__(
            score_batch,
            return_type=float,
            deterministic=True,
            cache_strategy=cache_strategy,
            max_batch_size=batch_size,
        )


class EncoderReranker(UDF):
    """Bi-encoder similarity reranker (reference: rerankers.py:251).
    ``device=None`` is the card for the default encoder."""

    def __init__(self, embedder=None, *, batch_size: int = 64, device=None,
                 **kwargs):
        from pathway_tpu_torch.models import EncoderConfig, SentenceEncoder

        self._encoder = (
            embedder
            if embedder is not None
            else SentenceEncoder(EncoderConfig.bge_small(), device=device)
        )
        enc = self._encoder

        def score_batch(docs: list, queries: list) -> list:
            texts = [_doc_text(d) for d in docs] + [q or "" for q in queries]
            embs = enc.encode(texts)
            n = len(docs)
            d_emb, q_emb = embs[:n], embs[n:]
            return [float((a * b).sum()) for a, b in zip(d_emb, q_emb)]

        super().__init__(
            score_batch,
            return_type=float,
            deterministic=True,
            max_batch_size=batch_size,
        )


class LLMReranker(UDF):
    """Ask an LLM for a 1-5 relevance score (reference: rerankers.py:58)."""

    def __init__(self, llm, *, retry_strategy=None, cache_strategy=None, **kwargs):
        self.llm = llm

        async def score(doc, query) -> float:
            import inspect

            prompt = (
                "Given a question and a document snippet, rate how relevant "
                "the document is to answering the question on a scale of 1 "
                "to 5. Answer with ONLY the number.\n\n"
                f"Question: {query}\nDocument: {_doc_text(doc)}\nScore:"
            )
            messages = [{"role": "user", "content": prompt}]
            out = llm.func(messages)
            if inspect.iscoroutine(out):
                out = await out
            digits = [c for c in str(out) if c.isdigit()]
            return float(digits[0]) if digits else 1.0

        super().__init__(
            score,
            return_type=float,
            deterministic=True,
            executor=AsyncExecutor(retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )


class FlashRankReranker(UDF):
    """reference: rerankers.py:319 — flashrank-backed."""

    def __init__(self, model_name: str = "ms-marco-TinyBERT-L-2-v2", **kwargs):
        try:
            from flashrank import Ranker  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "FlashRankReranker requires the `flashrank` package"
            ) from e
        from flashrank import Ranker, RerankRequest

        self._ranker = Ranker(model_name=model_name)
        ranker = self._ranker

        def score(doc, query) -> float:
            req = RerankRequest(
                query=query, passages=[{"text": _doc_text(doc)}]
            )
            return float(ranker.rerank(req)[0]["score"])

        super().__init__(score, return_type=float, deterministic=True)


def _doc_text(doc) -> str:
    from pathway_tpu_torch.internals.api import Json

    if isinstance(doc, Json):
        doc = doc.value
    if isinstance(doc, dict):
        return str(doc.get("text", doc))
    return str(doc)
