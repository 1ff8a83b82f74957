"""DocumentStore (reference:
python/pathway/xpacks/llm/document_store.py:32-529 — the retriever-factory
driven sibling of VectorStoreServer: same parse/split pipeline, but the
index is built by an AbstractRetrieverFactory, so BM25/hybrid/KNN all fit)."""

from __future__ import annotations

from typing import Callable, Sequence

import pathway_tpu_torch as pw
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndexFactory
from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer


class DocumentStore(VectorStoreServer):
    """reference: document_store.py:32. Accepts `retriever_factory`
    (pw.indexing.*Factory); index construction is injected into the shared
    pipeline as a builder strategy — the factory owns embedding."""

    def __init__(
        self,
        *docs,
        retriever_factory: InnerIndexFactory,
        parser: Callable | None = None,
        splitter: Callable | None = None,
        doc_post_processors: Sequence[Callable] | None = None,
    ):
        self.retriever_factory = retriever_factory

        def build_index(chunked_docs):
            from pathway_tpu_torch.internals import dtype as dt
            from pathway_tpu_torch.internals.api import Json
            from pathway_tpu_torch.internals.expression import apply_with_type

            return retriever_factory.build_index(
                chunked_docs.text,
                chunked_docs,
                metadata_column=apply_with_type(
                    lambda d: Json(d.value["metadata"]), dt.JSON,
                    chunked_docs.data,
                ),
            )

        super().__init__(
            *docs,
            index_builder=build_index,
            parser=parser,
            splitter=splitter,
            doc_post_processors=doc_post_processors,
        )


class SlidesDocumentStore(DocumentStore):
    """Document store for the slides-search application (reference:
    document_store.py:471): adds ``parsed_documents_query`` — the
    post-parse document metadata list the slide-search UI renders —
    with oversized fields (slide images) stripped from responses."""

    excluded_response_metadata = ["b64_image"]

    def parsed_documents_query(self, parse_docs_queries):
        """Table of parsed-document metadata (one Json list per query),
        filtered by the standard metadata_filter/filepath_globpattern
        pair."""
        from pathway_tpu_torch.internals.api import Json
        from pathway_tpu_torch.stdlib.indexing._filters import compile_filter

        parsed_docs = self._graph["parsed_docs"]

        @pw.udf(deterministic=True)
        def meta_of(data: Json) -> Json:
            try:
                return Json(dict(data.value.get("metadata") or {}))
            except AttributeError:
                return Json({})

        metas = parsed_docs.select(meta=meta_of(pw.this.data))
        all_metas = metas.reduce(
            metadatas=pw.reducers.tuple(pw.this.meta)
        )
        queries = self.merge_filters(parse_docs_queries)
        excluded = tuple(self.excluded_response_metadata)

        @pw.udf(deterministic=True)
        def format_inputs(metadatas, metadata_filter: str | None) -> Json:
            metadatas = list(metadatas or ())
            pred = compile_filter(metadata_filter)
            out = []
            for m in metadatas:
                value = m.value if hasattr(m, "value") else m
                if pred is not None and not pred(value):
                    continue
                cleaned = {
                    k: v for k, v in dict(value).items() if k not in excluded
                }
                out.append(cleaned)
            return Json(out)

        joined = queries.join_left(all_metas, id=queries.id).select(
            metadatas=all_metas.metadatas,
            metadata_filter=queries.metadata_filter,
        )
        return joined.select(
            result=format_inputs(pw.this.metadatas, pw.this.metadata_filter)
        )
