"""VectorStoreServer (reference:
python/pathway/xpacks/llm/vector_store.py:38-747).

Pipeline (reference :209 _build_graph): concat sources -> async parse UDF
-> flatten -> post-process -> split UDF -> flatten -> KNN document index
with embedder; query ops retrieve/statistics/inputs; REST serving via
rest_connector. The index here is the device brute-force document index
(fused matmul+top-k on the card) instead of host usearch
HNSW (:266)."""

from __future__ import annotations

import threading
from typing import Any, Callable, Sequence

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import Json
from pathway_tpu_torch.internals.expression import apply_with_type, coalesce
from pathway_tpu_torch.stdlib.indexing.colnames import _SCORE
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.vector_document_index import (
    default_brute_force_knn_document_index,
)
from pathway_tpu_torch.udfs import coerce_async
from pathway_tpu_torch.xpacks.llm.parsers import ParseUtf8
from pathway_tpu_torch.xpacks.llm.splitters import null_splitter


class VectorStoreServer:
    def __init__(
        self,
        *docs,
        embedder=None,
        parser: Callable | None = None,
        splitter: Callable | None = None,
        doc_post_processors: Sequence[Callable] | None = None,
        index_params: dict | None = None,
        mesh=None,
        index_builder: Callable | None = None,
    ):
        """Index construction is a strategy: either pass `embedder` (the
        default brute-force KNN document index is built around it) or
        inject `index_builder(chunked_docs) -> DataIndex` directly —
        DocumentStore does the latter with a retriever factory (reference:
        document_store.py:32-120)."""
        if (embedder is None) == (index_builder is None):
            raise ValueError(
                "provide exactly one of `embedder` or `index_builder`"
            )
        self.docs = list(docs)
        self.embedder = embedder
        self.parser = parser or ParseUtf8()
        self.splitter = splitter or null_splitter
        self.doc_post_processors = list(doc_post_processors or [])
        self.index_params = dict(index_params or {})
        self.mesh = mesh
        self._index_builder = index_builder
        if embedder is None:
            self.embedding_dimension = None
        elif hasattr(embedder, "get_embedding_dimension"):
            self.embedding_dimension = embedder.get_embedding_dimension()
        else:
            import numpy as np

            self.embedding_dimension = len(np.asarray(embedder("canary")).ravel())
        self._graph = self._build_graph()

    # -- pipeline ----------------------------------------------------------
    def _build_graph(self) -> dict:
        docs_s = self.docs
        if not docs_s:
            raise ValueError(
                "Provide at least one data source, e.g. "
                "pw.io.fs.read('./docs', format='binary', mode='static', "
                "with_metadata=True)"
            )
        if len(docs_s) == 1:
            (docs,) = docs_s
        else:
            docs = docs_s[0].concat_reindex(*docs_s[1:])

        parser = self.parser
        parse_fn = parser.func if hasattr(parser, "func") else parser
        post_processors = self.doc_post_processors
        splitter = self.splitter
        split_fn = splitter.func if hasattr(splitter, "func") else splitter

        @pw.udf(deterministic=True)
        async def parse_doc(data, metadata) -> list:
            rets = await coerce_async(parse_fn)(data)
            meta = metadata.value if isinstance(metadata, Json) else (metadata or {})
            return [
                Json(dict(text=ret[0], metadata={**meta, **ret[1]}))
                for ret in rets
            ]

        has_meta = "_metadata" in docs.column_names()
        meta_col = (
            docs["_metadata"]
            if has_meta
            else apply_with_type(lambda d: Json({}), dt.JSON, docs.data)
        )
        parsed_docs = docs.select(
            data=parse_doc(docs.data, meta_col)
        ).flatten(pw.this.data)

        if post_processors:

            @pw.udf(deterministic=True)
            def post_proc_docs(data_json) -> Json:
                data = data_json.value
                text, metadata = data["text"], data["metadata"]
                for processor in post_processors:
                    text, metadata = processor(text, metadata)
                return Json(dict(text=text, metadata=metadata))

            parsed_docs = parsed_docs.select(data=post_proc_docs(pw.this.data))

        @pw.udf(deterministic=True)
        def split_doc(data_json) -> list:
            data = data_json.value
            rets = split_fn(data["text"])
            return [
                Json(dict(text=ret[0], metadata={**data["metadata"], **ret[1]}))
                for ret in rets
            ]

        chunked_docs = parsed_docs.select(data=split_doc(pw.this.data)).flatten(
            pw.this.data
        )
        chunked_docs = chunked_docs.with_columns(
            text=apply_with_type(
                lambda d: str(d.value["text"]), dt.STR, pw.this.data
            ),
        )

        knn_index = self._build_index(chunked_docs)

        @pw.udf(deterministic=True)
        def meta_int(data, field: str) -> int:
            try:
                return int(data.value["metadata"].get(field, 0))
            except Exception:
                return 0

        @pw.udf(deterministic=True)
        def meta_str(data, field: str) -> str:
            try:
                return str(data.value["metadata"].get(field, ""))
            except Exception:
                return ""

        enriched = parsed_docs.with_columns(
            modified=meta_int(pw.this.data, "modified_at"),
            indexed=meta_int(pw.this.data, "seen_at"),
            path=meta_str(pw.this.data, "path"),
        )
        stats = enriched.reduce(
            count=pw.reducers.count(),
            last_modified=pw.reducers.max(pw.this.modified),
            last_indexed=pw.reducers.max(pw.this.indexed),
            paths=pw.reducers.tuple(pw.this.path),
        )
        return dict(
            docs=docs,
            parsed_docs=parsed_docs,
            chunked_docs=chunked_docs,
            knn_index=knn_index,
            stats=stats,
        )

    def _build_index(self, chunked_docs) -> DataIndex:
        """Index-construction strategy: the injected builder when given,
        else the embedder-driven brute-force KNN document index."""
        if self._index_builder is not None:
            return self._index_builder(chunked_docs)
        return default_brute_force_knn_document_index(
            chunked_docs.text,
            chunked_docs,
            dimensions=self.embedding_dimension,
            metadata_column=apply_with_type(
                lambda d: Json(d.value["metadata"]), dt.JSON, chunked_docs.data
            ),
            embedder=self.embedder,
            mesh=self.mesh,
            **self.index_params,
        )

    @property
    def index(self) -> DataIndex:
        return self._graph["knn_index"]

    # -- query schemas (reference parity) ----------------------------------
    class StatisticsQuerySchema(pw.Schema):
        pass

    class QueryResultSchema(pw.Schema):
        result: Json

    class InputResultSchema(pw.Schema):
        result: Json

    class FilterSchema(pw.Schema):
        metadata_filter: str | None = pw.column_definition(default_value=None)
        filepath_globpattern: str | None = pw.column_definition(default_value=None)

    InputsQuerySchema = FilterSchema

    class RetrieveQuerySchema(pw.Schema):
        query: str
        k: int
        metadata_filter: str | None = pw.column_definition(default_value=None)
        filepath_globpattern: str | None = pw.column_definition(default_value=None)

    # -- query transformers -------------------------------------------------
    @staticmethod
    def merge_filters(queries):
        """Combine the JMESPath filter and glob pattern (reference: :337)."""

        @pw.udf(deterministic=True)
        def _get_jmespath_filter(metadata_filter: str, filepath_globpattern: str) -> str | None:
            ret_parts = []
            if metadata_filter:
                metadata_filter = (
                    str(metadata_filter)
                    .replace("'", r"\'")
                    .replace("`", "'")
                    .replace('"', "")
                )
                ret_parts.append(f"({metadata_filter})")
            if filepath_globpattern:
                ret_parts.append(f"globmatch('{filepath_globpattern}', path)")
            if ret_parts:
                return " && ".join(ret_parts)
            return None

        keep = [
            c
            for c in queries.column_names()
            if c not in ("metadata_filter", "filepath_globpattern")
        ]
        return queries.select(
            *[queries[c] for c in keep],
            metadata_filter=_get_jmespath_filter(
                pw.this.metadata_filter, pw.this.filepath_globpattern
            ),
        )

    def retrieve_query(self, retrieval_queries):
        """reference: :417."""
        knn_index = self._graph["knn_index"]
        queries = self.merge_filters(retrieval_queries)
        retrieved = knn_index.query_as_of_now(
            queries.query,
            number_of_matches=queries.k,
            collapse_rows=True,
            metadata_filter=queries.metadata_filter,
        )

        @pw.udf(deterministic=True)
        def format_results(datas, scores) -> Json:
            datas = datas or ()
            scores = scores or ()
            out = [
                {**(d.value if isinstance(d, Json) else {"text": str(d)}), "dist": -s}
                for d, s in zip(datas, scores)
            ]
            return Json(sorted(out, key=lambda x: x["dist"]))

        return retrieved.select(
            result=format_results(retrieved.data, retrieved[_SCORE])
        )

    def statistics_query(self, info_queries):
        """reference: :297."""
        stats = self._graph["stats"]

        @pw.udf(deterministic=True)
        def format_stats(count, last_modified, last_indexed) -> Json:
            if count is not None:
                return Json(
                    {
                        "file_count": count,
                        "last_modified": last_modified,
                        "last_indexed": last_indexed,
                    }
                )
            return Json(
                {"file_count": 0, "last_modified": None, "last_indexed": None}
            )

        return info_queries.join_left(stats, id=info_queries.id).select(
            result=format_stats(
                stats.count, stats.last_modified, stats.last_indexed
            )
        )

    def inputs_query(self, input_queries):
        """reference: :365."""
        parsed_docs = self._graph["parsed_docs"]
        all_metas = parsed_docs.reduce(
            metadatas=pw.reducers.tuple(pw.this.data)
        )
        queries = self.merge_filters(input_queries)

        from pathway_tpu_torch.stdlib.indexing._filters import compile_filter

        @pw.udf(deterministic=True)
        def format_inputs(metadatas, metadata_filter) -> Json:
            metadatas = metadatas or ()
            metas = [
                (m.value.get("metadata", {}) if isinstance(m, Json) else {})
                for m in metadatas
            ]
            if metadata_filter:
                pred = compile_filter(metadata_filter)
                metas = [m for m in metas if pred(m)]
            return Json(metas)

        return queries.join_left(all_metas, id=queries.id).select(
            result=format_inputs(all_metas.metadatas, queries.metadata_filter)
        )

    # -- serving ------------------------------------------------------------
    def run_server(
        self,
        host: str,
        port: int,
        threaded: bool = False,
        with_cache: bool = False,
        cache_backend=None,
        **kwargs,
    ):
        """Bind /v1/retrieve, /v1/statistics, /v1/inputs and run
        (reference: :455). Routes serve through the batching gateway:
        concurrent retrieves coalesce into one commit (= one fused
        KNN dispatch) per batch window; ``window_ms``/``max_batch``/
        ``queue_cap``/``timeout_s``/``workers`` kwargs override the
        serve knobs (analysis/knobs.py) per server."""
        # kept on self so callers (CI smoke, metrics scrapers) can reach
        # each route's subject and its ServeMetrics via _routes
        webserver = self.webserver = pw.io.http.PathwayWebserver(
            host=host, port=port
        )
        gateway_kwargs = {
            k: kwargs.pop(k)
            for k in (
                "window_ms", "max_batch", "queue_cap", "timeout_s",
                "workers", "brownout_answer", "breaker_threshold",
                "breaker_cooldown_s",
            )
            if k in kwargs
        }

        routes = [
            ("/v1/retrieve", self.RetrieveQuerySchema, self.retrieve_query, ("GET", "POST")),
            ("/v1/statistics", self.StatisticsQuerySchema, self.statistics_query, ("GET", "POST")),
            ("/v1/inputs", self.InputsQuerySchema, self.inputs_query, ("GET", "POST")),
        ]
        for route, schema, handler, methods in routes:
            queries, writer = pw.io.http.rest_connector(
                webserver=webserver,
                route=route,
                schema=schema,
                methods=methods,
                delete_completed_queries=True,
                **gateway_kwargs,
            )
            writer(handler(queries))

        if threaded:
            t = threading.Thread(target=pw.run, daemon=True)
            t.start()
            return t
        pw.run()


class SlidesVectorStoreServer(VectorStoreServer):
    """reference: vector_store.py SlidesVectorStoreServer — parses slide
    decks with a vision parser; pipeline shape is identical."""


class VectorStoreClient:
    """HTTP client for a VectorStoreServer (reference: :629). Requests
    ride ONE kept-alive connection — against the batching gateway a
    closed-loop client pays connection setup once, not per query."""

    def __init__(self, host: str | None = None, port: int | None = None,
                 url: str | None = None, timeout: int = 15,
                 retries: int = 0):
        from pathway_tpu_torch.io.http import KeepAliveSession

        self.url = url or f"http://{host}:{port}"
        self.timeout = timeout
        # retries > 0 opts into the session's bounded 503/Retry-After
        # retry — the documented backpressure contract (admission sheds,
        # brownout, parked-deadline expiry during a mesh rollback)
        self._session = KeepAliveSession(
            self.url, timeout=timeout, retries=retries
        )

    def _post(self, route: str, payload: dict):
        return self._session.post(route, payload)

    def query(self, query: str, k: int = 3, metadata_filter: str | None = None,
              filepath_globpattern: str | None = None):
        return self._post(
            "/v1/retrieve",
            {
                "query": query,
                "k": k,
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )

    __call__ = query

    def get_vectorstore_statistics(self):
        return self._post("/v1/statistics", {})

    def get_input_files(self, metadata_filter=None, filepath_globpattern=None):
        return self._post(
            "/v1/inputs",
            {
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )
