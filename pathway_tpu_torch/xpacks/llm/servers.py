"""REST servers for RAG apps (reference:
python/pathway/xpacks/llm/servers.py:16-291 — BaseRestServer.serve binds
route -> schema -> handler via rest_connector; DocumentStoreServer :92,
QARestServer :140, QASummaryRestServer :193, serve_callable :227)."""

from __future__ import annotations

import threading
from typing import Any, Callable

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals.api import Json
from pathway_tpu_torch.internals.schema import schema_from_types
from pathway_tpu_torch.internals import dtype as dt


class BaseRestServer:
    def __init__(self, host: str, port: int, **rest_kwargs):
        self.host = host
        self.port = port
        self.webserver = pw.io.http.PathwayWebserver(host=host, port=port)
        self.rest_kwargs = rest_kwargs

    def serve(self, route: str, schema, handler, methods=("POST",), **kwargs):
        # routes serve through the batching gateway (windowed commits,
        # bounded admission); the serve knobs (knobs.py) or rest_kwargs
        # (window_ms/max_batch/queue_cap/timeout_s/workers) tune it
        queries, writer = pw.io.http.rest_connector(
            webserver=self.webserver,
            route=route,
            schema=schema,
            methods=methods,
            delete_completed_queries=True,
            **{**self.rest_kwargs, **kwargs},
        )
        writer(handler(queries))

    def serve_callable(self, route: str, schema=None, **kwargs):
        """Expose an arbitrary (async) python callable as an endpoint via
        AsyncTransformer (reference: servers.py:227)."""

        def decorator(callable_fn):
            import inspect

            nonlocal schema
            if schema is None:
                sig = inspect.signature(callable_fn)
                cols = {
                    name: dt.ANY
                    for name in sig.parameters
                    if name != "self"
                }
                schema = schema_from_types(**cols)

            class _CallableTransformer(
                pw.AsyncTransformer,
                output_schema=schema_from_types(result=dt.ANY),
            ):
                async def invoke(self, **kwargs) -> dict:
                    res = callable_fn(**kwargs)
                    if inspect.iscoroutine(res):
                        res = await res
                    return {"result": res}

            queries, writer = pw.io.http.rest_connector(
                webserver=self.webserver,
                route=route,
                schema=schema,
                delete_completed_queries=True,
            )
            transformer = _CallableTransformer(input_table=queries)
            writer(transformer.successful)
            return callable_fn

        return decorator

    def run(self, threaded: bool = False, with_cache: bool = False,
            cache_backend=None, terminate_on_error: bool = True, **kwargs):
        persistence_config = None
        if with_cache and cache_backend is not None:
            import pathway_tpu_torch as pw_mod

            persistence_config = pw_mod.persistence.Config(
                backend=cache_backend
            )

        def target():
            pw.run(
                terminate_on_error=terminate_on_error,
                persistence_config=persistence_config,
                **kwargs,
            )

        if threaded:
            t = threading.Thread(target=target, daemon=True)
            t.start()
            return t
        target()

    run_server = run


class DocumentStoreServer(BaseRestServer):
    """reference: servers.py:92."""

    def __init__(self, host: str, port: int, document_store, **rest_kwargs):
        super().__init__(host, port, **rest_kwargs)
        self.document_store = document_store
        self.serve(
            "/v1/retrieve",
            document_store.RetrieveQuerySchema,
            document_store.retrieve_query,
            methods=("GET", "POST"),
        )
        self.serve(
            "/v1/statistics",
            document_store.StatisticsQuerySchema,
            document_store.statistics_query,
            methods=("GET", "POST"),
        )
        self.serve(
            "/v1/inputs",
            document_store.InputsQuerySchema,
            document_store.inputs_query,
            methods=("GET", "POST"),
        )


class QARestServer(BaseRestServer):
    """reference: servers.py:140."""

    def __init__(self, host: str, port: int, rag_question_answerer, **rest_kwargs):
        super().__init__(host, port, **rest_kwargs)
        self.rag_question_answerer = rag_question_answerer
        self.serve(
            "/v2/answer",
            rag_question_answerer.AnswerQuerySchema,
            rag_question_answerer.answer_query,
        )
        self.serve(
            "/v1/pw_ai_answer",
            rag_question_answerer.AnswerQuerySchema,
            rag_question_answerer.answer_query,
        )
        self.serve(
            "/v1/retrieve",
            rag_question_answerer.RetrieveQuerySchema,
            rag_question_answerer.retrieve,
            methods=("GET", "POST"),
        )
        self.serve(
            "/v1/statistics",
            rag_question_answerer.StatisticsQuerySchema,
            rag_question_answerer.statistics,
            methods=("GET", "POST"),
        )
        self.serve(
            "/v2/list_documents",
            rag_question_answerer.InputsQuerySchema,
            rag_question_answerer.list_documents,
            methods=("GET", "POST"),
        )


class QASummaryRestServer(QARestServer):
    """reference: servers.py:193."""

    def __init__(self, host: str, port: int, rag_question_answerer, **rest_kwargs):
        super().__init__(host, port, rag_question_answerer, **rest_kwargs)
        self.serve(
            "/v2/summarize",
            rag_question_answerer.SummarizeQuerySchema,
            rag_question_answerer.summarize_query,
        )
        self.serve(
            "/v1/pw_ai_summary",
            rag_question_answerer.SummarizeQuerySchema,
            rag_question_answerer.summarize_query,
        )
