"""RAG question answering (reference:
python/pathway/xpacks/llm/question_answering.py — BaseQuestionAnswerer
:263, BaseRAGQuestionAnswerer :289, AdaptiveRAGQuestionAnswerer :574,
answer_with_geometric_rag_strategy :97/:162, RAGClient :816)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import Json
from pathway_tpu_torch.internals.expression import apply_with_type, coalesce
from pathway_tpu_torch.stdlib.indexing.colnames import _SCORE
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.xpacks.llm import prompts
from pathway_tpu_torch.xpacks.llm.llms import BaseChat, prompt_chat_single_qa

_NO_ANSWER = "No information found."


# -- geometric (adaptive) strategy ----------------------------------------


def _ask_with_docs(llm: BaseChat, questions_docs, n_documents: int,
                   strict_prompt: bool):
    @pw.udf(deterministic=True)
    def trim_docs(docs) -> Json:
        docs = docs.value if isinstance(docs, Json) else (docs or [])
        return Json(list(docs)[: n_documents])

    trimmed = questions_docs.with_columns(
        _pw_docs_k=trim_docs(pw.this.documents)
    )
    prompt = prompts.prompt_qa(trimmed.query, trimmed["_pw_docs_k"])
    answers = trimmed.select(
        answer=llm(prompt_chat_single_qa(prompt)),
    )

    @pw.udf(deterministic=True)
    def normalize(ans: str) -> str | None:
        if ans is None:
            return None
        # exact no-answer sentinel (reference compares the full reply, not a
        # substring — prompts themselves contain the sentinel as instruction)
        if str(ans).strip().lower().rstrip(".") == _NO_ANSWER.lower().rstrip("."):
            return None
        return ans

    return answers.select(answer=normalize(pw.this.answer))


def answer_with_geometric_rag_strategy(
    questions,
    documents,
    llm_chat_model: BaseChat,
    n_starting_documents: int,
    factor: int,
    max_iterations: int,
    strict_prompt: bool = False,
):
    """Ask with n docs, geometrically grow (×factor) until answered
    (reference: :97)."""
    n_documents = n_starting_documents
    t = pw.Table.from_columns(query=questions, documents=documents)
    t = t.with_columns(answer=None)
    for _ in range(max_iterations):
        rows_without_answer = t.filter(pw.this.answer.is_none())
        results = _ask_with_docs(
            llm_chat_model, rows_without_answer, n_documents, strict_prompt
        )
        new_answers = rows_without_answer.with_columns(answer=results.answer)
        t = t.update_rows(new_answers)
        n_documents *= factor
    return t.answer


def answer_with_geometric_rag_strategy_from_index(
    questions,
    index: DataIndex,
    documents_column,
    llm_chat_model: BaseChat,
    n_starting_documents: int,
    factor: int,
    max_iterations: int,
    metadata_filter=None,
    strict_prompt: bool = False,
):
    """reference: :162 — retrieve max needed docs once, then apply the
    geometric strategy on the retrieved list."""
    max_documents = n_starting_documents * (factor ** (max_iterations - 1))
    results = index.query_as_of_now(
        questions,
        number_of_matches=max_documents,
        collapse_rows=True,
        metadata_filter=metadata_filter,
    )
    col_name = (
        documents_column
        if isinstance(documents_column, str)
        else documents_column.name
    )
    docs = results.select(
        documents=coalesce(results[col_name], ()),
    )
    return answer_with_geometric_rag_strategy(
        questions,
        docs.documents,
        llm_chat_model,
        n_starting_documents,
        factor,
        max_iterations,
        strict_prompt=strict_prompt,
    )


# -- answerers -------------------------------------------------------------


class BaseQuestionAnswerer(ABC):
    """reference: :263 — the serving contract used by QARestServer."""

    AnswerQuerySchema: type[pw.Schema]
    RetrieveQuerySchema: type[pw.Schema]
    StatisticsQuerySchema: type[pw.Schema]
    InputsQuerySchema: type[pw.Schema]

    @abstractmethod
    def answer_query(self, pw_ai_queries): ...

    @abstractmethod
    def retrieve(self, retrieve_queries): ...

    @abstractmethod
    def statistics(self, statistics_queries): ...

    @abstractmethod
    def list_documents(self, list_documents_queries): ...


class SummaryQuestionAnswerer(BaseQuestionAnswerer):
    SummarizeQuerySchema: type[pw.Schema]

    @abstractmethod
    def summarize_query(self, summarize_queries): ...


class BaseRAGQuestionAnswerer(SummaryQuestionAnswerer):
    """reference: :289 — prompt build + answer_query :401,
    summarize_query :445, REST wiring build_server :481."""

    class AnswerQuerySchema(pw.Schema):
        prompt: str
        filters: str | None = pw.column_definition(default_value=None)
        model: str | None = pw.column_definition(default_value=None)
        return_context_docs: bool | None = pw.column_definition(default_value=False)

    class SummarizeQuerySchema(pw.Schema):
        text_list: Json
        model: str | None = pw.column_definition(default_value=None)

    def __init__(
        self,
        llm: BaseChat,
        indexer,
        *,
        default_llm_name: str | None = None,
        short_prompt_template=None,
        long_prompt_template=None,
        summarize_template=None,
        search_topk: int = 6,
    ):
        self.llm = llm
        self.indexer = indexer
        self.default_llm_name = default_llm_name
        self.short_prompt_template = short_prompt_template or prompts.prompt_short_qa
        self.long_prompt_template = long_prompt_template or prompts.prompt_qa
        self.summarize_template = summarize_template or prompts.prompt_summarize
        self.search_topk = search_topk
        self.server = None
        self._pending_endpoints: list = []

    # schemas delegated to the indexer
    @property
    def RetrieveQuerySchema(self):
        return self.indexer.RetrieveQuerySchema

    @property
    def StatisticsQuerySchema(self):
        return self.indexer.StatisticsQuerySchema

    @property
    def InputsQuerySchema(self):
        return self.indexer.InputsQuerySchema

    # -- core ops ----------------------------------------------------------
    def _retrieve_docs(self, queries):
        """queries: table with prompt + filters -> + docs column (list of
        {text, metadata, dist})."""
        index = self.indexer.index
        topk = self.search_topk
        retrieved = index.query_as_of_now(
            queries.prompt,
            number_of_matches=topk,
            collapse_rows=True,
            metadata_filter=queries.filters,
        )

        @pw.udf(deterministic=True)
        def pack_docs(datas, scores) -> Json:
            datas = datas or ()
            scores = scores or ()
            return Json(
                [
                    {**(d.value if isinstance(d, Json) else {"text": str(d)}),
                     "dist": -s}
                    for d, s in zip(datas, scores)
                ]
            )

        return queries.with_columns(
            docs=pack_docs(retrieved.data, retrieved[_SCORE])
        )

    def answer_query(self, pw_ai_queries):
        """reference: :401."""
        with_docs = self._retrieve_docs(pw_ai_queries)
        prompt = self.long_prompt_template(
            with_docs.prompt, with_docs.docs
        )
        answered = with_docs.with_columns(
            response=self.llm(prompt_chat_single_qa(prompt)),
        )

        @pw.udf(deterministic=True)
        def format_response(response, docs, return_context_docs) -> Json:
            out: dict[str, Any] = {"response": response}
            if return_context_docs:
                out["context_docs"] = (
                    docs.value if isinstance(docs, Json) else docs
                )
            return Json(out)

        return answered.select(
            result=format_response(
                pw.this.response, pw.this.docs, pw.this.return_context_docs
            )
        )

    pw_ai_query = answer_query  # reference alias

    def summarize_query(self, summarize_queries):
        """reference: :445."""
        prompt = self.summarize_template(summarize_queries.text_list)
        return summarize_queries.select(
            result=self.llm(prompt_chat_single_qa(prompt)),
        )

    def retrieve(self, retrieve_queries):
        return self.indexer.retrieve_query(retrieve_queries)

    def statistics(self, statistics_queries):
        return self.indexer.statistics_query(statistics_queries)

    def list_documents(self, list_documents_queries):
        return self.indexer.inputs_query(list_documents_queries)

    # -- serving -----------------------------------------------------------
    def build_server(self, host: str, port: int, **rest_kwargs):
        """reference: :481 — QASummaryRestServer over this answerer."""
        from pathway_tpu_torch.xpacks.llm.servers import QASummaryRestServer

        self.server = QASummaryRestServer(host, port, self, **rest_kwargs)
        for route, callable_fn, schema, extra in self._pending_endpoints:
            self.server.serve_callable(route, schema=schema, **extra)(
                callable_fn
            )

    def serve_callable(self, route: str, schema=None, **additional_endpoint_kwargs):
        """Decorator: expose a python callable on `route` (reference: :512)."""

        def decorator(callable_fn):
            if self.server is None:
                self._pending_endpoints.append(
                    (route, callable_fn, schema, additional_endpoint_kwargs)
                )
            else:
                self.server.serve_callable(
                    route, schema=schema, **additional_endpoint_kwargs
                )(callable_fn)
            return callable_fn

        return decorator

    def run_server(self, *args, **kwargs):
        if self.server is None:
            raise ValueError("call build_server first")
        self.server.run(*args, **kwargs)


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """reference: :574 — geometric context growth."""

    def __init__(
        self,
        llm: BaseChat,
        indexer,
        *,
        n_starting_documents: int = 2,
        factor: int = 2,
        max_iterations: int = 4,
        strict_prompt: bool = False,
        **kwargs,
    ):
        super().__init__(llm, indexer, **kwargs)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations
        self.strict_prompt = strict_prompt

    def answer_query(self, pw_ai_queries):
        index = self.indexer.index
        answer = answer_with_geometric_rag_strategy_from_index(
            pw_ai_queries.prompt,
            index,
            "text",
            self.llm,
            n_starting_documents=self.n_starting_documents,
            factor=self.factor,
            max_iterations=self.max_iterations,
            metadata_filter=pw_ai_queries.filters,
            strict_prompt=self.strict_prompt,
        )
        table = pw_ai_queries.with_columns(response=answer)

        @pw.udf(deterministic=True)
        def wrap(response) -> Json:
            return Json({"response": response})

        return table.select(result=wrap(pw.this.response))


class DeckRetriever(BaseQuestionAnswerer):
    """reference: :698 — slide-deck retrieval app (search only)."""

    def __init__(self, indexer, *, search_topk: int = 6):
        self.indexer = indexer
        self.search_topk = search_topk

    @property
    def RetrieveQuerySchema(self):
        return self.indexer.RetrieveQuerySchema

    @property
    def StatisticsQuerySchema(self):
        return self.indexer.StatisticsQuerySchema

    @property
    def InputsQuerySchema(self):
        return self.indexer.InputsQuerySchema

    def answer_query(self, queries):
        return self.indexer.retrieve_query(queries)

    def retrieve(self, queries):
        return self.indexer.retrieve_query(queries)

    def statistics(self, queries):
        return self.indexer.statistics_query(queries)

    def list_documents(self, queries):
        return self.indexer.inputs_query(queries)

    # DocumentStoreServer-compatible surface: a DeckRetriever can sit
    # directly behind the document-store REST routes
    retrieve_query = retrieve
    statistics_query = statistics
    inputs_query = list_documents


class RAGClient:
    """HTTP client for RAG servers (reference: :816). One kept-alive
    connection per client — a closed-loop driver against the batching
    gateway pays connection setup once, not per query."""

    def __init__(self, host: str | None = None, port: int | None = None,
                 url: str | None = None, timeout: int = 90,
                 retries: int = 0):
        from pathway_tpu_torch.io.http import KeepAliveSession

        self.url = url or f"http://{host}:{port}"
        self.timeout = timeout
        # retries > 0 opts into the session's bounded 503/Retry-After
        # retry (the documented backpressure contract) instead of
        # treating a shed/brownout 503 as terminal
        self._session = KeepAliveSession(
            self.url, timeout=timeout, retries=retries
        )

    def _post(self, route: str, payload: dict):
        return self._session.post(route, payload)

    def answer(self, prompt: str, filters: str | None = None,
               model: str | None = None, return_context_docs: bool = False):
        return self._post(
            "/v2/answer",
            {
                "prompt": prompt,
                "filters": filters,
                "model": model,
                "return_context_docs": return_context_docs,
            },
        )

    pw_ai_answer = answer

    def summarize(self, text_list: list[str], model: str | None = None):
        return self._post(
            "/v2/summarize", {"text_list": text_list, "model": model}
        )

    def retrieve(self, query: str, k: int = 3, metadata_filter=None,
                 filepath_globpattern=None):
        return self._post(
            "/v1/retrieve",
            {
                "query": query,
                "k": k,
                "metadata_filter": metadata_filter,
                "filepath_globpattern": filepath_globpattern,
            },
        )

    def statistics(self):
        return self._post("/v1/statistics", {})

    def list_documents(self, filters=None, keys=None):
        return self._post("/v2/list_documents", {"metadata_filter": filters})
