"""Prompt-building UDFs (reference: python/pathway/xpacks/llm/prompts.py,
355 LoC — QA / summarize / rerank prompt builders)."""

from __future__ import annotations

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import Json
from pathway_tpu_torch.internals.expression import apply_with_type
from pathway_tpu_torch.udfs import udf


def _doc_texts(docs) -> list[str]:
    if docs is None:
        return []
    if isinstance(docs, Json):
        docs = docs.value
    out = []
    for d in docs:
        if isinstance(d, Json):
            d = d.value
        if isinstance(d, dict):
            out.append(str(d.get("text", d)))
        else:
            out.append(str(d))
    return out


@udf(deterministic=True)
def prompt_qa(query: str, docs) -> str:
    """Default QA prompt (reference: prompts.py prompt_qa)."""
    context = "\n\n".join(_doc_texts(docs))
    return (
        "Please provide an answer based solely on the provided sources. "
        "If none of the sources answer the question, reply exactly: "
        "No information found.\n\n"
        f"Sources:\n{context}\n\n"
        f"Question: {query}\n"
        "Answer:"
    )


@udf(deterministic=True)
def prompt_short_qa(query: str, docs) -> str:
    context = "\n\n".join(_doc_texts(docs))
    return (
        "Answer the question with a short phrase based on the context. "
        "If the context is insufficient reply: No information found.\n\n"
        f"Context:\n{context}\n\nQuestion: {query}\nAnswer:"
    )


@udf(deterministic=True)
def prompt_citing_qa(query: str, docs) -> str:
    context = "\n\n".join(
        f"[{i + 1}] {t}" for i, t in enumerate(_doc_texts(docs))
    )
    return (
        "Answer based on the numbered sources and cite them like [1].\n\n"
        f"Sources:\n{context}\n\nQuestion: {query}\nAnswer:"
    )


@udf(deterministic=True)
def prompt_summarize(text_list) -> str:
    texts = _doc_texts(text_list)
    joined = "\n".join(texts)
    return (
        "Summarize the following texts into a single concise summary.\n\n"
        f"{joined}\n\nSummary:"
    )


@udf(deterministic=True)
def prompt_rerank(query: str, doc: str) -> str:
    return (
        "Rate 1-5 how relevant the document is to the question. "
        "Reply with only the number.\n\n"
        f"Question: {query}\nDocument: {doc}\nScore:"
    )


DEFAULT_MD_TABLE_PARSE_PROMPT = (
    "Explain the given table in markdown format in detail. Do not skip "
    "details or units. Keep column and row names understandable. If it "
    "is not a table, return 'No table.'."
)

DEFAULT_IMAGE_PARSE_PROMPT = (
    "Explain the given image in detail. If there is text, spell out all "
    "of the text in the image."
)
