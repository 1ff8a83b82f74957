"""pw.xpacks.llm — LLM/RAG toolkit (reference: python/pathway/xpacks/llm;
SURVEY §2.8).

Device-first: local models (SentenceTransformerEmbedder, CrossEncoderReranker)
are PyTorch modules from pathway_tpu_torch.models running on the card, fed
whole logical-time batches; remote models are async UDFs with
capacity/retry/cache like the reference."""

from pathway_tpu_torch.xpacks.llm import (
    embedders,
    llms,
    parsers,
    prompts,
    rerankers,
    splitters,
)

__all__ = [
    "embedders",
    "llms",
    "parsers",
    "prompts",
    "rerankers",
    "splitters",
    "vector_store",
    "document_store",
    "question_answering",
    "servers",
]


def __getattr__(name):
    # heavier modules (servers pull aiohttp) load lazily
    if name in ("vector_store", "document_store", "question_answering", "servers", "mocks"):
        import importlib

        mod = importlib.import_module(f"pathway_tpu_torch.xpacks.llm.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(name)
