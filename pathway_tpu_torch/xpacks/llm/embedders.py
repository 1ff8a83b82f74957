"""Embedders (reference: python/pathway/xpacks/llm/embedders.py:64-413).

The flagship is ``SentenceTransformerEmbedder`` — the name is kept for
config compatibility, but instead of sentence-transformers on one string
per call (reference :270), it wraps this package's PyTorch encoder
(pathway_tpu_torch.models.SentenceEncoder, on the card unless
``device="cpu"``) and receives whole logical-time batches
(``max_batch_size``); that batching is the ingest lever (SURVEY §7
stage 4). Remote embedders (OpenAI/LiteLLM/Gemini) are async
UDFs with capacity/retry/cache, gated on their client libraries.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.udfs import UDF, AsyncExecutor


class BaseEmbedder(UDF):
    kwargs: dict = {}

    def get_embedding_dimension(self, **kwargs) -> int:
        """Probe the embedder with a canary call (reference: :65)."""
        out = self.func("pathway_canary", **{**self.kwargs, **kwargs})
        import asyncio
        import inspect

        if inspect.iscoroutine(out):
            out = asyncio.run(out)
        return len(np.asarray(out).ravel() if not isinstance(out, (list, tuple)) else out)

    def __call__(self, *args, **kwargs):
        return super().__call__(*args, **kwargs)


class SentenceTransformerEmbedder(BaseEmbedder):
    """Local sentence encoder (reference: embedders.py:270 —
    sentence-transformers with `device=`; here this package's PyTorch
    encoder, whole batches per call). ``device=None`` is the card; without
    CUDA pass ``device="cpu"``. ``encoder=`` takes a ready
    ``SentenceEncoder`` (its own device wins)."""

    def __init__(
        self,
        model: str | None = "bge-small",
        *,
        call_kwargs: dict = {},
        device=None,                # None = the card
        batch_size: int = 256,
        encoder=None,
        **init_kwargs,
    ):
        from pathway_tpu_torch.models import EncoderConfig, SentenceEncoder

        if encoder is not None:
            self._encoder = encoder
        else:
            if model in (None, "bge-small", "BAAI/bge-small-en-v1.5"):
                config = EncoderConfig.bge_small()
            elif model in ("bge-base", "BAAI/bge-base-en-v1.5"):
                config = EncoderConfig.bge_base()
            elif model == "tiny":
                config = EncoderConfig.tiny()
            else:
                # unknown checkpoint name: keep bge-small geometry, try the
                # local tokenizer files if present (no network egress here)
                config = EncoderConfig.bge_small()
            self._encoder = SentenceEncoder(
                config, tokenizer_path=model, batch_size=batch_size,
                device=device,
            )
        self.kwargs = dict(call_kwargs)
        encoder_ref = self._encoder

        def embed_batch(texts: list, **kwargs) -> list:
            embs = encoder_ref.encode([t or "" for t in texts])
            return [np.asarray(e, dtype=np.float32) for e in embs]

        super().__init__(
            embed_batch,
            return_type=np.ndarray,
            deterministic=True,
            max_batch_size=batch_size,
        )

    def get_embedding_dimension(self, **kwargs) -> int:
        return self._encoder.embed_dim

    def __call__(self, *args, **kwargs):
        return expr_mod.ApplyExpression(
            self.func,
            np.ndarray,
            False,
            True,
            args,
            {**self.kwargs, **kwargs} if (self.kwargs or kwargs) else {},
            max_batch_size=self.max_batch_size,
        )


class _RemoteEmbedder(BaseEmbedder):
    """Shared scaffold for API embedders: async, capacity/retry/cache."""

    def __init__(self, call_fn, *, capacity=None, retry_strategy=None,
                 cache_strategy=None, **kwargs):
        self.kwargs = kwargs
        super().__init__(
            call_fn,
            deterministic=True,
            executor=AsyncExecutor(
                capacity=capacity, retry_strategy=retry_strategy
            ),
            cache_strategy=cache_strategy,
        )


class OpenAIEmbedder(_RemoteEmbedder):
    """reference: embedders.py:85 — one async API call per string."""

    def __init__(self, model: str = "text-embedding-3-small", *,
                 capacity=None, retry_strategy=None, cache_strategy=None,
                 api_key: str | None = None, **kwargs):
        try:
            import openai  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "OpenAIEmbedder requires the `openai` package"
            ) from e

        client_box: list = []  # one pooled client reused across all calls

        async def embed(text: str, **call_kwargs) -> list:
            import openai

            if not client_box:
                client_box.append(openai.AsyncOpenAI(api_key=api_key))
            ret = await client_box[0].embeddings.create(
                input=[text or "."], model=model, **call_kwargs
            )
            return ret.data[0].embedding

        super().__init__(
            embed, capacity=capacity, retry_strategy=retry_strategy,
            cache_strategy=cache_strategy, model=model, **kwargs,
        )


class LiteLLMEmbedder(_RemoteEmbedder):
    """reference: embedders.py:180."""

    def __init__(self, model: str, *, capacity=None, retry_strategy=None,
                 cache_strategy=None, **kwargs):
        try:
            import litellm  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "LiteLLMEmbedder requires the `litellm` package"
            ) from e

        async def embed(text: str, **call_kwargs) -> list:
            import litellm

            ret = await litellm.aembedding(
                input=[text or "."], model=model, **call_kwargs
            )
            return ret.data[0]["embedding"]

        super().__init__(
            embed, capacity=capacity, retry_strategy=retry_strategy,
            cache_strategy=cache_strategy, model=model, **kwargs,
        )


class GeminiEmbedder(_RemoteEmbedder):
    """reference: embedders.py:330."""

    def __init__(self, model: str = "models/text-embedding-004", *,
                 capacity=None, retry_strategy=None, cache_strategy=None,
                 **kwargs):
        try:
            import google.generativeai as genai  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "GeminiEmbedder requires `google-generativeai`"
            ) from e

        async def embed(text: str, **call_kwargs) -> list:
            import google.generativeai as genai

            ret = genai.embed_content(
                model=model, content=text or ".", **call_kwargs
            )
            return ret["embedding"]

        super().__init__(
            embed, capacity=capacity, retry_strategy=retry_strategy,
            cache_strategy=cache_strategy, model=model, **kwargs,
        )
