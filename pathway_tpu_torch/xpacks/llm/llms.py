"""LLM chat wrappers (reference: python/pathway/xpacks/llm/llms.py:27-707).

Remote chats are async UDFs (capacity/retry/cache); HFPipelineChat runs a
local transformers pipeline (CPU/offline). `prompt_chat_single_qa` mirrors
the reference helper (:686).
"""

from __future__ import annotations

import json as _json
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.api import Json
from pathway_tpu_torch.udfs import UDF, AsyncExecutor


class BaseChat(UDF):
    """ABC for chat models (reference: llms.py:27). Subclass UDFs take a
    list of ChatCompletion messages (or a Json thereof) and return str."""

    kwargs: dict = {}

    def _accepts_call_arg(self, arg_name: str) -> bool:
        return True


def _normalize_messages(messages) -> list[dict]:
    if isinstance(messages, Json):
        messages = messages.value
    if isinstance(messages, str):
        return [{"role": "user", "content": messages}]
    out = []
    for m in messages:
        if isinstance(m, Json):
            m = m.value
        out.append(dict(m))
    return out


class OpenAIChat(BaseChat):
    """reference: llms.py:84."""

    def __init__(self, model: str = "gpt-4o-mini", *, capacity=None,
                 retry_strategy=None, cache_strategy=None,
                 api_key: str | None = None, base_url: str | None = None,
                 **kwargs):
        try:
            import openai  # noqa: F401
        except ImportError as e:
            raise ImportError("OpenAIChat requires the `openai` package") from e
        self.kwargs = {"model": model, **kwargs}

        client_box: list = []  # one pooled client reused across all calls

        async def chat(messages, **call_kwargs) -> str:
            import openai

            if not client_box:
                client_box.append(
                    openai.AsyncOpenAI(api_key=api_key, base_url=base_url)
                )
            merged = {**self.kwargs, **call_kwargs}
            ret = await client_box[0].chat.completions.create(
                messages=_normalize_messages(messages), **merged
            )
            return ret.choices[0].message.content

        super().__init__(
            chat,
            return_type=str,
            deterministic=False,
            executor=AsyncExecutor(
                capacity=capacity, retry_strategy=retry_strategy
            ),
            cache_strategy=cache_strategy,
        )


class LiteLLMChat(BaseChat):
    """reference: llms.py:313."""

    def __init__(self, model: str, *, capacity=None, retry_strategy=None,
                 cache_strategy=None, **kwargs):
        try:
            import litellm  # noqa: F401
        except ImportError as e:
            raise ImportError("LiteLLMChat requires the `litellm` package") from e
        self.kwargs = {"model": model, **kwargs}

        async def chat(messages, **call_kwargs) -> str:
            import litellm

            merged = {**self.kwargs, **call_kwargs}
            ret = await litellm.acompletion(
                messages=_normalize_messages(messages), **merged
            )
            return ret.choices[0].message.content

        super().__init__(
            chat,
            return_type=str,
            deterministic=False,
            executor=AsyncExecutor(
                capacity=capacity, retry_strategy=retry_strategy
            ),
            cache_strategy=cache_strategy,
        )


class HFPipelineChat(BaseChat):
    """Local transformers text-generation pipeline (reference: llms.py:441).
    Works offline with a local checkpoint path; batched per logical time."""

    def __init__(self, model: str, *, call_kwargs: dict = {},
                 device: str | None = None, batch_size: int = 8, **init_kwargs):
        from transformers import pipeline

        self._pipeline = pipeline(
            "text-generation", model=model, **init_kwargs
        )
        self.kwargs = dict(call_kwargs)
        pipe = self._pipeline

        def chat_batch(messages_list: list, **ckw) -> list:
            outs = []
            for messages in messages_list:
                msgs = _normalize_messages(messages)
                prompt = (
                    msgs
                    if getattr(pipe.tokenizer, "chat_template", None)
                    else "\n".join(m["content"] for m in msgs)
                )
                result = pipe(prompt, **{**self.kwargs, **ckw})
                text = result[0]["generated_text"]
                if isinstance(text, list):  # chat-template pipelines
                    text = text[-1]["content"]
                outs.append(text)
            return outs

        super().__init__(
            chat_batch,
            return_type=str,
            deterministic=True,
            max_batch_size=batch_size,
        )

    def crop_to_max_tokens(self, text):  # reference parity helper
        return text


class CohereChat(BaseChat):
    """reference: llms.py:544 — returns (response, citations)."""

    def __init__(self, *, capacity=None, retry_strategy=None,
                 cache_strategy=None, model: str = "command", **kwargs):
        try:
            import cohere  # noqa: F401
        except ImportError as e:
            raise ImportError("CohereChat requires the `cohere` package") from e
        self.kwargs = {"model": model, **kwargs}

        async def chat(messages, docs=None, **call_kwargs) -> tuple:
            import cohere

            client = cohere.AsyncClient()
            msgs = _normalize_messages(messages)
            ret = await client.chat(
                message=msgs[-1]["content"],
                documents=docs,
                **{**self.kwargs, **call_kwargs},
            )
            cites = [
                dict(c.__dict__) for c in (ret.citations or [])
            ]
            return ret.text, cites

        super().__init__(
            chat,
            return_type=tuple,
            deterministic=False,
            executor=AsyncExecutor(
                capacity=capacity, retry_strategy=retry_strategy
            ),
            cache_strategy=cache_strategy,
        )


def prompt_chat_single_qa(question) -> expr_mod.ColumnExpression:
    """Wrap a question column into a single-message chat payload
    (reference: llms.py:686)."""
    from pathway_tpu_torch.internals.expression import apply_with_type

    return apply_with_type(
        lambda q: Json([{"role": "user", "content": q or ""}]),
        dt.JSON,
        question,
    )
