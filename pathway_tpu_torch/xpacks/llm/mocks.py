"""Deterministic mocks for LLM tests (reference:
python/pathway/xpacks/llm/tests/mocks.py — IdentityMockChat; fake
deterministic embedders in test_vector_store.py). These are the primary CI
substrate: real-model tests stay quarantined to an opt-in tier (SURVEY §4).
"""

from __future__ import annotations

import hashlib

import numpy as np

from pathway_tpu_torch.udfs import UDF
from pathway_tpu_torch.xpacks.llm.llms import BaseChat, _normalize_messages


class IdentityMockChat(BaseChat):
    """Echoes 'model,prompt' (reference: mocks.py IdentityMockChat)."""

    def __init__(self, model: str = "mock", **kwargs):
        self.kwargs = {"model": model}

        async def chat(messages, **ckw) -> str:
            msgs = _normalize_messages(messages)
            return f"{model},{msgs[-1]['content']}"

        super().__init__(chat, return_type=str, deterministic=True)


class DeterministicVisionMockChat:
    """Vision-LLM mock for the multimodal pipeline: given an ImageParser
    message (prompt + base64 data-url), answers with a deterministic
    description derived from the image bytes — so template tests can
    assert that image-derived chunks are indexed and retrieved without any
    real vision model (CI substrate pattern, SURVEY §4)."""

    captions = {
        "mock-chart": "a bar chart showing quarterly revenue growth",
        "mock-slide": "a slide describing the streaming architecture",
    }

    def func(self, messages):
        import base64

        content = messages[-1]["content"]
        url = next(
            (c["image_url"]["url"] for c in content if c.get("type") == "image_url"),
            "",
        )
        raw = base64.b64decode(url.split(",", 1)[1]) if "," in url else b""
        for marker, caption in self.captions.items():
            if marker.encode() in raw:
                return caption
        digest = hashlib.blake2b(raw, digest_size=4).hexdigest()
        return f"an image with fingerprint {digest}"


class DeterministicMockEmbedder(UDF):
    """Stable pseudo-random unit vector per text — hashed, so embeddings
    are identical across processes/runs (test_vector_store.py pattern)."""

    def __init__(self, dimension: int = 16, **kwargs):
        self.dimension = dimension

        def embed(text: str) -> np.ndarray:
            seed = int.from_bytes(
                hashlib.blake2b(
                    (text or "").encode(), digest_size=8
                ).digest(),
                "little",
            )
            rng = np.random.default_rng(seed)
            v = rng.normal(size=dimension).astype(np.float32)
            return v / (np.linalg.norm(v) or 1.0)

        super().__init__(embed, return_type=np.ndarray, deterministic=True)

    def get_embedding_dimension(self, **kwargs) -> int:
        return self.dimension
