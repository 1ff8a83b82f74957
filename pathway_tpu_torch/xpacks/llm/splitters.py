"""Text splitters (reference: python/pathway/xpacks/llm/splitters.py:13-121
— null_splitter, TokenCountSplitter (tiktoken))."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.udfs import UDF


def null_splitter(txt: str) -> list[tuple[str, dict]]:
    """No splitting: one chunk (reference: splitters.py:13)."""
    return [(txt, {})]


class TokenCountSplitter(UDF):
    """Split into chunks of [min_tokens, max_tokens] tokens, preferring
    punctuation boundaries (reference: splitters.py:34 — tiktoken-based;
    falls back to a whitespace token model offline)."""

    def __init__(
        self,
        min_tokens: int = 50,
        max_tokens: int = 500,
        encoding_name: str = "cl100k_base",
        **kwargs,
    ):
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        self.encoding_name = encoding_name
        try:
            import tiktoken

            self._enc = tiktoken.get_encoding(encoding_name)
        except Exception:
            self._enc = None
        splitter = self

        def split(txt: str, **kw) -> list:
            return splitter._split(txt or "")

        super().__init__(split, return_type=list, deterministic=True)

    def _tokenize(self, text: str) -> list:
        if self._enc is not None:
            return self._enc.encode(text)
        return text.split()

    def _detokenize(self, toks) -> str:
        if self._enc is not None:
            return self._enc.decode(toks)
        return " ".join(toks)

    def _split(self, text: str) -> list[tuple[str, dict]]:
        toks = self._tokenize(text)
        if not toks:
            return []
        chunks: list[tuple[str, dict]] = []
        start = 0
        n = len(toks)
        while start < n:
            end = min(start + self.max_tokens, n)
            if end < n:
                # prefer a punctuation boundary past min_tokens
                window = self._detokenize(toks[start:end])
                cut = max(
                    window.rfind(". "), window.rfind("! "),
                    window.rfind("? "), window.rfind("\n"),
                )
                min_chars = len(self._detokenize(toks[start:start + self.min_tokens]))
                if cut > min_chars:
                    chunk = window[: cut + 1]
                    consumed = len(self._tokenize(chunk))
                    if consumed > 0:
                        chunks.append((chunk.strip(), {}))
                        start += consumed
                        continue
            chunks.append((self._detokenize(toks[start:end]).strip(), {}))
            start = end
        return [(c, m) for c, m in chunks if c]
