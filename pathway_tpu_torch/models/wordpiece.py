"""Exact WordPiece tokenizer with per-word memoization.

The port's copy of ``pathway_tpu/models/wordpiece.py``: token-identical to
HF ``BertTokenizerFast`` (BertNormalizer + BertPreTokenizer + greedy
longest-match WordPiece), built for the streaming-ingest hot path.
Natural-language corpora repeat words heavily (Zipf), so each distinct
word's subword ids are computed once and memoized — amortized tokenization
cost becomes one dict lookup per word. Only numpy and unicodedata; the JAX
package's native batch fast path is not carried over, and the Python path
it falls back to gives the same ids.
"""

from __future__ import annotations

import unicodedata

import numpy as np

_MAX_WORD_CHARS = 100  # HF WordPiece max_input_chars_per_word


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """BERT-contract tokenizer: texts -> (ids [n, L], mask [n, L])."""

    def __init__(
        self,
        vocab_file: str,
        max_length: int = 512,
        lowercase: bool = True,
        cache_size: int = 1_000_000,
    ):
        with open(vocab_file, encoding="utf-8") as f:
            self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.max_length = max_length
        self.lowercase = lowercase
        self.pad_id = self.vocab["[PAD]"]
        self.unk_id = self.vocab["[UNK]"]
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.vocab_size = len(self.vocab)
        self._cache_size = cache_size
        # raw word -> subword ids, covering normalize+split+wordpiece of a
        # whitespace-delimited chunk (the hot-path memo)
        self._cache: dict[str, list[int]] = {}

    # -- normalization (BertNormalizer semantics) --------------------------
    def _normalize(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_cjk(cp):
                out.append(" ")
                out.append(ch)
                out.append(" ")
            elif ch.isspace():
                out.append(" ")
            else:
                out.append(ch)
        text = "".join(out)
        if self.lowercase:
            text = text.lower()
            # strip accents (BertNormalizer couples this to lowercase)
            text = "".join(
                ch
                for ch in unicodedata.normalize("NFD", text)
                if unicodedata.category(ch) != "Mn"
            )
        return text

    def _split_punct(self, word: str) -> list[str]:
        pieces: list[str] = []
        cur: list[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if cur:
                    pieces.append("".join(cur))
                    cur = []
                pieces.append(ch)
            else:
                cur.append(ch)
        if cur:
            pieces.append("".join(cur))
        return pieces

    # -- greedy longest-match-first WordPiece ------------------------------
    def _wordpiece(self, token: str) -> list[int]:
        if len(token) > _MAX_WORD_CHARS:
            return [self.unk_id]
        vocab = self.vocab
        ids: list[int] = []
        start = 0
        n = len(token)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                cur = vocab.get(sub)
                if cur is not None:
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def _word_ids(self, raw_word: str) -> list[int]:
        ids = self._cache.get(raw_word)
        if ids is not None:
            return ids
        normalized = self._normalize(raw_word)
        ids = []
        for chunk in normalized.split():
            for piece in self._split_punct(chunk):
                ids.extend(self._wordpiece(piece))
        if len(self._cache) < self._cache_size:
            self._cache[raw_word] = ids
        return ids

    def tokenize_ids(self, text: str, max_len: int) -> list[int]:
        ids: list[int] = [self.cls_id]
        budget = max_len - 2
        for raw_word in text.split():
            if len(ids) - 1 >= budget:
                break
            ids.extend(self._word_ids(raw_word))
        del ids[budget + 1 :]
        ids.append(self.sep_id)
        return ids

    def __call__(
        self, texts, max_length: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(ids [n, L], mask [n, L]) padded to the longest sequence (callers
        bucket-pad to stable shapes)."""
        max_len = max_length or self.max_length
        seqs = [self.tokenize_ids(t, max_len) for t in texts]
        longest = max((len(s) for s in seqs), default=1)
        ids_arr = np.full((len(seqs), longest), self.pad_id, np.int32)
        mask = np.zeros((len(seqs), longest), np.int32)
        for i, s in enumerate(seqs):
            ids_arr[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return ids_arr, mask
