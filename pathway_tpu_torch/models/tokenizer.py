"""Tokenizers for the sentence encoder.

The port's copy of ``pathway_tpu/models/tokenizer.py``. ``HashTokenizer``
is a deterministic, dependency-free hashing tokenizer (lowercase word +
sub-word shingles hashed into the vocab) used for benchmarks and tests —
embedding throughput does not depend on tokenizer quality, only on token
counts. ``get_tokenizer`` prefers a local HuggingFace tokenizer, then the
trained WordPiece vocab asset, then the hashing tokenizer. ``transformers``
is imported only when a HuggingFace tokenizer is asked for: the main path
does not need it.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
_RESERVED = 3


def _hash_token(tok: str, vocab_size: int) -> int:
    h = int.from_bytes(hashlib.blake2b(tok.encode(), digest_size=8).digest(), "little")
    return _RESERVED + (h % (vocab_size - _RESERVED))


class HashTokenizer:
    """Deterministic hashing tokenizer with a BERT-style output contract."""

    def __init__(self, vocab_size: int = 30522, max_length: int = 512):
        self.vocab_size = vocab_size
        self.max_length = max_length
        # word -> ids memo: corpora repeat words heavily, and hashing is
        # the host-side cost that must overlap device compute
        self._word_cache: dict[str, list[int]] = {}

    def _word_ids(self, word: str) -> list[int]:
        ids = self._word_cache.get(word)
        if ids is not None:
            return ids
        if len(word) <= 6:
            ids = [_hash_token(word, self.vocab_size)]
        else:
            # sub-word shingles approximate BPE granularity so long
            # words cost proportionally more tokens, like real BPE
            ids = [
                _hash_token(("##" if i else "") + word[i : i + 6], self.vocab_size)
                for i in range(0, len(word), 6)
            ]
        if len(self._word_cache) < 500_000:
            self._word_cache[word] = ids
        return ids

    def _tokens(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in text.lower().split():
            ids.extend(self._word_ids(word))
        return ids

    def __call__(
        self, texts: list[str], max_length: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (ids [n, L], mask [n, L]) padded to the longest sequence
        (callers bucket-pad to stable shapes)."""
        max_len = max_length or self.max_length
        seqs = []
        for t in texts:
            ids = [CLS_ID] + self._tokens(t)[: max_len - 2] + [SEP_ID]
            seqs.append(ids)
        longest = max((len(s) for s in seqs), default=1)
        ids_arr = np.full((len(texts), longest), PAD_ID, np.int32)
        mask = np.zeros((len(texts), longest), np.int32)
        for i, s in enumerate(seqs):
            ids_arr[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return ids_arr, mask


class _HFTokenizerAdapter:
    def __init__(self, tok, max_length: int):
        self.tok = tok
        self.vocab_size = tok.vocab_size
        self.max_length = max_length

    def __call__(self, texts, max_length=None):
        enc = self.tok(
            list(texts),
            truncation=True,
            max_length=max_length or self.max_length,
            padding="longest",
            return_tensors="np",
        )
        return enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(np.int32)


VOCAB_ASSET = os.path.join(os.path.dirname(__file__), "assets", "wordpiece_vocab.txt")


def get_tokenizer(model_name_or_path: str | None = None, *, vocab_size: int = 30522,
                  max_length: int = 512, prefer: str = "wordpiece"):
    """Resolve the tokenizer, best first:

    1. a local HF checkpoint's own tokenizer (`model_name_or_path`);
    2. the trained WordPiece vocab asset (exact WordPiece algorithm);
    3. the dependency-free HashTokenizer (`prefer="hash"` forces this).
    """
    if model_name_or_path is not None:
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(
                model_name_or_path, local_files_only=True
            )
            return _HFTokenizerAdapter(tok, max_length)
        except Exception:
            pass
    if prefer == "wordpiece" and os.path.exists(VOCAB_ASSET):
        try:
            from pathway_tpu_torch.models.wordpiece import WordPieceTokenizer

            tok = WordPieceTokenizer(VOCAB_ASSET, max_length=max_length)
            # small-vocab models (tiny/test geometries) can't take the
            # asset's ids — their embedding table would be indexed OOB
            if tok.vocab_size <= vocab_size:
                return tok
        except Exception:
            pass
    return HashTokenizer(vocab_size=vocab_size, max_length=max_length)
