"""The reference's tokenizer: BERT's uncased WordPiece over the frozen vocab.

A frozen copy of the algorithm of ``pathway_tpu_torch/models/wordpiece.py``
(itself HuggingFace ``BertTokenizerFast``'s: BertNormalizer, then
BertPreTokenizer, then greedy longest-match WordPiece), without its memo,
over ``data/vocab.txt``, the frozen copy of the port's vocab asset. It
imports nothing of the program.
"""

from __future__ import annotations

import unicodedata

import numpy as np

from rag_bench.textgen import VOCAB

_MAX_WORD_CHARS = 100


def _punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in (
        (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F)))


class ReferenceTokenizer:
    """texts -> (ids [n, L] int64, lengths [n]) with [CLS] ... [SEP]."""

    def __init__(self, vocab_file: str = VOCAB, max_len: int = 512):
        with open(vocab_file, encoding="utf-8") as f:
            self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.max_len = max_len
        self.unk = self.vocab["[UNK]"]
        self.cls = self.vocab["[CLS]"]
        self.sep = self.vocab["[SEP]"]
        self.pad = self.vocab["[PAD]"]

    def _normalize(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _control(ch):
                continue
            if _cjk(cp):
                out.append(f" {ch} ")
            elif ch.isspace():
                out.append(" ")
            else:
                out.append(ch)
        text = "".join(out).lower()
        return "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")

    def _pieces(self, word: str) -> list[int]:
        if len(word) > _MAX_WORD_CHARS:
            return [self.unk]
        ids, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                cur = self.vocab.get(sub)
                if cur is not None:
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            ids.append(cur)
            start = end
        return ids

    def ids(self, text: str) -> list[int]:
        out = [self.cls]
        for raw in text.split():
            for chunk in self._normalize(raw).split():
                piece = []
                for ch in chunk:
                    if _punct(ch):
                        if piece:
                            out.extend(self._pieces("".join(piece)))
                            piece = []
                        out.extend(self._pieces(ch))
                    else:
                        piece.append(ch)
                if piece:
                    out.extend(self._pieces("".join(piece)))
        del out[self.max_len - 1:]
        out.append(self.sep)
        return out

    def __call__(self, texts) -> tuple[np.ndarray, np.ndarray]:
        seqs = [self.ids(t) for t in texts]
        lengths = np.array([len(s) for s in seqs], np.int64)
        ids = np.full((len(seqs), int(lengths.max(initial=1))), self.pad, np.int64)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
        return ids, lengths
