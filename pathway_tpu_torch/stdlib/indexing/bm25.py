"""Full-text BM25 index (reference:
python/pathway/stdlib/indexing/bm25.py:41 TantivyBM25 — tantivy-backed in
the native core, src/external_integration/tantivy_integration.rs:16).

Here the inverted index is an in-process posting-list structure (term ->
{doc: tf}) scored with Okapi BM25. Class names keep reference parity so
templates configuring `TantivyBM25` run unchanged.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.stdlib.indexing._filters import compile_filter
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndex, InnerIndexFactory

_WORD_RE = re.compile(r"[A-Za-z0-9_]+")


def _tokenize(text: str) -> list[str]:
    return [w.lower() for w in _WORD_RE.findall(str(text))]


class _NativeBm25Adapter:
    """C++ posting lists (native/bm25.cpp) behind the adapter contract;
    128-bit Pointers are mapped to dense int64 ids (reference:
    KeyToU64IdMapper, external_integration/mod.rs)."""

    def __init__(self, k1: float = 1.2, b: float = 0.75):
        from pathway_tpu_torch.native import NativeBm25

        self.index = NativeBm25(k1, b)
        self.key_to_id: dict[Any, int] = {}
        self.id_to_key: dict[int, Any] = {}
        self.meta: dict[Any, Any] = {}
        # raw texts retained for operator snapshots (C++ postings rebuild)
        self.texts: dict[Any, str] = {}
        self._next = 0

    def _id(self, key) -> int:
        i = self.key_to_id.get(key)
        if i is None:
            i = self._next
            self._next += 1
            self.key_to_id[key] = i
            self.id_to_key[i] = key
        return i

    def add(self, key, data, filter_data) -> None:
        self.index.add(self._id(key), str(data))
        self.meta[key] = filter_data
        self.texts[key] = str(data)

    def remove(self, key) -> None:
        i = self.key_to_id.get(key)
        if i is not None:
            self.index.remove(i)
        self.meta.pop(key, None)
        self.texts.pop(key, None)

    def snapshot_state(self):
        return {"texts": dict(self.texts), "meta": dict(self.meta)}

    def load_state(self, state) -> None:
        for key, text in state["texts"].items():
            self.add(key, text, state["meta"].get(key))

    def search(self, queries):
        out = []
        n_total = len(self.index)
        for qdata, limit, filt in queries:
            pred = compile_filter(filt) if isinstance(filt, str) else filt
            k = limit if pred is None else max(limit * 4, limit)
            hits: list = []
            while True:
                asked = min(k, max(n_total, 1))
                raw = self.index.search(str(qdata), asked)
                hits = []
                for i, score in raw:
                    key = self.id_to_key.get(i)
                    if key is None:
                        continue
                    if pred is not None:
                        try:
                            if not pred(self.meta.get(key)):
                                continue
                        except Exception:
                            continue
                    hits.append((key, score))
                    if len(hits) == limit:
                        break
                # stop growing once satisfied OR the index returned fewer
                # candidates than asked (it has no more matching docs)
                if pred is None or len(hits) >= limit or len(raw) < asked:
                    break
                k *= 4
            out.append(
                (
                    tuple(key for key, _ in hits),
                    tuple(s for _, s in hits),
                )
            )
        return out


class _Bm25Adapter:
    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = k1
        self.b = b
        self.postings: dict[str, dict[Any, int]] = {}
        self.doc_len: dict[Any, int] = {}
        self.meta: dict[Any, Any] = {}

    def snapshot_state(self):
        return {
            "postings": self.postings,
            "doc_len": self.doc_len,
            "meta": self.meta,
        }

    def load_state(self, state) -> None:
        self.postings = state["postings"]
        self.doc_len = state["doc_len"]
        self.meta = state["meta"]

    def add(self, key, data, filter_data) -> None:
        if key in self.doc_len:
            self.remove(key)
        toks = _tokenize(data)
        self.doc_len[key] = len(toks)
        self.meta[key] = filter_data
        for tok in toks:
            d = self.postings.setdefault(tok, {})
            d[key] = d.get(key, 0) + 1

    def remove(self, key) -> None:
        if key not in self.doc_len:
            return
        del self.doc_len[key]
        self.meta.pop(key, None)
        for tok, d in list(self.postings.items()):
            if key in d:
                del d[key]
                if not d:
                    del self.postings[tok]

    def _scores(self, query: str) -> dict[Any, float]:
        n = len(self.doc_len)
        if n == 0:
            return {}
        avg_len = sum(self.doc_len.values()) / n
        scores: dict[Any, float] = {}
        for tok in _tokenize(query):
            plist = self.postings.get(tok)
            if not plist:
                continue
            idf = math.log(1.0 + (n - len(plist) + 0.5) / (len(plist) + 0.5))
            for key, tf in plist.items():
                dl = self.doc_len[key]
                denom = tf + self.k1 * (1 - self.b + self.b * dl / avg_len)
                scores[key] = scores.get(key, 0.0) + idf * tf * (self.k1 + 1) / denom
        return scores

    def search(self, queries):
        out = []
        for qdata, limit, filt in queries:
            pred = compile_filter(filt) if isinstance(filt, str) else filt
            scored = sorted(
                self._scores(str(qdata)).items(), key=lambda kv: (-kv[1], repr(kv[0]))
            )
            hits = []
            for key, score in scored:
                if pred is not None:
                    try:
                        if not pred(self.meta.get(key)):
                            continue
                    except Exception:
                        continue
                hits.append((key, score))
                if len(hits) == limit:
                    break
            out.append(
                (
                    tuple(k for k, _ in hits),
                    tuple(s for _, s in hits),
                )
            )
        return out


@dataclass(frozen=True)
class TantivyBM25(InnerIndex):
    """BM25 text index (reference name kept for config compatibility)."""

    ram_budget: int = 50_000_000  # accepted, unused (no tantivy here)
    in_memory_index: bool = True
    k1: float = 1.2
    b: float = 0.75

    def make_adapter(self):
        from pathway_tpu_torch.native import available

        if available():
            return _NativeBm25Adapter(k1=self.k1, b=self.b)
        return _Bm25Adapter(k1=self.k1, b=self.b)


@dataclass
class TantivyBM25Factory(InnerIndexFactory):
    ram_budget: int = 50_000_000
    in_memory_index: bool = True

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex:
        return TantivyBM25(
            data_column=data_column,
            metadata_column=metadata_column,
            ram_budget=self.ram_budget,
            in_memory_index=self.in_memory_index,
        )
