"""KNN inner indexes (reference:
python/pathway/stdlib/indexing/nearest_neighbors.py — BruteForceKnn :170,
USearchKnn :65 and their factories).

``BruteForceKnn`` is backed by the device brute-force shard
(pathway_tpu_torch.ops.KnnShard — a padded buffer in the card's memory
searched by the hand-written fused KNN kernel, csrc/fused_knn.cu).
``device=`` picks where the shard lives: None is the card, and without
CUDA the caller passes ``device="cpu"`` (the kernel's plain PyTorch
version). The reference's USearchKnn wraps a host-CPU HNSW
(usearch_integration.rs:20); ``UsearchKnn`` here is backed by the C++
HNSW (native/hnsw.cpp) and falls back to the exact device scan when no
toolchain is present. The mesh-sharded index (``mesh=``,
``PATHWAY_INDEX_SHARDS``) belongs to a later slice of the port and raises
``NotImplementedError`` here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.stdlib.indexing._filters import compile_filter
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndex, InnerIndexFactory


class _FilterErrorLog:
    """A filter predicate that raises is a data error, not an empty
    match: swallowing it silently drops matching rows. Adapters count every failure here and retain the first
    message; ``ExternalIndexNode`` drains the log after each search into
    ``index_filter_errors_total`` and ``pw.global_error_log()``."""

    __slots__ = ("count", "first")

    def __init__(self):
        self.count = 0
        self.first: tuple[str, Any] | None = None

    def note(self, exc: BaseException, key) -> None:
        self.count += 1
        if self.first is None:
            self.first = (
                f"index filter predicate raised {type(exc).__name__}: "
                f"{exc} — matching row dropped from results",
                key,
            )

    def drain(self) -> tuple[int, tuple[str, Any] | None]:
        count, first = self.count, self.first
        self.count = 0
        self.first = None
        return count, first


class _HnswAdapter:
    """C++ HNSW ANN (native/hnsw.cpp — the usearch equivalent,
    usearch_integration.rs:20) behind the adapter contract."""

    def __init__(self, dimension: int, metric: str, *, connectivity: int = 16,
                 expansion_add: int = 128, expansion_search: int = 64):
        from pathway_tpu_torch.native import NativeHnsw

        self.index = NativeHnsw(
            dimension,
            metric,
            M=connectivity or 16,
            ef_build=expansion_add or 128,
            ef_search=expansion_search or 64,
        )
        self.key_to_id: dict[Any, int] = {}
        self.id_to_key: dict[int, Any] = {}
        self.meta: dict[Any, Any] = {}
        # raw vectors retained for operator snapshots (the HNSW graph
        # itself is rebuilt on restore)
        self.vecs: dict[Any, Any] = {}
        self._next = 0
        self.filter_errors = _FilterErrorLog()

    def _id(self, key) -> int:
        i = self.key_to_id.get(key)
        if i is None:
            i = self._next
            self._next += 1
            self.key_to_id[key] = i
            self.id_to_key[i] = key
        return i

    def add(self, key, data, filter_data) -> None:
        vec = np.asarray(data, dtype=np.float32)
        self.index.add(self._id(key), vec)
        self.meta[key] = filter_data
        self.vecs[key] = vec

    def add_batch(self, rows) -> None:
        """One native crossing for a whole delta batch (the per-doc
        ctypes add was the dominant term in ann_recall's index build)."""
        vecs = np.ascontiguousarray(
            [np.asarray(d, np.float32).reshape(-1) for _, d, _ in rows],
            dtype=np.float32,
        )
        ids = [self._id(k) for k, _, _ in rows]
        self.index.add_batch(ids, vecs)
        for (key, _, fdata), vec in zip(rows, vecs):
            self.meta[key] = fdata
            self.vecs[key] = vec

    def remove(self, key) -> None:
        i = self.key_to_id.get(key)
        if i is not None:
            self.index.remove(i)
        self.meta.pop(key, None)
        self.vecs.pop(key, None)

    def remove_batch(self, keys) -> None:
        for key in keys:
            self.remove(key)

    def snapshot_state(self):
        return {"vecs": dict(self.vecs), "meta": dict(self.meta)}

    def load_state(self, state) -> None:
        meta = state["meta"]
        rows = [
            (key, vec, meta.get(key)) for key, vec in state["vecs"].items()
        ]
        if rows:
            self.add_batch(rows)

    def search(self, queries):
        out = []
        for qdata, limit, filt in queries:
            vec = np.asarray(qdata, dtype=np.float32)
            pred = compile_filter(filt) if isinstance(filt, str) else filt
            k = limit if pred is None else max(limit * 4, limit)
            n_total = len(self.index)
            while True:
                asked = min(k, max(n_total, 1))
                raw = self.index.search(vec, asked)
                hits = []
                for i, score in raw:
                    key = self.id_to_key.get(i)
                    if key is None:
                        continue
                    if pred is not None:
                        try:
                            if not pred(self.meta.get(key)):
                                continue
                        except Exception as exc:
                            # counted + surfaced by the index node — a
                            # buggy filter must not silently starve
                            # results
                            self.filter_errors.note(exc, key)
                            continue
                    hits.append((key, score))
                    if len(hits) == limit:
                        break
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


_SHARDED_SLICE = (
    "the sharded KNN index (parallel/sharded_knn.py, parallel/mesh.py) "
    "is not ported to pathway_tpu_torch yet; it comes with the "
    "sharded-index slice of the port"
)
_SNAPSHOT_SLICE = (
    "index snapshots of the device KNN shard are not ported to "
    "pathway_tpu_torch yet; they come with the index-snapshot slice of "
    "the port"
)


def _auto_mesh():
    """PATHWAY_INDEX_SHARDS=N (N>1) asks for the sharded index over N
    cards — one shard of the corpus per card. Returns None (single-card
    KnnShard) when unset, 0/1, malformed, or when fewer than N CUDA
    devices are visible; raises NotImplementedError otherwise (the
    sharded index is a later slice)."""
    raw = os.environ.get("PATHWAY_INDEX_SHARDS", "").strip()
    if not raw:
        return None
    try:
        n = int(raw)
    except ValueError:
        return None
    if n <= 1:
        return None
    import torch

    if torch.cuda.device_count() < n:
        return None
    raise NotImplementedError(f"PATHWAY_INDEX_SHARDS={n}: {_SHARDED_SLICE}")


class _KnnAdapter:
    """ExternalIndexAdapter over a (sharded) KNN shard with filter-aware
    over-querying (reference: DerivedFilteredSearchIndex retries with
    growing k when a filter starves results, external_integration/mod.rs)."""

    def __init__(self, dimension: int, metric: str, mesh=None,
                 capacity: int = 128, device: Any = None):
        if mesh is None:
            mesh = _auto_mesh()
        if mesh is not None:
            raise NotImplementedError(f"mesh={mesh!r}: {_SHARDED_SLICE}")
        from pathway_tpu_torch.ops.knn import KnnShard

        self.shard = KnnShard(dimension, metric, capacity=capacity, device=device)
        self.meta: dict[Any, Any] = {}
        self.filter_errors = _FilterErrorLog()

    def device_sites(self) -> tuple:
        """Registered device-site names this adapter dispatches through
       : the Device Doctor's reachability hook, forwarded
        from the wrapped shard (knn.write/search or the sharded pair)."""
        return tuple(getattr(self.shard, "device_sites", ()) or ())

    def add(self, key, data, filter_data) -> None:
        vec = np.asarray(data, dtype=np.float32)
        self.shard.add([key], vec[None, :] if vec.ndim == 1 else vec)
        self.meta[key] = filter_data

    def add_batch(self, rows) -> None:
        """One slot-write dispatch per consolidated delta batch instead
        of one per row."""
        keys = [k for k, _, _ in rows]
        vecs = np.stack(
            [np.asarray(d, np.float32).reshape(-1) for _, d, _ in rows]
        )
        self.shard.add(keys, vecs)
        for key, _, fdata in rows:
            self.meta[key] = fdata

    def remove(self, key) -> None:
        self.shard.remove([key])
        self.meta.pop(key, None)

    def remove_batch(self, keys) -> None:
        self.shard.remove(list(keys))
        for key in keys:
            self.meta.pop(key, None)

    # -- operator-snapshot hooks -------------------------------------------
    def snapshot_state(self):
        """Operator snapshots of the device index (epoch-aligned delta
        segments) are a later slice of the port."""
        raise NotImplementedError(_SNAPSHOT_SLICE)

    def load_state(self, state) -> None:
        raise NotImplementedError(_SNAPSHOT_SLICE)

    def search(self, queries):
        out = []
        for qdata, limit, filt in queries:
            vec = np.asarray(qdata, dtype=np.float32)[None, :]
            pred = compile_filter(filt) if isinstance(filt, str) else filt
            if pred is None:
                hits = self.shard.search(vec, limit)[0]
            else:
                # over-query, growing k until the filter stops starving us
                k = max(limit * 4, limit)
                n_total = len(self.shard)
                while True:
                    raw = self.shard.search(vec, min(k, n_total))[0]
                    hits = [
                        (key, score)
                        for key, score in raw
                        if self._match(pred, key)
                    ][:limit]
                    if len(hits) >= limit or len(raw) >= n_total:
                        break
                    k *= 4
            out.append(
                (
                    tuple(key for key, _ in hits),
                    tuple(score for _, score in hits),
                )
            )
        return out

    def _match(self, pred, key) -> bool:
        meta = self.meta.get(key)
        try:
            return bool(pred(meta))
        except Exception as exc:
            # counted + surfaced by the index node — a buggy filter must
            # not silently starve results
            self.filter_errors.note(exc, key)
            return False


def _calculate_embeddings(column: ColumnReference, embedder):
    """Apply an embedder UDF to a text column, materializing the embedded
    column on the column's table (reference: nearest_neighbors.py:52)."""
    if embedder is None:
        return column
    table = column.table.with_columns(_pw_embedded_column=embedder(column))
    return table["_pw_embedded_column"]


@dataclass(frozen=True)
class _EmbeddingKnn(InnerIndex):
    dimensions: int = 0
    reserved_space: int = 128
    metric: str = "cos"  # cos | l2sq | dot
    embedder: Any = None
    mesh: Any = None
    device: Any = None  # None = the card

    def make_adapter(self):
        return _KnnAdapter(
            self.dimensions, self.metric,
            mesh=self.mesh, capacity=self.reserved_space, device=self.device,
        )

    def _lower_query(self, query_column, number_of_matches, metadata_filter, mode):
        query_column = _calculate_embeddings(query_column, self.embedder)
        return super()._lower_query(
            query_column, number_of_matches, metadata_filter, mode
        )


@dataclass(frozen=True)
class BruteForceKnn(_EmbeddingKnn):
    """Exact KNN on the device shard (reference: nearest_neighbors.py:170;
    native core brute_force_knn_integration.rs:22)."""


@dataclass(frozen=True)
class UsearchKnn(_EmbeddingKnn):
    """HNSW ANN (reference: nearest_neighbors.py:65, native core
    usearch_integration.rs). Backed by the C++ HNSW (native/hnsw.cpp);
    falls back to the exact device scan when no toolchain is present."""

    connectivity: int = 0
    expansion_add: int = 0
    expansion_search: int = 0

    def make_adapter(self):
        from pathway_tpu_torch.native import available

        if available():
            return _HnswAdapter(
                self.dimensions,
                self.metric,
                connectivity=self.connectivity,
                expansion_add=self.expansion_add,
                expansion_search=self.expansion_search,
            )
        return super().make_adapter()


@dataclass
class BruteForceKnnFactory(InnerIndexFactory):
    dimensions: int | None = None
    reserved_space: int = 128
    metric: str = "cos"
    embedder: Any = None
    mesh: Any = None
    device: Any = None  # None = the card

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex:
        return BruteForceKnn(
            data_column=_calculate_embeddings(data_column, self.embedder),
            metadata_column=metadata_column,
            dimensions=self.dimensions or 0,
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
            mesh=self.mesh,
            device=self.device,
        )


@dataclass
class UsearchKnnFactory(InnerIndexFactory):
    dimensions: int | None = None
    reserved_space: int = 128
    metric: str = "cos"
    connectivity: int = 0
    expansion_add: int = 0
    expansion_search: int = 0
    embedder: Any = None
    mesh: Any = None
    device: Any = None  # the exact fallback's device; None = the card

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex:
        return UsearchKnn(
            data_column=_calculate_embeddings(data_column, self.embedder),
            metadata_column=metadata_column,
            dimensions=self.dimensions or 0,
            reserved_space=self.reserved_space,
            metric=self.metric,
            connectivity=self.connectivity,
            expansion_add=self.expansion_add,
            expansion_search=self.expansion_search,
            embedder=self.embedder,
            mesh=self.mesh,
            device=self.device,
        )
