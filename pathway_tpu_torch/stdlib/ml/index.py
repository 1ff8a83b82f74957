"""Pure-dataflow LSH KNN index (reference:
python/pathway/stdlib/ml/index.py:9-301 KNNIndex +
classifiers/_knn_lsh.py:64-326).

Unlike the external brute-force index (replicated adapter state), this one
is ordinary incremental dataflow end to end: bucket assignments flatten into
band-keyed rows, queries join their buckets, and a final batched UDF scores
the candidate set exactly — so index updates retract/revise earlier answers
through the standard dataflow mechanics, and all state is engine state."""

from __future__ import annotations

import json as _json
from typing import Any

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import apply_with_type, coalesce, make_tuple
from pathway_tpu_torch.stdlib.indexing._filters import compile_filter
from pathway_tpu_torch.stdlib.ml._lsh import (
    generate_cosine_lsh_bucketer,
    generate_euclidean_lsh_bucketer,
)


def _build_reply_table(
    data_embedding,
    data_table,
    query_embedding,
    *,
    n_dimensions: int,
    n_or: int,
    n_and: int,
    bucket_length: float,
    distance_type: str,
    metadata=None,
    number_of_matches=3,
    metadata_filter=None,
):
    """Query table + `_pw_index_reply` column ((id, -distance) pairs)."""
    import pathway_tpu_torch as pw

    if distance_type == "euclidean":
        bucketer = generate_euclidean_lsh_bucketer(
            n_dimensions, n_and, n_or, bucket_length
        )
    elif distance_type == "cosine":
        bucketer = generate_cosine_lsh_bucketer(n_dimensions, n_and, n_or)
    else:
        raise ValueError(f"unknown distance_type {distance_type!r}")

    query_table = query_embedding.table

    def buckets(v) -> tuple:
        return bucketer(v)

    meta_expr = (
        expr_mod.smart_coerce(metadata)
        if metadata is not None
        else expr_mod.ColumnConstExpression(None)
    )
    data_b = data_table.select(
        _pw_emb=data_embedding,
        _pw_meta=meta_expr,
        _pw_bands=apply_with_type(buckets, dt.ANY, data_embedding),
    )
    # capture the ORIGINAL row id before flatten re-keys per band
    data_b = data_b.with_columns(_pw_did=data_b.id)
    data_b = data_b.flatten(data_b["_pw_bands"])

    q_b = query_table.select(
        _pw_qemb=query_embedding,
        _pw_bands=apply_with_type(buckets, dt.ANY, query_embedding),
        _pw_limit=expr_mod.smart_coerce(number_of_matches),
        _pw_filter=(
            expr_mod.smart_coerce(metadata_filter)
            if metadata_filter is not None
            else expr_mod.ColumnConstExpression(None)
        ),
    )
    q_b = q_b.with_columns(_pw_qid=q_b.id)
    q_b = q_b.flatten(q_b["_pw_bands"])

    joined = q_b.join(
        data_b, q_b["_pw_bands"] == data_b["_pw_bands"]
    ).select(
        q_b["_pw_qid"],
        data_id=data_b["_pw_did"],
        emb=data_b["_pw_emb"],
        meta=data_b["_pw_meta"],
    )
    # dedupe candidate pairs found in several bands
    pairs = joined.groupby(
        joined["_pw_qid"], joined.data_id
    ).reduce(
        joined["_pw_qid"],
        joined.data_id,
        emb=pw.reducers.any(joined.emb),
        meta=pw.reducers.any(joined.meta),
    )
    candidates = pairs.groupby(pairs["_pw_qid"]).reduce(
        pairs["_pw_qid"],
        cands=pw.reducers.tuple(
            make_tuple(pairs.data_id, pairs.emb, pairs.meta)
        ),
    )

    dist = distance_type

    def topk(qemb, limit, filt, cands) -> tuple:
        if not cands:
            return ()
        pred = compile_filter(filt) if isinstance(filt, str) else None
        q = np.asarray(qemb, dtype=np.float64)
        scored = []
        for data_id, emb, meta in cands:
            if pred is not None:
                try:
                    if not pred(meta):
                        continue
                except Exception:
                    continue
            v = np.asarray(emb, dtype=np.float64)
            if dist == "euclidean":
                d_val = float(((q - v) ** 2).sum())
            else:
                qa = q / (np.linalg.norm(q) or 1.0)
                va = v / (np.linalg.norm(v) or 1.0)
                d_val = 1.0 - float(qa @ va)
            scored.append((d_val, data_id))
        scored.sort(key=lambda s: (s[0], repr(s[1])))
        return tuple(
            (data_id, -d_val) for d_val, data_id in scored[: int(limit)]
        )

    base = query_table.with_columns(
        _pw_qemb=query_embedding,
        _pw_limit=expr_mod.smart_coerce(number_of_matches),
        _pw_filter=(
            expr_mod.smart_coerce(metadata_filter)
            if metadata_filter is not None
            else expr_mod.ColumnConstExpression(None)
        ),
    )
    with_cands = base.join(
        candidates,
        base.id == candidates["_pw_qid"],
        how="left",
        id=base.id,
    ).select(
        *base,
        cands=candidates.cands,
    )
    reply = with_cands.select(
        *[with_cands[c] for c in query_table.column_names()],
        _pw_index_reply=apply_with_type(
            topk,
            dt.ANY,
            with_cands["_pw_qemb"],
            with_cands["_pw_limit"],
            with_cands["_pw_filter"],
            with_cands.cands,
        ),
    )
    return reply


class KNNIndex:
    """Legacy LSH KNN API (reference: stdlib/ml/index.py:9 KNNIndex)."""

    def __init__(
        self,
        data_embedding,
        data,
        *,
        n_dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        metadata=None,
    ):
        self.data_embedding = data_embedding
        self.data = data
        self.n_dimensions = n_dimensions
        self.n_or = n_or
        self.n_and = n_and
        self.bucket_length = bucket_length
        self.distance_type = distance_type
        self.metadata = metadata

    def _reply(self, query_embedding, number_of_matches, metadata_filter):
        return _build_reply_table(
            self.data_embedding,
            self.data,
            query_embedding,
            n_dimensions=self.n_dimensions,
            n_or=self.n_or,
            n_and=self.n_and,
            bucket_length=self.bucket_length,
            distance_type=self.distance_type,
            metadata=self.metadata,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
        )

    def get_nearest_items(
        self, query_embedding, k=3, collapse_rows=True, metadata_filter=None
    ):
        from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex

        reply = self._reply(query_embedding, k, metadata_filter)
        index = DataIndex(self.data, _PrecomputedInner(reply))
        return index._repack_results(
            reply, query_embedding.table, collapse_rows, as_of_now=False
        )

    def get_nearest_items_asof_now(
        self, query_embedding, k=3, collapse_rows=True, metadata_filter=None
    ):
        from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex

        reply = self._reply(query_embedding, k, metadata_filter)
        index = DataIndex(self.data, _PrecomputedInner(reply))
        return index._repack_results(
            reply, query_embedding.table, collapse_rows, as_of_now=True
        )


class _PrecomputedInner:
    """DataIndex shim when the reply table is already built."""

    def __init__(self, reply):
        self.reply = reply
