"""KNN-LSH classifiers (reference:
python/pathway/stdlib/ml/classifiers/_knn_lsh.py:64-326 —
knn_lsh_classifier_train returning a query closure; classification via
majority vote)."""

from __future__ import annotations

from collections import Counter

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import apply_with_type


def knn_lsh_classifier_train(
    data, L: int = 20, type: str = "euclidean", **lsh_params
):
    """Trains (declares) an LSH index over `data` (columns: data, label?)
    and returns a closure ``classify(queries, k)`` / ``query(queries, k)``
    (reference: _knn_lsh.py knn_lsh_classifier_train)."""
    from pathway_tpu_torch.stdlib.ml.index import KNNIndex

    n_dimensions = lsh_params.pop("d", None) or lsh_params.pop(
        "n_dimensions", None
    )
    if n_dimensions is None:
        raise ValueError("pass d=<embedding dimension>")
    index = KNNIndex(
        data.data,
        data,
        n_dimensions=n_dimensions,
        n_or=L,
        n_and=lsh_params.pop("M", 10),
        bucket_length=lsh_params.pop("A", 10.0),
        distance_type=type,
    )

    def classify(queries, k: int = 3):
        labels = index.get_nearest_items(
            queries.data, k=k, collapse_rows=True
        ).select(predicted_class=_majority(queries, "label"))
        return labels

    def _majority(queries, label_col):
        def vote(labels) -> object:
            if not labels:
                return None
            return Counter(labels).most_common(1)[0][0]

        import pathway_tpu_torch as pw

        return apply_with_type(vote, dt.ANY, pw.this[label_col])

    classify.index = index
    return classify


def knn_lsh_train(data, **kwargs):
    return knn_lsh_classifier_train(data, **kwargs)
