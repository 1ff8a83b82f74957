"""The yardstick's arithmetic: peaks, FLOPs and the KNN bound.

Frozen copies, each counted once here and never imported from the port:

- ``BF16``, ``TF32``, ``HBM``: NVIDIA's H100 SXM data sheet, dense, at the
  700 W limit, as
  ``pathway_tpu_torch/internals/device.py`` ``_PEAK_TABLE`` has them;
- ``encoder_flops``: the per-token count of
  ``pathway_tpu_torch/models/encoder.py`` ``forward_flops_per_token``,
  taken per sequence at its own length (the port counts padded tokens);
- ``knn_bound_s``: the idea of ``pathway_tpu_torch/ops/fused_knn.py``
  ``fused_knn_bound``, counting live rows (not the capacity) and one
  output list (not one per split).
"""

from __future__ import annotations

from typing import Iterable

# dense bf16 FLOP/s, TF32 FLOP/s and HBM bytes/s of the H100 SXM
BF16, TF32, HBM = 989e12, 495e12, 3.35e12
# TF32 passes of the KNN scan at each precision of the port
PASSES = {"highest": 3, "default": 1}


def encoder_flops(layers: int, hidden: int, mlp: int, lengths: Iterable[int]) -> float:
    """FLOPs of a forward over sequences of the given real lengths: per
    layer and sequence of length L, L·(8h² + 4h·mlp) for the four
    projections and the MLP pair, and 4·L²·h for scores and weighted
    values. Embeddings, LayerNorms and pooling are O(L·h) and left out."""
    h = float(hidden)
    total = 0.0
    for L in lengths:
        L = float(L)
        total += L * (8.0 * h * h + 4.0 * h * mlp) + 4.0 * L * L * h
    return layers * total


def knn_flops(q: int, n: int, d: int) -> float:
    """The score product's FLOPs: 2·Q·n·d over n live rows."""
    return 2.0 * q * n * d


def knn_bound_s(q: int, n: int, d: int, k: int, precision: str) -> float:
    """The least time one search of Q queries over n live rows can take:
    the larger of its bytes (rows, queries, the valid mask read once, the
    [Q, k] values and slots written once) at HBM bandwidth and its
    products at the TF32 rate, times the passes of the precision."""
    t_bytes = (4.0 * n * d + 4.0 * q * d + n + 8.0 * q * k) / HBM
    t_ops = PASSES[precision] * knn_flops(q, n, d) / TF32
    return max(t_bytes, t_ops)
