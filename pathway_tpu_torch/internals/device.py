"""Device resolution and the shared shape-bucket functions.

The port's counterpart of ``pathway_tpu/internals/device.py``, trimmed to
what the live-RAG device path needs: the rule that picks the device an
entry point runs on, and copies of the shape-bucket functions the encoder,
the index and the ingest chain pad with (``device.py:369-452`` of the JAX
package). The dispatch records, supervised dispatch, fault points and the
HBM table belong to a later slice.
"""

from __future__ import annotations

from typing import Any

import torch


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card (``cuda``). Without CUDA the caller must ask
    for the CPU by name (``device="cpu"``): an entry point never drops to
    the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pathway_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:  # one spelling per card, so devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def batch_bucket(n: int, floor: int, cap: int) -> int:
    """Pow2 batch bucket from ``floor``, capped — the encoder's batch
    padding (models/encoder.py ``pad_batch``)."""
    b = floor
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def seq_bucket(L: int, cap: int) -> int:
    """Multiple-of-32 sequence bucket (floor 16), capped — the encoder's
    sequence padding."""
    if L <= 16:
        return 16
    return min(((L + 31) // 32) * 32, cap)


def pow2_capacity(n: int, floor: int = 128) -> int:
    """Pow2 index capacity from the 128-slot floor — KnnShard's growth
    schedule."""
    p = floor
    while p < n:
        p *= 2
    return p


def query_pad(n: int) -> int:
    """Pow2 query-batch padding from 1 — the search sites' batch set."""
    p = 1
    while p < n:
        p *= 2
    return p


def knn_search_bucket(
    n: int, capacity: int, k: int, chunk: int | None
) -> tuple:
    """Shape key of one index search: (padded query batch, capacity,
    effective k). Effective k is clamped to the scored block width."""
    k_eff = min(k, capacity, chunk or 8192)
    return (query_pad(n), capacity, k_eff)


def encoder_bucket(nb: int, Lb: int, compact: bool) -> tuple:
    """Shape key of one encoder forward."""
    return (nb, Lb, bool(compact))


def ingest_bucket(nb: int, Lb: int, capacity: int, ids_dtype: str) -> tuple:
    """Shape key of one fused ingest chain (batch bucket x seq bucket x
    index capacity x wire dtype)."""
    return (nb, Lb, capacity, ids_dtype)
