"""pathway_tpu_torch — the PyTorch / CUDA port of pathway_tpu's live-RAG
device path, for NVIDIA Hopper (H100).

WordPiece tokenizer -> bge-small sentence encoder -> fused ingest into a
device-resident brute-force KNN shard -> serving through ``QueryEngine``
and ``MicroBatcher``. On CUDA the index search runs a fused KNN kernel
written by hand in CUDA C++ for ``sm_90a`` (``csrc/fused_knn.cu``), built
with ``nvcc`` at first use. Entry points run on the card unless the
caller passes ``device="cpu"``.

This package imports ``torch`` and numpy, never JAX or ``pathway_tpu``.
"""

from pathway_tpu_torch.internals.device import resolve_device
from pathway_tpu_torch.models import (
    EncoderConfig,
    SentenceEncoder,
    TransformerEncoder,
    flax_params_to_torch,
    get_tokenizer,
    init_params,
)
from pathway_tpu_torch.ops import (
    IngestPipeline,
    KnnShard,
    Metric,
    MicroBatcher,
    QueryEngine,
    chunked_topk_scores,
    fused_topk_scores,
    masked_topk,
    merge_topk,
)

__all__ = [
    "EncoderConfig",
    "IngestPipeline",
    "KnnShard",
    "Metric",
    "MicroBatcher",
    "QueryEngine",
    "SentenceEncoder",
    "TransformerEncoder",
    "chunked_topk_scores",
    "flax_params_to_torch",
    "fused_topk_scores",
    "get_tokenizer",
    "init_params",
    "masked_topk",
    "merge_topk",
    "resolve_device",
]
