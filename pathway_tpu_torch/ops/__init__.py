"""pathway_tpu_torch.ops — the live-RAG device path in PyTorch: the
device-resident KNN shard, its hand-written fused KNN kernel for Hopper,
the fused ingest chain and the serving engine (the counterparts of
the JAX package's ``ops``)."""

from pathway_tpu_torch.ops.fused_knn import fused_topk_scores
from pathway_tpu_torch.ops.ingest import IngestPipeline
from pathway_tpu_torch.ops.knn import KnnShard, Metric
from pathway_tpu_torch.ops.query_engine import MicroBatcher, QueryEngine
from pathway_tpu_torch.ops.topk import (
    chunked_topk_scores,
    masked_topk,
    merge_topk,
)

__all__ = [
    "IngestPipeline",
    "KnnShard",
    "Metric",
    "MicroBatcher",
    "QueryEngine",
    "chunked_topk_scores",
    "fused_topk_scores",
    "masked_topk",
    "merge_topk",
]
