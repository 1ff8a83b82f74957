"""pw.indexing — retrieval indexes (reference:
python/pathway/stdlib/indexing/__init__.py; SURVEY §2.4).

Device-first: KNN retrieval runs on fused matmul+top-k shards on the card
(pathway_tpu_torch.ops) instead of the reference's per-worker replicated
host indexes.
"""

from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25, TantivyBM25Factory
from pathway_tpu_torch.stdlib.indexing.colnames import _INDEX_REPLY, _MATCHED_ID, _SCORE
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.hybrid_index import HybridIndex, HybridIndexFactory
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    BruteForceKnnFactory,
    UsearchKnn,
    UsearchKnnFactory,
)
from pathway_tpu_torch.stdlib.indexing.lsh_knn import LshKnn, LshKnnFactory
from pathway_tpu_torch.stdlib.indexing.retrievers import InnerIndex, InnerIndexFactory
from pathway_tpu_torch.stdlib.indexing.vector_document_index import (
    default_brute_force_knn_document_index,
    default_usearch_knn_document_index,
)
from pathway_tpu_torch.stdlib.indexing.full_text_document_index import (
    default_full_text_document_index,
)

__all__ = [
    "DataIndex",
    "InnerIndex",
    "InnerIndexFactory",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "UsearchKnn",
    "UsearchKnnFactory",
    "LshKnn",
    "LshKnnFactory",
    "TantivyBM25",
    "TantivyBM25Factory",
    "HybridIndex",
    "HybridIndexFactory",
    "default_brute_force_knn_document_index",
    "default_usearch_knn_document_index",
    "default_full_text_document_index",
]
