"""pw.ml (reference: python/pathway/stdlib/ml/ — LSH KNN index,
classifiers, smart_table_ops)."""

from pathway_tpu_torch.stdlib.ml import classifiers, hmm, smart_table_ops
from pathway_tpu_torch.stdlib.ml.index import KNNIndex

__all__ = ["KNNIndex", "classifiers", "hmm", "smart_table_ops"]
