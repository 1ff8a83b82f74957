"""pw.graphs — iterative graph algorithms (reference:
python/pathway/stdlib/graphs/: bellman_ford, pagerank,
louvain_communities — dataflow-iteration showcases, SURVEY §2.7)."""

from pathway_tpu_torch.stdlib.graphs.bellman_ford import bellman_ford
from pathway_tpu_torch.stdlib.graphs.pagerank import pagerank
from pathway_tpu_torch.stdlib.graphs.louvain import louvain_level

__all__ = ["bellman_ford", "pagerank", "louvain_level"]
