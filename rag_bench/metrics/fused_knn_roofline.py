"""The fused KNN kernel pair's share of its roofline, in percent: the sum
over the window's searches of the least time each could take
(``rag_bench/arith.py`` ``knn_bound_s``: its queries over the live rows)
over the device seconds of the site ``knn.fused``. One search a batch:
the probe's batch sizes give each search's query count."""

from rag_bench import arith


def read(probe):
    got = probe.site("knn.fused")
    if got is None or got[0] != len(probe.batches) or got[1] <= 0:
        return None
    dep = probe.cfg["deployment"]
    d = probe.cfg["hidden_size"]
    bound = sum(arith.knn_bound_s(q, probe.live_rows, d, dep["k"], dep["precision"])
                for q in probe.batches)
    return 100.0 * bound / got[1]
