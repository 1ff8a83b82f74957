"""The serve step's share of the card's bf16 peak, in percent: useful
FLOPs (the encoder at each query's own length, and 2·Q·n·d a search over
the n live rows) over the device seconds of the sites ``encoder.forward``
and ``knn.fused`` times the peak (``rag_bench/arith.py``)."""

from rag_bench import arith


def read(probe):
    enc, knn = probe.site("encoder.forward"), probe.site("knn.fused")
    if enc is None or knn is None:
        return None
    c = probe.cfg
    flops = arith.encoder_flops(c["num_hidden_layers"], c["hidden_size"],
                                c["intermediate_size"], probe.token_lengths())
    flops += sum(arith.knn_flops(q, probe.live_rows, c["hidden_size"])
                 for q in probe.batches)
    return 100.0 * flops / ((enc[1] + knn[1]) * arith.BF16)
