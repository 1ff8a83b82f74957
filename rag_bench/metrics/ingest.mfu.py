"""The ingest window's share of the card's bf16 peak, in percent: the
encoder's FLOPs at each passage's own length (``rag_bench/arith.py``)
over the window's seconds times the peak."""

from rag_bench import arith


def read(probe):
    lengths = probe.token_lengths()
    if not lengths or probe.window_s <= 0:
        return None
    c = probe.cfg
    flops = arith.encoder_flops(c["num_hidden_layers"], c["hidden_size"],
                                c["intermediate_size"], lengths)
    return 100.0 * flops / (probe.window_s * arith.BF16)
