"""Mean wall milliseconds a batch of the Python key map that shapes the
answers on a readback thread (the program's span ``serve.keymap``)."""

from rag_bench import spans


def read(probe):
    return spans.mean_ms(probe, "serve.keymap")
