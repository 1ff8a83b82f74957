"""Mean wall milliseconds a batch of the encoder's token copies to the
card, which wait for the stream (the program's span ``encoder.h2d``)."""

from rag_bench import spans


def read(probe):
    return spans.mean_ms(probe, "encoder.h2d")
