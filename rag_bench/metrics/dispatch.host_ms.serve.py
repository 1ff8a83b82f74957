"""Mean wall milliseconds a batch of the collector's whole dispatch
(tokenize, pad, copies, graph launch, search launch: the program's span
``serve.dispatch``)."""

from rag_bench import spans


def read(probe):
    return spans.mean_ms(probe, "serve.dispatch")
