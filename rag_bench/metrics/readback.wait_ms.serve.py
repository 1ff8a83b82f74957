"""Mean wall milliseconds a batch of the answer's one device-to-host copy
on a readback thread, which waits for the device (the program's span
``serve.readback``)."""

from rag_bench import spans


def read(probe):
    return spans.mean_ms(probe, "serve.readback")
