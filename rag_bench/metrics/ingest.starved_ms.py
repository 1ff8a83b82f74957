"""Mean wall milliseconds a batch that ``IngestPipeline.run``'s consumer
waited for the producer to stage it (the program's span
``ingest.wait_staged``): the device fed too slowly by the host."""

from rag_bench import spans


def read(probe):
    got = [s for s in spans.spans(probe, "ingest.wait_staged") if s[3] is not None]
    if not got:
        return None
    return sum(t1 - t0 for t0, t1, *_ in got) / len(got) / 1e6
