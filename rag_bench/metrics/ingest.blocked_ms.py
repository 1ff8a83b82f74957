"""Mean wall milliseconds a batch that ``IngestPipeline.run``'s producer
waited to hand a staged batch over a full queue (the program's span
``ingest.put_staged``): the host ahead of the device."""

from rag_bench import spans


def read(probe):
    return spans.mean_ms(probe, "ingest.put_staged")
