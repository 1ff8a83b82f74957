"""Host milliseconds per call of the encoder's tokenizer in the window,
on the ingest path (the tokenize-ahead thread of
``IngestPipeline.run``)."""


def read(probe):
    if not probe.tokenize:
        return None
    return 1e3 * sum(t for t, _ in probe.tokenize) / len(probe.tokenize)
