"""Host milliseconds per call of the encoder's tokenizer in the window,
on the serving path (``QueryEngine.dispatch``)."""


def read(probe):
    if not probe.tokenize:
        return None
    return 1e3 * sum(t for t, _ in probe.tokenize) / len(probe.tokenize)
