"""Queries per ``QueryEngine.dispatch`` call in the window: the
MicroBatcher's batch size (the probe counts ``len(texts)`` per call)."""


def read(probe):
    if not probe.batches:
        return None
    return sum(probe.batches) / len(probe.batches)
