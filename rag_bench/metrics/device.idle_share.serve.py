"""Percent of the profiled part of the window in which no kernel, copy or
set ran on the card (``torch.profiler``'s trace, ``rag_bench/devtrace.py``)."""


def read(probe):
    p = probe.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
