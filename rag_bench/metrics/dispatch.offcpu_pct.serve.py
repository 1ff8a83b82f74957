"""Percent of the wall time of the program's ``serve.dispatch`` spans
that the collector thread spent off the CPU (waiting for the GIL, a lock,
a blocking copy): the sum of wall less thread CPU time over the sum of
wall."""

from rag_bench import spans


def read(probe):
    got = spans.spans(probe, "serve.dispatch")
    wall = sum(t1 - t0 for t0, t1, *_ in got)
    if wall <= 0:
        return None
    off = sum((t1 - t0) - min(cpu, t1 - t0) for t0, t1, cpu, *_ in got)
    return 100.0 * off / wall
