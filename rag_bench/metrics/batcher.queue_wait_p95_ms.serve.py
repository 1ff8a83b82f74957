"""95th percentile, in milliseconds, of the window's requests' waits from
``MicroBatcher.query``'s put until the collector took them (the program's
span ``serve.queue_wait``)."""

import numpy as np

from rag_bench import spans


def read(probe):
    got = spans.spans(probe, "serve.queue_wait")
    if not got:
        return None
    return float(np.percentile([(t1 - t0) / 1e6 for t0, t1, *_ in got], 95))
