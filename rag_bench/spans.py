"""The program's own spans of a traced window, for the metric readers.

A probe armed with the port's flight recorder (``pathway_tpu_torch/
internals/flight.py``) keeps the recorder's events as ``probe.program``:
tuples, of which the spans are ``("span", name, thread ident, t0_ns,
t1_ns, cpu_ns, trace_id, args)`` on ``perf_counter_ns``, with ``cpu_ns``
None for a span that is no thread's (a request's wait in a queue). A
probe without them reads as nothing: the readers of these spans return
None.
"""

from __future__ import annotations

# the waits of single requests, which start before the batch they join
# and so would name every idle gap of the device after themselves
REQUEST_SPANS = ("serve.queue_wait", "serve.handoff")


def spans(probe, name: str) -> list[tuple]:
    """(t0_ns, t1_ns, cpu_ns, trace_id, args) of the spans called
    ``name`` in the probe's program events."""
    return [e[3:] for e in getattr(probe, "program", None) or ()
            if e[0] == "span" and e[1] == name]


def mean_ms(probe, name: str) -> float | None:
    """Mean wall milliseconds of the spans called ``name``."""
    got = spans(probe, name)
    if not got:
        return None
    return sum(t1 - t0 for t0, t1, *_ in got) / len(got) / 1e6


def thread_spans(probe) -> list[tuple[int, int, str]]:
    """(t0_ns, t1_ns, name) of the spans bound to a thread, in the form
    ``devtrace.Profile.read`` takes beside the probe's own."""
    return [(e[3], e[4], e[1]) for e in getattr(probe, "program", None) or ()
            if e[0] == "span" and e[5] is not None and e[1] not in REQUEST_SPANS]
