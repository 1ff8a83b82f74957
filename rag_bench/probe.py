"""What a traced run records around the program, for the metric readers.

Installed at the start of the measured window of a ``--trace 1`` run and
taken off at its end:

- the port's device plane (``pathway_tpu_torch/internals/device.py``
  ``PLANE``), armed with a fresh ``ProberStats``: per device site,
  launches and CUDA-event device seconds, and new shape buckets;
- a host timer around the encoder's tokenizer callable: seconds and each
  text's real token count per call;
- around ``QueryEngine.dispatch`` and ``QueryEngine.finish``: the queries
  of each batch, and host spans;
- ``torch.profiler`` over the whole window (``devtrace``).

The mode adds what it knows of the cell (``cfg``, ``window_s``, ...)
before the metric readers (``metrics/<name>.py``) read it.
"""

from __future__ import annotations

import contextlib
import threading
import time


class Probe:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.window_s = 0.0
        self.live_rows = 0
        self.tokenize: list[tuple[float, list[int]]] = []
        self.batches: list[int] = []
        self.spans: list[tuple[int, int, str]] = []
        self.sites: dict[str, list] = {}
        self.recompiles: dict[str, int] = {}
        self.profile: dict | None = None
        self._lock = threading.Lock()
        self._undo: list = []
        self._stats = None

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter_ns()
        try:
            yield
        finally:
            with self._lock:
                self.spans.append((t, time.perf_counter_ns(), name))

    def wrap_tokenizer(self, encoder) -> None:
        inner = encoder.tokenizer

        def timed(texts, *args, **kwargs):
            t = time.perf_counter_ns()
            ids, mask = inner(texts, *args, **kwargs)
            t1 = time.perf_counter_ns()
            with self._lock:
                self.tokenize.append(((t1 - t) * 1e-9, mask.sum(axis=1).tolist()))
                self.spans.append((t, t1, "rag_bench: tokenizer"))
            return ids, mask

        encoder.tokenizer = timed
        self._undo.append(lambda: setattr(encoder, "tokenizer", inner))

    def wrap_engine(self, engine) -> None:
        dispatch, finish = engine.dispatch, engine.finish

        def counted(texts):
            with self._lock:
                self.batches.append(len(texts))
            with self.span("rag_bench: QueryEngine.dispatch"):
                return dispatch(texts)

        def timed(ticket):
            with self.span("rag_bench: QueryEngine.finish"):
                return finish(ticket)

        engine.dispatch, engine.finish = counted, timed

        def undo():
            engine.dispatch, engine.finish = dispatch, finish

        self._undo.append(undo)

    def arm(self) -> None:
        from pathway_tpu_torch.internals.device import PLANE
        from pathway_tpu_torch.internals.monitoring import ProberStats

        self._stats = ProberStats()
        PLANE.arm(None, self._stats)
        self._undo.append(PLANE.disarm)

    def close(self) -> None:
        """Take every hook off (the plane delivers its pending records
        first) and keep what they counted."""
        for undo in reversed(self._undo):
            undo()
        self._undo = []
        if self._stats is not None:
            self.sites = {k: list(v) for k, v in self._stats.device_sites.items()}
            self.recompiles = dict(self._stats.device_recompiles)

    def site(self, name: str) -> tuple[int, float] | None:
        """(launches, device seconds) of a device site, None if unseen."""
        agg = self.sites.get(name)
        if not agg or not agg[0]:
            return None
        return int(agg[0]), float(agg[2])

    def event_profile(self) -> dict:
        """Busy seconds from the device plane's CUDA events, where the
        profiler's trace shows no device time: the sum over the sites."""
        return {"busy_s": sum(float(v[2]) for v in self.sites.values()),
                "window_s": self.window_s, "device_ops": [], "idle_gaps": []}

    def token_lengths(self) -> list[int]:
        return [n for _, lengths in self.tokenize for n in lengths]
