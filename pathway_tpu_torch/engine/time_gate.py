"""Watermark-gated temporal operators: buffer, freeze, forget.

Re-derivation of the reference's time-column operators
(src/engine/dataflow/operators/time_column.rs —
postpone_core :380 (buffer), TimeColumnFreeze :631/:677 (late-data cutoff),
TimeColumnForget :556 (state expiry)). Each operator tracks its own
watermark = the maximum event time seen on its input; per the reference's
contract, a batch is evaluated against the watermark recorded BEFORE the
batch, which then advances after the whole batch is processed
(temporal_behavior.py docstring).
"""

from __future__ import annotations

import heapq
from typing import Callable

from pathway_tpu_torch.engine.nodes import Node, _split_deltas
from pathway_tpu_torch.engine.stream import (
    Delta,
    Key,
    MultisetState,
    Row,
    consolidate,
    freeze_row,
)


class _WatermarkNode(Node):
    # elastic-mesh rescale (persistence/reshard.py): release heaps and
    # watermark stashes are ordered rank-local structures whose
    # placement cannot be re-derived from a key — a world-size change
    # refuses restore with an error naming the node instead of guessing
    # (re-buffering under a merged heap could release a row twice)
    RESHARD = "refuse"

    def __init__(self, scope, input_node, gate_fn):
        super().__init__(scope, [input_node])
        # gate_fn(key, row) -> (threshold, event_time); gate_fn.batch, when
        # present, evaluates both expressions column-wise over the whole
        # batch (no per-row closure on the temporal hot path)
        self.gate_fn = gate_fn
        self.watermark = None

    def _gate(self, deltas) -> list:
        """[(delta, (threshold, event_time)), ...] for a batch."""
        gb = getattr(self.gate_fn, "batch", None)
        if gb is not None:
            keys, rows, _ = _split_deltas(deltas)
            thr_col, t_col = gb(keys, rows)
            return list(zip(deltas, zip(thr_col, t_col)))
        return [(d, self.gate_fn(d[0], d[1])) for d in deltas]

    def _advance(self, gated: list) -> None:
        for (k, row, d), (thr, t) in gated:
            if d > 0 and t is not None and (
                self.watermark is None or t > self.watermark
            ):
                self.watermark = t


class BufferNode(_WatermarkNode):
    """Hold rows until watermark >= threshold (reference: postpone_core)."""

    STATE_ATTRS = ("watermark", "stash")

    def __init__(self, scope, input_node, gate_fn):
        super().__init__(scope, input_node, gate_fn)
        # frozen (key,row) -> [key, row, diff, threshold]
        self.stash: dict[tuple, list] = {}

    def process(self, time, batches):
        deltas = consolidate(batches[0])
        gated = self._gate(deltas)
        out: list[Delta] = []
        for (k, row, d), (thr, _t) in gated:
            ident = (k, freeze_row(row))
            if d < 0 and ident not in self.stash:
                # retraction of an already-released row passes through
                out.append((k, row, d))
                continue
            slot = self.stash.get(ident)
            if slot is None:
                slot = [k, row, 0, thr]
                self.stash[ident] = slot
            slot[2] += d
            if slot[2] == 0:
                del self.stash[ident]
        self._advance(gated)
        if self.watermark is not None:
            for ident, (k, row, d, thr) in list(self.stash.items()):
                if thr is not None and thr <= self.watermark:
                    del self.stash[ident]
                    out.append((k, row, d))
        return consolidate(out)

    def on_input_closed(self):
        # end-of-stream: flush everything still buffered, in threshold
        # order (reference: buffers flush on input closure)
        if self.stash:
            out = [
                (k, row, d)
                for k, row, d, _ in sorted(
                    self.stash.values(), key=lambda s: (repr(s[3]), s[0])
                )
            ]
            self.stash.clear()
            t = self.scope.runtime.clock + 1
            for child, port in self.downstream:
                child.accept(t, port, out)


class FreezeNode(_WatermarkNode):
    """Drop updates arriving after their cutoff threshold passed
    (reference: TimeColumnFreeze / ignore_late)."""

    STATE_ATTRS = ("watermark",)

    def process(self, time, batches):
        deltas = consolidate(batches[0])
        gated = self._gate(deltas)
        out = []
        for (k, row, d), (thr, _t) in gated:
            if (
                self.watermark is not None
                and thr is not None
                and thr <= self.watermark
            ):
                continue  # late — ignore entirely
            out.append((k, row, d))
        self._advance(gated)
        return out


class ForgetNode(_WatermarkNode):
    """Pass rows through, then retract them once watermark >= threshold
    (reference: TimeColumnForget). Used with keep_results=False semantics —
    downstream state genuinely loses expired rows."""

    STATE_ATTRS = ("watermark", "live", "heap", "_seq")

    def __init__(self, scope, input_node, gate_fn):
        super().__init__(scope, input_node, gate_fn)
        self.live = MultisetState()
        self.heap: list[tuple] = []  # (threshold, seq, key, row)
        self._seq = 0

    def process(self, time, batches):
        deltas = consolidate(batches[0])
        gated = self._gate(deltas)
        out = []
        for (k, row, d), (thr, _t) in gated:
            out.append((k, row, d))
            self.live.apply_one(k, row, d)
            if d > 0 and thr is not None:
                self._seq += 1
                heapq.heappush(
                    self.heap, (_HeapKey(thr), self._seq, k, row)
                )
        self._advance(gated)
        if self.watermark is not None:
            while self.heap and self.heap[0][0].value <= self.watermark:
                _, _, k, row = heapq.heappop(self.heap)
                count = 0
                for lrow, c in self.live.get(k):
                    if freeze_row(lrow) == freeze_row(row):
                        count = c
                        break
                if count > 0:
                    self.live.apply_one(k, row, -count)
                    out.append((k, row, -count))
        return consolidate(out)


class _HeapKey:
    """Total-orders heterogeneous threshold values (ints, floats,
    datetimes) without cross-type comparisons blowing up the heap."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __lt__(self, other):
        try:
            return self.value < other.value
        except TypeError:
            return repr(self.value) < repr(other.value)

    def __eq__(self, other):
        return self.value == other.value
