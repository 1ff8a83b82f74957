"""External-index dataflow operator: as-of-time index/query stream sync.

Re-derivation of the reference's external-index operator
(src/engine/dataflow/operators/external_index.rs:81-163):
index diffs and queries are merged and batched by logical time, so every
query sees exactly the index state as of its timestamp; query retractions
replay the memoized answer so downstream multisets cancel exactly. The
reference broadcasts index diffs to every worker (each holds a full copy,
:95-106); our index adapters may instead be mesh-sharded
(pathway_tpu_torch.parallel.sharded_knn) — the time-batching semantics here are
unchanged, the sharding lives inside the adapter.

Two modes (stdlib/indexing/data_index.py:46-473 in the reference):
* as_of_now: answer once at query insertion time, never revisit;
* revising: maintained — when index updates arrive, affected answers are
  retracted and re-emitted.
"""

from __future__ import annotations

from typing import Any, Callable, Protocol, Sequence

from pathway_tpu_torch.engine.nodes import Node
from pathway_tpu_torch.engine.stream import Delta, Key, Row, consolidate, negate


class ExternalIndexAdapter(Protocol):
    """Host adapter owning the actual index (KNN shard, BM25, HNSW...).

    Adapters may additionally expose batch delta hooks — the operator
    prefers them when present (one device dispatch / native crossing
    per consolidated time-batch instead of one per row):

    * ``add_batch(rows)`` with ``rows = [(key, data, filter_data)]``
    * ``remove_batch(keys)``
    """

    def add(self, key: Key, data: Any, filter_data: Any | None) -> None: ...

    def remove(self, key: Key) -> None: ...

    def search(
        self, queries: Sequence[tuple[Any, int, Any]]
    ) -> list[tuple[tuple, tuple]]:
        """queries: [(query_data, limit, filter)] -> per query
        (matched_keys_tuple, scores_tuple)."""
        ...


class ExternalIndexNode(Node):
    """Port 0: index stream; port 1: query stream.

    Output rows: query_row + (matched_ids: tuple, scores: tuple). Output key
    is the query key.
    """

    # adapter.search()/add() issue the engine's device dispatches (KNN
    # scan, rerank, embedder forward) — the device plane correlates its
    # dispatch records to this node's span (engine/nodes.py)
    device_node = True

    def device_sites(self) -> tuple:
        """Registered device-site names reachable through this node's
        adapter: the Device Doctor's reachability hook. An
        adapter exposes ``device_sites`` as an attribute or zero-arg
        callable (KnnShard / ShardedKnnIndex ship it); adapters without
        one contribute no statically-analyzable dispatch chain."""
        sites = getattr(self.adapter, "device_sites", None)
        if callable(sites):
            sites = sites()
        return tuple(sites) if sites else ()

    def __init__(
        self,
        scope,
        index_node,
        query_node,
        adapter: ExternalIndexAdapter,
        index_fn: Callable[[Key, Row], tuple[Any, Any]],  # -> (data, filter_data)
        query_fn: Callable[[Key, Row], tuple[Any, int, Any]],  # -> (data, limit, filter)
        mode: str = "as_of_now",  # or "revising"
    ):
        super().__init__(scope, [index_node, query_node])
        self.adapter = adapter
        self.index_fn = index_fn
        self.query_fn = query_fn
        self.mode = mode
        # memoized answers: query key -> (query_row, result_cols)
        self.answers: dict[Key, tuple[Row, tuple]] = {}
        # live queries (revising mode): key -> row
        self.live: dict[Key, Row] = {}

    # -- operator snapshots -------------------------------------------------
    def state_dict(self):
        if not hasattr(self.adapter, "snapshot_state"):
            raise RuntimeError(
                "OPERATOR_PERSISTING requires a snapshot-capable index "
                f"adapter; {type(self.adapter).__name__} has no "
                "snapshot_state/load_state — use journal persistence "
                "(PERSISTING) for this pipeline"
            )
        return {
            "answers": self.answers,
            "live": self.live,
            "adapter": self.adapter.snapshot_state(),
        }

    def load_state(self, state) -> None:
        self.answers = state["answers"]
        self.live = state["live"]
        self.adapter.load_state(state["adapter"])

    def reshard_state(self, states, keep):
        """Honest N→M re-shard: the default ``RESHARD =
        "keyed"`` policy would filter the adapter's state dict by row
        key — silently wrong for an index snapshot (segment manifests
        and corpus keys are not this rank's row keys). Answers/live ARE
        keyed row maps; the adapter states wrap into a reshard envelope
        the index restore resolves by folding every old rank's committed
        entries and re-bucketing through the keep set (reshard runs
        in-process, so the callable rides the returned state)."""
        from pathway_tpu_torch.persistence.reshard import filter_value, merge_values

        return {
            "answers": filter_value(
                merge_values([s["answers"] for s in states]), keep
            ),
            "live": filter_value(
                merge_values([s["live"] for s in states]), keep
            ),
            "adapter": {
                "__index_reshard__": True,
                "parts": [s["adapter"] for s in states],
                "keep": keep,
            },
        }

    def process(self, time, batches):
        index_deltas = consolidate(batches[0])
        query_deltas = consolidate(batches[1])
        out: list[Delta] = []

        # 1. apply index updates first — queries at time t see the index
        #    as of t (reference: batch merge by time, external_index.rs:112).
        #    Removes run before adds: a same-key update may arrive as
        #    (+new, -old) within one consolidated batch, and add-then-remove
        #    would delete the live row.
        index_changed = bool(index_deltas)
        removes = [k for k, row, d in index_deltas if d < 0]
        adds = [
            (k, *self.index_fn(k, row)) for k, row, d in index_deltas if d > 0
        ]
        # batch the delta application when the adapter supports it: one
        # device dispatch (or one native crossing) per consolidated batch
        # instead of one per row — the fix for ann_recall's per-doc index
        # build
        remove_batch = getattr(self.adapter, "remove_batch", None)
        if removes:
            if remove_batch is not None:
                remove_batch(removes)
            else:
                for k in removes:
                    self.adapter.remove(k)
        add_batch = getattr(self.adapter, "add_batch", None)
        if adds:
            if add_batch is not None:
                add_batch(adds)
            else:
                for k, data, fdata in adds:
                    self.adapter.add(k, data, fdata)

        # 2. retractions of queries replay the memoized answer
        to_answer: list[tuple[Key, Row]] = []
        for k, row, d in query_deltas:
            if d < 0:
                memo = self.answers.pop(k, None)
                self.live.pop(k, None)
                if memo is not None:
                    out.append((k, memo[0] + memo[1], -1))
            else:
                to_answer.append((k, row))

        # 3. revising mode: index changes re-answer all live queries
        if self.mode == "revising" and index_changed and self.live:
            for k, row in self.live.items():
                memo = self.answers.pop(k, None)
                if memo is not None:
                    out.append((k, memo[0] + memo[1], -1))
                to_answer.append((k, row))

        # 4. answer new queries against the as-of-t index, batched
        if to_answer:
            qspecs = [self.query_fn(k, row) for k, row in to_answer]
            results = self.adapter.search(qspecs)
            self._surface_filter_errors()
            for (k, row), res in zip(to_answer, results):
                result_cols = (tuple(res[0]), tuple(res[1]))
                self.answers[k] = (row, result_cols)
                if self.mode == "revising":
                    self.live[k] = row
                out.append((k, row + result_cols, 1))

        return consolidate(out)

    def _surface_filter_errors(self) -> None:
        """Filter-predicate failures are data errors, not empty matches
       : count every one in
        ``index_filter_errors_total`` and surface the first through the
        global error log (log_data_error dedups on (key, message))."""
        log = getattr(self.adapter, "filter_errors", None)
        if log is None or not log.count:
            return
        count, first = log.drain()
        self.scope.runtime.stats.on_index_filter_error(count)
        if first is not None:
            self.scope.runtime.log_data_error(first[0], key=first[1])
