"""Engine scope: the graph-construction API the DSL lowers onto.

Equivalent of the reference's ``trait Graph`` (reference: src/engine/
graph.rs:664-1011) + the PyO3 ``Scope`` pyclass (src/python_api.rs:2216),
collapsed into one Python-facing class since our bridge needs no FFI for
graph *construction* — only the data plane is native/JAX.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine import nodes as N
from pathway_tpu_torch.engine.stream import Delta


class EngineTable:
    """Handle to a node output inside a scope."""

    __slots__ = ("node", "width")

    def __init__(self, node: N.Node, width: int):
        self.node = node
        self.width = width


class Scope:
    def __init__(self, runtime):
        self.runtime = runtime
        self.nodes: list[N.Node] = []
        # multi-process runs: exchange boundaries the lockstep scheduler
        # must step at every global timestamp (engine/runtime.py)
        self.exchange_nodes: list[N.ExchangeNode] = []
        # transactional egress (io/txn.py): 2PC sinks the
        # runtime drives precommit/finalize/recover on around its
        # snapshot lifecycle. Registered on EVERY rank (the collective
        # windows must agree), even where callbacks are nulled.
        self.txn_sinks: list = []

    def register(self, node: N.Node) -> int:
        self.nodes.append(node)
        if isinstance(node, N.ExchangeNode):
            self.exchange_nodes.append(node)
        return len(self.nodes) - 1

    # -- multi-process shard routing --------------------------------------
    # Value-keyed stateful operators group rows from MANY sources under one
    # key, so in a multi-process run their inputs pass through an
    # ExchangeNode that hash-routes each row to the rank owning its key
    # (the reference's exchange pact before reduce/join, dataflow.rs).
    # Row-id-keyed state (buffers/freeze/forget) needs no exchange: row ids
    # are globally unique, so per-row state is always local.
    def _world(self) -> int:
        if getattr(self.runtime, "local_only", False):
            return 1  # throwaway inner runtimes never join the mesh
        from pathway_tpu_torch.internals.config import get_pathway_config

        return max(1, get_pathway_config().processes)

    def _exchange(
        self, table: EngineTable, key_batch=None, mode="hash", nb_kidx=None,
        nb_blame=(),
    ) -> EngineTable:
        # nb_kidx: plain-column shard key for the columnar exchange path
        # (tuple of column indices, or "id" for row-Pointer routing);
        # None keeps NativeBatch inputs on the tuple fallback. nb_blame
        # carries the lowering-time reason (analysis/eligibility.py) so
        # pw.analyze can name the expression that forced the tuple path.
        if self._world() <= 1:
            return table
        return EngineTable(
            N.ExchangeNode(
                self, table.node, key_batch, mode, nb_kidx=nb_kidx,
                nb_blame=nb_blame,
            ),
            table.width,
        )

    def _exchange_by_id(self, table: EngineTable) -> EngineTable:
        return self._exchange(table, lambda keys, rows: keys, nb_kidx="id")

    @staticmethod
    def _rowwise_key(fn):
        return lambda keys, rows: [fn(k, r) for k, r in zip(keys, rows)]

    # -- sources ---------------------------------------------------------
    def static_table(self, rows: list[tuple[int, tuple]], width: int) -> EngineTable:
        node = N.SourceNode(self)
        self.runtime.add_static_data(node, [(k, r, 1) for k, r in rows])
        return EngineTable(node, width)

    def empty_table(self, width: int) -> EngineTable:
        node = N.SourceNode(self)
        self.runtime.add_static_data(node, [])
        return EngineTable(node, width)

    def connector_table(self, subject, parser, width: int, name=None) -> EngineTable:
        node = N.SourceNode(self, append_only=False)
        self.runtime.add_connector(node, subject, parser, name=name)
        return EngineTable(node, width)

    # -- stateless transforms --------------------------------------------
    def rowwise(
        self, table: EngineTable, batch_fn, width: int, nb_proj_idx=None,
        nb_blame=(), src_exprs=None,
    ) -> EngineTable:
        return EngineTable(
            N.RowwiseNode(
                self, table.node, batch_fn, nb_proj_idx=nb_proj_idx,
                nb_blame=nb_blame, src_exprs=src_exprs,
            ),
            width,
        )

    def rowwise_memoized(
        self, table: EngineTable, batch_fn, width: int, src_exprs=None
    ) -> EngineTable:
        node = N.MemoizedRowwiseNode(self, table.node, batch_fn)
        node.src_exprs = src_exprs
        return EngineTable(node, width)

    def rowwise_auto(
        self, table: EngineTable, batch_fn, width: int, deterministic: bool,
        nb_proj_idx=None, nb_blame=(), src_exprs=None,
    ) -> EngineTable:
        """Plain rowwise for pure expressions; memoized when the expressions
        contain non-deterministic UDFs so retractions replay stored outputs
        (reference: `deterministic` flag, graph.rs:751)."""
        if deterministic:
            return self.rowwise(
                table, batch_fn, width, nb_proj_idx=nb_proj_idx,
                nb_blame=nb_blame, src_exprs=src_exprs,
            )
        return self.rowwise_memoized(table, batch_fn, width, src_exprs=src_exprs)

    def filter_table(self, table: EngineTable, mask_fn) -> EngineTable:
        return EngineTable(N.FilterNode(self, table.node, mask_fn), table.width)

    def reindex(self, table: EngineTable, key_fn) -> EngineTable:
        return EngineTable(N.ReindexNode(self, table.node, key_fn), table.width)

    def reindex_checked(self, table: EngineTable, key_fn) -> EngineTable:
        """Re-key with duplicate detection (user-facing with_id_from /
        with_id; reference pins ERROR rows + warning on key conflicts).
        Rows exchange by the NEW key first so cross-rank duplicates
        co-locate on one rank's detector."""
        table = self._exchange(table, self._rowwise_key(key_fn))
        return EngineTable(
            N.CheckedReindexNode(self, table.node, key_fn, table.width),
            table.width,
        )

    def reuniverse(self, table: EngineTable, other: EngineTable) -> EngineTable:
        """with_universe_of with runtime promise checks (missing keys
        become ERROR rows / drops, both logged)."""
        table = self._exchange_by_id(table)
        other = self._exchange_by_id(other)
        return EngineTable(
            N.ReuniverseNode(self, table.node, other.node, table.width),
            table.width,
        )

    def flatten(self, table: EngineTable, idx: int) -> EngineTable:
        return EngineTable(N.FlattenNode(self, table.node, idx), table.width)

    def concat(self, tables: list[EngineTable]) -> EngineTable:
        width = tables[0].width
        # id-collision detection requires same-id rows to co-locate
        tables = [self._exchange_by_id(t) for t in tables]
        return EngineTable(N.ConcatNode(self, [t.node for t in tables]), width)

    # -- stateful transforms ---------------------------------------------
    def join(
        self,
        left: EngineTable,
        right: EngineTable,
        left_key_fn,
        right_key_fn,
        join_type: str = "inner",
        id_from_left: bool = False,
        id_from_right: bool = False,
        left_id_fn=None,
        right_id_fn=None,
        lkey_batch=None,
        rkey_batch=None,
        nb_lkidx=None,
        nb_rkidx=None,
        nb_blame=(),
        nb_lblame=None,
        nb_rblame=None,
    ) -> EngineTable:
        if self._world() > 1:
            # nb_lkidx/nb_rkidx are valid shard keys exactly when that
            # SIDE's join keys are plain columns — the same eligibility
            # the fused join uses; lkey_batch then returns the tuple of
            # those columns, so columnar and tuple routing agree
            # byte-for-byte. Each exchange carries only its own side's
            # blame (nb_lblame/nb_rblame; the combined tuple would
            # misattribute the other side's expression) — callers that
            # pass only nb_blame get the old combined behavior.
            left = self._exchange(
                left, lkey_batch or self._rowwise_key(left_key_fn),
                nb_kidx=nb_lkidx,
                nb_blame=nb_blame if nb_lblame is None else nb_lblame,
            )
            right = self._exchange(
                right, rkey_batch or self._rowwise_key(right_key_fn),
                nb_kidx=nb_rkidx,
                nb_blame=nb_blame if nb_rblame is None else nb_rblame,
            )
        node = N.JoinNode(
            self,
            left.node,
            right.node,
            left_key_fn,
            right_key_fn,
            join_type,
            left_width=left.width,
            right_width=right.width,
            id_from_left=id_from_left,
            id_from_right=id_from_right,
            left_id_fn=left_id_fn,
            right_id_fn=right_id_fn,
            lkey_batch=lkey_batch,
            rkey_batch=rkey_batch,
            nb_lkidx=nb_lkidx,
            nb_rkidx=nb_rkidx,
            nb_blame=nb_blame,
        )
        return EngineTable(node, left.width + right.width)

    def group_by(
        self, table: EngineTable, grouping_fn, args_fn, reducer_fns, n_group_cols: int,
        key_fn=None, grouping_batch=None, args_batch=None, native_args=None,
        native_order=None, nb_gidx=None, nb_argidx=None, nb_blame=(),
        src_exprs=None,
    ) -> EngineTable:
        # nb_gidx (plain-column grouping) doubles as the columnar shard
        # key: grouping_batch returns the tuple of exactly those columns
        table = self._exchange(
            table, grouping_batch or self._rowwise_key(grouping_fn),
            nb_kidx=nb_gidx, nb_blame=nb_blame,
        )
        node = N.GroupByNode(
            self, table.node, grouping_fn, args_fn, reducer_fns, key_fn,
            grouping_batch=grouping_batch, args_batch=args_batch,
            native_args=native_args, native_order=native_order,
            nb_gidx=nb_gidx, nb_argidx=nb_argidx, nb_blame=nb_blame,
        )
        node.src_exprs = src_exprs
        return EngineTable(node, n_group_cols + len(reducer_fns))

    def update_rows(self, left: EngineTable, right: EngineTable) -> EngineTable:
        left = self._exchange_by_id(left)
        right = self._exchange_by_id(right)
        return EngineTable(N.UpdateRowsNode(self, left.node, right.node), left.width)

    def update_cells(self, left: EngineTable, right: EngineTable, positions) -> EngineTable:
        left = self._exchange_by_id(left)
        right = self._exchange_by_id(right)
        return EngineTable(
            N.UpdateCellsNode(self, left.node, right.node, positions), left.width
        )

    def ix(self, source: EngineTable, keys: EngineTable, key_fn, optional, strict) -> EngineTable:
        # co-locate each lookup with the source row it targets
        source = self._exchange_by_id(source)
        keys = self._exchange(keys, self._rowwise_key(key_fn))
        node = N.IxNode(
            self, source.node, keys.node, key_fn, optional, strict, source.width
        )
        return EngineTable(node, source.width)

    def intersect(self, left: EngineTable, others: list[EngineTable]) -> EngineTable:
        left = self._exchange_by_id(left)
        others = [self._exchange_by_id(o) for o in others]
        return EngineTable(
            N.IntersectNode(self, left.node, [o.node for o in others]), left.width
        )

    def difference(self, left: EngineTable, right: EngineTable) -> EngineTable:
        left = self._exchange_by_id(left)
        right = self._exchange_by_id(right)
        return EngineTable(N.DifferenceNode(self, left.node, right.node), left.width)

    def sort(self, table: EngineTable, key_fn, instance_fn) -> EngineTable:
        table = self._exchange(table, self._rowwise_key(instance_fn))
        return EngineTable(N.SortNode(self, table.node, key_fn, instance_fn), 2)

    def deduplicate(self, table: EngineTable, instance_fn, value_fn, acceptor) -> EngineTable:
        table = self._exchange(table, self._rowwise_key(instance_fn))
        return EngineTable(
            N.DeduplicateNode(self, table.node, instance_fn, value_fn, acceptor),
            table.width,
        )

    def stateful_reduce(
        self, table: EngineTable, grouping_fn, args_fn, combine_many, n_group_cols, key_fn=None
    ) -> EngineTable:
        table = self._exchange(table, self._rowwise_key(grouping_fn))
        node = N.StatefulReduceNode(
            self, table.node, grouping_fn, args_fn, combine_many, key_fn
        )
        return EngineTable(node, n_group_cols + 1)

    def buffer(self, table: EngineTable, gate_fn) -> EngineTable:
        from pathway_tpu_torch.engine.time_gate import BufferNode

        return EngineTable(BufferNode(self, table.node, gate_fn), table.width)

    def freeze(self, table: EngineTable, gate_fn) -> EngineTable:
        from pathway_tpu_torch.engine.time_gate import FreezeNode

        return EngineTable(FreezeNode(self, table.node, gate_fn), table.width)

    def forget(self, table: EngineTable, gate_fn) -> EngineTable:
        from pathway_tpu_torch.engine.time_gate import ForgetNode

        return EngineTable(ForgetNode(self, table.node, gate_fn), table.width)

    def gradual_broadcast(
        self, left: EngineTable, threshold: EngineTable, triplet_fn
    ) -> EngineTable:
        # the (small) threshold table is replicated to every rank; the
        # broadcast-target side keeps per-row state locally
        threshold = self._exchange(threshold, mode="broadcast")
        node = N.GradualBroadcastNode(
            self, left.node, threshold.node, triplet_fn
        )
        return EngineTable(node, left.width + 1)

    def forget_immediately(self, table: EngineTable) -> EngineTable:
        return EngineTable(
            N.ForgetImmediatelyNode(self, table.node), table.width
        )

    def external_index(
        self,
        index: EngineTable,
        queries: EngineTable,
        adapter,
        index_fn,
        query_fn,
        mode: str = "as_of_now",
    ) -> EngineTable:
        from pathway_tpu_torch.engine.external_index import ExternalIndexNode

        # reference semantics: the index is replicated per worker
        # (broadcast build side); queries are answered where they live
        index = self._exchange(index, mode="broadcast")
        node = ExternalIndexNode(
            self, index.node, queries.node, adapter, index_fn, query_fn, mode
        )
        return EngineTable(node, queries.width + 2)

    # -- sinks ------------------------------------------------------------
    # outputs gather to rank 0 in multi-process runs: one process owns the
    # external side effects (files, subscribers), mirroring the reference's
    # single-writer guidance for fs sinks
    def output(
        self,
        table: EngineTable,
        *,
        txn_sink=None,
        partitioned: bool = False,
        **callbacks,
    ) -> None:
        if partitioned:
            # per-rank partitioned egress (ROADMAP item 3):
            # NO gather leg — every rank runs the sink callbacks over
            # its own shard and commits its own output partition. Only
            # meaningful for sinks whose finalization makes the union
            # exactly-once (the transactional Delta writer: each rank
            # commits its own data files, rank 0 appends the log).
            pass
        else:
            table = self._exchange(table, mode="gather")
            if self._world() > 1:
                from pathway_tpu_torch.internals.config import get_pathway_config

                if get_pathway_config().process_id != 0:
                    # rows gather to rank 0; other ranks keep the node
                    # (graph shape must match) but must not run side
                    # effects — an on_end here would e.g. truncate the
                    # file rank 0 wrote
                    callbacks = {k: None for k in callbacks}
        node = N.OutputNode(self, table.node, **callbacks)
        if txn_sink is not None:
            # registered on every rank — the runtime's 2PC windows are
            # collective, and non-writer ranks' verbs no-op on their
            # empty staging areas
            node._txn_sink = txn_sink
            self.txn_sinks.append(txn_sink)

    def capture(self, table: EngineTable) -> N.CaptureNode:
        return N.CaptureNode(self, self._exchange(table, mode="gather").node)
