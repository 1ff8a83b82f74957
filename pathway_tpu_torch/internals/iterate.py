"""pw.iterate — fixed-point iteration (reference:
Graph::iterate graph.rs:941; engine impl src/engine/dataflow/
complex_columns.rs; python surface internals/common.py iterate).

The body is captured ONCE into a scoped operator list at declaration time.
At run time the IterateNode re-lowers that body onto a fresh throwaway
Runtime per fixpoint pass: feed current state as static tables, run to
completion, compare outputs; repeat until stable (or `iteration_limit`).
Whole-state recompute per *timestamp* keeps retraction semantics exact (the
node diffs the converged output against what it previously emitted) without
re-deriving differential's nested-scope compaction — the right trade for a
batch-per-timestamp scheduler. Dense per-iteration work still hits XLA
through whatever UDFs the body uses.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable

from pathway_tpu_torch.engine.nodes import Node
from pathway_tpu_torch.engine.scope import EngineTable
from pathway_tpu_torch.engine.stream import TableState, consolidate, freeze_row, negate
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.universe import Universe


class _IterateOutputNode(Node):
    """Reader for one output slot of an IterateNode. Fed directly via
    accept() (the IterateNode routes per-name outputs itself), but the
    graph edge from the IterateNode matters: the multi-process lockstep
    protocol computes downstream-reachable exchange masks over the static
    graph, and without the edge the ranks would disagree mid-timestep on
    which exchanges an iterate output can feed (runtime.py
    _exchange_reach_masks)."""

    def __init__(self, scope, iter_node):
        super().__init__(scope, [iter_node])

    def process(self, time, batches):
        return consolidate(batches[0])


class IterateNode(Node):
    def __init__(
        self,
        scope,
        input_nodes: list[Node],
        input_tables: list,            # DSL tables, same order as input_nodes
        placeholders: dict[str, Any],  # name -> placeholder DSL table
        body_ops: list,
        result_tables: dict[str, Any],  # name -> body output DSL table
        extra_tables: list,             # outer tables used by the body
        iteration_limit: int | None,
    ):
        super().__init__(scope, input_nodes)
        self.input_tables = input_tables
        self.placeholders = placeholders
        self.body_ops = body_ops
        self.result_tables = result_tables
        self.extra_tables = extra_tables
        # set via attach_outputs (output nodes need this node as their
        # graph input, so they are created after it)
        self.output_nodes: dict[str, _IterateOutputNode] = {}
        self.iteration_limit = iteration_limit
        self.states = [TableState() for _ in input_nodes]
        # name -> {key: row} last emitted output
        self.emitted: dict[str, dict] = {}

    def attach_outputs(
        self, output_nodes: dict[str, "_IterateOutputNode"]
    ) -> None:
        self.output_nodes = output_nodes
        self.emitted = {name: {} for name in output_nodes}

    def process(self, time, batches):
        for st, batch in zip(self.states, batches):
            st.apply(consolidate(batch))

        n_iter = len(self.placeholders)
        iter_state = {
            name: dict(self.states[i].rows)
            for i, name in enumerate(self.placeholders)
        }
        extra_state = {
            id(t): dict(self.states[n_iter + j].rows)
            for j, t in enumerate(self.extra_tables)
        }

        limit = self.iteration_limit
        rounds = 0
        while True:
            rounds += 1
            new_state = self._run_body(iter_state, extra_state)
            if self._same(new_state, iter_state) or (
                limit is not None and rounds >= limit
            ):
                iter_state = new_state
                break
            iter_state = new_state

        # diff converged outputs against previously emitted
        for name, out_node in self.output_nodes.items():
            prev = self.emitted[name]
            cur = iter_state[name]
            deltas = []
            for k, row in prev.items():
                if k not in cur or freeze_row(cur[k]) != freeze_row(row):
                    deltas.append((k, row, -1))
            for k, row in cur.items():
                if k not in prev or freeze_row(prev[k]) != freeze_row(row):
                    deltas.append((k, row, 1))
            self.emitted[name] = dict(cur)
            if deltas:
                out_node.accept(time, 0, deltas)
                self.scope.runtime.mark_pending(time, out_node)
        return []

    def _run_body(self, iter_state, extra_state):
        from pathway_tpu_torch.engine.runtime import Runtime
        from pathway_tpu_torch.internals.graph_runner import LoweringContext

        # local_only: the fixpoint body is a complete local subgraph over
        # this node's (gathered) state — it must not try to join the
        # process mesh even under PATHWAY_PROCESSES>1
        rt = Runtime(local_only=True)
        ctx = LoweringContext(rt)
        for name, ph in self.placeholders.items():
            rows = [(k, row) for k, row in iter_state[name].items()]
            width = len(ph._column_names)
            ctx.set_engine_table(ph, rt.scope.static_table(rows, width))
        for t in self.extra_tables:
            rows = [(k, row) for k, row in extra_state[id(t)].items()]
            ctx.set_engine_table(
                t, rt.scope.static_table(rows, len(t._column_names))
            )
        for op in self.body_ops:
            rt.current_trace = op.trace
            op.lower_fn(ctx)
        rt.current_trace = None
        captures = {
            name: rt.scope.capture(ctx.engine_table(t))
            for name, t in self.result_tables.items()
        }
        rt.run_static()
        return {name: dict(c.state.rows) for name, c in captures.items()}

    @staticmethod
    def _same(a, b) -> bool:
        if a.keys() != b.keys():
            return False
        for name in a:
            da, db = a[name], b[name]
            if da.keys() != db.keys():
                return False
            for k in da:
                if freeze_row(da[k]) != freeze_row(db[k]):
                    return False
        return True


def iterate(
    body: Callable,
    iteration_limit: int | None = None,
    **kwargs,
):
    """Iterate `body` to a fixed point (reference: pw.iterate).

    kwargs are the iterated tables; the body receives placeholder tables
    with the same schemas and must return a Table (single iterated value)
    or a dict/namespace with the same names as kwargs.
    """
    from pathway_tpu_torch.internals.table import Table

    if not kwargs:
        raise ValueError("iterate() needs at least one table argument")
    tables = {name: t for name, t in kwargs.items()}
    placeholders = {
        name: Table(t._schema_cls, Universe()) for name, t in tables.items()
    }
    with G.scoped() as body_ops:
        result = body(**placeholders)

    if isinstance(result, Table):
        if len(tables) != 1:
            raise ValueError(
                "body returned a single table but iterate() got several"
            )
        result_map = {next(iter(tables)): result}
        single = True
    else:
        result_map = dict(
            result if isinstance(result, dict) else vars(result)
        )
        single = False
        if set(result_map) != set(tables):
            raise ValueError(
                f"body must return tables named {sorted(tables)}, "
                f"got {sorted(result_map)}"
            )

    body_op_ids = {id(op) for op in body_ops}
    placeholder_ids = {id(t) for t in placeholders.values()}
    extra_tables: list = []
    seen: set[int] = set()
    for op in body_ops:
        for t in op.inputs:
            if (
                id(t) not in placeholder_ids
                and id(t) not in seen
                and (t._source is None or id(t._source) not in body_op_ids)
            ):
                seen.add(id(t))
                extra_tables.append(t)

    outputs = {
        name: Table(result_map[name]._schema_cls, Universe())
        for name in result_map
    }

    def lower(ctx):
        # Multi-process: every input gathers to rank 0, the fixpoint runs
        # there over the full state, and downstream ExchangeNodes re-shard
        # the converged output — the iterate scope is a non-partitioned
        # operator, like the reference's worker-0-reads-then-exchanges
        # pattern for unpartitioned sources (SURVEY §5). The fixpoint's
        # data-dependent re-stepping therefore never has to ride the
        # lockstep exchange protocol mid-iteration.
        input_nodes = [
            ctx.scope._exchange(ctx.engine_table(t), mode="gather").node
            for t in tables.values()
        ]
        input_nodes += [
            ctx.scope._exchange(ctx.engine_table(t), mode="gather").node
            for t in extra_tables
        ]
        iter_node = IterateNode(
            ctx.scope,
            input_nodes,
            list(tables.values()),
            placeholders,
            body_ops,
            result_map,
            extra_tables,
            iteration_limit,
        )
        out_nodes = {
            name: _IterateOutputNode(ctx.scope, iter_node)
            for name in outputs
        }
        iter_node.attach_outputs(out_nodes)
        for name, t in outputs.items():
            ctx.set_engine_table(
                t, EngineTable(out_nodes[name], len(t._column_names))
            )

    G.add_operator(
        list(tables.values()) + extra_tables,
        list(outputs.values()),
        lower,
        "iterate",
    )
    if single:
        return next(iter(outputs.values()))
    return SimpleNamespace(**outputs)
