"""Graph lowering + execution (reference:
python/pathway/internals/graph_runner/__init__.py:36 GraphRunner,
storage_graph.py, expression_evaluator.py — collapsed: our engine scope is
in-process, so column-path planning reduces to schema-order row tuples).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Iterable

from pathway_tpu_torch.engine.expression import compile_expression
from pathway_tpu_torch.engine.runtime import Runtime
from pathway_tpu_torch.engine.scope import EngineTable
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.parse_graph import G, Operator
from pathway_tpu_torch.internals.universe import SOLVER

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table


class LoweringContext:
    def __init__(self, runtime: Runtime):
        self.runtime = runtime
        self.scope = runtime.scope
        self.engine_tables: dict[int, EngineTable] = {}

    # -- table registry ---------------------------------------------------
    def set_engine_table(self, table: "Table", et: EngineTable) -> None:
        self.engine_tables[id(table)] = et

    def engine_table(self, table: "Table") -> EngineTable:
        try:
            return self.engine_tables[id(table)]
        except KeyError:
            raise RuntimeError(
                f"table {table._name!r} was not lowered before use"
            ) from None

    # -- expression compilation -------------------------------------------
    def _combined_view(
        self, base: "Table", exprs: Iterable[expr_mod.ColumnExpression]
    ) -> tuple[EngineTable, Callable[[expr_mod.ColumnReference], Any]]:
        """Engine input holding base's row (+ id-joined rows of any other
        same-universe tables referenced by `exprs`) and a ref resolver."""
        dep_tables: list[Table] = []
        seen = {id(base)}
        for e in exprs:
            for ref in e._deps:
                t = ref.table
                if id(t) not in seen:
                    seen.add(id(t))
                    dep_tables.append(t)
        combined = self.engine_table(base)
        offsets: dict[int, int] = {id(base): 0}
        width = combined.width
        for t in dep_tables:
            if not (
                SOLVER.query_are_equal(base._universe, t._universe)
                or SOLVER.query_is_subset(base._universe, t._universe)
            ):
                raise ValueError(
                    f"expression references table {t._name!r} with an unrelated "
                    f"universe; use .restrict()/.ix() first"
                )
            other = self.engine_table(t)
            # join keys are 1-tuples (not bare Pointers) so the native
            # delta-join serializer accepts them — id-joins are the hot
            # path behind every cross-table expression
            combined = self.scope.join(
                combined,
                other,
                lambda k, row: (k,),
                lambda k, row: (k,),
                "inner",
                id_from_left=True,
                lkey_batch=lambda keys, rows: [(k,) for k in keys],
                rkey_batch=lambda keys, rows: [(k,) for k in keys],
            )
            offsets[id(t)] = width
            width += other.width

        def resolver(ref: expr_mod.ColumnReference):
            if ref.name == "id":
                return "id"
            t = ref.table
            try:
                idx = t._column_names.index(ref.name)
            except ValueError:
                raise KeyError(
                    f"no column {ref.name!r} in table {t._name!r} "
                    f"(columns: {t._column_names})"
                ) from None
            return offsets[id(t)] + idx

        return combined, resolver

    def rowwise_eval(
        self, base: "Table", exprs: list[expr_mod.ColumnExpression]
    ) -> tuple[EngineTable, Callable]:
        """Returns (engine_input, fn(keys, rows) -> list of output row tuples)."""
        combined, resolver = self._combined_view(base, exprs)
        fns = [compile_expression(e, resolver, self.runtime) for e in exprs]

        def batch_fn(keys, rows):
            cols = [f(keys, rows) for f in fns]
            return list(zip(*cols)) if cols else [()] * len(keys)

        return combined, batch_fn

    def mask_eval(
        self, base: "Table", e: expr_mod.ColumnExpression
    ) -> tuple[EngineTable, Callable]:
        combined, resolver = self._combined_view(base, [e])
        fn = compile_expression(e, resolver, self.runtime)
        return combined, fn

    def row_fn(
        self, base: "Table", exprs: list[expr_mod.ColumnExpression]
    ) -> tuple[EngineTable, Callable]:
        """Per-row variant: fn(key, row) -> tuple of values (for key fns).
        ``fn.batch(keys, rows) -> list of per-expr columns`` lets batch
        consumers (the time-gate operators) evaluate each expression once
        per batch instead of once per row."""
        combined, resolver = self._combined_view(base, exprs)
        fns = [compile_expression(e, resolver, self.runtime) for e in exprs]

        def one(key, row):
            return tuple(f([key], [row])[0] for f in fns)

        one.batch = lambda keys, rows: [f(keys, rows) for f in fns]
        return combined, one


_lower_lock = None  # serializes lowering across emulated-rank threads


class GraphRunner:
    """Lower + run the captured graph (reference:
    graph_runner/__init__.py:86 run_nodes / :96 run_tables / :113 run_outputs).

    Emulated-rank CI lane: with ``PATHWAY_LANE_PROCESSES=N`` set (and no
    real multi-process config), every run transparently spawns N-1
    companion ranks as THREADS of this process — each with a per-thread
    config overlay (process_id, first_port) and its own Runtime — joined
    over the real loopback TCP mesh. This re-runs the entire semantics
    battery through the lockstep exchange protocol (reference CI pattern:
    the suite re-runs under PATHWAY_THREADS=n / real process forks,
    python/pathway/tests/utils.py:31-48,599-677)."""

    def __init__(
        self,
        parse_graph=None,
        *,
        terminate_on_error: bool = True,
        persistence_config=None,
        with_http_server: bool = False,
        monitoring_level=None,
        **kwargs,
    ):
        self.graph = parse_graph or G
        self.terminate_on_error = terminate_on_error
        self.persistence_config = persistence_config
        self.with_http_server = with_http_server
        self.monitoring_level = monitoring_level

    def _make_runtime(self) -> Runtime:
        persistence = None
        if self.persistence_config is not None:
            from pathway_tpu_torch.persistence import PersistenceManager

            persistence = PersistenceManager(self.persistence_config)
        return Runtime(
            terminate_on_error=self.terminate_on_error,
            persistence=persistence,
            with_http_server=self.with_http_server,
            monitoring_level=self.monitoring_level,
        )

    def _lower(self, ops: list[Operator], runtime: Runtime) -> LoweringContext:
        ctx = LoweringContext(runtime)
        try:
            for op in ops:
                # nodes created during this lower inherit the operator's
                # user frame for error attribution (reference:
                # EngineErrorWithTrace, graph_runner/__init__.py:217-229)
                runtime.current_trace = op.trace
                op.lower_fn(ctx)
        finally:
            runtime.current_trace = None
        return ctx

    @staticmethod
    def _lane_world() -> int:
        import os

        from pathway_tpu_torch.internals.config import get_pathway_config

        try:
            n = int(os.environ.get("PATHWAY_LANE_PROCESSES", "1") or 1)
        except ValueError:
            return 1
        if n > 1 and get_pathway_config().processes == 1:
            return n
        return 1

    def _with_companions(self, ops, rank0_fn, companion_extra=None):
        """Run rank0_fn() with N-1 companion rank threads when the
        emulated lane is active; transparent no-op otherwise.
        companion_extra(runtime, ctx) mirrors any post-lowering graph
        construction rank 0 performs (captures) — the ranks' graphs must
        be shape-identical or the lockstep exchange sets diverge."""
        import threading

        n = self._lane_world()
        if n <= 1:
            return rank0_fn()
        global _lower_lock
        if _lower_lock is None:
            _lower_lock = threading.Lock()
        import socket

        from pathway_tpu_torch.internals.config import (
            pop_config_overlay,
            push_config_overlay,
        )

        def free_port_base() -> int:
            # need n consecutive free ports (rank r listens on base + r)
            for _ in range(50):
                probe = socket.socket()
                probe.bind(("127.0.0.1", 0))
                base = probe.getsockname()[1]
                probe.close()
                held = []
                try:
                    for i in range(n):
                        s = socket.socket()
                        s.bind(("127.0.0.1", base + i))
                        held.append(s)
                    return base
                except OSError:
                    continue
                finally:
                    for s in held:
                        s.close()
            raise RuntimeError("no consecutive free port range found")

        port = free_port_base()
        errors: list = []
        companion_rts: list = []

        def companion(rank: int) -> None:
            token = push_config_overlay(
                processes=n, process_id=rank, first_port=port
            )
            try:
                rt = self._make_runtime()
                rt._lane_emulated = True
                companion_rts.append(rt)
                with _lower_lock:
                    ctx = self._lower(ops, rt)
                    if companion_extra is not None:
                        companion_extra(rt, ctx)
                rt.run()
            except Exception as exc:  # surfaced on the main thread
                errors.append((rank, exc))
            finally:
                pop_config_overlay(token)

        threads = [
            threading.Thread(target=companion, args=(r,), daemon=True)
            for r in range(1, n)
        ]
        for t in threads:
            t.start()
        token = push_config_overlay(
            processes=n, process_id=0, first_port=port
        )
        rank0_exc: BaseException | None = None
        result = None
        try:
            result = rank0_fn()
        except BaseException as exc:
            rank0_exc = exc
        finally:
            pop_config_overlay(token)
            if rank0_exc is not None:
                # unblock companions stuck in collectives or mesh setup:
                # closing their sockets surfaces ConnectionError there.
                # Failure-path close: no goodbye frame, so companions
                # classify the loss as a crash, not a clean shutdown
                for rt in companion_rts:
                    pg = getattr(rt, "_procgroup", None)
                    if pg is not None:
                        try:
                            pg.close(goodbye=False)
                        except Exception:
                            pass
            for t in threads:
                t.join(timeout=120)
        if rank0_exc is not None:
            # a companion's real failure beats rank 0's secondary
            # disconnect error (the raising rank closes the mesh, peers
            # observe ConnectionError)
            if errors and isinstance(rank0_exc, ConnectionError):
                raise errors[0][1]
            raise rank0_exc
        if errors:
            raise errors[0][1]
        return result

    def run_tables(self, *tables: "Table", include_outputs: bool = False):
        """Run to completion, capturing the given tables' final state +
        update streams.  Returns list of CaptureNodes."""
        targets = [t._source for t in tables if t._source is not None]
        if include_outputs:
            targets += self.graph.output_operators()
        ops = self.graph.reachable_operators(targets)

        # captured BEFORE _with_companions pushes the rank-0 overlay
        lane_active = self._lane_world() > 1

        def rank0():
            runtime = self._make_runtime()
            if lane_active:
                runtime._lane_emulated = True
                with _lower_lock:
                    ctx = self._lower(ops, runtime)
            else:
                ctx = self._lower(ops, runtime)
            captures = [
                runtime.scope.capture(ctx.engine_table(t)) for t in tables
            ]
            runtime.run()
            return captures

        def companion_extra(rt, ctx):
            # mirror rank 0's capture nodes (gather exchanges included) so
            # every rank's graph has identical shape; the gathers route all
            # rows to rank 0, so these captures stay empty
            for t in tables:
                rt.scope.capture(ctx.engine_table(t))

        return self._with_companions(ops, rank0, companion_extra)

    def run_outputs(self):
        from pathway_tpu_torch.internals.config import get_pathway_config
        from pathway_tpu_torch.internals.telemetry import Telemetry

        targets = self.graph.output_operators()
        ops = self.graph.reachable_operators(targets)

        # captured BEFORE _with_companions pushes the rank-0 overlay —
        # under the overlay the lane looks like real multi-process
        lane_active = self._lane_world() > 1

        def rank0():
            runtime = self._make_runtime()
            telemetry = Telemetry.create(
                get_pathway_config().monitoring_server,
                stats=getattr(runtime, "stats", None),
            )
            if lane_active:
                runtime._lane_emulated = True
                with telemetry.span(
                    "graph_runner.build", n_operators=len(ops)
                ), _lower_lock:
                    self._lower(ops, runtime)
            else:
                with telemetry.span(
                    "graph_runner.build", n_operators=len(ops)
                ):
                    self._lower(ops, runtime)
            with telemetry.span("graph_runner.run"):
                runtime.run()
            # flush-on-shutdown: short runs must not exit with buffered
            # spans/gauges unsent (the periodic pusher is on a 60 s
            # cadence); the flight recorder's per-node aggregate spans
            # ride the same OTLP channel
            drain = getattr(telemetry, "drain", None)
            if drain is not None:
                summary = getattr(runtime, "trace_summary", None) or {}
                drain(
                    node_spans=summary.get("node_spans"), timeout=2.0
                )
            else:
                flush = getattr(telemetry, "flush", None)
                if flush is not None:
                    flush(timeout=2.0)

        return self._with_companions(ops, rank0)
