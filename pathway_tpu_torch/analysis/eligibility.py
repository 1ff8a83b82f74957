"""NativeBatch fused-chain eligibility — the ONE module deciding whether
a join/groupby/select/exchange stays on the columnar zero-interpreter
path, shared verbatim by the executor nodes (engine/nodes.py) and the
static analyzer (analysis/analyzer.py) so the two can never drift.

Every predicate returns an :class:`NBDecision` carrying ``ok`` plus the
human-readable *blame*: which expression, UDF, reducer or ``id=`` broke
the chain. Node constructors store the decision; ``pw.analyze`` reads it
back and attributes it to the user frame that declared the operator.

This module must not import engine/nodes at module level (nodes imports
it); node-graph helpers import lazily.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

# reducer codes the columnar group-by door executes without an ordered
# multiset (exec.cpp process_batch_nb) — keep in sync with the C side
NB_ABELIAN_CODES = ("count", "sum", "avg")

# value types a NativeBatch column can carry (exec.cpp nb_put):
# None / bool / int64 / float / str
_NB_DTYPE_NAMES = {"INT", "FLOAT", "STR", "BOOL", "NONE"}


class NBDecision(NamedTuple):
    """Construction-time fused-chain verdict for one operator node.

    ``ok`` mirrors exactly the predicate the executor gates its columnar
    path on; ``reasons`` name what broke it (empty when ok).
    """

    ok: bool
    reasons: tuple[str, ...] = ()


FUSED = NBDecision(True, ())


class NBStrictError(RuntimeError):
    """PATHWAY_NB_STRICT=1: a fused-eligible node demoted or de-optimized
    to the tuple path at runtime; raised with the fusion-blame diagnostic
    instead of degrading silently."""


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean env knob: unset or '' is ``default``; '0', 'false', 'no'
    are off (a plain truthiness check would treat PATHWAY_NO_NB_JOIN=0 as
    ON — the typo class the knob registry exists to catch)."""
    raw = os.environ.get(name, "").strip().lower()
    return default if raw == "" else raw not in ("0", "false", "no")


def nb_join_forced_off() -> bool:
    return env_flag("PATHWAY_NO_NB_JOIN")


def nb_exchange_forced_off() -> bool:
    return env_flag("PATHWAY_NO_NB_EXCHANGE")


def nb_capture_forced_off() -> bool:
    """PATHWAY_NO_NB_CAPTURE=1 forces the row-expanding egress path
    (capture/sinks materialize Python rows) — the parity knob for the
    columnar-egress battery."""
    return env_flag("PATHWAY_NO_NB_CAPTURE")


def nb_strict() -> bool:
    return env_flag("PATHWAY_NB_STRICT")


def describe(e: Any) -> str:
    """Short blame label for an expression (reprs are already compact:
    ``(<left>.a + 1)``, ``pathway.apply(fn, ...)``)."""
    try:
        s = repr(e)
    except Exception:
        s = object.__repr__(e)
    return s if len(s) <= 120 else s[:117] + "..."


# -- expression-shape predicates (used at lowering time) ------------------

def plain_column_index(e, table) -> int | None:
    """Index of ``e`` in ``table`` when it is a plain (non-id) column
    reference — the shapes the columnar executors extract straight from
    the batch image; anything else keeps the tuple path."""
    from pathway_tpu_torch.internals.expression import ColumnReference

    if (
        isinstance(e, ColumnReference)
        and e.table is table
        and e.name != "id"
        and e.name in table._column_names
    ):
        return table._column_names.index(e.name)
    return None


def join_key_indices(on, left, right):
    """(nb_lkidx, nb_rkidx, lblame, rblame): per-side plain-column
    join-key indices. Sides nullify INDEPENDENTLY — a broken right key
    leaves nb_lkidx valid, so the left exchange still ships columnar
    (gating only on its own shard key, like ``_slice``) while the join
    node carries the combined blame and each exchange only its own
    side's."""
    lreasons: list[str] = []
    rreasons: list[str] = []
    lk: list[int] = []
    rk: list[int] = []
    for lhs, rhs in on:
        li = plain_column_index(lhs, left)
        ri = plain_column_index(rhs, right)
        if li is None:
            lreasons.append(
                f"left join key {describe(lhs)} is not a plain column"
            )
        else:
            lk.append(li)
        if ri is None:
            rreasons.append(
                f"right join key {describe(rhs)} is not a plain column"
            )
        else:
            rk.append(ri)
    return (
        None if lreasons else tuple(lk),
        None if rreasons else tuple(rk),
        tuple(lreasons),
        tuple(rreasons),
    )


def join_projection_indices(names, exprs, left, right, lw):
    """(nb_proj_idx, reasons) for a join select: every output expression
    a plain column of either side keeps the joined NativeBatch columnar
    through the select hop (exec.cpp nb_project)."""
    from pathway_tpu_torch.internals.expression import ColumnReference

    reasons: list[str] = []
    proj: list[int | None] = []
    for name, e in zip(names, exprs):
        idx = None
        if isinstance(e, ColumnReference) and e.name != "id":
            if e.table is left and e.name in left._column_names:
                idx = left._column_names.index(e.name)
            elif e.table is right and e.name in right._column_names:
                idx = lw + right._column_names.index(e.name)
        if idx is None:
            reasons.append(
                f"output column {name!r} = {describe(e)} is not a plain "
                f"column projection"
            )
        proj.append(idx)
    if reasons:
        return None, tuple(reasons)
    return tuple(proj), ()


# dedupe markers: decide_join_nb/decide_groupby_nb suppress their
# generic reason when the precise blame below already names the defect —
# producer and consumer share these constants so rewording a blame
# message cannot silently desynchronize the substring check
ID_BLAME_MARK = "id="
SORT_BLAME_MARK = "sort_by"


def join_id_blame(id_expr, id_expr_side) -> tuple[str, ...]:
    """Blame for ``join(..., id=<expr>)`` shapes that need a per-row
    Python mint (anything but taking one side's own row ids)."""
    if id_expr is None:
        return ()
    return (
        f"{ID_BLAME_MARK} is a computed {id_expr_side}-side expression "
        f"({describe(id_expr)}) — per-row Python id mint",
    )


def groupby_nb_indices(grouping, reducers, sort_by, deterministic, resolver):
    """(nb_gidx, nb_argidx, reasons): plain-column grouping + argless or
    single-plain-column reducer args, deterministic, no sort_by — the
    shapes the columnar parse→groupby path executes with zero per-row
    Python. Blame names the exact expression/reducer otherwise."""
    from pathway_tpu_torch.internals.expression import ColumnReference

    reasons: list[str] = []
    if not deterministic:
        reasons.append(
            "a non-deterministic UDF feeds the groupby (inputs are "
            "pre-materialized through the memoized per-row path)"
        )
    if sort_by is not None:
        reasons.append(
            f"{SORT_BLAME_MARK}={describe(sort_by)} needs the ordered "
            f"native store (no columnar door)"
        )

    def _col_idx(e):
        if isinstance(e, ColumnReference):
            loc = resolver(e)
            if isinstance(loc, int):
                return loc
        return None

    g_locs: list[int] = []
    if deterministic:
        for g in grouping:
            loc = _col_idx(g)
            if loc is None:
                reasons.append(
                    f"grouping expression {describe(g)} is not a plain "
                    f"column"
                )
            else:
                g_locs.append(loc)
    a_locs: list[int | None] = []
    for r in reducers:
        if len(r._args) == 0:
            a_locs.append(None)
            continue
        if len(r._args) > 1:
            reasons.append(
                f"reducer {describe(r)} takes {len(r._args)} arguments "
                f"(the native executor is single-column)"
            )
            continue
        loc = _col_idx(r._args[0]) if deterministic else None
        if loc is None and deterministic:
            reasons.append(
                f"reducer argument {describe(r._args[0])} is not a plain "
                f"column"
            )
        else:
            a_locs.append(loc)
    if reasons:
        return None, None, tuple(reasons)
    return tuple(g_locs), tuple(a_locs), ()


# -- node-construction decisions (used by engine/nodes.py) ----------------

def decide_join_nb(
    *, native_ok, nb_lkidx, nb_rkidx, left_id_fn, right_id_fn, blame=(),
) -> NBDecision:
    """JoinNode fused-chain verdict — must stay equivalent to
    ``native_ok and nb_lkidx is not None and nb_rkidx is not None and
    left_id_fn is None and right_id_fn is None and not
    PATHWAY_NO_NB_JOIN`` (the predicate join_batch_nb gates on)."""
    reasons = list(blame)
    if not native_ok:
        reasons.append(
            "join shape has no native executor (unsupported join type or "
            "unknown side widths)"
        )
    if (nb_lkidx is None or nb_rkidx is None) and not blame:
        reasons.append("join keys are not plain columns")
    if (left_id_fn is not None or right_id_fn is not None) and not any(
        ID_BLAME_MARK in r for r in reasons
    ):
        reasons.append(
            f"{ID_BLAME_MARK} is a computed expression (per-row Python "
            f"mint)"
        )
    if nb_join_forced_off():
        reasons.append("PATHWAY_NO_NB_JOIN forces the tuple path")
    return NBDecision(not reasons, tuple(reasons))


def decide_groupby_nb(
    *, native_ok, nb_gidx, nb_argidx, native_order, native_codes, blame=(),
) -> NBDecision:
    """GroupByNode fused-chain verdict — equivalent to ``native_ok and
    nb_gidx/nb_argidx set and native_order is None and all codes in
    count/sum/avg`` (the predicate process_batch_nb gates on)."""
    reasons = list(blame)
    if not native_ok:
        reasons.append(
            "a reducer has no native executor code or multi-column "
            "arguments (Python group-rediff path)"
        )
    if (nb_gidx is None or nb_argidx is None) and not blame:
        reasons.append("grouping/reducer args are not plain columns")
    if native_order is not None and not any(
        SORT_BLAME_MARK in r for r in reasons
    ):
        reasons.append(
            f"{SORT_BLAME_MARK} needs the ordered native store"
        )
    slow = [
        c for c in native_codes if c is not None and c not in NB_ABELIAN_CODES
    ]
    if slow:
        reasons.append(
            f"reducer code(s) {sorted(set(slow))} keep an ordered multiset "
            f"(columnar door is count/sum/avg only)"
        )
    return NBDecision(not reasons, tuple(reasons))


def decide_exchange_nb(*, mode, nb_kidx, blame=()) -> NBDecision:
    """ExchangeNode columnar verdict — must stay equivalent to the
    ``_slice`` gate: hash boundaries need a plain-column (or by-id) shard
    key; broadcast/gather ship whatever arrives. ``blame`` rides in from
    the join/groupby lowering and only explains WHY the shard key is
    missing — it must not veto an exchange whose key is valid (e.g. an
    id=-broken join still exchanges columnar on its plain-column keys)."""
    reasons: list[str] = []
    if mode == "hash" and nb_kidx is None:
        reasons = list(blame) or [
            "shard key is not plain columns (per-row stable_shard + "
            "pickled tuple slices)"
        ]
    if nb_exchange_forced_off():
        reasons.append("PATHWAY_NO_NB_EXCHANGE forces the tuple path")
    return NBDecision(not reasons, tuple(reasons))


def decide_rowwise_nb(*, nb_proj_idx, blame=()) -> NBDecision:
    reasons = list(blame)
    if nb_proj_idx is None and not blame:
        reasons.append(
            "select is not a pure column projection (batch materializes)"
        )
    return NBDecision(not reasons, tuple(reasons))


# -- static NativeBatch reachability (shared by the runtime's fallback
#    accounting and the analyzer's chain propagation) ---------------------

def source_nb_capability(node) -> NBDecision:
    """Can this SourceNode emit columnar NativeBatches? True for
    connector sources whose parser has the C columnar door (keyless or
    pk upsert sessions over columnar value types); static tables and
    remove()-capable subjects are tuple sources."""
    conn = None
    for c in getattr(node.scope.runtime, "connectors", ()):
        if c.node is node:
            conn = c
            break
    if conn is None:
        return NBDecision(
            False, ("static table source (rows injected as tuple deltas)",)
        )
    parser = conn.parser
    capable = bool(getattr(parser, "nb_capable", False))
    if capable:
        return FUSED
    blame = tuple(
        getattr(parser, "nb_blame", ())
    ) or ("connector parser has no columnar door",)
    return NBDecision(False, blame)


def schema_nb_blame(schema) -> tuple[str, ...]:
    """Columns whose declared dtype is outside the NativeBatch value set
    (None/bool/int64/float/str) — such sources parse on the tuple path."""
    reasons = []
    try:
        dtypes = schema._dtypes()
    except Exception:
        return ()
    for name, dtype in dtypes.items():
        base = dtype.wrapped() if dtype.is_optional() else dtype
        if getattr(base, "_name", None) not in _NB_DTYPE_NAMES:
            reasons.append(
                f"column {name!r} dtype {base!r} is outside the columnar "
                f"value set (None/bool/int/float/str)"
            )
    return tuple(reasons)


def steady_streams(node) -> bool:
    """Does this node keep DELIVERING batches in the steady streaming
    state — i.e. does a live connector source reach it? Static-table
    chains emit their initial batches and quiesce; a chain fed by a live
    connector re-fires on every commit. Memoized per node."""
    cached = getattr(node, "_steady_streams_cache", None)
    if cached is not None:
        return cached
    from pathway_tpu_torch.engine import nodes as N

    if isinstance(node, N.SourceNode):
        val = any(
            c.node is node
            for c in getattr(node.scope.runtime, "connectors", ())
        )
    else:
        val = any(steady_streams(i) for i in node.inputs)
    node._steady_streams_cache = val
    return val


def expects_native_batch(node) -> bool:
    """Static reachability of the columnar path at ``node``'s OUTPUT:
    would this node emit NativeBatches in the steady streaming state?
    Used identically by the analyzer (fusion verdicts) and the runtime
    (an exchange/join/groupby counts a *fallback* only when its input was
    expected columnar — tuple flow that was never columnar is not a
    de-optimization). Memoized per node; the graph is static by run
    time."""
    cached = getattr(node, "_expects_nb_cache", None)
    if cached is not None:
        return cached
    from pathway_tpu_torch.engine import nodes as N

    val = False
    if isinstance(node, N.SourceNode):
        val = source_nb_capability(node).ok
    elif isinstance(node, N.MemoizedRowwiseNode):
        val = False
    elif isinstance(node, N.RowwiseNode):
        # construction-time decision, NOT the mutable _nb_proj (nulled on
        # runtime demotion): the static expectation must read the same
        # before, during and after execution, or downstream fallback
        # accounting changes mid-run
        val = node.nb_decision.ok and expects_native_batch(node.inputs[0])
    elif isinstance(node, N.ExchangeNode):
        val = node.nb_decision.ok and expects_native_batch(node.inputs[0])
    elif isinstance(node, N.JoinNode):
        # the fused join gate requires every delivering input columnar
        # OR empty in the same batch. A static build side quiesces after
        # its initial tuple batch (fine); a side that keeps streaming
        # TUPLE batches — e.g. a live aggregate of the same stream —
        # coincides with the columnar side on every commit and forces
        # the tuple path every time, so it must veto the fused verdict.
        # Outer flavors are vetoed too: even on the fused path, pad
        # transitions (a side's liveness flipping) emit tuple batches
        # ("retractions disqualify the columnar output" in exec.cpp), so
        # the OUTPUT is not statically columnar — downstream nodes must
        # not count those batches as fallbacks, and NB_STRICT must not
        # abort a correct outer-join pipeline on them
        cols = [expects_native_batch(i) for i in node.inputs]
        val = (
            node.nb_decision.ok
            and node.join_type == "inner"
            and any(cols)
            and all(
                c or not steady_streams(i)
                for c, i in zip(cols, node.inputs)
            )
        )
    node._expects_nb_cache = val
    return val


def sink_consumer_columnar(node) -> NBDecision:
    """Does this egress node's CONSUMER declare columnar (Arrow-batch)
    capability? The sink half of the egress verdict: an
    OutputNode delivering through ``on_batch_arrow`` (Arrow-mode
    subscribe, the transactional file/Delta sinks) or a CaptureNode
    (whose pending chunks export columnar on read) consumes NativeBatch
    output without row expansion; a per-row ``on_change`` or a rows-mode
    ``on_batch`` expands every C-owned batch back into Python rows.
    Keyed on the consumer's *declared* capability, not on what happened
    at runtime — the Plan Doctor's ``sink.row-expanding`` diagnostic and
    the runtime's ``capture_rows_expanded_total`` counter must agree."""
    from pathway_tpu_torch.engine import nodes as N

    reasons: list[str] = []
    if isinstance(node, N.CaptureNode):
        try:
            from pathway_tpu_torch.io._arrow import arrow_capable

            if not arrow_capable():
                reasons.append(
                    "capture export needs pyarrow + the native toolchain"
                )
        except Exception:
            reasons.append("columnar capture export unavailable")
    elif isinstance(node, N.OutputNode):
        if getattr(node, "_on_batch_arrow", None) is None:
            if getattr(node, "_on_batch", None) is not None:
                reasons.append(
                    "rows-mode on_batch consumer (each delivered batch "
                    "materializes into (key, row, diff) tuples)"
                )
            if getattr(node, "_on_change", None) is not None:
                reasons.append(
                    "per-row on_change consumer (one Python call per "
                    "change)"
                )
            # no reasons = a callback-free probe (e.g. a neutered
            # non-writer rank): the runtime never materializes its
            # batches, so it cannot row-expand — verdict stays ok
        elif getattr(node, "_on_change", None) is not None:
            # rows are needed anyway for the per-row callback — the
            # arrow leg would be pure extra work, so the node stays on
            # the row path by construction
            reasons.append(
                "per-row on_change registered beside the Arrow consumer "
                "(rows must materialize regardless)"
            )
        else:
            # the Arrow consumer is declared, but can this process
            # actually export? Without pyarrow/toolchain every delivery
            # falls to the row path — claiming fused here would be
            # exactly the plan-vs-counters drift this module prevents
            try:
                from pathway_tpu_torch.io._arrow import arrow_capable

                if not arrow_capable() and not nb_capture_forced_off():
                    reasons.append(
                        "arrow egress needs pyarrow + the native "
                        "toolchain"
                    )
            except Exception:
                reasons.append("columnar egress export unavailable")
    else:
        reasons.append("not an egress node")
    if nb_capture_forced_off():
        reasons.append("PATHWAY_NO_NB_CAPTURE forces the row path")
    return NBDecision(not reasons, tuple(reasons))


def sink_input_columnar(node) -> bool:
    """Does the sink's input chain deliver columnar batches in the
    steady state? (The chain half of the egress verdict.)"""
    return bool(node.inputs) and expects_native_batch(node.inputs[0])


def sink_egress_verdict(node) -> str:
    """THE three-way egress verdict — ``"fused"`` (columnar chain +
    columnar consumer: no row ever expands), ``"row-expanding"``
    (columnar chain but a rows consumer: the sink IS the
    de-optimization), ``"degraded"`` (tuple chain: upstream fusion
    blame applies first). Shared by the analyzer's sink pass and the
    flight recorder's node metadata (via :func:`sink_row_expands`), so
    static verdict, traced verdict and the runtime's
    ``capture_rows_expanded_total`` counter cannot drift."""
    consumer = sink_consumer_columnar(node)
    columnar_in = sink_input_columnar(node)
    if consumer.ok and columnar_in:
        return "fused"
    if columnar_in:
        return "row-expanding"
    return "degraded"


def sink_row_expands(node) -> bool:
    """Does this egress pay avoidable PER-ROW Python work? True for a
    per-row ``on_change`` callback (always), a rows consumer over a
    statically-columnar chain (every C-owned batch materializes), and
    a CaptureNode that cannot read out columnar (no door, forced off,
    or tuple input — its readers expand). A batched rows consumer of
    an already-tuple chain is NOT row-expanding: those rows were never
    columnar and one callback per batch is the best possible shape."""
    from pathway_tpu_torch.engine import nodes as N

    consumer = sink_consumer_columnar(node)
    columnar_in = sink_input_columnar(node)
    if isinstance(node, N.CaptureNode):
        return not (consumer.ok and columnar_in)
    return getattr(node, "_on_change", None) is not None or (
        columnar_in and not consumer.ok
    )


def sink_egress_decision(node) -> NBDecision:
    """:func:`sink_egress_verdict` as an ``NBDecision`` (ok = fused),
    with the consumer/chain blame attached — the strict-mode-style
    handle tests and tooling consume."""
    consumer = sink_consumer_columnar(node)
    if not node.inputs:
        return NBDecision(False, ("egress node has no input",))
    if not sink_input_columnar(node):
        return NBDecision(
            False,
            ("input chain is not statically columnar (upstream blame "
             "applies — the sink is not the de-optimization)",)
            + consumer.reasons,
        )
    return consumer


def strict_error(node, event: str, cause: Exception | None = None):
    """Build the NBStrictError for a fused-eligible node leaving the
    columnar path, carrying the fusion-blame diagnostic + provenance."""
    trace = getattr(node, "trace", None)
    where = ""
    if trace is not None:
        where = f" (declared at {trace.filename}:{trace.lineno})"
    reasons = getattr(node, "nb_decision", FUSED).reasons
    blame = "; ".join(reasons) if reasons else "plan said fused"
    detail = f": {cause}" if cause is not None else ""
    return NBStrictError(
        f"PATHWAY_NB_STRICT: {type(node).__name__}#{node.node_id} "
        f"{event}{detail}{where} [{blame}] — run pw.analyze() for the "
        f"full plan report, or unset PATHWAY_NB_STRICT to allow the "
        f"tuple-path degradation"
    )
