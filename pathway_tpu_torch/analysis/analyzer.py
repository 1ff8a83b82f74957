"""The Plan Doctor: static analysis passes over a lowered operator plan.

``analyze(*tables, processes=N)`` lowers the captured ParseGraph onto a
scratch Runtime (graph construction only — no connector threads, no mesh,
no data) and runs five passes over the node graph:

1. **fusion blame** — per join/groupby/select/exchange node, the SAME
   construction-time ``nb_decision`` the executor gated its columnar path
   on (analysis/eligibility.py), plus chain propagation from columnar
   sources, so a diagnostic names the exact expression/UDF/id= that
   breaks the NativeBatch fused chain and the user frame that declared
   the operator.
2. **exchange safety** — reach/upstream exchange masks (the same
   computation the wave scheduler uses): future-time emitters
   (forget_immediately, the error log) that force per-timestamp
   negotiated frontiers, multi-input nodes stepping under the quiesce
   guard, and pure-gather legs the wave engine elides.
3. **replay/retraction safety** — non-deterministic UDFs feeding
   exchanged or persisted columns (replay-after-rollback divergence), and
   declared-deterministic UDFs whose code references wall clocks / RNGs.
4. **serving/egress sinks** — row-expanding ``on_change`` sinks that pay
   one Python callback per change (the CaptureNode-style egress
   de-optimization), with the fix hint pointing at the batched
   subscribe path.
5. **distributed safety** (multi-rank plans) — the mesh verifier
   (``analysis/meshcheck.py``) exhaustively model-checks the
   wave/rollback protocol over this plan's ACTUAL exchange topology at
   the requested rank count: deadlock, frontier divergence,
   exactly-once across rollback, dead-epoch straggler acceptance —
   before any real N-rank mesh is ever launched.
6. **knob validation** — the PATHWAY_* registry findings as diagnostics.

``analyze_scope(runtime)`` runs the same passes over an already-lowered
runtime (the agreement tests lower once, analyze, run, then compare
verdicts against the runtime fallback counters); ``audit_runtime``
asserts that no node the report called *fused* incremented a fallback
counter — the "zero false fused verdicts" guarantee.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

from pathway_tpu_torch.analysis import eligibility as elig

SEVERITIES = ("info", "warning", "error")


@dataclass
class Diagnostic:
    code: str                 # e.g. "fusion.join-key", "knob.unknown"
    severity: str             # "info" | "warning" | "error"
    node: str                 # "JoinNode#12" or "env"
    message: str
    hint: str | None = None
    where: str | None = None  # user frame: "file.py:42 (source line)"

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "severity": self.severity,
            "node": self.node,
            "message": self.message,
            "hint": self.hint,
            "where": self.where,
        }

    def render(self) -> str:
        loc = f" at {self.where}" if self.where else ""
        hint = f"\n      hint: {self.hint}" if self.hint else ""
        return (
            f"[{self.severity.upper():7}] {self.code} {self.node}{loc}\n"
            f"      {self.message}{hint}"
        )


@dataclass
class PlanReport:
    """Structured result of one analysis run."""

    verdict: str                       # "fused" | "degraded" | "tuple"
    processes: int
    nodes: list[dict] = field(default_factory=list)
    diagnostics: list[Diagnostic] = field(default_factory=list)
    # Device Doctor sub-report (analyze(device=True)): the
    # pathway_tpu_torch.analysis.device/v1 dict, None when the pass didn't run
    device: dict | None = None

    @property
    def fully_fused(self) -> bool:
        return self.verdict == "fused"

    def __getitem__(self, node_id: int) -> dict:
        for n in self.nodes:
            if n["node_id"] == node_id:
                return n
        raise KeyError(node_id)

    def by_kind(self, kind: str) -> list[dict]:
        return [n for n in self.nodes if n["kind"] == kind]

    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def to_dict(self) -> dict:
        counts = {s: 0 for s in SEVERITIES}
        for d in self.diagnostics:
            counts[d.severity] += 1
        return {
            "schema": "pathway_tpu_torch.analysis/v1",
            "verdict": self.verdict,
            "processes": self.processes,
            "summary": {
                "nodes": len(self.nodes),
                "fused_nodes": sum(
                    1 for n in self.nodes if n["verdict"] == "fused"
                ),
                "degraded_nodes": sum(
                    1 for n in self.nodes if n["verdict"] == "degraded"
                ),
                "diagnostics": counts,
            },
            "nodes": self.nodes,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            **({"device": self.device} if self.device is not None else {}),
        }

    def to_json(self, **kwargs) -> str:
        kwargs.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kwargs)

    def render(self) -> str:
        lines = [
            f"plan verdict: {self.verdict.upper()} "
            f"({self.processes} process(es), {len(self.nodes)} fusable "
            f"node(s))"
        ]
        for n in self.nodes:
            mark = {"fused": "+", "degraded": "!", "tuple": "-"}[n["verdict"]]
            lines.append(
                f"  [{mark}] {n['node']:<22} {n['verdict']:<8}"
                + (f" {n['where']}" if n.get("where") else "")
            )
        for d in self.diagnostics:
            lines.append(d.render())
        return "\n".join(lines)


def _where(node) -> str | None:
    trace = getattr(node, "trace", None)
    if trace is None:
        return None
    line = (trace.line or "").strip()
    loc = f"{trace.filename}:{trace.lineno}"
    return f"{loc} ({line})" if line else loc


def _node_label(node) -> str:
    return f"{type(node).__name__}#{node.node_id}"


# -- pass 1: fusion blame -------------------------------------------------


def _fusion_pass(runtime, diags: list[Diagnostic]) -> list[dict]:
    from pathway_tpu_torch.engine import nodes as N

    entries: list[dict] = []
    for node in runtime.scope.nodes:
        kind = None
        decision = None
        if isinstance(node, N.SourceNode):
            kind = "source"
            decision = elig.source_nb_capability(node)
        elif isinstance(node, N.MemoizedRowwiseNode):
            kind = "select"
            decision = elig.NBDecision(
                False,
                ("non-deterministic expressions route through the "
                 "memoized per-row path",),
            )
        elif isinstance(node, N.RowwiseNode):
            kind = "select"
            decision = node.nb_decision
        elif isinstance(node, N.ExchangeNode):
            kind = "exchange"
            decision = node.nb_decision
        elif isinstance(node, N.JoinNode):
            kind = "join"
            decision = node.nb_decision
        elif isinstance(node, N.GroupByNode):
            kind = "groupby"
            decision = node.nb_decision
        if kind is None:
            continue
        nb_in = any(
            elig.expects_native_batch(i) for i in node.inputs
        ) if node.inputs else False
        nb_out = elig.expects_native_batch(node)
        if kind == "source":
            verdict = "fused" if nb_out else "tuple"
        elif kind == "groupby":
            # the chain's natural terminal: fused means it CONSUMES
            # columnar; its output is always materialized rows
            verdict = (
                "fused" if (decision.ok and nb_in)
                else ("degraded" if nb_in else "tuple")
            )
        else:
            verdict = (
                "fused" if (nb_in and nb_out)
                else ("degraded" if nb_in else "tuple")
            )
        entry = {
            "node_id": node.node_id,
            "node": _node_label(node),
            "kind": kind,
            "verdict": verdict,
            "reasons": list(decision.reasons),
            "where": _where(node),
        }
        entries.append(entry)
        if verdict == "degraded":
            code = f"fusion.{kind}"
            blame = "; ".join(decision.reasons)
            if not blame and kind == "join" and node.join_type != "inner":
                blame = (
                    f"{node.join_type} join emits tuple pad-transition "
                    f"batches (unmatched-row padding retracts/re-inserts "
                    f"as a side's liveness flips), so its output is not "
                    f"statically columnar — input processing stays fused"
                )
            if not blame and kind == "join":
                tup = [
                    i for i in node.inputs
                    if not elig.expects_native_batch(i)
                    and elig.steady_streams(i)
                ]
                if tup:
                    blame = (
                        "input(s) "
                        + ", ".join(_node_label(i) for i in tup)
                        + " keep streaming tuple batches in the steady "
                        "state — the fused join needs every delivering "
                        "input columnar-or-empty per batch"
                    )
            blame = blame or "columnar input cannot be consumed columnar here"
            diags.append(
                Diagnostic(
                    code=code,
                    severity="warning",
                    node=_node_label(node),
                    message=(
                        f"NativeBatch fused chain breaks here: {blame}"
                    ),
                    hint=(
                        "keep join/groupby keys and projections as plain "
                        "columns, avoid id=/sort_by/multi-arg reducers on "
                        "the hot path, or accept the tuple path and "
                        "silence this via the runtime counters"
                    ),
                    where=_where(node),
                )
            )
        elif kind == "source" and not nb_out:
            diags.append(
                Diagnostic(
                    code="fusion.source",
                    severity="info",
                    node=_node_label(node),
                    message=(
                        "tuple source (no columnar door): "
                        + "; ".join(decision.reasons)
                    ),
                    hint=(
                        "columnar parsing needs a connector source with "
                        "append-only/pk-upsert flushes over "
                        "None/bool/int/float/str columns and the native "
                        "toolchain"
                    ),
                    where=_where(node),
                )
            )
    return entries


# -- pass 2: exchange safety ----------------------------------------------

def _exchange_pass(runtime, diags: list[Diagnostic]) -> None:
    from pathway_tpu_torch.engine import nodes as N
    from pathway_tpu_torch.engine.nodes import ForgetImmediatelyNode

    xnodes = runtime.scope.exchange_nodes
    if not xnodes:
        return
    masks = runtime._exchange_reach_masks()
    umasks = runtime._exchange_upstream_masks()

    # future-time emitters reaching an exchange force the negotiated
    # frontier (one control round-trip per timestamp) — the exact
    # predicate of runtime._planned_walk_eligible
    emitters = [
        n for n in runtime.scope.nodes
        if isinstance(n, ForgetImmediatelyNode) and masks[n.node_id]
    ]
    if (
        runtime.error_log_node is not None
        and masks[runtime.error_log_node.node_id]
    ):
        emitters.append(runtime.error_log_node)
    for n in emitters:
        what = (
            "the global error log"
            if n is runtime.error_log_node
            else "forget_immediately (t+1 retractions)"
        )
        diags.append(
            Diagnostic(
                code="exchange.future-time",
                severity="warning",
                node=_node_label(n),
                message=(
                    f"{what} reaches an exchange boundary: BSP rounds "
                    f"cannot walk commit timestamps off the shared plan "
                    f"and pay one negotiated frontier round-trip per "
                    f"timestamp"
                ),
                hint=(
                    "keep as-of-now/forget_immediately flows and "
                    "error-prone expressions off exchanged legs, or "
                    "accept the control-plane cost"
                ),
                where=_where(n),
            )
        )

    # multi-input nodes whose inputs depend on different exchange sets
    # can only step under the upstream-mask quiesce guard — correct, but
    # worth surfacing (they serialize on the slowest boundary)
    for n in runtime.scope.nodes:
        if len(n.inputs) < 2:
            continue
        in_masks = {umasks[i.node_id] | (
            1 << xnodes.index(i) if i in xnodes else 0
        ) for i in n.inputs}
        if len(in_masks) > 1 and any(m for m in in_masks):
            diags.append(
                Diagnostic(
                    code="exchange.quiesce",
                    severity="info",
                    node=_node_label(n),
                    message=(
                        "multi-input node with asymmetric upstream "
                        "exchange dependencies: steps only after the "
                        "upstream-mask quiesce guard confirms every "
                        "boundary delivered (incomplete-input hazard is "
                        "guarded, at the cost of waiting on the slowest "
                        "leg)"
                    ),
                    where=_where(n),
                )
            )

    # pure-gather legs: the wave engine elides non-rank-0 recv legs and
    # empty frames entirely — surface them so operators know the
    # boundary is control-free in the steady state
    gathers = [x for x in xnodes if x.mode == "gather"]
    if gathers:
        diags.append(
            Diagnostic(
                code="exchange.gather-elide",
                severity="info",
                node=", ".join(_node_label(x) for x in gathers),
                message=(
                    f"{len(gathers)} pure-gather leg(s) (outputs to "
                    f"rank 0): non-contributor send legs and empty "
                    f"frames are elided from the exchange waves"
                ),
            )
        )


# -- pass 3: replay / retraction safety -----------------------------------

_SUSPECT_NAMES = {
    "random", "randint", "randrange", "shuffle", "uniform", "choice",
    "getrandbits", "token_bytes", "token_hex", "uuid1", "uuid4",
    "urandom", "time", "time_ns", "monotonic", "monotonic_ns",
    "perf_counter", "perf_counter_ns", "now", "utcnow", "today",
}


def _apply_exprs(exprs):
    from pathway_tpu_torch.internals.expression import ApplyExpression

    out = []
    stack = list(exprs or ())
    while stack:
        e = stack.pop()
        if isinstance(e, ApplyExpression):
            out.append(e)
        stack.extend(e._subexpressions())
    return out


def _udf_name(e) -> str:
    return getattr(e._fun, "__name__", None) or repr(e._fun)


def _suspect_calls(fun) -> list[str]:
    code = getattr(fun, "__code__", None)
    if code is None:  # builtins / partials / C callables: nothing to scan
        return []
    # co_names only (globals + attribute loads): a LOCAL named `time` or
    # `choice` is just a variable, not a clock/RNG call
    return sorted(set(code.co_names) & _SUSPECT_NAMES)


def _replay_pass(
    runtime, diags: list[Diagnostic], persistence: bool | None = None
) -> None:
    masks = runtime._exchange_reach_masks()
    # the analyzer's scratch runtime never carries a PersistenceManager,
    # so callers that know the run will be persisted (pw.analyze's
    # ``persistence=`` flag, the CLI observing the user program's
    # persistence_config) pass the verdict in explicitly
    persisted = (
        persistence
        if persistence is not None
        else runtime.persistence is not None
    )
    for node in runtime.scope.nodes:
        exprs = getattr(node, "src_exprs", None)
        if not exprs:
            continue
        exchanged = bool(masks[node.node_id])
        for e in _apply_exprs(exprs):
            name = _udf_name(e)
            if not e._deterministic:
                if exchanged or persisted:
                    sink = "an exchanged column" if exchanged else (
                        "a persisted column"
                    )
                    diags.append(
                        Diagnostic(
                            code="replay.nondeterministic-udf",
                            severity="warning",
                            node=_node_label(node),
                            message=(
                                f"non-deterministic UDF {name!r} feeds "
                                f"{sink}: outputs are memoized for local "
                                f"retractions, but a replay after "
                                f"rollback recovery recomputes them and "
                                f"may diverge across ranks"
                            ),
                            hint=(
                                "seed the RNG from row content, or "
                                "materialize the UDF output through a "
                                "persisted source before exchanging it"
                            ),
                            where=_where(node),
                        )
                    )
            else:
                suspects = _suspect_calls(e._fun)
                if suspects:
                    diags.append(
                        Diagnostic(
                            code="replay.suspicious-udf",
                            severity="warning",
                            node=_node_label(node),
                            message=(
                                f"UDF {name!r} is declared deterministic "
                                f"but references {suspects} — wall-clock "
                                f"or RNG reads make retraction replay "
                                f"and rollback recovery diverge"
                            ),
                            hint=(
                                "pass deterministic=False (memoized "
                                "replay) or remove the non-deterministic "
                                "calls"
                            ),
                            where=_where(node),
                        )
                    )


# -- pass 4: serving/egress sinks -----------------------------------------

def _sink_pass(runtime, diags: list[Diagnostic]) -> None:
    """Egress verdicts keyed on the CONSUMER's declared capability
    (the older pass blamed per-row ``on_change``
    only, and would mis-blame an ``on_batch=`` subscriber even when its
    batches arrive columnar). Three verdicts per egress node, shared
    with the runtime counters through ``eligibility.sink_egress_
    decision``:

    * **fused** — input chain statically columnar AND the consumer is
      Arrow-capable (``batch_format='arrow'`` subscribe, the txn
      file/Delta sinks, CaptureNode's columnar export): no diagnostic,
      ``capture_rows_expanded_total`` stays flat;
    * **row-expanding** — input columnar but the consumer demands rows
      (per-row ``on_change`` / rows-mode ``on_batch``): the sink IS the
      de-optimization, ``sink.row-expanding`` fires with the consumer
      blame;
    * **degraded** — input chain not statically columnar: the sink is
      not to blame (upstream fusion blame applies); a per-row
      ``on_change`` still gets the batching hint at info severity."""
    from pathway_tpu_torch.analysis import eligibility as _elig
    from pathway_tpu_torch.engine import nodes as N

    for node in runtime.scope.nodes:
        if not isinstance(node, (N.OutputNode, N.CaptureNode)):
            continue
        verdict = _elig.sink_egress_verdict(node)
        if verdict == "fused":
            continue  # fused egress: columnar to the edge
        if verdict == "row-expanding":
            blame = "; ".join(_elig.sink_consumer_columnar(node).reasons)
            diags.append(
                Diagnostic(
                    code="sink.row-expanding",
                    severity="info",
                    node=_node_label(node),
                    message=(
                        f"columnar batches row-expand at this sink: "
                        f"{blame} — every C-owned batch materializes "
                        f"into Python rows at the egress, the expansion "
                        f"that throttles value_incl_capture"
                    ),
                    hint=(
                        "consume columnar: pw.io.subscribe(..., "
                        "on_batch=, batch_format='arrow') delivers "
                        "Arrow record batches straight off the column "
                        "buffers; pw.io.fs/csv/jsonlines/deltalake "
                        "writers already do (unset PATHWAY_NO_NB_CAPTURE "
                        "if forced off)"
                    ),
                    where=_where(node),
                )
            )
            continue
        if (
            isinstance(node, N.OutputNode)
            and node._on_change is not None
            and node._on_batch is None
        ):
            via = (
                "the C delivery loop builds its row dicts, but the "
                "callback still fires once per row"
                if node._dict_cols is not None
                else "each delivered batch expands through a Python "
                "callback"
            )
            diags.append(
                Diagnostic(
                    code="sink.row-expanding",
                    severity="info",
                    node=_node_label(node),
                    message=(
                        f"per-row on_change sink: {via} — under load "
                        f"this egress pays one Python call per change "
                        f"(input chain is not columnar here, so the "
                        f"upstream fusion blame applies first)"
                    ),
                    hint=(
                        "deliver batched: pass on_batch= to "
                        "pw.io.subscribe (one callback per delivered "
                        "batch/window) — the rest_connector response "
                        "path already fans out this way"
                    ),
                    where=_where(node),
                )
            )


# -- pass 5: distributed safety (the mesh verifier) -------------------------

def _mesh_pass(runtime, diags: list[Diagnostic], processes: int) -> None:
    """Model-check the lowered plan's ACTUAL exchange topology at
    ``processes`` ranks (analysis/meshcheck.py): exhaustively explore
    the wave/rollback protocol over the plan's boundaries — deadlock,
    frontier divergence, exactly-once across rollback, dead-epoch
    acceptance — so the user gets a distributed-safety verdict before
    ever launching a real N-rank mesh. The checker drives the SAME
    transition table (parallel/protocol.py) the runtime executes, so
    the verdict cannot drift from the engine."""
    if not runtime.scope.exchange_nodes:
        return
    import os

    if os.environ.get(
        "PATHWAY_MESHCHECK_DOCTOR", "1"
    ).strip().lower() in ("0", "false", "no"):
        return
    from pathway_tpu_torch.analysis import meshcheck

    try:
        rounds = int(os.environ.get("PATHWAY_MESHCHECK_ROUNDS", "2") or 2)
        budget = int(os.environ.get("PATHWAY_MESHCHECK_FAULTS", "1") or 1)
        cap = int(
            os.environ.get("PATHWAY_MESHCHECK_MAX_STATES", "200000")
            or 200_000
        )
    except ValueError:  # the knob pass reports the bad value itself
        rounds, budget, cap = 2, 1, 200_000
    checked_world = min(processes, 8)
    report = meshcheck.check_runtime_mesh(
        runtime,
        processes=checked_world,
        rounds=rounds,
        fault_budget=budget,
        max_states=cap,
    )
    # never let a capped check read as full coverage: the verdict names
    # the world size it actually explored
    capped = (
        f" (plan runs {processes} ranks; model checked at "
        f"{checked_world} — run `python -m pathway_tpu_torch.analysis --mesh "
        f"--processes {processes}` for the full world)"
        if checked_world < processes
        else ""
    )
    nodes = ", ".join(
        f"{_node_label(x)}[{x.mode}]"
        for x in runtime.scope.exchange_nodes
    )
    if report.ok:
        diags.append(
            Diagnostic(
                code="mesh.verified",
                severity="info",
                node=nodes,
                message=(
                    f"mesh protocol model-checked at "
                    f"{report.config.world} ranks over this plan's "
                    f"{len(runtime.scope.exchange_nodes)} exchange "
                    f"boundary(ies): {report.states} states / "
                    f"{report.transitions} interleavings explored "
                    f"(fault budget {report.config.fault_budget}) — no "
                    f"deadlock, frontier divergence, lost/duplicated "
                    f"delta, or dead-epoch acceptance" + capped
                ),
            )
        )
        return
    if not report.complete and not report.violations:
        diags.append(
            Diagnostic(
                code="mesh.incomplete",
                severity="warning",
                node=nodes,
                message=(
                    f"mesh model check hit the "
                    f"PATHWAY_MESHCHECK_MAX_STATES cap ({report.states} "
                    f"states) before exhausting the space — no violation "
                    f"found, but the verdict is not exhaustive"
                ),
                hint="raise PATHWAY_MESHCHECK_MAX_STATES or lower "
                     "PATHWAY_MESHCHECK_ROUNDS/_FAULTS",
            )
        )
        return
    for v in report.violations:
        plan = v.fault_plan()
        diags.append(
            Diagnostic(
                code=f"mesh.{v.kind}",
                severity="error",
                node=nodes,
                message=(
                    f"mesh model check found a {v.kind} violation at "
                    f"{report.config.world} ranks: {v.detail}"
                ),
                hint=(
                    "replay the minimal trace: PATHWAY_FAULT_PLAN='"
                    + json.dumps(plan, separators=(",", ":"))
                    + "'"
                    if plan
                    else "run python -m pathway_tpu_torch.analysis --mesh "
                         "for the full trace"
                ),
            )
        )


# -- pass 6: knob validation ----------------------------------------------

def _knob_pass(diags: list[Diagnostic]) -> None:
    from pathway_tpu_torch.analysis.knobs import (
        knob_check_disabled,
        validate_environment,
    )

    # mirror the runtime's startup gate: PATHWAY_KNOB_CHECK=0 downgrades
    # rejection to a warning, so the CLI's errors()-based exit code (and
    # any CI lane keyed on it) honors the same escape hatch
    severity = "warning" if knob_check_disabled() else "error"
    for name, problem, hint in validate_environment():
        code = "knob.unknown" if "unknown" in problem else "knob.invalid"
        diags.append(
            Diagnostic(
                code=code,
                severity=severity,
                node="env",
                message=f"{name}: {problem}",
                hint=hint,
            )
        )


# -- pass 6: device dispatch plane (the Device Doctor) ----------------------

def _device_pass(
    runtime, diags: list[Diagnostic], processes: int
) -> dict | None:
    """Statically lower every registered device chain reachable from the
    plan (analysis/device_plan.py) — donation aliasing, host syncs,
    retrace buckets, the per-chip HBM budget, and the mesh/merge layout
    — with zero execution. Folds the Doctor's diagnostics into the plan
    report and returns the structured device sub-report. The checks
    consume the SAME jitted callables and bucket/cost models the runtime
    dispatch sites use (internals/device.py), so the verdict cannot
    drift from what actually compiles."""
    import os

    if os.environ.get(
        "PATHWAY_DEVICE_DOCTOR", "1"
    ).strip().lower() in ("0", "false", "no"):
        return None
    from pathway_tpu_torch.analysis.device_plan import analyze_device_plan

    reachable: set[str] = set()
    for node in runtime.scope.nodes:
        sites = getattr(node, "device_sites", None)
        if callable(sites):
            reachable.update(sites())
    report = analyze_device_plan(world=processes)
    if reachable:
        # scope the plan-level blame to chains the plan actually reaches;
        # the full sub-report still carries every chain's verdict
        diags.extend(
            d for d in report.diagnostics
            if d.severity != "info" and (
                d.node in reachable
                or any(d.node.startswith(s.split(".")[0]) for s in reachable)
            )
        )
    else:
        diags.extend(d for d in report.diagnostics if d.severity == "error")
    device = report.to_dict()
    device["reachable_sites"] = sorted(reachable)
    return device


# -- entry points ---------------------------------------------------------

def analyze_scope(
    runtime,
    processes: int | None = None,
    persistence: bool | None = None,
    device: bool = False,
) -> PlanReport:
    """Run all passes over an already-lowered runtime. Purely static:
    reads construction-time node attributes only, so it is valid before,
    during, or after execution (runtime demotions don't change it).
    ``persistence`` overrides the replay pass's persisted-run detection
    (None = read it off ``runtime.persistence``)."""
    if processes is None:
        from pathway_tpu_torch.internals.config import get_pathway_config

        processes = max(1, get_pathway_config().processes)
    diags: list[Diagnostic] = []
    entries = _fusion_pass(runtime, diags)
    _exchange_pass(runtime, diags)
    _replay_pass(runtime, diags, persistence=persistence)
    _sink_pass(runtime, diags)
    if processes > 1:
        _mesh_pass(runtime, diags, processes)
    device_report = (
        _device_pass(runtime, diags, processes) if device else None
    )
    _knob_pass(diags)

    has_nb_source = any(
        n["kind"] == "source" and n["verdict"] == "fused" for n in entries
    )
    degraded = any(n["verdict"] == "degraded" for n in entries)
    if degraded:
        verdict = "degraded"
    elif has_nb_source:
        verdict = "fused"
    else:
        verdict = "tuple"
    order = {s: i for i, s in enumerate(("error", "warning", "info"))}
    diags.sort(key=lambda d: order[d.severity])
    return PlanReport(
        verdict=verdict,
        processes=processes,
        nodes=entries,
        diagnostics=diags,
        device=device_report,
    )


def analyze(
    *tables,
    graph=None,
    processes: int | None = None,
    include_outputs: bool = True,
    persistence: bool | None = None,
    device: bool = False,
) -> PlanReport:
    """Statically analyze the captured plan WITHOUT executing it.

    Lowers the reachable operators onto a scratch Runtime (graph
    construction only: no connector threads, no process mesh, no rows)
    under an optional ``processes=N`` overlay so multi-rank plans show
    their exchange boundaries, then runs the diagnostic passes.
    ``persistence=True`` tells the replay pass the run will persist
    state (the scratch lowering itself never configures persistence, so
    without the flag single-rank replay hazards stay invisible).
    """
    from pathway_tpu_torch.engine.runtime import Runtime
    from pathway_tpu_torch.internals.config import (
        get_pathway_config,
        pop_config_overlay,
        push_config_overlay,
    )
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.internals.parse_graph import G

    graph = graph or G
    targets = [t._source for t in tables if t._source is not None]
    if include_outputs:
        targets += [
            op for op in graph.output_operators() if op not in targets
        ]
    if not targets:
        targets = list(graph.operators)
    ops = graph.reachable_operators(targets)

    world = (
        processes
        if processes is not None
        else max(1, get_pathway_config().processes)
    )
    token = None
    if processes is not None:
        token = push_config_overlay(processes=processes, process_id=0)
    try:
        runtime = Runtime(validate_env=False)
        GraphRunner(graph)._lower(ops, runtime)
        return analyze_scope(
            runtime, processes=world, persistence=persistence,
            device=device,
        )
    finally:
        if token is not None:
            pop_config_overlay(token)


def audit_runtime(runtime, report: PlanReport) -> list[str]:
    """Compare a (post-run) runtime's fallback counters against the
    report's static verdicts: no node the analyzer called *fused* may
    have counted a fallback (zero false "fused" verdicts). Returns the
    list of mismatches (empty = agreement)."""
    from pathway_tpu_torch.engine import nodes as N

    problems: list[str] = []
    for entry in report.nodes:
        node = runtime.scope.nodes[entry["node_id"]]
        if entry["verdict"] != "fused":
            continue
        if isinstance(node, N.ExchangeNode):
            if node._fallbacks:
                problems.append(
                    f"{entry['node']} verdict=fused but counted "
                    f"{node._fallbacks} exchange tuple fallback(s)"
                )
        elif isinstance(node, (N.JoinNode, N.GroupByNode, N.RowwiseNode)):
            if getattr(node, "_nb_fallbacks", 0):
                problems.append(
                    f"{entry['node']} verdict=fused but counted "
                    f"{node._nb_fallbacks} nb fallback(s)"
                )
    return problems
