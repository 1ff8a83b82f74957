"""Plan-doctor CLI.

    python -m pathway_tpu_torch.analysis [--json] [--processes N]
        [--require-fused] program.py [prog args...]
    python -m pathway_tpu_torch.analysis --bench [--json]
        [--update-artifact BENCH_JSON]
    python -m pathway_tpu_torch.analysis --device-plan [--processes N]
        [--device-mutant NAME] [--profile TRACE_JSON] [--json]
    python -m pathway_tpu_torch.analysis --mesh [--processes N]
        [--mesh-rounds D] [--mesh-faults F] [--mesh-mutant NAME]
        [--json] [program.py]
    python -m pathway_tpu_torch.analysis --serve [--serve-requests N]
        [--mesh-faults F] [--serve-mutant NAME] [--json]
    python -m pathway_tpu_torch.analysis --profile trace.json [--top K] [--json]
    python -m pathway_tpu_torch.analysis --critical-path trace.json
        [--top K] [--json]

Profile mode (hot-path blame) joins a PATHWAY_TRACE flight-recorder
trace back onto the plan metadata embedded at dump time — the same
NBDecision objects the executor gates on — and reports the top-k nodes
by measured self-time, each with its fused / degraded / row-expanding-
sink verdict (analysis/profile.py). Exit 0 = valid trace, 2 = schema
problems.

Critical-path mode (``--critical-path``) walks a merged
multi-rank trace's wave spans: each wave's wall-clock is attributed to
(rank, compute / send / recv-wait / decode) legs, per-wave straggler
spread sums to ``mesh_skew_seconds``, the dominant recv-wait cell names
the straggler rank joined with its hottest node's NBDecision verdict,
and ``speedup_if_balanced`` predicts the wall-clock ratio if per-rank
pre-send work were equalized (analysis/critical_path.py). Same exit
codes as profile mode.

Doctor options go BEFORE the program path; everything after it is the
program's own argv (flags included), exactly like ``python script.py``.

Serve mode (``--serve``) runs the serving-plane verifier
(``analysis/meshcheck.py check_serving``) over the epoch-survivable
frontend's park/replay protocol: every interleaving of arrivals, window
commits, response deliveries, backend crashes and epoch+1 reattaches,
checking that no admitted request is lost or answered twice across
rollbacks and that all-parked windows commit nothing. ``--serve-mutant
replay_committed_window`` must be caught — the serving checker's own
regression test.

Mesh mode runs the exhaustive bounded model checker
(``analysis/meshcheck.py``) over the wave/rollback protocol: with a
program, against that plan's ACTUAL exchange topology; without one,
against the canonical hash→gather shape. It reports state/interleaving
counts and any violation with a minimal trace rendered as a replayable
``PATHWAY_FAULT_PLAN`` (``scripts/fault_matrix.py --from-trace`` runs
it as a real kill-and-resume cell). ``--mesh-mutant`` checks a
deliberately broken protocol variant — the checker must catch it, which
is the checker's own regression test.

Program mode loads the user program with ``Runtime.run`` stubbed out:
``pw.run()`` still LOWERS the captured graph (cheap, pure construction)
but never starts connector threads or the process mesh; the captured
ParseGraph is then analyzed. ``--require-fused`` exits non-zero unless
the plan verdict is "fused" — the CI gate for "this pipeline must stay
on the NativeBatch fused chain".

Bench mode analyzes the canonical bench pipeline shapes
(analysis/bench.py) and, with ``--update-artifact PATH``, annotates the
matching metric lines of the bench artifact at PATH in place with
``plan_verdict`` so future perf regressions triage as "plan degraded" vs
"engine slower". No file is written unless a path is given.

Device-plan mode runs the Device Doctor (analysis/device_plan.py) over
every registered device chain, traced on meta tensors: nothing launches
and nothing is allocated on the card. Exit 0 = no error, 2 = an error
diagnostic (a seeded ``--device-mutant`` must give 2).
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import sys


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _load_user_program(args) -> bool:
    """Load the user program with ``Runtime.run`` stubbed out: ``pw.run()``
    still LOWERS the captured graph (cheap, pure construction) but never
    starts connector threads or the process mesh. Returns whether the
    program configured persistence (its ``pw.run(persistence_config=...)``
    reaches Runtime as ``persistence=`` — the replay pass needs to know,
    since the analyzer's own scratch Runtime never persists). Shared by
    program mode and mesh mode so the delicate stub-and-restore dance
    exists exactly once."""
    from pathway_tpu_torch.engine.runtime import Runtime

    prog = args.program
    sys.argv = [prog, *args.arguments]
    sys.path.insert(0, os.path.dirname(os.path.abspath(prog)) or ".")
    orig_run = Runtime.run
    orig_init = Runtime.__init__
    Runtime.run = lambda self, *a, **k: None  # lower, never execute
    # knob findings must land as knob.* diagnostics in the report, not as
    # a KnobError traceback out of the user program's own pw.run()
    seen = {"persistence": False}

    def _init(self, *a, **k):
        if k.get("persistence") is not None:
            seen["persistence"] = True
        return orig_init(self, *a, **{**k, "validate_env": False})

    Runtime.__init__ = _init
    try:
        # run_name="__main__" executes the program's `if __name__ ==`
        # block, so a `sys.exit(main())` tail must not abort the doctor
        # (with SystemExit(0) a --require-fused gate would vacuously
        # pass, with no report at all) — the graph is captured, analyze
        try:
            runpy.run_path(prog, run_name="__main__")
        except SystemExit:
            pass
    finally:
        Runtime.run = orig_run
        Runtime.__init__ = orig_init
    return seen["persistence"]


def _analyze_program(args) -> int:
    from pathway_tpu_torch.analysis.analyzer import analyze

    persisted = _load_user_program(args)
    report = analyze(
        processes=args.processes,
        persistence=persisted or None,
    )
    if args.json:
        print(report.to_json())
    else:
        print(report.render())
    if args.require_fused and not report.fully_fused:
        print(
            f"plan is {report.verdict!r}, not fused (--require-fused)",
            file=sys.stderr,
        )
        return 1
    if report.errors():
        return 2
    return 0


def _lower_program_runtime(args):
    """Load (via the shared ``_load_user_program`` stub) + lower the
    user program without executing it; returns the scratch runtime
    carrying the lowered plan for topology extraction."""
    from pathway_tpu_torch.engine.runtime import Runtime
    from pathway_tpu_torch.internals.config import (
        pop_config_overlay,
        push_config_overlay,
    )
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.internals.parse_graph import G

    _load_user_program(args)
    targets = G.output_operators() or list(G.operators)
    ops = G.reachable_operators(targets)
    token = push_config_overlay(
        processes=args.processes or 2, process_id=0
    )
    try:
        runtime = Runtime(validate_env=False)
        GraphRunner(G)._lower(ops, runtime)
    finally:
        pop_config_overlay(token)
    return runtime


def _analyze_mesh(args) -> int:
    from pathway_tpu_torch.analysis import meshcheck

    world = args.processes or _env_int("PATHWAY_MESHCHECK_RANKS", 3)
    rounds = (
        args.mesh_rounds
        if args.mesh_rounds is not None
        else _env_int("PATHWAY_MESHCHECK_ROUNDS", 2)
    )
    faults = (
        args.mesh_faults
        if args.mesh_faults is not None
        else _env_int("PATHWAY_MESHCHECK_FAULTS", 1)
    )
    cap = _env_int("PATHWAY_MESHCHECK_MAX_STATES", 200_000)
    # gather-tree topology: --mesh-tree overrides, else the
    # LIVE env (falling back to "auto") — the checker must explore the
    # topology the real engine would drive, on every doctor path
    tree_kw = {
        "tree_knob": (
            args.mesh_tree
            if args.mesh_tree is not None
            else os.environ.get("PATHWAY_MESH_TREE_FANOUT", "auto")
        )
    }
    sink_kw = (
        {
            "sink": True,
            "fault_phases": meshcheck.SINK_FAULT_PHASES,
        }
        if args.sink
        else {}
    )
    if args.sink and not args.rescale:
        # transactional-egress verification: the sink model
        # over all crash interleavings — fixed world AND one rescale
        # window (staged output is (tag, world)-scoped; pending
        # partitions of the dead world must be re-owned through
        # shard_owner), mirroring the fault grid's rescale cell
        reports = []
        for target in (None, world + 1):
            reports.append(
                meshcheck.check(
                    meshcheck.MeshCheckConfig(
                        world=world,
                        rounds=rounds,
                        fault_budget=faults,
                        max_states=cap,
                        mutate=args.mesh_mutant,
                        rescale_to=target,
                        **(
                            {"snap_every": 1}
                            if target is not None
                            else {}
                        ),
                        **sink_kw,
                        **tree_kw,
                    )
                )
            )
        if args.json:
            print(json.dumps([r.to_dict() for r in reports], indent=2))
        else:
            for r in reports:
                print(r.render())
        if any(r.violations for r in reports):
            return 2
        if not all(r.complete for r in reports):
            print(
                "state space NOT exhausted "
                "(PATHWAY_MESHCHECK_MAX_STATES); verdict inconclusive",
                file=sys.stderr,
            )
            return 3
        return 0
    if args.rescale:
        # elastic-mesh verification: model-check the rescale
        # transition over all crash interleavings of the rescale window
        # — a GROW (world -> world+1) and a SHRINK (world -> world-1)
        # run, each from a committed pre-rescale store. The supervisor
        # may fire the rescale at any explorable point, so the reap /
        # re-shard-restore / first-wave phases are all inside the
        # explored window; snap_every=1 keeps cuts committing around it.
        targets = [world + 1] + ([world - 1] if world > 1 else [])
        reports = []
        for target in targets:
            report = meshcheck.check(
                meshcheck.MeshCheckConfig(
                    world=world,
                    rounds=rounds,
                    fault_budget=faults,
                    max_states=cap,
                    mutate=args.mesh_mutant,
                    rescale_to=target,
                    snap_every=1,
                    **sink_kw,
                    **tree_kw,
                )
            )
            reports.append(report)
        if args.json:
            print(json.dumps(
                [r.to_dict() for r in reports], indent=2
            ))
        else:
            for r in reports:
                print(r.render())
        if any(r.violations for r in reports):
            return 2
        if not all(r.complete for r in reports):
            print(
                "state space NOT exhausted "
                "(PATHWAY_MESHCHECK_MAX_STATES); verdict inconclusive",
                file=sys.stderr,
            )
            return 3
        return 0
    if args.program:
        runtime = _lower_program_runtime(args)
        report = meshcheck.check_runtime_mesh(
            runtime,
            processes=world,
            rounds=rounds,
            fault_budget=faults,
            max_states=cap,
            mutate=args.mesh_mutant,
            tree_knob=args.mesh_tree,
        )
    else:
        report = meshcheck.check(
            meshcheck.MeshCheckConfig(
                world=world,
                rounds=rounds,
                fault_budget=faults,
                max_states=cap,
                mutate=args.mesh_mutant,
                **tree_kw,
            )
        )
    if args.json:
        print(report.to_json())
    else:
        print(report.render())
    if report.violations:
        return 2
    if not report.complete:
        print(
            "state space NOT exhausted (PATHWAY_MESHCHECK_MAX_STATES); "
            "verdict inconclusive",
            file=sys.stderr,
        )
        return 3
    return 0


def _analyze_serve(args) -> int:
    """Serving-plane verifier: exhaustively model-check the
    park/replay protocol of the epoch-survivable frontend — the same
    ``serve_*`` transitions of parallel/protocol.py the frontend and
    the gateway breaker drive through at runtime."""
    from pathway_tpu_torch.analysis import meshcheck

    report = meshcheck.check_serving(
        meshcheck.ServeCheckConfig(
            requests=args.serve_requests,
            fault_budget=(
                args.mesh_faults
                if args.mesh_faults is not None
                else _env_int("PATHWAY_MESHCHECK_FAULTS", 1)
            ),
            mutate=args.serve_mutant,
        )
    )
    if args.json:
        print(report.to_json())
    else:
        print(report.render())
    if report.violations:
        return 2
    if not report.complete:
        print("state space NOT exhausted; verdict inconclusive",
              file=sys.stderr)
        return 3
    return 0


def _analyze_pace(args) -> int:
    """Pacing verifier: exhaustively model-check the memory
    governor's pause/resume loop — the same mem_ladder / pace_decide /
    pace_resume transitions of parallel/protocol.py the runtime's
    governance pass and the connector self-pacing drive at runtime.
    Proves a paced source can never deadlock against the drain that
    unpauses it, across pressure spikes, crashes and rescale restores."""
    from pathway_tpu_torch.analysis import meshcheck

    report = meshcheck.check_pacing(
        meshcheck.PaceCheckConfig(
            rows=args.pace_rows,
            mutate=args.pace_mutant,
        )
    )
    if args.json:
        print(report.to_json())
    else:
        print(report.render())
    if report.violations:
        return 2
    if not report.complete:
        print("state space NOT exhausted; verdict inconclusive",
              file=sys.stderr)
        return 3
    return 0


def _analyze_profile(args) -> int:
    from pathway_tpu_torch.analysis.profile import (
        profile_trace,
        render_profile,
    )

    try:
        report = profile_trace(args.profile, top_k=args.top)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"[ERROR  ] trace.unreadable {args.profile}\n      {exc}",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(render_profile(report))
    return 0 if report["valid"] else 2


def _analyze_critical_path(args) -> int:
    """Wave critical-path mode: walk the merged multi-rank
    trace's wave spans and attribute each wave's wall-clock to
    (rank, compute/send/recv-wait/decode) legs, with a straggler
    verdict and a predicted speedup-if-balanced
    (analysis/critical_path.py). Exit 0 = valid trace (a single-rank
    trace reports "no waves" but is not an error), 2 = schema problems."""
    from pathway_tpu_torch.analysis.critical_path import (
        critical_path,
        render_critical_path,
    )

    try:
        report = critical_path(args.critical_path, top_waves=args.top)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(
            f"[ERROR  ] trace.unreadable {args.critical_path}\n"
            f"      {exc}",
            file=sys.stderr,
        )
        return 2
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(render_critical_path(report))
    return 0 if report["valid"] else 2


def _analyze_bench(args) -> int:
    from pathway_tpu_torch.analysis.bench import (
        BENCH_DEVICE_METRIC_CHAINS,
        BENCH_METRIC_PLANS,
        bench_verdicts,
        device_chain_verdicts,
        write_artifact_atomic,
    )

    verdicts = bench_verdicts()
    if args.json:
        print(json.dumps(verdicts, indent=2))
    else:
        for name, verdict in sorted(verdicts.items()):
            print(f"{name:<24} {verdict}")
    if args.update_artifact:
        path = args.update_artifact
        try:
            with open(path) as f:
                artifact = json.load(f)
        except (OSError, json.JSONDecodeError):
            print(f"no artifact at {path}", file=sys.stderr)
            return 1
        chain_verdicts = device_chain_verdicts()
        n = nd = 0
        for entry in artifact:
            if not isinstance(entry, dict):
                continue
            plan = BENCH_METRIC_PLANS.get(entry.get("metric"))
            if plan is not None:
                name, world = plan
                entry["plan_verdict"] = verdicts[f"{name}@{world}rank"]
                n += 1
            chain = BENCH_DEVICE_METRIC_CHAINS.get(entry.get("metric"))
            if chain is not None and chain in chain_verdicts:
                entry["device_plan_verdict"] = (
                    f"device-{chain_verdicts[chain]}"
                )
                nd += 1
        write_artifact_atomic(path, artifact)
        print(
            f"annotated {n} metric line(s) "
            f"(+{nd} device lane(s)) in {path}"
        )
    return 0


def _analyze_device_plan(args) -> int:
    from pathway_tpu_torch.analysis.device_plan import (
        analyze_device_plan,
        join_profile,
    )

    report = analyze_device_plan(
        world=args.processes or 1, mutant=args.device_mutant
    )
    if args.profile:
        try:
            report = join_profile(report, args.profile)
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            print(
                f"[ERROR  ] trace.unreadable {args.profile}\n"
                f"      {exc}",
                file=sys.stderr,
            )
            return 2
    if args.json:
        print(report.to_json())
    else:
        print(report.render())
    if report.errors():
        return 2
    if args.require_device_clean and not report.device_clean:
        return 1
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pathway_tpu_torch.analysis",
        description="Plan Doctor: static dataflow-plan analysis",
    )
    parser.add_argument("program", nargs="?", help="pipeline program to analyze")
    # REMAINDER: everything after the program path is the PROGRAM's argv
    # (flags included — `doctor prog.py --limit 5` must forward --limit,
    # not die on 'unrecognized arguments'); doctor options go BEFORE it
    parser.add_argument(
        "arguments", nargs=argparse.REMAINDER, help="program arguments"
    )
    parser.add_argument("--json", action="store_true", help="JSON report")
    parser.add_argument(
        "--processes", type=int, default=None,
        help="analyze the plan as an N-rank mesh (exchange boundaries)",
    )
    parser.add_argument(
        "--require-fused", action="store_true",
        help="exit non-zero unless the plan verdict is 'fused' (CI gate)",
    )
    parser.add_argument(
        "--bench", action="store_true",
        help="analyze the canonical bench pipelines instead of a program",
    )
    parser.add_argument(
        "--mesh", action="store_true",
        help="exhaustively model-check the mesh wave/rollback protocol "
             "(against the program's exchange topology, or the "
             "canonical one without a program)",
    )
    parser.add_argument(
        "--mesh-rounds", type=int, default=None,
        help="checker wave depth: BSP rounds per rank "
             "(default PATHWAY_MESHCHECK_ROUNDS)",
    )
    parser.add_argument(
        "--mesh-faults", type=int, default=None,
        help="injected-crash budget per interleaving "
             "(default PATHWAY_MESHCHECK_FAULTS)",
    )
    parser.add_argument(
        "--mesh-mutant", default=None,
        help="check a deliberately broken protocol variant "
             "(skip_quiesce | accept_dead_epoch | "
             "drop_rollback_retraction | drop_reshard_shard | "
             "drop_relay) — the checker must catch it",
    )
    parser.add_argument(
        "--mesh-tree", default=None,
        help="gather-tree topology to explore (PATHWAY_MESH_TREE_FANOUT "
             "syntax: auto | off | fanout>=2; default: the live env, "
             "falling back to auto — tree at world >= 4)",
    )
    parser.add_argument(
        "--sink", action="store_true",
        help="with --mesh: model the transactional-egress plane "
             " — final-hop deliveries stage, pre-commit at "
             "the cut, finalize after the marker; audits no-lost/"
             "no-duplicated committed output over all crash "
             "interleavings INCLUDING a rescale window (mutant: "
             "--mesh-mutant finalize_before_marker)",
    )
    parser.add_argument(
        "--rescale", action="store_true",
        help="with --mesh: model-check the elastic-mesh rescale "
             "transition — a grow (N->N+1) and a shrink "
             "(N->N-1) run over all crash interleavings of the rescale "
             "window, verifying re-sharded restores lose/duplicate no "
             "deltas and dead-world stragglers are rejected",
    )
    parser.add_argument(
        "--serve", action="store_true",
        help="exhaustively model-check the serving plane's park/replay "
             "protocol (epoch-survivable frontend): no "
             "admitted request lost or answered twice across rollbacks",
    )
    parser.add_argument(
        "--serve-requests", type=int, default=3,
        help="with --serve: symbolic request count (default 3)",
    )
    parser.add_argument(
        "--serve-mutant", default=None,
        help="with --serve: check a deliberately broken serving variant "
             "(replay_committed_window) — the checker must catch it",
    )
    parser.add_argument(
        "--pace", action="store_true",
        help="exhaustively model-check the memory-governor pacing loop "
             "(bounded-memory backpressure): a paced source "
             "never deadlocks against the drain that unpauses it, and "
             "every row is delivered exactly once across pressure "
             "spikes, crash restores and rescales",
    )
    parser.add_argument(
        "--pace-rows", type=int, default=4,
        help="with --pace: symbolic source row count (default 4)",
    )
    parser.add_argument(
        "--pace-mutant", default=None,
        help="with --pace: check a deliberately broken governance "
             "variant (never_resume) — the checker must catch it",
    )
    parser.add_argument(
        "--device-plan", action="store_true",
        help="Device Doctor: trace every registered device dispatch "
             "chain (fused ingest, KNN scan/write, sharded search/write, "
             "encoder forward; the fused KNN kernel pair as a shape model) "
             "on meta tensors, with no launch and no allocation, and "
             "audit in-place index writes, host syncs, shape buckets "
             "(CUDA graphs), the per-card memory budget, and the "
             "mesh/merge layout; combine with --profile TRACE_JSON to "
             "join measured recompiles onto the static predictions "
             "(drift verdict), --processes N for the declared world",
    )
    parser.add_argument(
        "--require-device-clean", action="store_true",
        help="with --device-plan: exit non-zero unless the device "
             "verdict is 'device-clean' (CI gate)",
    )
    parser.add_argument(
        "--device-mutant", default=None,
        help="with --device-plan: analyze a deliberately broken chain "
             "(undonated_write | host_sync | unbounded_buckets | "
             "over_budget) — the doctor must catch it",
    )
    parser.add_argument(
        "--update-artifact", default=None, metavar="BENCH_JSON",
        help="with --bench: annotate the metric lines of the bench "
             "artifact at this path with plan_verdict (written in place; "
             "nothing is written without a path)",
    )
    parser.add_argument(
        "--profile", default=None, metavar="TRACE_JSON",
        help="hot-path blame: profile a PATHWAY_TRACE flight-recorder "
             "trace — top-k nodes by self-time with fused/degraded/"
             "row-expanding verdicts",
    )
    parser.add_argument(
        "--critical-path", default=None, metavar="TRACE_JSON",
        help="wave critical-path analysis of a merged multi-rank trace: "
             "per-wave (rank, compute/send/recv-wait/decode) "
             "attribution, mesh_skew_seconds, straggler verdict and "
             "predicted speedup-if-balanced",
    )
    parser.add_argument(
        "--top", type=int, default=10,
        help="with --profile: how many nodes to report; with "
             "--critical-path: how many worst waves (default 10)",
    )
    args = parser.parse_args(argv)
    # the doctor must DIAGNOSE a broken environment, not crash on it:
    # config-backed knobs validate lazily (config._load_config), so a
    # bad PATHWAY_* var raises KnobError out of the analysis/lowering
    # calls below — caught here instead of crashing the package import
    from pathway_tpu_torch.analysis.knobs import KnobError

    try:
        if args.device_plan:
            return _analyze_device_plan(args)
        if args.profile:
            return _analyze_profile(args)
        if args.critical_path:
            return _analyze_critical_path(args)
        if args.serve:
            return _analyze_serve(args)
        if args.pace:
            return _analyze_pace(args)
        if args.mesh:
            return _analyze_mesh(args)
        if args.bench:
            return _analyze_bench(args)
        if not args.program:
            parser.error(
                "a program path (or --bench/--mesh/--serve/--pace) is "
                "required"
            )
        return _analyze_program(args)
    except KnobError as e:
        print(f"[ERROR  ] knob.invalid env\n      {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
