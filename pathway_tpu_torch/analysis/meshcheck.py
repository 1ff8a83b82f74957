"""Mesh Verifier: exhaustive bounded model checking of the wave/rollback
protocol.

The multi-rank engine's correctness rests on a hand-rolled protocol —
wave-stepped BSP exchange (``PWX2``), heartbeat/timeout failure
detection (``PWHB``), goodbye-vs-crash classification (``PWBY``),
epoch-bound handshakes and supervisor rollback — that until this module
was validated only by an 8-cell fault grid at 2 ranks: a handful of
interleavings out of the astronomically many a 4/8-rank mesh will hit.
This checker explores **all** of them, bounded by rank count, round
depth and fault budget.

Anti-drift, as the plan doctor does it: the protocol's *decisions* (wave partition,
quiesce guard, leg elision, frontier agreement, commit-timestamp walk,
handshake acceptance, liveness verdicts, the supervisor's rollback
choice) are NOT re-modeled here. They live in
``pathway_tpu_torch/parallel/protocol.py`` as pure transition functions that
``engine/runtime.py``, ``parallel/procgroup.py`` and
``parallel/supervisor.py`` drive through at runtime — and this checker
drives through the *same objects* (``Transitions`` below binds
``protocol.TRANSITIONS`` entries; tests/test_meshcheck.py pins the
identity exactly like test_plan_doctor.py pins the shared ``NBDecision``
objects). What this module adds is everything around the decisions: the
per-rank state machine, the network of in-flight frames, the durable
store, the supervisor, and a deterministic scheduler.

Exploration: DFS over the interleaving graph with full-state hashing,
plus a partial-order reduction — each scheduler action runs a rank's
*deterministic* micro-steps to completion atomically (rank-local steps
and link-appends commute across ranks; the only explored branch points
are fault firings, frame arrivals vs. failure detection, barrier
resolution and supervisor moves). When a violation is found under DFS
the state space is re-searched breadth-first from the root so the
reported counterexample is a *minimal* interleaving trace; its crash
choices are rendered as a replayable ``PATHWAY_FAULT_PLAN``
(``internals/faults.py`` rule syntax — ``scripts/fault_matrix.py
--from-trace`` runs them as real kill-and-resume grid cells).

Properties checked:

* **deadlock** — a reachable state where no rank can step, no frame can
  arrive, no failure can be detected and the supervisor has no move
  (e.g. a quiesced multi-input boundary that can never be released);
* **frontier divergence** — two same-epoch ranks whose committed
  timestamp sequences are not prefix-compatible;
* **exactly-once** — on every *clean* terminal state, every workload
  delta reached its destination exactly once across any number of
  rollbacks (missing = lost, count>1 = duplicated — e.g. a dropped
  rollback retraction);
* **dead-epoch straggler** — a rank surviving from a rolled-back epoch
  must never be accepted into the recovered mesh;
* **wave desync** — a rank receiving an exchange frame it did not
  expect (send/recv leg asymmetry);
* **missing snapshot** — the commit marker naming a cut for which some
  rank's snapshot does not durably exist (two-phase commit violation).

Faults are drawn from the existing ``internals/faults.py`` points: the
checker crashes ranks at the same phase-tagged ``mesh.rank_kill`` slots
(``wave_send``, ``post_snapshot``, ``restore``) the engine's fault
hooks expose, with per-(rank, phase) hit counters matching the plan
semantics — which is what makes the traces replayable.

Mutation testing: ``mutate=`` swaps in a deliberately broken protocol
variant (``skip_quiesce``, ``accept_dead_epoch``,
``drop_rollback_retraction``) — each must be caught with a minimal
trace, proving the checker can actually see the bug classes it claims
to rule out.

Elastic mesh: ``rescale_to=`` arms a one-shot supervisor
rescale directive the scheduler may fire at ANY explorable point — a
voluntary reap + respawn into a different world size whose restore
re-buckets the committed store through the shared ``reshard_keep``
transition (exactly what ``persistence/reshard.py`` does to the real
stores; token routes resolve their hash destinations against the
CURRENT world via ``shard_owner``, so the workload re-partitions like
the engine's key-routed rows). The terminal audit then additionally
proves the committed-store half of exactly-once: every hash-hop entry
applied on exactly one rank of the final world — where a broken
re-shard (the ``drop_reshard_shard`` mutant) loses or duplicates whole
shards. Dead-WORLD stragglers are modeled like dead-epoch ones (the
hello binds both).

CLI: ``python -m pathway_tpu_torch.analysis --mesh [--processes N]
[--mesh-rounds D] [--mesh-faults F] [--mesh-mutant NAME] [--rescale]
[--json]``; ``check_runtime_mesh`` runs the checker against a *lowered
plan's* actual exchange topology (the Plan Doctor's distributed-safety
pass).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, NamedTuple

from pathway_tpu_torch.parallel import protocol as _proto

CRASH_EXIT_CODE = 27  # faults.CRASH_EXIT_CODE (kept import-light)
KILLED_EXIT_CODE = 137  # SIGKILL from the supervisor's reap

FAULT_POINT = "mesh.rank_kill"  # the injection point traces replay through
FAULT_PHASES = ("wave_send", "post_snapshot", "restore")
# the sink model's extra kill slot: a rank dying AFTER the marker moved
# but BEFORE its local finalize — the window sink_recover's "finalize"
# verdict exists for. Crashes here replay through the engine's own
# ``sink.finalize`` fault point (internals/faults.py), not a
# mesh.rank_kill phase.
SINK_FINALIZE_PHASE = "sink_finalize"
SINK_FAULT_PHASES = FAULT_PHASES + (SINK_FINALIZE_PHASE,)


# -- the shared transition table -------------------------------------------


class Transitions:
    """The protocol decisions the model drives through. Default-binds
    the engine's own ``protocol.TRANSITIONS`` entries (identity pinned
    by tests), so checker and runtime execute the same functions; a
    mutant swaps exactly one entry for a deliberately broken variant."""

    NAMES = (
        "wave_bits",
        "quiesce_candidates",
        "wave_partition",
        "wave_send_targets",
        "wave_recv_sources",
        "lockstep_plan",
        "commit_time",
        "commit_plan",
        "hello_accept",
        "peer_liveness",
        "classify_peer_loss",
        "supervisor_decide",
        # elastic mesh: the stable shard mint's owner
        # decision, the restore-side re-shard keep filter, and the
        # supervisor's rescale-target clamp — the exact functions the
        # engine's stable_shard / persistence re-shard reader /
        # supervisor drive through
        "shard_owner",
        "reshard_keep",
        "rescale_plan",
        # transactional egress: when a staged sink unit may
        # become externally visible, and the recovery verdict over
        # pending units — the exact functions io/txn.py's sinks drive
        "sink_may_finalize",
        "sink_recover",
        # fast wire: the gather-tree topology resolution and
        # the interior-rank relay decision — the exact functions the
        # wave engine drives (wave_send_targets/wave_recv_sources take
        # the resolved fanout; tree_relay folds children's slices into
        # the parent frame)
        "tree_fanout",
        "tree_relay",
    )

    def __init__(self, overrides: dict | None = None, *, model_flags=()):
        for name in self.NAMES:
            setattr(self, name, _proto.TRANSITIONS[name])
        for name, fn in (overrides or {}).items():
            if name not in self.NAMES:
                raise ValueError(f"unknown transition {name!r}")
            setattr(self, name, fn)
        # model-level behavior switches (for bug classes that live in
        # the recovery machinery around the decisions, e.g. the sink
        # retraction of rollback-or-retract)
        self.model_flags = frozenset(model_flags)


def _mutant_skip_quiesce(remaining, masks, xi):
    """Broken wave partition: ships every pending boundary in ONE wave,
    ignoring upstream exchanges — the quiesce guard (a downstream
    boundary must wait for its feeder's wave) is skipped."""
    return sorted(remaining)


def _mutant_accept_dead_epoch(
    acceptor_rank, acceptor_epoch, world, peer_rank, peer_epoch,
    peer_world=None,
):
    """Broken handshake: rank sanity only, neither the recovery epoch
    nor the world size is checked — a straggler from a rolled-back (or
    rescaled) epoch is let back in."""
    return not (peer_rank <= acceptor_rank or peer_rank >= world)


def _mutant_drop_reshard_shard(h, rank, world):
    """Broken re-shard reader: committed entries the
    new-world mint assigns to rank 0 are dropped on a world-size change
    — one whole shard's deltas lost across the rescale, exactly the bug
    class the re-bucketing's partition property rules out."""
    return h % world == rank and h % world != 0


def _mutant_finalize_before_marker(unit_tag, marker_tag):
    """Broken 2PC egress: staged sink output finalizes at
    PRE-COMMIT, before the ``snapshot_commit`` marker lands — the
    classic premature-commit bug. A crash between the pre-commit and
    the marker rolls the engine back; the re-emitted suffix then stages
    and finalizes AGAIN, duplicating every row of the uncommitted cut
    in the external output. Invisible fault-free (everything finalizes
    exactly once when nothing crashes), which is why the sink model
    checker must find the crash interleaving that exposes it."""
    return True


def _mutant_drop_relay(own_entries, relayed_entries):
    """Broken tree relay: an interior rank of the gather
    tree forwards only its OWN slices, silently dropping everything its
    children shipped through it — whole subtrees' deltas vanish before
    rank 0 ever sees them. Invisible on flat topologies (there is no
    relay) and on worlds too small to have interior ranks, which is why
    the checker must explore the tree transition itself."""
    return list(own_entries)


def get_transitions(mutate: str | None = None) -> Transitions:
    if mutate is None:
        return Transitions()
    if mutate == "drop_relay":
        return Transitions({"tree_relay": _mutant_drop_relay})
    if mutate == "skip_quiesce":
        return Transitions({"wave_partition": _mutant_skip_quiesce})
    if mutate == "accept_dead_epoch":
        return Transitions({"hello_accept": _mutant_accept_dead_epoch})
    if mutate == "drop_rollback_retraction":
        return Transitions(model_flags=("drop_rollback_retraction",))
    if mutate == "drop_reshard_shard":
        return Transitions({"reshard_keep": _mutant_drop_reshard_shard})
    if mutate == "finalize_before_marker":
        return Transitions(
            {"sink_may_finalize": _mutant_finalize_before_marker}
        )
    raise ValueError(
        f"unknown mutant {mutate!r}; known: skip_quiesce, "
        "accept_dead_epoch, drop_rollback_retraction, "
        "drop_reshard_shard, finalize_before_marker, drop_relay"
    )


MUTANT_NAMES = (
    "skip_quiesce", "accept_dead_epoch", "drop_rollback_retraction",
    "drop_reshard_shard", "finalize_before_marker", "drop_relay",
)


# -- topology / workload ----------------------------------------------------


class Exchange(NamedTuple):
    """One exchange boundary of the modeled plan. ``upstream`` lists the
    exchange indices whose delivered output can cascade into this one
    (the wave scheduler's reach/upstream relation)."""

    idx: int
    mode: str  # "hash" | "gather" | "broadcast"
    upstream: tuple = ()


class Token(NamedTuple):
    """One symbolic delta. ``hops`` = ((exchange_idx, dest_spec), ...):
    the route it takes through the exchange topology. A dest_spec is
    ``("h", key_hash)`` for a hash hop — the destination is computed AT
    DELIVERY TIME as ``shard_owner(key_hash, current_world)``, so the
    same workload re-partitions across a rescale exactly like the
    engine's key-routed rows do — or ``("f", rank)`` for a fixed
    destination (gather → 0; broadcast legs expand per build-time
    dest). ``skey`` is the token's source-partition hash: which rank's
    connector commits it, again under the current world. ``rnd`` is the
    source round the committed-cut reconciliation keys on."""

    tid: tuple
    rnd: int
    skey: int
    hops: tuple


def canonical_topology() -> tuple[Exchange, ...]:
    """The shipped protocol's minimal complete shape: a hash boundary (a
    sharded groupby/join) cascading into a gather boundary (outputs to
    rank 0) — two waves per timestamp, cascade feeders, pure-gather leg
    elision."""
    return (
        Exchange(0, "hash", ()),
        Exchange(1, "gather", (0,)),
    )


def _reach_masks(topology: tuple[Exchange, ...]) -> tuple[list[int], list[int]]:
    """(masks, umasks) over exchange indices, mirroring the runtime's
    ``_exchange_reach_masks`` / ``_exchange_upstream_masks``: masks[i]
    includes i itself plus every exchange downstream-reachable from it;
    umasks[i] is every exchange upstream of i (transitively)."""
    E = len(topology)
    down: list[set] = [set() for _ in range(E)]
    for x in topology:
        for u in x.upstream:
            down[u].add(x.idx)
    masks = [0] * E
    for i in reversed(range(E)):
        m = 1 << i
        for j in sorted(down[i]):
            m |= masks[j]
        masks[i] = m
    umasks = [0] * E
    for i in range(E):
        m = 0
        for u in topology[i].upstream:
            m |= umasks[u] | (1 << u)
        umasks[i] = m
    return masks, umasks


def make_workload(
    topology: tuple[Exchange, ...], world: int, rounds: int,
    tokens_per_commit: int | None = None,
) -> tuple:
    """rounds[rnd] -> tuple[Token]. Each round carries
    ``tokens_per_commit × world`` (default ``world²``) deltas whose
    source ranks AND hash destinations are key hashes resolved against
    the CURRENT world at commit/delivery time (``shard_owner``) — the
    sizing uses ``world`` but ownership is dynamic, so the workload
    re-partitions across a rescale exactly like the engine's committed
    stores. Key hashes are chosen to cover every (source, dest) leg at
    the build world; entry exchanges (no upstream) seed routes, a
    token's route then follows every downstream chain (gather → fixed
    rank 0, broadcast → one expanded path per build-world rank)."""
    K = world if tokens_per_commit is None else tokens_per_commit
    entries = [x for x in topology if not x.upstream]
    down: dict[int, list[int]] = {x.idx: [] for x in topology}
    for x in topology:
        for u in x.upstream:
            down[u].append(x.idx)

    def hop_specs(x: Exchange, skey: int, i: int, depth: int) -> list:
        if x.mode == "gather":
            return [("f", 0)]
        if x.mode == "broadcast":
            return [("f", d) for d in range(world)]
        # hash: a deterministic key hash; varying with (skey, i, depth)
        # sweeps every (source, dest) pair at the build world
        return [("h", skey + i + 3 * depth + 7 * x.idx)]

    per_round = []
    for rnd in range(rounds):
        toks = []
        for src in range(world):
            skey = src  # shard_owner(src, world) == src at build world
            for i in range(K):
                for e in entries:
                    paths = [[(e.idx, s)] for s in hop_specs(e, skey, i, 0)]
                    final_paths = []
                    frontier = paths
                    while frontier:
                        nxt = []
                        for p in frontier:
                            last_x, _spec = p[-1]
                            kids = down[last_x]
                            if not kids:
                                final_paths.append(p)
                                continue
                            for kid in kids:
                                for s in hop_specs(
                                    topology[kid], skey, i, len(p)
                                ):
                                    nxt.append(p + [(kid, s)])
                        frontier = nxt
                    for pi, path in enumerate(final_paths):
                        toks.append(
                            Token(
                                ("t", rnd, src, i, e.idx, pi),
                                rnd,
                                skey,
                                tuple(path),
                            )
                        )
        per_round.append(tuple(toks))
    return tuple(per_round)


@dataclass(frozen=True)
class MeshCheckConfig:
    """Bounds of the exploration. ``rounds`` is the wave depth (BSP
    ingest rounds per rank), ``snap_every`` the snapshot cadence in
    rounds, ``fault_budget`` how many injected rank crashes one
    interleaving may contain, drawn from ``fault_phases`` ×
    ``fault_ranks``."""

    world: int = 3
    rounds: int = 2
    tokens_per_commit: int | None = None
    snap_every: int = 2
    fault_budget: int = 1
    fault_phases: tuple = FAULT_PHASES
    fault_ranks: tuple | None = None
    max_restarts: int = 2
    straggler: bool = True
    max_states: int = 200_000
    topology: tuple = field(default_factory=canonical_topology)
    mutate: str | None = None
    # elastic mesh: a one-shot supervisor rescale directive
    # to this world size, fireable at ANY explorable point — combined
    # with the fault budget this explores every crash interleaving of
    # the rescale window (reap / re-shard restore / first waves).
    # Restores whose committed cut was taken at a different world size
    # re-bucket through the shared reshard_keep transition. Broadcast
    # exchanges are rejected under rescale (their legs expand at build
    # world); hash/gather topologies — the canonical shape — rescale.
    rescale_to: int | None = None
    # transactional egress: model the sink as a two-phase-
    # commit external store — final-hop deliveries STAGE (invisible)
    # instead of landing directly, pre-commit checks / post-marker
    # finalization / restore recovery drive the shared
    # sink_may_finalize / sink_recover transitions, and the terminal
    # audit proves every delta became externally visible exactly once
    # across rollbacks AND rescales. Composes with rescale_to: pending
    # partitions of a dead world are re-owned through shard_owner.
    sink: bool = False
    # fast wire: the raw PATHWAY_MESH_TREE_FANOUT knob value
    # the model resolves per CURRENT world through the shared
    # protocol.tree_fanout transition — the default "auto" matches the
    # engine's default, so a 4-rank doctor pass explores exactly the
    # tree topology a 4-rank run drives (and a rescale across the
    # world-4 boundary flips the topology in the model exactly when it
    # flips in the engine).
    tree_knob: str | None = "auto"
    # partial-order reduction strength. Per-rank macro-steps pairwise
    # commute (disjoint rank state, append-only per-link sends, disjoint
    # sink keys), so "persistent" explores only the lowest-ranked rank's
    # enabled actions per state — fault placements, crash/continue
    # branches, detection races and supervisor moves are all still
    # exhaustive, but orderings of commuting deterministic steps
    # collapse to one representative. "full" keeps every ordering
    # (exact, exponential in world size).
    por: str = "persistent"


# -- model state ------------------------------------------------------------

# rank statuses
RUN = "run"
CRASHED = "crashed"          # injected fault fired (exit CRASH_EXIT_CODE)
EXIT_OK = "exit_ok"          # clean end of input (exit 0)
EXIT_RESTART = "exit_restart"  # detected a peer loss, epoch abort (exit 28)
DEAD = "dead"                # reaped by the supervisor


class RankState(NamedTuple):
    status: str
    epoch: int
    pc: tuple
    srcpos: int          # global rounds committed by this rank's source
    applied: frozenset   # operator state: tokens applied at hash dests
    committed: tuple     # commit-timestamp sequence this rank stepped
    fhits: tuple         # sorted ((phase, hits), ...) fault-point counters


class Frame(NamedTuple):
    kind: str            # "xw" | "bye"
    epoch: int
    t: int
    wave: int
    slices: tuple        # sorted ((exch_idx, (Token, ...)), ...)


class StoreState(NamedTuple):
    # committed cut: (source round count, world size of the cut) — the
    # world rides in the marker exactly like the engine's
    # snapshot_commit marker records it (None = nothing committed)
    marker: tuple | None
    snaps: tuple         # sorted (((rank, tag), (applied, srcpos)), ...)
    sink: tuple          # sorted ((token_id, count), ...) — final-hop
    #                      deliveries, keyed by token only (the dest is
    #                      world-dependent across a rescale)
    # transactional egress (cfg.sink): staged-but-not-
    # finalized units ((stager_rank, epoch, unit_tag, tid), ...) and
    # the externally visible finalized output ((tid, count), ...)
    pending: tuple = ()
    final: tuple = ()


class SupState(NamedTuple):
    epoch: int
    restarts: int
    status: str          # "watch" | "done" | "failed"


class State(NamedTuple):
    ranks: tuple
    links: tuple         # links[src][dst] = tuple[Frame]
    store: StoreState
    sup: SupState
    budget: int
    zombies: tuple = ()  # (rank, dead_epoch, dead_world) stragglers
    # one-shot supervisor rescale directive still to fire
    rescale_pending: int | None = None


def _initial_state(cfg: MeshCheckConfig, model=None, preseed: int = 0) -> State:
    """Root state. ``preseed > 0`` starts from a store a *previous* run
    committed through ``preseed`` rounds (marker + per-rank snapshots +
    sink entries) — the restore-at-startup scenario of the fault grid's
    'restore' cells, which is the only place the restore-phase kill slot
    is reachable with a fault budget (the supervisor strips the fault
    plan from rollback respawns). Under a rescale directive the same
    preseeded root is what makes the re-shard itself interesting: the
    committed store holds real entries to re-bucket."""
    ranks = tuple(
        RankState(RUN, 0, ("restore",), 0, frozenset(), (), ())
        for _ in range(cfg.world)
    )
    links = tuple(
        tuple(() for _ in range(cfg.world)) for _ in range(cfg.world)
    )
    store = StoreState(None, (), ())
    if preseed:
        snaps = {}
        sink = {}
        for rank in range(cfg.world):
            applied = frozenset(
                (tok.tid, h)
                for rnd in range(min(preseed, cfg.rounds))
                for tok in model.rounds_tokens[rnd]
                for h, (x, spec) in enumerate(tok.hops)
                if model.topology[x].mode == "hash"
                and model.hop_dest(spec, cfg.world) == rank
            )
            snaps[(rank, preseed)] = (applied, preseed)
        for rnd in range(min(preseed, cfg.rounds)):
            for tok in model.rounds_tokens[rnd]:
                sink[tok.tid] = 1
        if cfg.sink:
            # sink-model preseed: the previous run FINALIZED the
            # committed rounds' output (its cuts landed cleanly);
            # nothing is pending
            store = StoreState(
                (preseed, cfg.world), tuple(sorted(snaps.items())),
                (), (), tuple(sorted(sink.items())),
            )
        else:
            store = StoreState(
                (preseed, cfg.world), tuple(sorted(snaps.items())),
                tuple(sorted(sink.items())),
            )
    return State(
        ranks, links, store, SupState(0, 0, "watch"), cfg.fault_budget,
        (), cfg.rescale_to,
    )


def _set_rank(state: State, r: int, rs: RankState) -> State:
    ranks = list(state.ranks)
    ranks[r] = rs
    return state._replace(ranks=tuple(ranks))


def _push_frame(links, src: int, dst: int, frame: Frame):
    rows = list(links)
    row = list(rows[src])
    row[dst] = row[dst] + (frame,)
    rows[src] = tuple(row)
    return tuple(rows)


def _pop_frame(links, src: int, dst: int):
    rows = list(links)
    row = list(rows[src])
    frame = row[dst][0]
    row[dst] = row[dst][1:]
    rows[src] = tuple(row)
    return tuple(rows), frame


def _fhit(rs: RankState, phase: str) -> tuple[RankState, int]:
    """Count a fault-point hit on the rank's per-phase counter — the
    exact semantics of faults.py's per-(point, phase) counters, which is
    what makes crash choices replayable as PATHWAY_FAULT_PLAN rules."""
    d = dict(rs.fhits)
    d[phase] = d.get(phase, 0) + 1
    return rs._replace(fhits=tuple(sorted(d.items()))), d[phase]


# -- violations -------------------------------------------------------------


@dataclass
class Violation:
    kind: str
    detail: str
    trace: list = field(default_factory=list)
    # when the checked config carried a rescale directive: the world
    # transition, so fault_matrix --from-trace replays the trace as a
    # real kill-and-resume RESCALE cell ({"from": N, "to": M})
    rescale: dict | None = None

    def fault_plan(self) -> dict | None:
        """The trace's crash choices as a replayable PATHWAY_FAULT_PLAN
        (one phase-scoped, rank-scoped, hit-exact rule per crash). Sink
        finalize-window crashes replay through the engine's own
        ``sink.finalize`` point (it has no phases — the point itself IS
        the slot)."""
        rules = []
        for step in self.trace:
            if step.get("action") != "crash":
                continue
            if step["phase"] == SINK_FINALIZE_PHASE:
                rules.append(
                    {
                        "point": "sink.finalize",
                        "rank": step["rank"],
                        "hits": [step["hit"]],
                        "action": "crash",
                    }
                )
            else:
                rules.append(
                    {
                        "point": FAULT_POINT,
                        "phase": step["phase"],
                        "rank": step["rank"],
                        "hits": [step["hit"]],
                        "action": "crash",
                    }
                )
        return {"seed": 7, "rules": rules} if rules else None

    def to_dict(self) -> dict:
        out = {
            "kind": self.kind,
            "detail": self.detail,
            "trace": self.trace,
            "fault_plan": self.fault_plan(),
        }
        if self.rescale is not None:
            out["rescale"] = self.rescale
        return out


@dataclass
class MeshCheckReport:
    config: MeshCheckConfig
    states: int = 0
    transitions: int = 0
    terminals: int = 0
    rollbacks_explored: int = 0
    rescales_explored: int = 0
    complete: bool = True
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.complete and not self.violations

    def to_dict(self) -> dict:
        return {
            "schema": "pathway_tpu_torch.meshcheck/v1",
            "world": self.config.world,
            "rounds": self.config.rounds,
            "fault_budget": self.config.fault_budget,
            "mutate": self.config.mutate,
            "rescale_to": self.config.rescale_to,
            "sink": self.config.sink,
            "states": self.states,
            "transitions": self.transitions,
            "terminals": self.terminals,
            "rollbacks_explored": self.rollbacks_explored,
            "rescales_explored": self.rescales_explored,
            "complete": self.complete,
            "ok": self.ok,
            "violations": [v.to_dict() for v in self.violations],
        }

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    def render(self) -> str:
        c = self.config
        lines = [
            f"mesh verifier: {c.world} rank(s), {c.rounds} round(s), "
            f"fault budget {c.fault_budget}"
            + (
                f", rescale -> {c.rescale_to} rank(s)"
                if c.rescale_to is not None
                else ""
            )
            + (", txn-sink model" if c.sink else "")
            + (f", mutant {c.mutate!r}" if c.mutate else ""),
            f"  explored {self.states} states / {self.transitions} "
            f"transitions ({self.terminals} terminal(s), "
            f"{self.rollbacks_explored} rollback path(s), "
            f"{self.rescales_explored} rescale path(s))"
            + ("" if self.complete else " — INCOMPLETE (state cap hit)"),
        ]
        if not self.violations:
            lines.append(
                "  no deadlock, frontier divergence, lost/duplicated "
                "delta, dead-epoch or dead-world acceptance found"
                + (
                    " across the rescale window"
                    if c.rescale_to is not None
                    else ""
                )
            )
        for v in self.violations:
            lines.append(f"  VIOLATION [{v.kind}] {v.detail}")
            for step in v.trace:
                lines.append(f"    - {step['label']}")
            plan = v.fault_plan()
            if plan:
                lines.append(
                    "    replay: PATHWAY_FAULT_PLAN='"
                    + json.dumps(plan, separators=(",", ":"))
                    + "'"
                )
        return "\n".join(lines)


# -- the model --------------------------------------------------------------


class MeshModel:
    """Successor-state generator for one configuration. All iteration
    orders are deterministic, so two runs explore the identical graph."""

    def __init__(self, cfg: MeshCheckConfig, trans: Transitions):
        self.cfg = cfg
        self.t = trans
        self.topology = cfg.topology
        if cfg.rescale_to is not None and any(
            x.mode == "broadcast" for x in cfg.topology
        ):
            raise ValueError(
                "rescale model checking supports hash/gather exchange "
                "topologies (broadcast legs expand at build world)"
            )
        self.masks, self.umasks = _reach_masks(cfg.topology)
        self.xi = {i: i for i in range(len(cfg.topology))}
        self.sink_mode = cfg.sink
        self.rounds_tokens = make_workload(
            cfg.topology, cfg.world, cfg.rounds, cfg.tokens_per_commit
        )
        self.tok_by_tid = {
            tok.tid: tok for toks in self.rounds_tokens for tok in toks
        }
        # every token must reach its final hop exactly once (the dest is
        # world-dependent, so the audit keys on the token alone), and
        # every hash hop must be APPLIED on exactly one rank at terminal
        # — the committed-store half of exactly-once, which is where a
        # broken re-shard (lost/duplicated shard) surfaces
        self.expected = frozenset(
            tok.tid for toks in self.rounds_tokens for tok in toks
        )
        self.applied_expected = frozenset(
            (tok.tid, h)
            for toks in self.rounds_tokens
            for tok in toks
            for h, (x, _spec) in enumerate(tok.hops)
            if self.topology[x].mode == "hash"
        )
        self.full_xmask = 0
        for x in cfg.topology:
            self.full_xmask |= 1 << x.idx

    # -- helpers ----------------------------------------------------------

    def hop_dest(self, spec, world: int) -> int:
        """A hop's destination under the CURRENT world — hash specs
        resolve through the shared shard_owner transition (the same
        function stable_shard and the re-shard reader drive)."""
        kind, v = spec
        return self.t.shard_owner(v, world) if kind == "h" else v

    def src_of(self, tok: Token, world: int) -> int:
        """Which rank's source commits this token under the current
        world — partition-aware connectors shard their reads by the
        same mint."""
        return self.t.shard_owner(tok.skey, world)

    def _rank_dead(self, rs: RankState) -> bool:
        return rs.status in (CRASHED, DEAD, EXIT_RESTART, EXIT_OK)

    def _fault_matches(self, state: State, r: int, phase: str) -> bool:
        cfg = self.cfg
        if state.budget <= 0 or phase not in cfg.fault_phases:
            return False
        if cfg.fault_ranks is not None and r not in cfg.fault_ranks:
            return False
        return True

    # -- per-rank deterministic micro-steps (the macro-step POR) ----------

    def advance(self, state: State, r: int) -> State | None:
        """Run rank r's deterministic micro-steps until it blocks
        (barrier / empty-link recv), pauses at a matching fault point,
        or exits. Returns the new state, or None when the rank cannot
        make local progress (its next move belongs to another action:
        frame arrival, barrier resolution, detection)."""
        rs = state.ranks[r]
        if rs.status != RUN:
            return None
        progressed = False
        while True:
            rs = state.ranks[r]
            pc = rs.pc
            op = pc[0]
            if op == "restore":
                state = self._do_restore(state, r)
                progressed = True
                continue
            if op == "restore_fp":
                # paused at the restore-phase kill slot: the scheduler
                # owns the crash/continue branch
                return state if progressed else None
            if op == "round":
                n = 1 if rs.srcpos < self.cfg.rounds else 0
                state = _set_rank(
                    state, r, rs._replace(pc=("barrier_plan", n))
                )
                progressed = True
                continue
            if op in ("barrier_plan", "barrier_snap"):
                return state if progressed else None
            if op == "exec":
                state = self._start_commit(state, r)
                progressed = True
                continue
            if op == "wave_fp":
                return state if progressed else None
            if op == "wave_send":
                state = self._do_wave_send(state, r)
                progressed = True
                continue
            if op == "wave_recv":
                got = self._try_recv(state, r)
                if got is None:
                    return state if progressed else None
                state = got
                progressed = True
                continue
            if op == "snap":
                state = self._do_snapshot(state, r)
                progressed = True
                continue
            if op == "snap_fp":
                return state if progressed else None
            if op == "sink_fin":
                # fault slot FIRST: the marker has moved but this
                # rank's staged units are still pending — dying here is
                # the window recovery's "finalize" verdict heals
                rs, hit = _fhit(rs, SINK_FINALIZE_PHASE)
                if self._fault_matches(state, r, SINK_FINALIZE_PHASE):
                    state = _set_rank(
                        state, r,
                        rs._replace(pc=("sink_fin_fp", rs.pc[1])),
                    )
                else:
                    state = self._do_sink_finalize(
                        _set_rank(state, r, rs), r
                    )
                progressed = True
                continue
            if op == "sink_fin_fp":
                return state if progressed else None
            if op == "closing":
                state = self._do_close(state, r)
                return state
            raise AssertionError(f"unknown pc {pc!r}")

    # -- restore ----------------------------------------------------------

    def _do_restore(self, state: State, r: int) -> State:
        rs = state.ranks[r]
        world = len(state.ranks)
        marker = state.store.marker
        if marker is None:
            # nothing committed: fresh start (connectors from scratch).
            # rollback-or-retract: sink entries from dead epochs that the
            # (empty) cut does not cover are retracted
            if self.sink_mode:
                state = self._sink_recover_model(state, r, None)
            else:
                state = self._reconcile_sink(state, r, cut=0)
            return _set_rank(
                state, r,
                rs._replace(
                    pc=("round",), srcpos=0, applied=frozenset(),
                    committed=(),
                ),
            )
        tag, snap_world = marker
        snaps = dict(state.store.snaps)
        if snap_world == world:
            snap = snaps.get((r, tag))
            # two-phase property: the marker only ever names a tag for
            # which EVERY rank's snapshot exists durably
            if snap is None:
                raise _PropertyViolation(
                    "missing-snapshot",
                    f"commit marker names cut {tag} but rank {r} has no "
                    f"durable snapshot at that tag",
                )
            applied, srcpos = snap
        else:
            # RESCALE restore: the cut was taken at a
            # different world size — read EVERY old rank's snapshot and
            # re-bucket the union through the shared reshard_keep
            # transition (exactly what persistence/reshard.py does with
            # the real stores). The kept sets must form a partition;
            # the drop_reshard_shard mutant breaks the keep filter and
            # surfaces as lost deltas in the terminal audit.
            applied_union = []
            srcpos = tag
            for rr in range(snap_world):
                snap = snaps.get((rr, tag))
                if snap is None:
                    raise _PropertyViolation(
                        "missing-snapshot",
                        f"commit marker names cut {tag} at world "
                        f"{snap_world} but rank {rr}'s snapshot is "
                        "missing — the two-phase cut is broken",
                    )
                applied_union.extend(snap[0])
            applied = frozenset(
                (tid, h)
                for (tid, h) in applied_union
                if self.t.reshard_keep(
                    self.tok_by_tid[tid].hops[h][1][1], r, world
                )
            )
        if self.sink_mode:
            # 2PC egress recovery: one shared sink_recover verdict per
            # pending unit this rank claims through the shard mint —
            # finalize what the cut covers, discard the rest
            state = self._sink_recover_model(state, r, tag)
        else:
            state = self._reconcile_sink(state, r, cut=tag)
        rs = state.ranks[r]._replace(
            pc=("restore_fp",), srcpos=srcpos, applied=applied,
            committed=(),
        )
        # the restore-phase kill slot fires only when there IS a marker
        # to restore (mirrors runtime._restore_operator_snapshot_distributed;
        # on a rescale restore this slot IS the re-shard window)
        rs, hit = _fhit(rs, "restore")
        state = _set_rank(state, r, rs)
        if not self._fault_matches(state, r, "restore"):
            state = _set_rank(
                state, r, state.ranks[r]._replace(pc=("round",))
            )
        return state

    def _reconcile_sink(self, state: State, r: int, cut: int) -> State:
        """Rollback-or-retract at the exactly-once boundary: on restore,
        this rank retracts the sink entries whose final hop IT OWNS
        under the current world for tokens the committed cut does not
        cover — they will be re-delivered by the replay. Ownership is
        evaluated at the CURRENT world: across a rescale the new owner
        retracts what the old owner wrote (the sink store is shared).
        The drop_rollback_retraction mutant skips this, which is
        precisely a duplicated-delta bug."""
        if "drop_rollback_retraction" in self.t.model_flags:
            return state
        world = len(state.ranks)
        sink = [
            (tid, cnt)
            for tid, cnt in state.store.sink
            # tid = ("t", rnd, src, ...): rnd < cut is committed
            if not (
                tid[1] >= cut
                and self.hop_dest(
                    self.tok_by_tid[tid].hops[-1][1], world
                ) == r
            )
        ]
        return state._replace(
            store=state.store._replace(sink=tuple(sorted(sink)))
        )

    # -- transactional egress (cfg.sink) -------------------------

    def _sink_recover_model(
        self, state: State, r: int, marker_tag: int | None
    ) -> State:
        """Restore-time recovery of the 2PC sink store: this rank
        claims the pending partitions the shard mint assigns to it at
        the CURRENT world (after a rescale, a dead rank's partition is
        re-owned by exactly one new rank) and takes the shared
        ``sink_recover`` verdict per unit — finalize what the committed
        cut covers (the crash landed between the marker and the owner's
        local finalize), discard the rest (the restored engine will
        re-emit it; keeping it would duplicate)."""
        world = len(state.ranks)
        pending = []
        final = dict(state.store.final)
        for unit in state.store.pending:
            stager, _epoch, unit_tag, tid = unit
            if self.t.shard_owner(stager, world) != r:
                pending.append(unit)
                continue
            if self.t.sink_recover(unit_tag, marker_tag) == "finalize":
                final[tid] = final.get(tid, 0) + 1
            # else: discard — drop the unit entirely
        return state._replace(
            store=state.store._replace(
                pending=tuple(sorted(pending)),
                final=tuple(sorted(final.items())),
            )
        )

    def _sink_precommit_check(self, state: State, r: int) -> State:
        """The pre-commit step drives ``sink_may_finalize`` over this
        rank's pending units against the CURRENT marker. The shipped
        transition always answers False here (the marker has not moved
        for this cut yet), making this a no-op; the
        ``finalize_before_marker`` mutant answers True — premature
        finalization, which a crash at the post_snapshot slot then
        turns into duplicated external output."""
        marker = state.store.marker
        marker_tag = marker[0] if marker is not None else None
        rs = state.ranks[r]
        pending = []
        final = dict(state.store.final)
        changed = False
        for unit in state.store.pending:
            stager, epoch, unit_tag, tid = unit
            if (
                stager == r
                and epoch == rs.epoch
                and self.t.sink_may_finalize(unit_tag, marker_tag)
            ):
                final[tid] = final.get(tid, 0) + 1
                changed = True
            else:
                pending.append(unit)
        if not changed:
            return state
        return state._replace(
            store=state.store._replace(
                pending=tuple(sorted(pending)),
                final=tuple(sorted(final.items())),
            )
        )

    def _do_sink_finalize(self, state: State, r: int) -> State:
        """Post-marker finalization: the marker landed at the barrier's
        tag — this rank's pending units at-or-below it become
        externally visible (shared ``sink_may_finalize`` decision). A
        rank killed before this step leaves its units pending; the next
        recovery's ``sink_recover`` verdict finalizes them, which the
        terminal audit depends on."""
        rs = state.ranks[r]
        _op, tag = rs.pc
        pending = []
        final = dict(state.store.final)
        for unit in state.store.pending:
            stager, epoch, unit_tag, tid = unit
            if (
                stager == r
                and epoch == rs.epoch
                and self.t.sink_may_finalize(unit_tag, tag)
            ):
                final[tid] = final.get(tid, 0) + 1
            else:
                pending.append(unit)
        state = state._replace(
            store=state.store._replace(
                pending=tuple(sorted(pending)),
                final=tuple(sorted(final.items())),
            )
        )
        return _set_rank(state, r, rs._replace(pc=("round",)))

    # -- commit execution (the wave walk) ---------------------------------

    def _start_commit(self, state: State, r: int) -> State:
        rs = state.ranks[r]
        _op, plan, idx = rs.pc
        if idx >= len(plan):
            # round's plan exhausted -> snapshot decision
            rnd = rs.srcpos  # rounds completed (commit consumed below)
            take_snap = rnd % self.cfg.snap_every == self.cfg.snap_every - 1
            if take_snap:
                pc = ("snap",)
            else:
                pc = ("round",)
            return _set_rank(
                state, r, rs._replace(pc=pc, srcpos=rs.srcpos + 1)
            )
        t, xmask, contrib = plan[idx]
        world = len(state.ranks)
        owner = None
        for rr in range(world):
            if (contrib >> rr) & 1:
                owner = rr
        pending: dict[int, tuple] = {}
        if owner == r:
            # the round's tokens this rank's source owns under the
            # CURRENT world (partition-aware reads re-shard with it)
            toks = [
                tok
                for tok in self.rounds_tokens[rs.srcpos]
                if self.src_of(tok, world) == r
            ]
            for tok in toks:
                x0 = tok.hops[0][0]
                pending[x0] = pending.get(x0, ()) + ((tok, 0),)
        remaining = frozenset(
            i for i in range(len(self.topology)) if (xmask >> i) & 1
        )
        return _set_rank(
            state, r,
            rs._replace(
                pc=(
                    "wave_send", plan, idx, remaining,
                    tuple(sorted(pending.items())), 1,
                )
            ),
        )

    def _wave_of(self, remaining: frozenset) -> list[int]:
        return self.t.wave_partition(remaining, self.masks, self.xi)

    def _do_wave_send(self, state: State, r: int) -> State:
        rs = state.ranks[r]
        _op, plan, idx, remaining, pending, wave_no = rs.pc
        if not remaining:
            # commit's waves done: record the committed timestamp
            t, _x, _c = plan[idx]
            return _set_rank(
                state, r,
                rs._replace(
                    pc=("exec", plan, idx + 1),
                    committed=rs.committed + (t,),
                ),
            )
        wave = self._wave_of(remaining)
        # the wave_send kill slot: slices prepared, frames not shipped
        rs, hit = _fhit(rs, "wave_send")
        if self._fault_matches(state, r, "wave_send"):
            state = _set_rank(
                state, r,
                rs._replace(
                    pc=(
                        "wave_fp", plan, idx, remaining, pending, wave_no,
                    )
                ),
            )
            return state
        state = _set_rank(state, r, rs)
        return self._ship_wave(state, r)

    def resume_after_fault_point(self, state: State, r: int) -> State:
        """The scheduler's 'continue' branch at a paused fault point."""
        rs = state.ranks[r]
        op = rs.pc[0]
        if op == "wave_fp":
            _op, plan, idx, remaining, pending, wave_no = rs.pc
            state = _set_rank(
                state, r,
                rs._replace(
                    pc=(
                        "wave_send+", plan, idx, remaining, pending,
                        wave_no,
                    )
                ),
            )
            return self._ship_wave(state, r)
        if op == "snap_fp":
            return _set_rank(
                state, r, rs._replace(pc=("barrier_snap", rs.pc[1]))
            )
        if op == "restore_fp":
            return _set_rank(state, r, rs._replace(pc=("round",)))
        if op == "sink_fin_fp":
            return self._do_sink_finalize(state, r)
        raise AssertionError(f"not at a fault point: {rs.pc!r}")

    def _ship_wave(self, state: State, r: int) -> State:
        """Send this rank's frames for the current wave and switch to
        the recv half. Leg elision comes from the shared transition
        table (wave_send_targets / wave_recv_sources)."""
        rs = state.ranks[r]
        _op, plan, idx, remaining, pending, wave_no = rs.pc
        t, _xmask, contrib_mask = plan[idx]
        wave = self._wave_of(remaining)
        gather_only = all(
            self.topology[x].mode == "gather" for x in wave
        )
        contrib = contrib_mask if wave_no == 1 else None
        world = len(state.ranks)
        fanout = self.t.tree_fanout(world, self.cfg.tree_knob)
        targets = self.t.wave_send_targets(
            world, r, gather_only, contrib, fanout
        )
        expect = tuple(
            self.t.wave_recv_sources(
                world, r, gather_only, contrib, fanout
            )
        )
        if gather_only and fanout >= 2 and world > 2:
            # tree-gather wave: recv-before-send — the
            # parent frame (own + relayed slices, protocol.tree_relay)
            # ships in _finish_wave once every child has been heard;
            # tree edges form a DAG toward rank 0, so the inverted
            # order cannot deadlock
            rs = rs._replace(
                pc=(
                    "wave_recv", plan, idx, remaining, pending, wave_no,
                    expect, (),
                )
            )
            return _set_rank(state, r, rs)
        pend = dict(pending)
        links = state.links
        for peer in targets:
            slices = []
            for x in sorted(wave):
                toks = tuple(
                    tok
                    for tok, hop in pend.get(x, ())
                    if self.hop_dest(tok.hops[hop][1], world) == peer
                )
                if toks:
                    slices.append((x, toks))
            links = _push_frame(
                links, r, peer,
                Frame("xw", rs.epoch, t, wave_no, tuple(slices)),
            )
        rs = rs._replace(
            pc=(
                "wave_recv", plan, idx, remaining, pending, wave_no,
                expect, (),
            )
        )
        return _set_rank(state._replace(links=links), r, rs)

    def _try_recv(self, state: State, r: int) -> State | None:
        """Consume the next expected wave frame if one is in flight;
        completes the wave (deliver + cascade) once every expected peer
        has been heard. Returns None when blocked."""
        rs = state.ranks[r]
        (_op, plan, idx, remaining, pending, wave_no, expect, got) = rs.pc
        if not expect:
            return self._finish_wave(state, r)
        peer = expect[0]
        link = state.links[peer][r]
        # skip goodbye frames (the peer announced clean shutdown); the
        # classification of the resulting loss happens in the detect
        # action, through the shared classify_peer_loss
        while link and link[0].kind == "bye":
            links, _ = _pop_frame(state.links, peer, r)
            state = state._replace(links=links)
            link = state.links[peer][r]
        if not link:
            return None
        links, frame = _pop_frame(state.links, peer, r)
        state = state._replace(links=links)
        t, _xm, _c = plan[idx]
        if frame.kind != "xw" or frame.t != t or frame.wave != wave_no \
                or frame.epoch != rs.epoch:
            raise _PropertyViolation(
                "wave-desync",
                f"rank {r} expected (t={t}, wave={wave_no}, epoch="
                f"{rs.epoch}) from peer {peer}, got (kind={frame.kind}, "
                f"t={frame.t}, wave={frame.wave}, epoch={frame.epoch}) — "
                "send/recv legs disagree",
            )
        rs = rs._replace(
            pc=(
                "wave_recv", plan, idx, remaining, pending, wave_no,
                expect[1:], got + (frame,),
            )
        )
        return _set_rank(state, r, rs)

    def _relay_tree_wave(self, state: State, r: int) -> State:
        """Interior/leaf rank of a tree-gather wave, children all heard:
        fold own + relayed slices into ONE frame to the tree parent
        (the shared ``tree_relay`` transition — the ``drop_relay``
        mutant breaks it here) and move to the next wave. Nothing
        delivers locally: every token of a gather wave is in transit to
        rank 0."""
        rs = state.ranks[r]
        world = len(state.ranks)
        (_op, plan, idx, remaining, pending, wave_no, _expect, got) = rs.pc
        t, _xm, contrib_mask = plan[idx]
        wave = self._wave_of(remaining)
        wave_set = set(wave)
        fanout = self.t.tree_fanout(world, self.cfg.tree_knob)
        contrib = contrib_mask if wave_no == 1 else None
        pend = {x: list(v) for x, v in pending}
        own = []
        for x in sorted(wave):
            toks = tuple(
                tok
                for tok, hop in pend.pop(x, ())
                if self.hop_dest(tok.hops[hop][1], world) == 0
            )
            if toks:
                own.append((x, toks))
        relayed = []
        for frame in got:
            for x, toks in frame.slices:
                if x not in wave_set:
                    raise _PropertyViolation(
                        "wave-desync",
                        f"rank {r} relayed exchange {x} outside wave "
                        f"{sorted(wave)}",
                    )
                if toks:
                    relayed.append((x, toks))
        links = state.links
        for peer in self.t.wave_send_targets(
            world, r, True, contrib, fanout
        ):
            links = _push_frame(
                links, r, peer,
                Frame(
                    "xw", rs.epoch, t, wave_no,
                    tuple(self.t.tree_relay(own, relayed)),
                ),
            )
        new_remaining = remaining - wave_set
        rs = rs._replace(
            pc=(
                "wave_send", plan, idx, new_remaining,
                tuple(sorted((x, tuple(v)) for x, v in pend.items() if v)),
                wave_no + 1,
            )
        )
        return _set_rank(state._replace(links=links), r, rs)

    def _finish_wave(self, state: State, r: int) -> State:
        """All expected frames arrived: deliver this wave's tokens
        (apply at hash dests, sink at final hops), run the cascade
        feeders under the quiesce guard, and move to the next wave."""
        rs = state.ranks[r]
        world = len(state.ranks)
        (_op, plan, idx, remaining, pending, wave_no, _expect, got) = rs.pc
        wave = self._wave_of(remaining)
        if r != 0 and all(
            self.topology[x].mode == "gather" for x in wave
        ) and self.t.tree_fanout(world, self.cfg.tree_knob) >= 2 \
                and world > 2:
            # tree-gather wave on a non-root rank: relay, don't deliver
            return self._relay_tree_wave(state, r)
        pend = {x: list(v) for x, v in pending}
        # delivered[x] = tokens this rank received/kept for wave member x
        delivered: dict[int, list] = {x: [] for x in wave}
        for x in sorted(wave):
            for tok, hop in pend.pop(x, ()):
                if self.hop_dest(tok.hops[hop][1], world) == r:
                    delivered[x].append((tok, hop))
        for frame in got:
            for x, toks in frame.slices:
                if x not in delivered:
                    raise _PropertyViolation(
                        "wave-desync",
                        f"rank {r} received exchange {x} outside wave "
                        f"{sorted(wave)}",
                    )
                for tok in toks:
                    hop = None
                    for h, (hx, hd) in enumerate(tok.hops):
                        if hx == x and self.hop_dest(hd, world) == r:
                            hop = h
                    if hop is None:
                        raise _PropertyViolation(
                            "wave-desync",
                            f"rank {r} received token {tok.tid} it does "
                            f"not own at exchange {x}",
                        )
                    delivered[x].append((tok, hop))
        applied = set(rs.applied)
        sink = dict(state.store.sink)
        staged = list(state.store.pending)
        new_remaining = remaining - set(wave)
        wbits_left = self.t.wave_bits(new_remaining, self.xi)
        E = len(self.topology)
        for x in sorted(delivered):
            for tok, hop in delivered[x]:
                if self.topology[x].mode == "hash":
                    # the committed-store half: this (token, hop) entry
                    # now lives on this rank — snapshots carry it, a
                    # rescale restore re-buckets it
                    applied.add((tok.tid, hop))
                if hop + 1 >= len(tok.hops):
                    if self.sink_mode:
                        # 2PC egress: the final-hop delivery STAGES the
                        # unit (invisible), keyed by (stager rank,
                        # epoch, the first cut tag that can commit it)
                        # — finalization waits for the marker
                        staged.append(
                            (r, rs.epoch, tok.rnd + 1, tok.tid)
                        )
                    else:
                        sink[tok.tid] = sink.get(tok.tid, 0) + 1
                    continue
                nx = tok.hops[hop + 1][0]
                # cascade feeder: may this local step run before the
                # next wave? The quiesce guard decides — driven through
                # the SAME quiesce_candidates the engine loop uses. The
                # feeder pseudo-node (the local node between exchange x
                # and exchange nx) reaches everything nx reaches and
                # sits downstream of x — exactly the engine's reach/
                # upstream masks for a child of x feeding nx.
                feeder = E + x * E + nx
                size = E + E * E
                fmasks = list(self.masks) + [0] * (size - E)
                fumasks = list(self.umasks) + [0] * (size - E)
                fmasks[feeder] = self.masks[nx]
                fumasks[feeder] = self.umasks[x] | (1 << x)
                cand = self.t.quiesce_candidates(
                    [feeder], new_remaining, fmasks, fumasks, wbits_left
                )
                if feeder in cand:
                    pend.setdefault(nx, []).append((tok, hop + 1))
                # else: the boundary already shipped (or never will
                # this timestamp) — the token is stranded, which the
                # exactly-once audit reports as a lost delta
        rs = rs._replace(
            applied=frozenset(applied),
            pc=(
                "wave_send", plan, idx, new_remaining,
                tuple(sorted((x, tuple(v)) for x, v in pend.items() if v)),
                wave_no + 1,
            ),
        )
        state = state._replace(
            store=state.store._replace(
                sink=tuple(sorted(sink.items())),
                pending=tuple(sorted(staged)),
            )
        )
        return _set_rank(state, r, rs)

    # -- snapshot ----------------------------------------------------------

    def _do_snapshot(self, state: State, r: int) -> State:
        rs = state.ranks[r]
        tag = rs.srcpos  # the cut: rounds this rank's source committed
        snaps = dict(state.store.snaps)
        snaps[(r, tag)] = (rs.applied, rs.srcpos)
        state = state._replace(
            store=state.store._replace(snaps=tuple(sorted(snaps.items())))
        )
        if self.sink_mode:
            # the sink pre-commit drives sink_may_finalize against the
            # CURRENT marker — a no-op under the shipped transition,
            # premature finalization under finalize_before_marker
            state = self._sink_precommit_check(state, r)
        # kill slot: rank-local snapshot durable, marker not yet moved
        rs, hit = _fhit(rs, "post_snapshot")
        if self._fault_matches(state, r, "post_snapshot"):
            return _set_rank(state, r, rs._replace(pc=("snap_fp", tag)))
        return _set_rank(state, r, rs._replace(pc=("barrier_snap", tag)))

    # -- closing ------------------------------------------------------------

    def _do_close(self, state: State, r: int) -> State:
        rs = state.ranks[r]
        links = state.links
        for peer in range(len(state.ranks)):
            if peer != r:
                links = _push_frame(
                    links, r, peer, Frame("bye", rs.epoch, -1, 0, ())
                )
        return _set_rank(
            state._replace(links=links), r, rs._replace(status=EXIT_OK)
        )

    # -- barriers (control plane) ------------------------------------------

    def barrier_ready(self, state: State) -> str | None:
        """A control collective (gather0 + bcast0) resolves only when
        EVERY rank of the mesh participates — a crashed/exited member
        makes it hang, which is what the blocked survivors' failure
        detectors then turn into an epoch abort."""
        if all(
            rs.status == RUN and rs.pc[0] == "barrier_plan"
            for rs in state.ranks
        ):
            return "plan"
        if all(
            rs.status == RUN and rs.pc[0] == "barrier_snap"
            for rs in state.ranks
        ):
            return "snap"
        return None

    def resolve_plan_barrier(self, state: State) -> State:
        """The BSP round's control phase: gather per-rank commit counts
        + exchange masks, let the shared commit_plan transition assign
        globally ordered times, hand every rank the same plan."""
        world = len(state.ranks)
        counts = []
        xmasks: list[list[int]] = []
        for rs in state.ranks:
            n = rs.pc[1]
            counts.append(n)
            xmasks.append([self.full_xmask] * n)
        rnd = state.ranks[0].srcpos
        total = sum(counts)
        if total == 0:
            # alldone: every rank's input is exhausted
            if self.sink_mode:
                # clean-shutdown 2PC cut (mirrors runtime._txn_final_
                # cut): one FINAL snapshot + marker covering the tail,
                # then everything pending finalizes through the shared
                # predicate — the tail never commits outside a marker
                world = len(state.ranks)
                snaps = dict(state.store.snaps)
                for r, rs in enumerate(state.ranks):
                    snaps[(r, rnd)] = (rs.applied, rnd)
                pending = []
                final = dict(state.store.final)
                for unit in state.store.pending:
                    _stager, _epoch, unit_tag, tid = unit
                    if self.t.sink_may_finalize(unit_tag, rnd):
                        final[tid] = final.get(tid, 0) + 1
                    else:
                        pending.append(unit)
                state = state._replace(
                    store=state.store._replace(
                        marker=(rnd, world),
                        snaps=tuple(sorted(snaps.items())),
                        pending=tuple(sorted(pending)),
                        final=tuple(sorted(final.items())),
                    )
                )
            for r, rs in enumerate(state.ranks):
                state = _set_rank(state, r, rs._replace(pc=("closing",)))
            return state
        # base spacing uses the LARGEST world this config can reach so
        # commit times stay distinct per round across a rescale
        maxw = max(world, self.cfg.world, self.cfg.rescale_to or 0)
        base = self.t.commit_time(2 * maxw * (rnd + 1), 0)
        plan = tuple(self.t.commit_plan(base, counts, xmasks))
        for r, rs in enumerate(state.ranks):
            state = _set_rank(state, r, rs._replace(pc=("exec", plan, 0)))
        return state

    def resolve_snap_barrier(self, state: State) -> State:
        """Two-phase commit of the distributed cut: every rank's
        snapshot ack arrived, rank 0 moves the marker — so the marker
        always names a tag for which every rank's snapshot exists
        durably."""
        tag = state.ranks[0].pc[1]
        # the marker records the cut's world size next to its tag — the
        # engine's snapshot_commit marker does the same, which is how a
        # later restore detects a rescale and takes the re-shard path
        state = state._replace(
            store=state.store._replace(
                marker=(tag, len(state.ranks))
            )
        )
        for r, rs in enumerate(state.ranks):
            if self.sink_mode:
                # 2PC egress phase 2: each rank finalizes its own
                # staged units AFTER the marker moved — a separate
                # per-rank step, so the kill window between the marker
                # and a rank's local finalize is explorable (recovery
                # must then finalize the pending remainder)
                state = _set_rank(
                    state, r, rs._replace(pc=("sink_fin", tag))
                )
            else:
                state = _set_rank(state, r, rs._replace(pc=("round",)))
        return state

    # -- detection ----------------------------------------------------------

    def blocked_on_dead_peer(self, state: State, r: int) -> str | None:
        """When rank r is blocked and some rank it transitively depends
        on is dead, the heartbeat/timeout detector will fire (the
        peer_liveness verdict with unbounded idle). Returns the
        classification ('crashed'/'gone') of the loss, or None when r is
        not (yet) entitled to detect anything."""
        rs = state.ranks[r]
        if rs.status != RUN:
            return None
        pc = rs.pc[0]
        dead = [
            p for p, ps in enumerate(state.ranks)
            if p != r and self._rank_dead(ps)
        ]
        if not dead:
            return None
        if pc == "wave_recv":
            expect = rs.pc[6]
            for peer in expect:
                ps = state.ranks[peer]
                if self._rank_dead(ps) and not any(
                    f.kind == "xw" for f in state.links[peer][r]
                ):
                    goodbye = ps.status == EXIT_OK or any(
                        f.kind == "bye" for f in state.links[peer][r]
                    )
                    # liveness verdict through the shared table: a peer
                    # that will never beat again scores unbounded idle
                    if self.t.peer_liveness(
                        float("inf"), 1.0, goodbye
                    ) == "failed" or goodbye:
                        return self.t.classify_peer_loss(goodbye)
            return None
        if pc in ("barrier_plan", "barrier_snap"):
            # a collective with a dead member: the op deadline fires
            ps = state.ranks[dead[0]]
            return self.t.classify_peer_loss(ps.status == EXIT_OK)
        return None

    def detect(self, state: State, r: int) -> State:
        """Epoch abort: the rank drains + discards in-flight frames,
        drops its links (no goodbye — it is aborting) and exits with the
        rollback-request code."""
        links = list(state.links)
        # inbound frames of the dead epoch are drained and discarded
        for p in range(len(state.ranks)):
            row = list(links[p])
            row[r] = ()
            links[p] = tuple(row)
        rs = state.ranks[r]._replace(status=EXIT_RESTART)
        return _set_rank(state._replace(links=tuple(links)), r, rs)

    # -- supervisor ----------------------------------------------------------

    def supervisor_enabled(self, state: State) -> str | None:
        if state.sup.status != "watch":
            return None
        statuses = [rs.status for rs in state.ranks]
        if any(s in (CRASHED, EXIT_RESTART) for s in statuses):
            return "reap"
        if all(s == EXIT_OK for s in statuses):
            return "finish"
        return None

    def reap_outcomes(self, state: State) -> list[tuple[str, State]]:
        """Reap the epoch: SIGKILL still-running ranks (each may instead
        survive the grace window briefly as a straggler — the model
        explores that race), collect exit codes, and take the shared
        supervisor_decide verdict: respawn everyone at epoch+1 from the
        committed cut, or give up. Respawns keep the CURRENT world size
        (a pending rescale fires as its own supervisor action)."""
        outcomes = []
        world = len(state.ranks)
        running = [
            r for r, rs in enumerate(state.ranks) if rs.status == RUN
        ]
        choices: list[tuple[int | None, str]] = [(None, "reap")]
        if self.cfg.straggler and not state.zombies:
            # only non-zero ranks have a straggle vector: a zombie
            # re-connects to LOWER ranks (acceptors), and the recovered
            # mesh listens on a fresh port base so nobody dials IT
            for r in running:
                if r > 0:
                    choices.append((r, f"reap(straggler={r})"))
        for zombie, label in choices:
            s = state
            codes = []
            for r, rs in enumerate(s.ranks):
                if rs.status == CRASHED:
                    codes.append(CRASH_EXIT_CODE)
                elif rs.status == EXIT_RESTART:
                    codes.append(_proto.MESH_RESTART_EXIT_CODE)
                elif rs.status == EXIT_OK:
                    codes.append(0)
                else:  # still running: SIGKILLed by the reap
                    codes.append(KILLED_EXIT_CODE)
            verdict, payload = self.t.supervisor_decide(
                codes, s.sup.restarts, self.cfg.max_restarts
            )
            if verdict == "give_up":
                s = s._replace(sup=s.sup._replace(status="failed"))
                outcomes.append((label + "->give_up", s))
                continue
            if verdict == "done":  # unreachable here (some code nonzero)
                s = s._replace(sup=s.sup._replace(status="done"))
                outcomes.append((label + "->done", s))
                continue
            # rollback: respawn ALL ranks at epoch+1 on a fresh port
            # base; links of the dead epoch vanish with the processes.
            # PATHWAY_FAULT_PLAN is stripped from respawns (supervisor
            # default), so the recovered epoch runs fault-free.
            new_epoch = s.sup.epoch + payload
            old_epoch = s.sup.epoch
            s = self._respawn(
                s, world, new_epoch,
                restarts=s.sup.restarts + 1,
                budget=0,
                zombie=(zombie, old_epoch, world)
                if zombie is not None else None,
            )
            outcomes.append((label + f"->rollback(e{new_epoch})", s))
        return outcomes

    def _respawn(
        self, s: State, new_world: int, new_epoch: int, *,
        restarts: int, budget: int, zombie=None,
        clear_rescale: bool = False,
    ) -> State:
        """Fresh rank set + empty links at the given world size; the
        durable store survives (that is the whole point)."""
        ranks = tuple(
            RankState(RUN, new_epoch, ("restore",), 0, frozenset(),
                      (), ())
            for _ in range(new_world)
        )
        links = tuple(
            tuple(() for _ in range(new_world)) for _ in range(new_world)
        )
        zombies = s.zombies
        if zombie is not None:
            zombies = zombies + (zombie,)
        return State(
            ranks, links, s.store,
            SupState(new_epoch, restarts, "watch"), budget,
            zombies,
            None if clear_rescale else s.rescale_pending,
        )

    def rescale_outcomes(self, state: State) -> list[tuple[str, State]]:
        """The supervisor's one-shot rescale directive: a
        VOLUNTARY rollback into a different world size — reap the whole
        rank set wherever it is (every still-running rank may straggle,
        like a failure reap), respawn ``rescale_plan(...)`` ranks at
        epoch+1. The fault budget is PRESERVED so crashes can land
        inside and after the rescale window — 'all crash interleavings
        of the rescale window' is exactly this product."""
        old_world = len(state.ranks)
        new_world = self.t.rescale_plan(
            old_world, state.rescale_pending
        )
        if new_world == old_world:
            return [
                (
                    "rescale(no-op)",
                    state._replace(rescale_pending=None),
                )
            ]
        outcomes = []
        new_epoch = state.sup.epoch + 1
        choices: list[tuple[int | None, str]] = [
            (None, f"rescale({old_world}->{new_world})")
        ]
        if self.cfg.straggler and not state.zombies:
            for r, rs in enumerate(state.ranks):
                if rs.status == RUN and r > 0:
                    choices.append(
                        (
                            r,
                            f"rescale({old_world}->{new_world}, "
                            f"straggler={r})",
                        )
                    )
        for zombie, label in choices:
            s = self._respawn(
                state, new_world, new_epoch,
                restarts=state.sup.restarts,
                budget=state.budget,
                zombie=(zombie, state.sup.epoch, old_world)
                if zombie is not None else None,
                clear_rescale=True,
            )
            outcomes.append((label + f"->e{new_epoch}", s))
        return outcomes

    def finish(self, state: State) -> State:
        return state._replace(sup=state.sup._replace(status="done"))

    # -- straggler ------------------------------------------------------------

    def straggle(self, state: State, zi: int) -> State:
        """A straggler process from a reaped epoch attempts to
        re-handshake into the recovered mesh (it dials its lower-rank
        peers). The shared hello_accept must refuse it (epoch AND world
        are bound into the hello AND its MAC); acceptance is the
        dead-epoch / dead-world violation."""
        rank, dead_epoch, dead_world = state.zombies[zi]
        new_epoch = state.sup.epoch
        world = len(state.ranks)
        if self.t.hello_accept(
            0, new_epoch, world, rank, dead_epoch, dead_world
        ) and (dead_epoch != new_epoch or dead_world != world):
            raise _PropertyViolation(
                "dead-epoch-straggler",
                f"rank {rank} surviving from reaped epoch {dead_epoch} "
                f"(world {dead_world}) was accepted into the recovered "
                f"epoch-{new_epoch} world-{world} mesh — pre-rollback "
                "in-flight state can now leak across the transition",
            )
        zombies = tuple(
            z for i, z in enumerate(state.zombies) if i != zi
        )
        return state._replace(zombies=zombies)

    # -- properties ------------------------------------------------------------

    def check_invariants(self, state: State) -> None:
        """Properties checked on every reachable state."""
        # frontier divergence: same-epoch ranks must commit timestamp
        # sequences that are prefixes of one another
        by_epoch: dict[int, list[tuple]] = {}
        for rs in state.ranks:
            if rs.status in (RUN, EXIT_OK):
                by_epoch.setdefault(rs.epoch, []).append(rs.committed)
        for epoch, seqs in by_epoch.items():
            seqs = sorted(seqs, key=len)
            for a, b in zip(seqs, seqs[1:]):
                if b[: len(a)] != a:
                    raise _PropertyViolation(
                        "frontier-divergence",
                        f"epoch {epoch}: committed timestamp sequences "
                        f"diverge: {a} vs {b}",
                    )

    def check_terminal(self, state: State) -> None:
        """Exactly-once audit on clean terminal states: every workload
        delta delivered exactly once across any rollbacks AND any
        rescales — at the sink (final-hop deliveries) and in the
        committed stores (each hash-hop entry applied on exactly one
        rank of the final world; a broken re-shard loses or duplicates
        whole shards here)."""
        if state.sup.status != "done":
            return
        if self.sink_mode:
            # transactional-egress audit: every delta became externally
            # VISIBLE exactly once (staged-only does not count — a unit
            # left pending forever is lost output)
            final = dict(state.store.final)
            missing = sorted(k for k in self.expected if k not in final)
            dupes = sorted(
                k
                for k, c in final.items()
                if c != 1 and k in self.expected
            )
            if missing or dupes:
                raise _PropertyViolation(
                    "exactly-once",
                    "committed egress violated exactly-once: "
                    f"{len(missing)} delta(s) never finalized "
                    f"(e.g. {missing[:3]}), {len(dupes)} finalized "
                    "more than once "
                    f"(e.g. {[(k, final[k]) for k in dupes[:3]]})",
                )
        else:
            sink = dict(state.store.sink)
            missing = sorted(k for k in self.expected if k not in sink)
            dupes = sorted(
                k for k, c in sink.items() if c != 1 and k in self.expected
            )
            if missing or dupes:
                raise _PropertyViolation(
                    "exactly-once",
                    f"clean run violated exactly-once: "
                    f"{len(missing)} lost delta(s) "
                    f"(e.g. {missing[:3]}), {len(dupes)} duplicated "
                    f"(e.g. {[(k, sink[k]) for k in dupes[:3]]})",
                )
        counts: dict = {}
        for rs in state.ranks:
            for entry in rs.applied:
                counts[entry] = counts.get(entry, 0) + 1
        lost = sorted(
            e for e in self.applied_expected if e not in counts
        )
        dup = sorted(
            e for e, c in counts.items()
            if c != 1 and e in self.applied_expected
        )
        if lost or dup:
            raise _PropertyViolation(
                "exactly-once",
                "committed store violated exactly-once across the "
                f"world transition: {len(lost)} store entr(ies) lost "
                f"(e.g. {lost[:3]}), {len(dup)} on several ranks "
                f"(e.g. {[(e, counts[e]) for e in dup[:3]]}) — a "
                "re-shard must re-bucket every entry to exactly one "
                "new owner",
            )

    def is_terminal(self, state: State) -> bool:
        return state.sup.status in ("done", "failed")


class _PropertyViolation(Exception):
    def __init__(self, kind: str, detail: str):
        super().__init__(detail)
        self.kind = kind
        self.detail = detail


# -- the scheduler / explorer ----------------------------------------------


def _successors(model: MeshModel, state: State) -> list[tuple[dict, Any]]:
    """All enabled scheduler actions at ``state`` as (label, successor)
    — successor is a State, or a _PropertyViolation raised through."""
    out: list[tuple[dict, State]] = []
    cfg = model.cfg
    per_rank: list[list[tuple[dict, State]]] = []
    for r in range(len(state.ranks)):
        acts: list[tuple[dict, State]] = []
        rs = state.ranks[r]
        if rs.status != RUN:
            per_rank.append(acts)
            continue
        pc0 = rs.pc[0]
        if pc0 in ("wave_fp", "snap_fp", "restore_fp", "sink_fin_fp"):
            phase = {
                "wave_fp": "wave_send",
                "snap_fp": "post_snapshot",
                "restore_fp": "restore",
                "sink_fin_fp": SINK_FINALIZE_PHASE,
            }[pc0]
            hit = dict(rs.fhits)[phase]
            crashed = _set_rank(
                state._replace(budget=state.budget - 1),
                r, rs._replace(status=CRASHED),
            )
            acts.append(
                (
                    {
                        "label": f"crash(rank={r}, phase={phase}, "
                                 f"hit={hit})",
                        "action": "crash", "rank": r, "phase": phase,
                        "hit": hit,
                    },
                    crashed,
                )
            )
            acts.append(
                (
                    {"label": f"continue(rank={r}, phase={phase})"},
                    model.resume_after_fault_point(state, r),
                )
            )
        else:
            nxt = model.advance(state, r)
            if nxt is not None:
                acts.append(({"label": f"step(rank={r})"}, nxt))
            else:
                # blocked: a frame may arrive (advance handles it once
                # present) or the failure detector may fire
                verdict = model.blocked_on_dead_peer(state, r)
                if verdict is not None:
                    acts.append(
                        (
                            {"label": f"detect(rank={r}, {verdict})"},
                            model.detect(state, r),
                        )
                    )
        per_rank.append(acts)
    if cfg.por == "persistent":
        # persistent-set reduction: rank macro-steps pairwise commute,
        # so one representative rank's actions per state suffice; its
        # OWN branches (crash/continue, detect) stay exhaustive, and
        # every other rank's actions remain enabled in the successors
        chosen = next((a for a in per_rank if a), None)
        if chosen:
            out.extend(chosen)
    else:
        for acts in per_rank:
            out.extend(acts)
    barrier = model.barrier_ready(state)
    if barrier == "plan":
        out.append(
            ({"label": "control(plan)"}, model.resolve_plan_barrier(state))
        )
    elif barrier == "snap":
        out.append(
            (
                {"label": "control(snapshot-commit)"},
                model.resolve_snap_barrier(state),
            )
        )
    sup = model.supervisor_enabled(state)
    if sup == "finish":
        out.append(({"label": "supervisor(finish)"}, model.finish(state)))
    elif sup == "reap":
        for label, s in model.reap_outcomes(state):
            out.append(({"label": f"supervisor({label})"}, s))
    if (
        state.sup.status == "watch"
        and state.rescale_pending is not None
        and sup != "finish"
    ):
        # the one-shot rescale directive may fire at ANY point while
        # the supervisor watches — reap wherever the ranks are, respawn
        # the new world; combined with the crash branches this explores
        # every interleaving of the rescale window
        for label, s in model.rescale_outcomes(state):
            out.append(({"label": f"supervisor({label})"}, s))
    if state.sup.status == "watch":
        for zi, (zr, ze, zw) in enumerate(state.zombies):
            out.append(
                (
                    {
                        "label": f"straggle(rank={zr}, dead_epoch={ze}, "
                                 f"dead_world={zw})"
                    },
                    model.straggle(state, zi),
                )
            )
    return out


def check(
    config: MeshCheckConfig | None = None, **kw
) -> MeshCheckReport:
    """Exhaustively explore the bounded state space. Returns a report
    with state/transition counts and any violations (each carrying a
    minimal trace + replayable fault plan)."""
    cfg = config or MeshCheckConfig(**kw)
    trans = get_transitions(cfg.mutate)
    model = MeshModel(cfg, trans)
    report = MeshCheckReport(config=cfg)
    roots = [(_initial_state(cfg), False)]
    if (
        cfg.fault_budget > 0
        and "restore" in cfg.fault_phases
        and cfg.snap_every <= cfg.rounds
    ) or (
        # a rescale over an EMPTY store is a degenerate re-bucket; the
        # preseeded root (a cut committed by a previous same-world run)
        # is what makes the re-shard filter load-bearing
        cfg.rescale_to is not None
        and cfg.snap_every <= cfg.rounds
    ):
        # second root: a store committed through one snapshot cadence by
        # a previous run — the restore-at-startup scenario where the
        # restore-phase kill slot is live (see _initial_state)
        roots.append(
            (_initial_state(cfg, model, preseed=cfg.snap_every), True)
        )

    def explore(order: str) -> Violation | None:
        """order='dfs': exhaustive count; order='bfs': shortest trace."""
        seen = {s for s, _ in roots}
        frontier: list[tuple[State, tuple]] = [
            (
                s,
                ((("label", "start(committed-store)"),),) if pre else (),
            )
            for s, pre in roots
        ]
        states = transitions = terminals = rollbacks = rescales = 0
        first: Violation | None = None
        while frontier:
            if order == "dfs":
                state, trace = frontier.pop()
            else:
                state, trace = frontier.pop(0)
            states += 1
            if states > cfg.max_states:
                report.complete = False
                break
            try:
                model.check_invariants(state)
                if model.is_terminal(state):
                    terminals += 1
                    model.check_terminal(state)
                    continue
                succ = _successors(model, state)
            except _PropertyViolation as v:
                first = Violation(
                    v.kind, v.detail,
                    [dict(s) for s in trace],
                )
                break
            if not succ:
                blocked = ", ".join(
                    f"rank {r}@{rs.pc[0]}"
                    for r, rs in enumerate(state.ranks)
                    if rs.status == RUN
                )
                first = Violation(
                    "deadlock",
                    "no rank can step, no frame can arrive, no failure "
                    f"is detectable ({blocked or 'no live ranks'}; "
                    f"supervisor {state.sup.status})",
                    [dict(s) for s in trace],
                )
                break
            for label, nxt in succ:
                transitions += 1
                if "rollback" in label["label"]:
                    rollbacks += 1
                if "rescale(" in label["label"]:
                    rescales += 1
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append((nxt, trace + (tuple(label.items()),)))
        if order == "dfs":
            report.states = states
            report.transitions = transitions
            report.terminals = terminals
            report.rollbacks_explored = rollbacks
            report.rescales_explored = rescales
        return first

    hit = explore("dfs")
    if hit is not None:
        # re-search breadth-first so the reported counterexample is a
        # MINIMAL interleaving trace (DFS finds deep ones first)
        minimal = explore("bfs")
        violation = minimal or hit
        if cfg.rescale_to is not None:
            violation.rescale = {
                "from": cfg.world, "to": cfg.rescale_to,
            }
        report.violations.append(violation)
    return report


# -- Plan Doctor integration ------------------------------------------------


def topology_from_runtime(runtime) -> tuple[Exchange, ...]:
    """Extract the model topology from a lowered runtime's actual
    exchange graph: one model Exchange per ExchangeNode, with the
    upstream relation read off the SAME reach masks the wave scheduler
    partitions with."""
    xnodes = runtime.scope.exchange_nodes
    masks = runtime._exchange_reach_masks()
    out = []
    for i, xn in enumerate(xnodes):
        ups = tuple(
            j
            for j, other in enumerate(xnodes)
            if j != i and (masks[other.node_id] >> i) & 1
        )
        out.append(Exchange(i, xn.mode, ups))
    return tuple(out)


def check_runtime_mesh(
    runtime,
    processes: int,
    rounds: int = 2,
    fault_budget: int = 1,
    max_states: int | None = None,
    mutate: str | None = None,
    tree_knob: str | None = None,
) -> MeshCheckReport:
    """The Plan Doctor's distributed-safety pass: model-check the
    *actual lowered plan's* exchange topology at ``processes`` ranks,
    so a user gets a deadlock/divergence/exactly-once verdict before
    ever launching a real N-rank mesh. ``tree_knob`` defaults to the
    live PATHWAY_MESH_TREE_FANOUT environment, so the doctor explores
    the gather topology (flat or tree) the real run would drive."""
    import os as _os

    topology = topology_from_runtime(runtime)
    if not topology:
        topology = canonical_topology()
    if tree_knob is None:
        tree_knob = _os.environ.get("PATHWAY_MESH_TREE_FANOUT", "auto")
    cfg = MeshCheckConfig(
        world=processes,
        rounds=rounds,
        fault_budget=fault_budget,
        topology=topology,
        mutate=mutate,
        tree_knob=tree_knob,
        **(
            {"max_states": max_states} if max_states is not None else {}
        ),
    )
    return check(cfg)


# ===========================================================================
# Serving-plane checker: park/replay across rollback
# ===========================================================================
#
# The epoch-survivable frontend (io/http/_frontend.py) parks every
# admitted, unresponded request when the backend epoch dies and replays
# it into epoch+1; the gateway (io/http/_server.py) aborts uncommitted
# windows on the way down. Those decisions are pure transitions in
# parallel/protocol.py (serve_admit / serve_park / serve_replay_split /
# serve_frontend_state) — this checker drives the SAME objects over
# every interleaving of {arrival, window commit, response delivery,
# backend crash, epoch+1 reattach} and verifies, on every terminal
# state, the serving exactly-once contract:
#
# * no admitted request is LOST — each ends in exactly one terminal:
#   a delivered response, or a deadline 503 (expired while parked);
# * no request is ANSWERED TWICE across any number of rollbacks — a
#   request whose response was already delivered must never replay
#   (the ``replay_committed_window`` mutant breaks exactly this filter
#   and must be caught with a replayable trace);
# * a window whose members were all parked/evicted commits NOTHING.

SERVE_MUTANT_NAMES = ("replay_committed_window",)

SERVE_FAULT_POINT = "serve.dispatch"


class ServeTransitions:
    """The serving protocol decisions the model drives through —
    default-binds the engine's own ``protocol.TRANSITIONS`` entries
    (same-object identity pinned by tests, like :class:`Transitions`)."""

    NAMES = (
        "serve_frontend_state",
        "serve_admit",
        "serve_park",
        "serve_replay_split",
        "serve_retry_after",
        "breaker_decide",
    )

    def __init__(self, overrides: dict | None = None):
        for name in self.NAMES:
            setattr(self, name, _proto.TRANSITIONS[name])
        for name, fn in (overrides or {}).items():
            if name not in self.NAMES:
                raise ValueError(f"unknown serve transition {name!r}")
            setattr(self, name, fn)


def _mutant_replay_committed_window(inflight_ids, responded_ids):
    """Broken park set: the responded filter is dropped, so a request
    whose window committed AND whose response was already delivered is
    parked and replayed at epoch+1 — the client is answered twice."""
    return sorted(inflight_ids)


def get_serve_transitions(mutate: str | None = None) -> ServeTransitions:
    if mutate is None:
        return ServeTransitions()
    if mutate == "replay_committed_window":
        return ServeTransitions(
            {"serve_park": _mutant_replay_committed_window}
        )
    raise ValueError(
        f"unknown serve mutant {mutate!r}; known: "
        + ", ".join(SERVE_MUTANT_NAMES)
    )


@dataclass
class ServeCheckConfig:
    requests: int = 3
    fault_budget: int = 1
    queue_cap: int = 8
    park_budget: int = 8
    # per-request outage budget: how many park/replay cycles a request's
    # PATHWAY_REST_TIMEOUT_S deadline survives; 0 = expires on its first
    # park (the deadline-accounting leg). Padded/truncated to `requests`.
    deadline_budgets: tuple = (1, 1, 0)
    mutate: str | None = None
    max_states: int = 100_000


@dataclass
class ServeViolation:
    kind: str
    detail: str
    trace: list = field(default_factory=list)

    def fault_plan(self) -> dict | None:
        """Crash choices as a replayable PATHWAY_FAULT_PLAN: each crash
        step names the ``serve.dispatch`` phase slot (``window`` — formed,
        uncommitted; ``committed`` — committed, responses undelivered)
        the real gateway exposes, on the rank that owns the gateway."""
        rules = [
            {
                "point": SERVE_FAULT_POINT,
                "phase": step["phase"],
                "rank": 0,
                "hits": [step["hit"]],
                "action": "crash",
            }
            for step in self.trace
            if step.get("action") == "crash"
        ]
        return {"seed": 7, "rules": rules} if rules else None

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "detail": self.detail,
            "trace": self.trace,
            "fault_plan": self.fault_plan(),
        }


@dataclass
class ServeCheckReport:
    config: ServeCheckConfig
    states: int = 0
    transitions: int = 0
    terminals: int = 0
    rollbacks_explored: int = 0
    complete: bool = True
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.complete and not self.violations

    def to_dict(self) -> dict:
        return {
            "schema": "pathway_tpu_torch.servecheck/v1",
            "requests": self.config.requests,
            "fault_budget": self.config.fault_budget,
            "mutate": self.config.mutate,
            "states": self.states,
            "transitions": self.transitions,
            "terminals": self.terminals,
            "rollbacks_explored": self.rollbacks_explored,
            "complete": self.complete,
            "ok": self.ok,
            "violations": [v.to_dict() for v in self.violations],
        }

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    def render(self) -> str:
        c = self.config
        lines = [
            f"serving verifier: {c.requests} request(s), fault budget "
            f"{c.fault_budget}"
            + (f", mutant {c.mutate!r}" if c.mutate else ""),
            f"  explored {self.states} states / {self.transitions} "
            f"transitions ({self.terminals} terminal(s), "
            f"{self.rollbacks_explored} rollback path(s))"
            + ("" if self.complete else " — INCOMPLETE (state cap hit)"),
        ]
        if not self.violations:
            lines.append(
                "  every admitted request reaches exactly one terminal "
                "(response or deadline 503) across all rollbacks; none "
                "answered twice; all-parked windows commit nothing"
            )
        for v in self.violations:
            lines.append(f"  VIOLATION [{v.kind}] {v.detail}")
            for step in v.trace:
                lines.append(f"    - {step['label']}")
            plan = v.fault_plan()
            if plan:
                lines.append(
                    "    replay: PATHWAY_FAULT_PLAN='"
                    + json.dumps(plan, separators=(",", ":"))
                    + "'"
                )
        return "\n".join(lines)


# per-request statuses of the serving model
_S_NEW = "new"            # not yet arrived
_S_QUEUED = "queued"      # admitted + forwarded, in the collecting window
_S_COMMITTED = "committed"  # its window committed (backend in-memory)
_S_RESPONDED = "responded"  # terminal: response delivered
_S_PARKED = "parked"      # backend lost; future retained at the frontend
_S_EXPIRED = "expired"    # terminal: deadline 503 while parked/shed


class _ServeState(NamedTuple):
    # per request: (status, terminals_delivered, outage_budget)
    reqs: tuple
    backend_up: bool
    epoch: int
    crashes_left: int
    window_hits: int      # serve.dispatch phase="window" hit counter
    committed_hits: int   # serve.dispatch phase="committed" hit counter


class _ServeProperty(Exception):
    def __init__(self, kind: str, detail: str):
        super().__init__(detail)
        self.kind = kind
        self.detail = detail


class _ServeModel:
    def __init__(self, cfg: ServeCheckConfig, t: ServeTransitions):
        self.cfg = cfg
        self.t = t
        budgets = list(cfg.deadline_budgets) + [1] * cfg.requests
        self.budgets = tuple(budgets[: cfg.requests])

    def initial(self) -> _ServeState:
        return _ServeState(
            reqs=tuple(
                (_S_NEW, 0, self.budgets[i])
                for i in range(self.cfg.requests)
            ),
            backend_up=True,
            epoch=0,
            crashes_left=self.cfg.fault_budget,
            window_hits=0,
            committed_hits=0,
        )

    # -- helpers -----------------------------------------------------------
    def _frontend_state(self, s: _ServeState) -> str:
        return self.t.serve_frontend_state(s.backend_up, False)

    def _counts(self, s: _ServeState):
        inflight = sum(
            1 for st, _, _ in s.reqs
            if st in (_S_QUEUED, _S_COMMITTED, _S_PARKED)
        )
        parked = sum(1 for st, _, _ in s.reqs if st == _S_PARKED)
        return inflight, parked

    def _deliver(self, s: _ServeState, i: int, status: str):
        """One terminal answer (response or 503) to request i — a second
        delivery is the double-answer violation, returned (not raised)
        so the violating step lands in the trace."""
        st, n, b = s.reqs[i]
        if n >= 1:
            return _ServeProperty(
                "double-response",
                f"request {i} answered twice (prior terminal, then "
                f"{status!r} after a replay of its committed window)",
            )
        reqs = list(s.reqs)
        reqs[i] = (status, n + 1, b)
        return s._replace(reqs=tuple(reqs))

    # -- successors --------------------------------------------------------
    def successors(self, s: _ServeState):
        """[(label_step, next_state)] — every scheduler choice."""
        out = []
        fe_state = self._frontend_state(s)
        inflight, parked = self._counts(s)
        # 1. next arrival (arrival order is fixed; interleaving with the
        # other actions is what's explored)
        for i, (st, n, b) in enumerate(s.reqs):
            if st != _S_NEW:
                continue
            verdict = self.t.serve_admit(
                fe_state, inflight, self.cfg.queue_cap, parked,
                self.cfg.park_budget,
            )
            if verdict == "admit":
                reqs = list(s.reqs)
                reqs[i] = (_S_QUEUED, n, b)
                out.append(
                    (
                        {"label": f"arrive r{i} -> queued (epoch {s.epoch})"},
                        s._replace(reqs=tuple(reqs)),
                    )
                )
            elif verdict == "park":
                reqs = list(s.reqs)
                reqs[i] = (_S_PARKED, n, b)
                out.append(
                    (
                        {"label": f"arrive r{i} -> parked (recovering)"},
                        s._replace(reqs=tuple(reqs)),
                    )
                )
            else:  # shed: terminal 503 + Retry-After
                out.append(
                    (
                        {"label": f"arrive r{i} -> shed 503"},
                        self._deliver(s, i, _S_EXPIRED),
                    )
                )
            break  # only the next unarrived request can arrive
        if s.backend_up:
            queued = [
                i for i, (st, _, _) in enumerate(s.reqs) if st == _S_QUEUED
            ]
            # 2. the collecting window closes and commits — ONE commit
            # for every queued member. An all-parked/evicted window
            # never reaches here (its live set is empty): the gateway
            # skips the commit entirely, which the model mirrors by
            # requiring a non-empty live set.
            if queued:
                reqs = list(s.reqs)
                for i in queued:
                    st, n, b = reqs[i]
                    reqs[i] = (_S_COMMITTED, n, b)
                out.append(
                    (
                        {
                            "label": "window commit "
                            + ",".join(f"r{i}" for i in queued)
                            + f" (epoch {s.epoch})"
                        },
                        # the real _dispatch_window fires BOTH
                        # serve.dispatch phases once per dispatched
                        # window (pre-commit "window", post-commit
                        # "committed") — the hit counters must track
                        # WINDOWS, not response deliveries, or the
                        # rendered fault plan kills at the wrong slot
                        s._replace(
                            reqs=tuple(reqs),
                            window_hits=s.window_hits + 1,
                            committed_hits=s.committed_hits + 1,
                        ),
                    )
                )
            # 3. deliver one committed request's response
            for i, (st, n, b) in enumerate(s.reqs):
                if st == _S_COMMITTED:
                    out.append(
                        (
                            {"label": f"respond r{i} (epoch {s.epoch})"},
                            self._deliver(s, i, _S_RESPONDED),
                        )
                    )
            # 4. the backend epoch crashes (rank kill mid-window /
            # post-commit): in-memory windows are lost; the frontend
            # parks every admitted, unresponded request — the park set
            # is the shared serve_park transition (the mutant breaks
            # its responded filter)
            if s.crashes_left > 0:
                has_committed = any(
                    st == _S_COMMITTED for st, _, _ in s.reqs
                )
                phase = "committed" if has_committed else "window"
                # a committed-phase crash lands AT the firing of the
                # latest commit (= committed_hits so far); a window-phase
                # crash lands at the NEXT window's pre-commit firing
                hit = (
                    max(1, s.committed_hits)
                    if has_committed
                    else s.window_hits + 1
                )
                frontend_inflight = {
                    i
                    for i, (st, _, _) in enumerate(s.reqs)
                    if st in (_S_QUEUED, _S_COMMITTED, _S_RESPONDED)
                }
                responded = {
                    i
                    for i, (st, _, _) in enumerate(s.reqs)
                    if st == _S_RESPONDED
                }
                park = set(
                    self.t.serve_park(frontend_inflight, responded)
                )
                reqs = list(s.reqs)
                for i in park:
                    st, n, b = reqs[i]
                    reqs[i] = (_S_PARKED, n, b)
                out.append(
                    (
                        {
                            "label": f"CRASH backend epoch {s.epoch} "
                            f"({phase}); park "
                            + (
                                ",".join(f"r{i}" for i in sorted(park))
                                or "nothing"
                            ),
                            "action": "crash",
                            "phase": phase,
                            "hit": hit,
                        },
                        s._replace(
                            reqs=tuple(reqs),
                            backend_up=False,
                            crashes_left=s.crashes_left - 1,
                        ),
                    )
                )
        else:
            # 5. epoch+1 reattaches: the replay-vs-expire verdict over
            # the parked set is the shared serve_replay_split transition
            # (deadline accounting: a request out of outage budget gets
            # a terminal 503, never a dropped connection)
            parked_ids = [
                i for i, (st, _, _) in enumerate(s.reqs) if st == _S_PARKED
            ]
            deadlines = {
                i: float(s.reqs[i][2]) for i in parked_ids
            }
            replay, expired = self.t.serve_replay_split(
                parked_ids, 0.5, deadlines
            )
            ns = s._replace(backend_up=True, epoch=s.epoch + 1)
            reqs = list(ns.reqs)
            for i in replay:
                st, n, b = reqs[i]
                reqs[i] = (_S_QUEUED, n, b - 1)
            ns = ns._replace(reqs=tuple(reqs))
            for i in expired:
                ns = self._deliver(ns, i, _S_EXPIRED)
                if isinstance(ns, _ServeProperty):
                    break
            out.append(
                (
                    {
                        "label": f"reattach epoch {s.epoch + 1}: replay "
                        + (",".join(f"r{i}" for i in replay) or "-")
                        + "; expire "
                        + (",".join(f"r{i}" for i in expired) or "-"),
                    },
                    ns,
                )
            )
        return out

    def is_terminal(self, s: _ServeState) -> bool:
        return all(
            st in (_S_RESPONDED, _S_EXPIRED) for st, _, _ in s.reqs
        )

    def check_terminal(self, s: _ServeState) -> None:
        for i, (st, n, b) in enumerate(s.reqs):
            if n != 1:
                raise _ServeProperty(
                    "request-lost" if n == 0 else "double-response",
                    f"request {i} ended with {n} terminal answer(s) "
                    f"(status {st!r}) — every admitted request must get "
                    "exactly one (response, degraded response, or "
                    "deadline 503)",
                )


def check_serving(cfg: ServeCheckConfig | None = None) -> ServeCheckReport:
    """Exhaustively explore the serving plane's park/replay protocol.
    BFS over all interleavings (arrivals × window commits × response
    deliveries × crashes × reattaches) with full-state memoization —
    BFS so a violation's trace is minimal by construction.

    Model abstractions: one collecting window at a time (every queued
    request joins it), and removal-only dispatches
    (``delete_completed_queries`` retraction flushes) are not modeled —
    replaying a trace against a keep-queries gateway keeps the
    ``serve.dispatch`` hit indices exact; under delete-completed mode
    the kill lands in the same protocol slot but possibly a later
    window (the fault-matrix contract, same as mesh traces)."""
    cfg = cfg or ServeCheckConfig()
    t = get_serve_transitions(cfg.mutate)
    model = _ServeModel(cfg, t)
    report = ServeCheckReport(config=cfg)
    root = model.initial()
    seen = {root}
    frontier: list[tuple[_ServeState, tuple]] = [(root, ())]
    while frontier:
        next_frontier = []
        for state, trace in frontier:
            report.states += 1
            if report.states > cfg.max_states:
                report.complete = False
                return report
            try:
                if model.is_terminal(state):
                    report.terminals += 1
                    model.check_terminal(state)
                    continue
                succs = model.successors(state)
            except _ServeProperty as p:
                report.violations.append(
                    ServeViolation(p.kind, p.detail, list(trace))
                )
                return report
            if not succs:
                report.violations.append(
                    ServeViolation(
                        "serve-deadlock",
                        "non-terminal state with no possible action",
                        list(trace),
                    )
                )
                return report
            for step, ns in succs:
                report.transitions += 1
                if step.get("action") == "crash":
                    report.rollbacks_explored += 1
                if isinstance(ns, _ServeProperty):
                    # a delivery violation surfaced while building this
                    # successor — the violating step closes the trace
                    report.violations.append(
                        ServeViolation(
                            ns.kind, ns.detail, list(trace + (step,))
                        )
                    )
                    return report
                if ns not in seen:
                    seen.add(ns)
                    next_frontier.append((ns, trace + (step,)))
        frontier = next_frontier
    return report


# ===========================================================================
# Pacing checker: bounded-memory backpressure without deadlock
# ===========================================================================
#
# The memory governor (internals/memory.py + engine/runtime.py
# _service_memory) pauses pausable sources off the pure transitions
# mem_ladder / pace_decide / pace_resume. The one catastrophic way to get
# that wrong is a PAUSE/DRAIN DEADLOCK: pacing on a signal only the
# paused subject itself can drain (the journal ledger, which shrinks at
# subject commit boundaries a parked subject can never reach). The
# engine avoids it by construction — the pacing signal is the
# put-minus-drained queue depth, which the MAIN LOOP shrinks — and this
# checker proves the construction: it drives the SAME transition objects
# over every interleaving of {read, drain, governance sample, injected
# mem.pressure sample, crash+restore, rescale restore} and verifies:
#
# * no dead end: every non-terminal state has a successor — in
#   particular a paced source never blocks the drain that would unpause
#   it (drain is enabled whenever anything is queued, paused or not);
# * exactly-once: every row is delivered exactly once across pacing
#   episodes, pressure injections, crash restores and rescale restores
#   (undrained queued rows are re-read after a restore; drained rows are
#   journal-covered and are not);
# * the sticky ``abort`` rung always resolves into an epoch abort +
#   restore, never a silent hang.
#
# The ``never_resume`` mutant (pace_resume that can never release) must
# be caught with a minimal BFS trace whose pressure/crash steps render
# as a replayable ``mem.pressure`` PATHWAY_FAULT_PLAN
# (scripts/fault_matrix.py --from-trace replays it as a real cell).

PACE_MUTANT_NAMES = ("never_resume",)

PACE_FAULT_POINT = "mem.pressure"


class PaceTransitions:
    """The governance decisions the pacing model drives through —
    default-binds the engine's own ``protocol.TRANSITIONS`` entries
    (same-object identity pinned by tests/test_backpressure.py)."""

    NAMES = ("mem_ladder", "pace_decide", "pace_resume")

    def __init__(self, overrides: dict | None = None):
        for name in self.NAMES:
            setattr(self, name, _proto.TRANSITIONS[name])
        for name, fn in (overrides or {}).items():
            if name not in self.NAMES:
                raise ValueError(f"unknown pace transition {name!r}")
            setattr(self, name, fn)


def _mutant_never_resume(ladder_state, backlog_rows=0, resume_rows=0):
    """Broken release: the resume verdict is never granted, so a paced
    source stays parked forever once the first pause engages — the
    pause/drain liveness hole the checker must catch as a dead end."""
    return False


def get_pace_transitions(mutate: str | None = None) -> PaceTransitions:
    if mutate is None:
        return PaceTransitions()
    if mutate == "never_resume":
        return PaceTransitions({"pace_resume": _mutant_never_resume})
    raise ValueError(
        f"unknown pace mutant {mutate!r}; known: "
        + ", ".join(PACE_MUTANT_NAMES)
    )


@dataclass
class PaceCheckConfig:
    # rows the modeled source must deliver; 1 queued row = 1 byte, so
    # the watermark arithmetic below stays single-digit
    rows: int = 4
    low_bytes: int = 2
    high_bytes: int = 3
    budget_bytes: int = 5
    abort_streak: int = 2
    # one-shot budgets: injected mem.pressure samples, rank crashes and
    # rescale restores the scheduler may spend
    spike_budget: int = 1
    crash_budget: int = 1
    rescale_budget: int = 1
    mutate: str | None = None
    max_states: int = 200_000


@dataclass
class PaceViolation:
    kind: str
    detail: str
    trace: list = field(default_factory=list)

    def fault_plan(self) -> dict | None:
        """Pressure/crash choices as a replayable PATHWAY_FAULT_PLAN:
        every governance sample fires the ``mem.pressure`` point (phase
        ``sample``), so the trace's sample ordinals are the hit indices
        — a ``raise`` rule is the injected over-watermark sample, a
        ``crash`` rule kills the rank at that sample."""
        rules = [
            {
                "point": PACE_FAULT_POINT,
                "phase": "sample",
                "rank": 0,
                "hits": [step["hit"]],
                "action": step["action"],
            }
            for step in self.trace
            if step.get("action") in ("raise", "crash")
        ]
        return {"seed": 7, "rules": rules} if rules else None

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "detail": self.detail,
            "pressure": True,
            "rescale": any(s.get("rescale") for s in self.trace),
            "trace": self.trace,
            "fault_plan": self.fault_plan(),
        }


@dataclass
class PaceCheckReport:
    config: PaceCheckConfig
    states: int = 0
    transitions: int = 0
    terminals: int = 0
    pauses_explored: int = 0
    restores_explored: int = 0
    complete: bool = True
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.complete and not self.violations

    def to_dict(self) -> dict:
        return {
            "schema": "pathway_tpu_torch.pacecheck/v1",
            "rows": self.config.rows,
            "mutate": self.config.mutate,
            "states": self.states,
            "transitions": self.transitions,
            "terminals": self.terminals,
            "pauses_explored": self.pauses_explored,
            "restores_explored": self.restores_explored,
            "complete": self.complete,
            "ok": self.ok,
            "violations": [v.to_dict() for v in self.violations],
        }

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    def render(self) -> str:
        c = self.config
        lines = [
            f"pacing verifier: {c.rows} row(s), watermarks "
            f"{c.low_bytes}/{c.high_bytes} of budget {c.budget_bytes}, "
            f"spike/crash/rescale budgets {c.spike_budget}/"
            f"{c.crash_budget}/{c.rescale_budget}"
            + (f", mutant {c.mutate!r}" if c.mutate else ""),
            f"  explored {self.states} states / {self.transitions} "
            f"transitions ({self.terminals} terminal(s), "
            f"{self.pauses_explored} pause(s), "
            f"{self.restores_explored} restore(s))"
            + ("" if self.complete else " — INCOMPLETE (state cap hit)"),
        ]
        if not self.violations:
            lines.append(
                "  every interleaving drains: a paced source never blocks "
                "the wave that unpauses it, every row is delivered exactly "
                "once across pressure spikes, crash restores and rescales, "
                "and the abort rung always resolves into a restore"
            )
        for v in self.violations:
            lines.append(f"  VIOLATION [{v.kind}] {v.detail}")
            for step in v.trace:
                lines.append(f"    - {step['label']}")
            plan = v.fault_plan()
            if plan:
                lines.append(
                    "    replay: PATHWAY_FAULT_PLAN='"
                    + json.dumps(plan, separators=(",", ":"))
                    + "'"
                )
        return "\n".join(lines)


class _PaceState(NamedTuple):
    unread: int          # rows the source has not read yet
    queued: int          # put on the engine queue, not yet drained
    delivered: int       # drained into the graph (each row exactly once)
    paused: bool         # the pace gate is cleared
    ladder: str          # cached ladder verdict of the last sample
    over_streak: int     # consecutive over-budget samples (abort input)
    spikes_left: int
    crashes_left: int
    rescales_left: int
    sample_hits: int     # governance samples so far (= fault-point hits)


class _PaceProperty(Exception):
    def __init__(self, kind: str, detail: str):
        super().__init__(detail)
        self.kind = kind
        self.detail = detail


class _PaceModel:
    def __init__(self, cfg: PaceCheckConfig, t: PaceTransitions):
        self.cfg = cfg
        self.t = t

    def initial(self) -> _PaceState:
        return _PaceState(
            unread=self.cfg.rows,
            queued=0,
            delivered=0,
            paused=False,
            ladder="ok",
            over_streak=0,
            spikes_left=self.cfg.spike_budget,
            crashes_left=self.cfg.crash_budget,
            rescales_left=self.cfg.rescale_budget,
            sample_hits=0,
        )

    def _restore(self, s: _PaceState) -> _PaceState:
        """Epoch restore semantics: a FRESH per-run accountant (ladder
        back to "ok", gate released — paced state is re-derived from
        real post-restore bytes, not carried over) and the undrained
        queue is re-read (those rows never reached the journal; drained
        rows are covered by the cut and are not replayed)."""
        return s._replace(
            unread=s.unread + s.queued,
            queued=0,
            paused=False,
            ladder="ok",
            over_streak=0,
        )

    def _sample(self, s: _PaceState, injected: bool) -> _PaceState:
        total = s.queued  # 1 queued row accounts 1 byte in the model
        if injected:
            # a caught mem.pressure raise reads as a synthetic
            # at-high-watermark sample (internals/memory.py sample())
            total = max(total, self.cfg.high_bytes)
        ladder = self.t.mem_ladder(
            total,
            self.cfg.low_bytes,
            self.cfg.high_bytes,
            self.cfg.budget_bytes,
            prev=s.ladder,
            over_streak=s.over_streak,
            abort_streak=self.cfg.abort_streak,
        )
        over = s.over_streak + 1 if total >= self.cfg.budget_bytes else 0
        paused = s.paused
        if not paused:
            if self.t.pace_decide(ladder, s.queued, 0):
                paused = True
        elif self.t.pace_resume(ladder, s.queued, 0):
            paused = False
        return s._replace(
            ladder=ladder,
            over_streak=over,
            paused=paused,
            spikes_left=s.spikes_left - (1 if injected else 0),
            sample_hits=s.sample_hits + 1,
        )

    def successors(self, s: _PaceState):
        """[(label_step, next_state)] — every scheduler choice. No-op
        governance samples are elided (they revisit the same state), so
        a dead end IS a state where nothing can ever change again."""
        out = []
        if s.ladder == "abort":
            # the sticky last rung: the epoch is aborting — the only
            # continuation is the restore that re-derives everything
            # (a missing successor here would be the silent-hang bug)
            out.append(
                (
                    {"label": "epoch ABORT -> restore (ladder reset, "
                              "gate released, undrained rows re-read)"},
                    self._restore(s),
                )
            )
            return out
        if s.unread > 0 and not s.paused:
            out.append(
                (
                    {"label": f"read (queued {s.queued} -> {s.queued + 1})"},
                    s._replace(unread=s.unread - 1, queued=s.queued + 1),
                )
            )
        if s.queued > 0:
            # THE invariant under test: the main loop's drain is enabled
            # whether or not the source is paced — the pacing signal
            # shrinks without the paused subject thread advancing
            out.append(
                (
                    {
                        "label": "drain (engine accepts; queued "
                        f"{s.queued} -> {s.queued - 1}"
                        + (", source paced)" if s.paused else ")")
                    },
                    s._replace(
                        queued=s.queued - 1, delivered=s.delivered + 1
                    ),
                )
            )
        ns = self._sample(s, injected=False)
        if (ns.ladder, ns.paused, ns.over_streak) != (
            s.ladder, s.paused, s.over_streak
        ):
            out.append(
                (
                    {
                        "label": f"sample #{ns.sample_hits}: total "
                        f"{s.queued} -> ladder {ns.ladder}"
                        + (
                            ", PAUSE" if ns.paused and not s.paused
                            else ", resume" if s.paused and not ns.paused
                            else ""
                        ),
                        "hit": ns.sample_hits,
                    },
                    ns,
                )
            )
        if s.spikes_left > 0:
            ns = self._sample(s, injected=True)
            out.append(
                (
                    {
                        "label": f"sample #{ns.sample_hits} under INJECTED "
                        f"mem.pressure -> ladder {ns.ladder}"
                        + (", PAUSE" if ns.paused and not s.paused else ""),
                        "hit": ns.sample_hits,
                        "action": "raise",
                    },
                    ns,
                )
            )
        if s.crashes_left > 0:
            out.append(
                (
                    {
                        "label": "CRASH rank at next sample -> restore "
                        "(fresh accountant, undrained rows re-read)",
                        "hit": s.sample_hits + 1,
                        "action": "crash",
                    },
                    self._restore(s)._replace(
                        crashes_left=s.crashes_left - 1
                    ),
                )
            )
        if s.rescales_left > 0:
            out.append(
                (
                    {
                        "label": "RESCALE restore (world changes; paced "
                        "state re-derived from post-restore bytes)",
                        "rescale": True,
                    },
                    self._restore(s)._replace(
                        rescales_left=s.rescales_left - 1
                    ),
                )
            )
        return out

    def is_terminal(self, s: _PaceState) -> bool:
        return s.unread == 0 and s.queued == 0

    def check_terminal(self, s: _PaceState) -> None:
        if s.delivered != self.cfg.rows:
            raise _PaceProperty(
                "exactly-once",
                f"terminal state delivered {s.delivered} of "
                f"{self.cfg.rows} row(s) — pacing/restore interleavings "
                "must neither drop nor duplicate rows",
            )


def check_pacing(cfg: PaceCheckConfig | None = None) -> PaceCheckReport:
    """Exhaustively explore the source-pacing governance loop. BFS over
    all interleavings (reads × drains × governance samples × injected
    pressure × crash/rescale restores) with full-state memoization —
    BFS so a violation's trace is minimal by construction.

    A dead end (non-terminal state with no successors) is the
    pause/drain deadlock class: with no-op samples elided, "no
    successors" literally means nothing in the system can ever change
    again — the signature of a gate nobody will release."""
    cfg = cfg or PaceCheckConfig()
    t = get_pace_transitions(cfg.mutate)
    model = _PaceModel(cfg, t)
    report = PaceCheckReport(config=cfg)
    root = model.initial()
    seen = {root}
    frontier: list[tuple[_PaceState, tuple]] = [(root, ())]
    while frontier:
        next_frontier = []
        for state, trace in frontier:
            report.states += 1
            if report.states > cfg.max_states:
                report.complete = False
                return report
            try:
                if model.is_terminal(state):
                    report.terminals += 1
                    model.check_terminal(state)
                    continue
                succs = model.successors(state)
            except _PaceProperty as p:
                report.violations.append(
                    PaceViolation(p.kind, p.detail, list(trace))
                )
                return report
            if not succs:
                report.violations.append(
                    PaceViolation(
                        "pace-deadlock",
                        "non-terminal state with no possible action — a "
                        "paced source is parked with nothing left that "
                        "could ever release it (unread "
                        f"{state.unread}, queued {state.queued}, ladder "
                        f"{state.ladder!r}, paused {state.paused})",
                        list(trace),
                    )
                )
                return report
            for step, ns in succs:
                report.transitions += 1
                if ns.paused and not state.paused:
                    report.pauses_explored += 1
                if step.get("action") == "crash" or step.get("rescale"):
                    report.restores_explored += 1
                if ns not in seen:
                    seen.add(ns)
                    next_frontier.append((ns, trace + (step,)))
        frontier = next_frontier
    return report
