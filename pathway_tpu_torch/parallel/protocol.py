"""The mesh protocol's transition table — ONE implementation shared by
the engine and the model checker.

The reference engine inherits multi-worker correctness from timely
dataflow's proven progress-tracking protocol (SURVEY §1,
src/engine/dataflow.rs); our replacement — wave-stepped BSP exchange
(``PWX2``), heartbeats/timeouts (``PWHB``), goodbye-vs-crash
classification (``PWBY``), epoch-bound handshakes and supervisor
rollback — is hand-rolled, so its correctness argument is the
PR-5 trick applied to concurrency: the protocol's *decisions* live here
as pure transition functions, the runtime/procgroup/supervisor **drive
through them** (pinned by tests/test_meshcheck.py the same way
test_plan_doctor.py pins the shared ``NBDecision`` objects), and
``analysis/meshcheck.py`` exhaustively model-checks the very same
functions over all interleavings of N symbolic ranks. A protocol change
that would make the checker and the engine disagree is impossible by
construction — there is only one copy of each decision.

Decisions modeled here (callers named per function):

* wave scheduling — which pending exchange boundaries form the next
  coalesced wave, and which local nodes must quiesce first
  (``engine/runtime.py _step_exchange_waves``);
* leg elision — which peers a rank sends to / receives from in a wave
  (pure-gather legs, wave-1 contributor masks;
  ``engine/runtime.py _run_exchange_wave``);
* frontier agreement — the rank-0 master's lockstep plan over gathered
  frontiers, and the planned commit-timestamp walk of a BSP round
  (``_step_lockstep`` / ``_bsp_inject_commits``);
* membership — epoch-bound handshake acceptance
  (``parallel/procgroup.py`` acceptor/connector);
* failure detection — peer-liveness verdicts and the goodbye-vs-crash
  classification of a lost link (``procgroup.recv``);
* rollback — the supervisor's reap/respawn/give-up decision after an
  epoch dies (``parallel/supervisor.py``).

This module is deliberately **stdlib-only and import-light**: the
supervisor is loaded by file path from stdlib-only drivers
(``scripts/fault_matrix.py``) and pulls this file the same way.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

# a surviving rank that detected a peer failure exits with this code to
# request a rollback restart; distinct from faults.CRASH_EXIT_CODE (27),
# which marks an injected crash itself. Defined here (not supervisor.py)
# so the detection side, the rollback side, and the checker's model all
# read the same constant.
MESH_RESTART_EXIT_CODE = 28


# -- wave scheduling (engine/runtime.py _step_exchange_waves) --------------

def wave_bits(remaining: Iterable[int], xi: Mapping[int, int]) -> int:
    """Bitmask (over exchange indices) of the still-unstepped exchange
    boundaries of the current timestamp."""
    wbits = 0
    for nid in remaining:
        wbits |= 1 << xi[nid]
    return wbits


def quiesce_candidates(
    pending_ids: Iterable[int],
    remaining: Iterable[int] | frozenset,
    masks: Sequence[int],
    umasks: Sequence[int],
    wbits: int,
) -> list[int]:
    """Local nodes that must run BEFORE the next wave: they feed a
    remaining exchange (reach-mask hit) but do not themselves sit
    downstream of one (upstream-mask miss — their inputs are complete).
    The quiesce guard: a node downstream of a remaining exchange has
    incomplete inputs until that boundary delivers and must wait for its
    wave. Topo order holds within the candidate set: every upstream of a
    candidate is a candidate or already stepped."""
    remaining = (
        remaining if isinstance(remaining, (set, frozenset))
        else set(remaining)
    )
    return [
        n
        for n in pending_ids
        if n not in remaining
        and masks[n] & wbits
        and not umasks[n] & wbits
    ]


def wave_partition(
    remaining: Iterable[int], masks: Sequence[int], xi: Mapping[int, int]
) -> list[int]:
    """Of the pending exchanges, those with no OTHER pending exchange
    upstream form the next wave. The pending set is the lockstep-agreed
    exchange mask (identical on every rank) and upstream-ness is static
    reachability, so every rank derives the same waves in the same order
    — the data-plane rendezvous needs no extra control traffic."""
    rem = sorted(remaining)
    return [
        nid
        for nid in rem
        if not any(o != nid and masks[o] & (1 << xi[nid]) for o in rem)
    ]


# -- wave leg elision (engine/runtime.py _run_exchange_wave) ---------------

def tree_fanout(world: int, knob: str | int | None) -> int:
    """Resolve ``PATHWAY_MESH_TREE_FANOUT`` into the gather-tree fanout
    for one mesh: ``0`` = flat (every sender ships straight to rank 0),
    ``k >= 2`` = k-ary reduction tree. ``auto`` (the default)
    turns the tree on at world >= 4 with fanout 2 — below that every
    rank is already a direct child of rank 0, so a tree only adds relay
    hops. The engine resolves its env knob and the model checker its
    config through THIS function, so the explored topology is the
    driven topology."""
    if world <= 2:
        return 0
    if knob is None:
        knob = "auto"
    if isinstance(knob, str):
        knob = knob.strip().lower() or "auto"
        if knob in ("off", "flat", "0", "1", "false", "no"):
            return 0
        if knob == "auto":
            return 2 if world >= 4 else 0
        try:
            knob = int(knob)
        except ValueError:
            return 2 if world >= 4 else 0
    return int(knob) if knob >= 2 else 0


def tree_parent(rank: int, fanout: int) -> int:
    """Parent of ``rank`` in the heap-layout k-ary gather tree rooted at
    rank 0 (rank 0 has no parent)."""
    return (rank - 1) // fanout


def tree_children(rank: int, world: int, fanout: int) -> list[int]:
    """Children of ``rank`` in the heap-layout k-ary gather tree."""
    lo = fanout * rank + 1
    return [c for c in range(lo, min(lo + fanout, world))]


def tree_depth(world: int, fanout: int) -> int:
    """Depth of the gather tree (edges on the longest root-to-leaf
    path); 0 = flat topology or a single rank. The TUI's tree-depth
    gauge and the README docs read this."""
    if fanout < 2 or world <= 1:
        return 0
    depth, r = 0, world - 1
    while r > 0:
        r = tree_parent(r, fanout)
        depth += 1
    return depth


def tree_subtree_active(
    rank: int, world: int, fanout: int, contrib: int | None
) -> bool:
    """Whether the subtree rooted at ``rank`` holds any wave-1
    contributor: a non-contributor interior rank must still RELAY its
    descendants' frames, so its send leg exists iff anything below it
    (or it itself) contributes. ``contrib None`` = every rank may hold
    routable rows."""
    if contrib is None:
        return True
    if (contrib >> rank) & 1:
        return True
    return any(
        tree_subtree_active(c, world, fanout, contrib)
        for c in tree_children(rank, world, fanout)
    )


def tree_relay(own_entries: list, relayed_entries: list) -> list:
    """The interior-rank relay decision of a tree-gather wave: the frame
    shipped to the parent carries this rank's OWN slices plus every
    slice received from its children, unchanged and in that order. A
    relay that drops (or reorders per-child batches of) the received
    slices loses deltas that no flat-topology check can see — the
    ``drop_relay`` mutant breaks exactly this and the model checker must
    catch it as a lost-delta exactly-once violation."""
    return list(own_entries) + list(relayed_entries)


def wave_send_targets(
    world: int,
    rank: int,
    gather_only: bool,
    contrib: int | None,
    fanout: int = 0,
) -> list[int]:
    """Peers this rank ships a wave frame to. Pure-gather waves route to
    rank 0 only (non-zero peers never receive); a rank outside the
    wave-1 contributor mask holds provably empty inputs, so ALL its send
    legs vanish (no frame at all, not an empty frame).

    ``fanout >= 2`` routes pure-gather waves over the k-ary reduction
    tree instead: every non-root rank sends ONE frame to its
    tree parent (after folding in its children's frames), so rank 0
    ingests fanout frames per wave instead of world-1 — the gather legs
    stop serializing on one receiver. A rank whose whole subtree is
    outside the contributor mask has nothing to send OR relay, so its
    leg vanishes exactly like the flat elision."""
    if gather_only and fanout >= 2 and world > 2:
        if rank == 0:
            return []
        return (
            [tree_parent(rank, fanout)]
            if tree_subtree_active(rank, world, fanout, contrib)
            else []
        )
    if contrib is not None and not (contrib >> rank) & 1:
        return []
    return [
        p
        for p in range(world)
        if p != rank and not (gather_only and p != 0)
    ]


def wave_recv_sources(
    world: int,
    rank: int,
    gather_only: bool,
    contrib: int | None,
    fanout: int = 0,
) -> list[int]:
    """Peers this rank expects a wave frame FROM — the exact mirror of
    :func:`wave_send_targets` (every rank derives both sides from the
    same lockstep state, so a frame is expected iff it is sent; any
    asymmetry here is a protocol deadlock). On tree-gather waves a rank
    receives from exactly its contributor-active tree children."""
    if gather_only and fanout >= 2 and world > 2:
        return [
            c
            for c in tree_children(rank, world, fanout)
            if tree_subtree_active(c, world, fanout, contrib)
        ]
    if gather_only and rank != 0:
        return []
    return [
        p
        for p in range(world)
        if p != rank
        and not (contrib is not None and not (contrib >> p) & 1)
    ]


# -- frontier agreement (engine/runtime.py _step_lockstep) ------------------

def lockstep_plan(
    fronts: Sequence[tuple[int, int] | None],
) -> tuple[int, int, int] | None:
    """The rank-0 clock master's frontier agreement: take the min time
    over every rank's reported frontier ``(time, xmask)``; the plan is
    ``(t, union-xmask, contributor-bitmask)`` over exactly the ranks
    whose frontier is at ``t``. ``None`` = no rank has pending work —
    the lockstep round ends."""
    live = [(r, f) for r, f in enumerate(fronts) if f is not None]
    if not live:
        return None
    t = min(f[0] for _, f in live)
    xmask = 0
    contrib = 0
    for r, (ft, fm) in live:
        if ft == t:
            xmask |= fm
            contrib |= 1 << r
    return (t, xmask, contrib)


# -- planned commit-timestamp walk (engine/runtime.py _bsp_inject_commits) --

def commit_time(base: int, offset: int) -> int:
    """Globally ordered even commit timestamps: rank-major within a BSP
    round, stride 2 (odd times are reserved for locally minted rows —
    the error log at clock+1)."""
    return base + 2 * offset


def commit_plan(
    base: int, counts: Sequence[int], xmasks: Sequence[Sequence[int]]
) -> list[tuple[int, int, int]]:
    """The shared plan of one BSP ingest round: every rank knows every
    commit's globally ordered time, exchange mask and owning rank
    (``contrib`` = 1 << owner), so eligible graphs walk the round's
    timestamps with ZERO per-timestamp control round-trips."""
    plan = []
    off = 0
    for r, cnt in enumerate(counts):
        for j in range(cnt):
            plan.append((commit_time(base, off + j), xmasks[r][j], 1 << r))
        off += cnt
    plan.sort()
    return plan


# -- sharding: the stable key mint (parallel/procgroup.py stable_shard) ----

def shard_owner(shard_hash: int, world: int) -> int:
    """Which rank owns a key, given the key's stable 64-bit blake2b
    digest (``procgroup.shard_hash``; exec.cpp shard_partition_nb
    computes the identical digest). The hash is world-independent, so
    re-partitioning a committed store from N to M shards is a pure
    re-bucketing of the SAME digests — the foundation the elastic-mesh
    rescale rests on."""
    return shard_hash % world


def reshard_keep(shard_hash: int, rank: int, world: int) -> bool:
    """Restore-side re-shard filter (persistence/reshard.py): of the
    union of all old ranks' committed entries, the new rank keeps
    exactly those the new-world mint assigns to it. Because
    :func:`shard_owner` is total and single-valued, the kept sets form
    a partition — every entry lands on exactly one new rank (no lost,
    no duplicated deltas; the ``drop_reshard_shard`` mutant breaks
    exactly this and the rescale model checker must catch it)."""
    return shard_owner(shard_hash, world) == rank


def rescale_plan(
    current: int, target: int, lo: int = 1, hi: int = 4096
) -> int:
    """The supervisor's clamp over a requested rescale target: the new
    world size, bounded to ``[lo, hi]`` and at least 1. An invalid
    (non-positive) target holds the current world."""
    if target is None or target < 1:
        return current
    return max(max(1, lo), min(hi, target))


# -- membership: epoch- and world-bound handshake (parallel/procgroup.py) --

def hello_accept(
    acceptor_rank: int,
    acceptor_epoch: int,
    world: int,
    peer_rank: int,
    peer_epoch: int,
    peer_world: int | None = None,
) -> bool:
    """Whether an acceptor admits a connecting peer's hello. Rank must
    be a higher rank of this world (lower ranks are dialed, not
    accepted), and the recovery epoch must match exactly: a straggler
    from a rolled-back epoch can neither join nor be joined by the
    recovered mesh, so in-flight state of the dead epoch can never leak
    across a rollback. (The epoch is additionally MAC-bound, so this
    refusal happens before any keyed output.)

    ``peer_world`` binds the WORLD SIZE the same way: a
    straggler from a reaped pre-rescale epoch carries the dead world's
    size and is rejected exactly like a dead-epoch one — its rank id
    may still be in range after a grow, but its slices were minted for
    a different shard count and must never merge into the rescaled
    mesh. ``None`` skips the check (pre-world-binding wire peers)."""
    if peer_rank <= acceptor_rank or peer_rank >= world:
        return False
    if peer_world is not None and peer_world != world:
        return False
    return peer_epoch == acceptor_epoch


# -- failure detection (parallel/procgroup.py recv) ------------------------

def peer_liveness(
    idle_s: float,
    peer_timeout_s: float,
    goodbye: bool,
    transport_alive: bool = False,
) -> str:
    """Liveness verdict for a peer that has sent nothing for ``idle_s``
    seconds: ``"alive"`` or ``"failed"``. A peer that announced an
    orderly goodbye is never *failed* (its silence is expected), and a
    non-positive timeout disables the detector.

    ``transport_alive`` is the busy-rank escape hatch: app-level silence
    past the timeout with the peer's TRANSPORT still demonstrably live
    (TCP ESTABLISHED and its kernel ACKing our heartbeats) means the
    peer process exists but cannot run Python — a long GIL-held native
    dispatch or fused device call, not a crash. Declaring it failed
    would roll back a healthy mesh; a genuinely hung peer is still
    bounded by the collective deadline (``MeshTimeout``). A crashed
    process closes its sockets (EOF reaches the receiver thread) and a
    dead host stops ACKing, so both real failure classes keep
    ``transport_alive`` False."""
    if goodbye or peer_timeout_s <= 0:
        return "alive"
    if idle_s <= peer_timeout_s:
        return "alive"
    return "alive" if transport_alive else "failed"


def classify_peer_loss(goodbye: bool) -> str:
    """A lost link is a clean shutdown (``"gone"``) iff the peer shipped
    its goodbye frame first; otherwise it is a crash (``"crashed"``).
    Both abort the epoch when traffic was still expected — the
    classification decides what the failure REPORT says, which is what
    points the operator's investigation at (or away from) the dead
    rank."""
    return "gone" if goodbye else "crashed"


# -- rollback: supervisor decision (parallel/supervisor.py) ----------------

def supervisor_decide(
    codes: Sequence[int], restarts_performed: int, max_restarts: int
) -> tuple[str, int]:
    """The supervisor's verdict over a reaped epoch's final exit codes:

    * ``("done", 0)`` — every rank exited cleanly;
    * ``("rollback", epoch_increment=1)`` — some rank failed and budget
      remains: reap the set, respawn ALL ranks at epoch+1 from the last
      committed snapshot cut;
    * ``("give_up", root_code)`` — budget exhausted; the root cause
      prefers a failing rank's own exit code over
      :data:`MESH_RESTART_EXIT_CODE` (survivors merely REPORTING the
      failure) so an outer orchestrator is not told "retryable rollback
      request" about a deterministically failing deployment.
    """
    if all(c == 0 for c in codes):
        return ("done", 0)
    if restarts_performed >= max_restarts:
        root = next(
            (c for c in codes if c not in (0, MESH_RESTART_EXIT_CODE)),
            next((c for c in codes if c != 0), 1),
        )
        return ("give_up", root if root else 1)
    return ("rollback", 1)


# -- serving plane: park/replay across rollback -------------------
# The epoch-survivable frontend (io/http/_frontend.py) and the gateway's
# brownout breaker (io/http/_server.py) drive through these; the serving
# model checker (analysis/meshcheck.py check_serving) explores the same
# functions over every crash interleaving, so "no admitted request is
# lost or answered twice across a rollback" is checked against the code
# that actually runs.

SERVE_STATES = ("serving", "draining", "recovering", "rescaling")


def serve_frontend_state(
    backend_up: bool, draining: bool, rescaling: bool = False
) -> str:
    """The frontend readiness state exposed on ``/healthz``: draining
    wins (shutdown was requested — shed everything so an LB rotates us
    out), otherwise serving iff the backend epoch is attached. A
    detached backend during a supervisor-initiated rescale reads
    ``rescaling`` instead of ``recovering``: same park
    semantics, but operators (and the Retry-After estimator) must tell
    a planned world-size change apart from a crash rollback."""
    if draining:
        return "draining"
    if backend_up:
        return "serving"
    return "rescaling" if rescaling else "recovering"


def serve_admit(
    state: str,
    inflight: int,
    queue_cap: int,
    parked: int,
    park_budget: int,
) -> str:
    """Admission verdict for one arriving request: ``"admit"`` |
    ``"park"`` | ``"shed"``. While recovering (or rescaling — same
    detached-backend window, planned instead of crashed), arrivals PARK
    (futures retained, replayed into epoch+1) up to the park budget
    instead of being shed — a rollback is a latency blip, not an
    outage; past the budget (or while draining) they shed with 503 +
    Retry-After."""
    if state == "draining":
        return "shed"
    if state in ("recovering", "rescaling"):
        return "park" if parked < park_budget else "shed"
    return "admit" if inflight < queue_cap else "shed"


def serve_park(
    inflight_ids: Iterable[int], responded_ids: Iterable[int]
) -> list[int]:
    """The park set at backend loss: every admitted request without a
    delivered response. A request whose response was already delivered
    is TERMINAL — replaying it would answer the client twice (the
    exactly-once boundary; the ``replay_committed_window`` mutant breaks
    exactly this and the serving checker must catch it)."""
    responded = set(responded_ids)
    return sorted(i for i in inflight_ids if i not in responded)


def serve_replay_split(
    parked: Sequence[int],
    now_s: float,
    deadlines_s: Mapping[int, float],
) -> tuple[list[int], list[int]]:
    """``(replay, expired)`` over the parked set at re-attach, in parked
    (arrival) order: requests whose admission deadline budget survived
    the outage replay into the first window of epoch+1; the rest are
    answered 503 + Retry-After (deadline accounting — never a dropped
    connection)."""
    replay: list[int] = []
    expired: list[int] = []
    for rid in parked:
        if now_s < deadlines_s[rid]:
            replay.append(rid)
        else:
            expired.append(rid)
    return replay, expired


def serve_retry_after(
    observed_restart_s: float, default_s: float = 1.0, hi: float = 600.0
) -> int:
    """Retry-After (whole seconds) for a shed or deadline-expired
    request, sized by the OBSERVED epoch restart time — clients back off
    for as long as a rollback actually takes here, not a made-up
    constant."""
    est = observed_restart_s if observed_restart_s > 0 else default_s
    est = min(hi, max(1.0, est))
    n = int(est)
    return n if n >= est else n + 1


def breaker_decide(
    state: str,
    consecutive_failures: int,
    threshold: int,
    since_open_s: float,
    cooldown_s: float,
) -> str:
    """Circuit breaker on the device-dispatch path: ``"closed"`` |
    ``"open"`` | ``"half_open"``. Consecutive dispatch failures or
    request-deadline breaches reaching ``threshold`` open it (requests
    then brown out or shed instead of queueing into a failing device
    path); after ``cooldown_s`` it half-opens to probe with one window —
    success closes it, failure re-opens. ``threshold <= 0`` disables
    the breaker entirely."""
    if threshold <= 0:
        return "closed"
    if state == "closed":
        return "open" if consecutive_failures >= threshold else "closed"
    if since_open_s >= cooldown_s:
        return "half_open"
    return "open"


# -- transactional egress (io/txn.py) -----------------------------
# Two-phase-commit sinks: each rank STAGES output during a wave,
# PRE-COMMITS the staged set at the snapshot cut (tagging it with the
# cut's tag), and FINALIZES — makes it externally visible — only once
# the ``snapshot_commit`` marker has landed at-or-past that tag. On
# restore, recovery scans pending staged units and takes the
# :func:`sink_recover` verdict per unit: finalize everything the
# committed cut covers, discard the rest. The runtime sinks
# (io/txn.py, io/deltalake.py) and the sink model checker
# (``analysis/meshcheck.py --mesh --sink``) drive the SAME functions,
# so "committed egress is bit-identical no matter where a rank died"
# is checked against the code that actually runs.


def sink_may_finalize(unit_tag: int, marker_tag: int | None) -> bool:
    """Whether a staged egress unit pre-committed under ``unit_tag`` may
    become externally visible: ONLY once the ``snapshot_commit`` marker
    has durably landed at-or-past its tag. Finalizing earlier is the
    classic 2PC bug — a crash before the marker moves rolls the engine
    back and re-emits the unit's rows, which then finalize AGAIN
    (duplicated output; the ``finalize_before_marker`` mutant breaks
    exactly this predicate and the sink model checker must catch it)."""
    return marker_tag is not None and unit_tag <= marker_tag


def sink_recover(unit_tag: int, marker_tag: int | None) -> str:
    """Recovery verdict for a pending staged unit found after a crash
    (or a rescale): ``"finalize"`` when the committed cut covers it —
    the crash happened after the marker moved but before the owning
    rank finished its local finalize — else ``"discard"``: the cut does
    not claim the unit, the restored engine will re-emit its rows, and
    keeping it would duplicate them. Total over both inputs, so every
    pending unit gets exactly one of the two verdicts (no unit is ever
    left pending forever)."""
    return "finalize" if sink_may_finalize(unit_tag, marker_tag) else "discard"


# -- device fault domain (persistence/index_snapshot.py,
# internals/device.py) --------------------------------------------
# The device plane's recovery decisions: when an epoch-aligned index cut
# writes a delta segment vs folds vs skips, whether a restore may trust
# a committed segment chain, and how a supervised dispatch reacts to a
# classified failure. Pure and identity-pinned (tests/test_device_faults)
# so the fault grid's --device cells and the live indexes run the SAME
# policy — no second copy to drift.


def index_cut_decide(dirty: int, segments: int, max_segments: int) -> str:
    """One index snapshot cut: ``"skip"`` | ``"delta"`` | ``"fold"``.

    ``dirty`` counts keys touched (upserted or removed) since the last
    cut; ``segments`` is the committed chain length. A quiet epoch
    (``dirty == 0``) writes NO segment — the manifest re-lists the
    existing chain, O(1) metadata (the per-cut-bytes-scale-with-delta
    acceptance bar; the ``always_write_base`` mutant — emitting a full
    segment every cut — breaks exactly this). A chain that would exceed
    ``max_segments`` folds into one base segment (``TxnDeltaSink``
    compaction); ``max_segments <= 0`` disables folding."""
    if dirty == 0:
        return "skip"
    if max_segments > 0 and segments + 1 > max_segments:
        return "fold"
    return "delta"


def index_restore_verdict(has_manifest: bool, missing_segments: int) -> str:
    """Restore-vs-rebuild verdict for an index state found in a
    committed cut: ``"restore"`` (fold the segment chain back into HBM
    — the ≥10x-faster-than-re-embed path), ``"rebuild"`` (no manifest:
    inline/legacy state, load it directly), or ``"refuse"`` (the marker
    names a manifest whose segments are missing — a broken chain; a
    silent rebuild here would serve an index with holes, violating the
    zero-lost-entries bar the --device grid pins)."""
    if not has_manifest:
        return "rebuild"
    if missing_segments > 0:
        return "refuse"
    return "restore"


def device_dispatch_decide(
    kind: str, attempt: int, max_retries: int
) -> tuple[str, ...]:
    """Supervised-dispatch reaction to a classified failure
    (``internals/device.py classify_device_error`` feeds ``kind``):

    * ``("retry", next_attempt)`` — transient XLA/runtime errors retry
      with bounded backoff while budget remains (the connector
      ``SupervisorPolicy`` semantics applied to device sites);
    * ``("brownout",)`` — HBM OOM: growth refuses, the serving breaker
      opens and answers ``Degraded: true`` from the last committed
      index instead of 500s;
    * ``("abort",)`` — permanent (or budget-exhausted): the failure
      routes to the epoch-abort path so the supervisor rolls the rank
      back. Total over every (kind, attempt) — no dispatch failure is
      ever left undecided."""
    if kind == "oom":
        return ("brownout",)
    if kind == "transient" and attempt < max_retries:
        return ("retry", attempt + 1)
    return ("abort",)


# -- autoscaler policy (parallel/autoscale.py) --------------------

def autoscale_decide(
    world: int,
    min_world: int,
    max_world: int,
    pressure: float,
    grow_pressure: float,
    efficiency: float | None,
    shrink_efficiency: float,
    grow_streak: int,
    shrink_streak: int,
    hysteresis: int,
    cooldown_remaining_s: float,
    budget_remaining: int,
) -> tuple[str, int]:
    """One autoscaler policy step: ``("grow"|"shrink"|"hold", target)``.

    ``pressure`` is the serving plane's demand signal (parked requests +
    shed/Retry-After deltas + backlog since the last tick); ``efficiency``
    the observatory's ``scaling_efficiency`` gauge (None before a
    baseline exists). Semantics:

    * pressure at/above ``grow_pressure`` for ``hysteresis`` consecutive
      ticks → grow (double, capped at ``max_world``) — capacity follows
      load;
    * zero pressure AND efficiency below ``shrink_efficiency`` for
      ``hysteresis`` consecutive ticks → shrink (halve, floored at
      ``min_world``) — running wide when narrow suffices burns the pod;
    * otherwise hold. A rescale in flight is guarded by the caller's
      cooldown (``cooldown_remaining_s > 0`` holds — hysteresis streaks
      must re-accumulate against the NEW world) and by the rescale
      budget (``budget_remaining <= 0`` holds forever).

    Pure and total: the autoscaler loop owns the streak/cooldown
    bookkeeping, this function owns every verdict — which is what lets
    tests pin the policy without a live mesh."""
    if cooldown_remaining_s > 0 or budget_remaining <= 0:
        return ("hold", world)
    if (
        pressure >= grow_pressure
        and grow_streak >= hysteresis
        and world < max_world
    ):
        return ("grow", rescale_plan(world, world * 2, min_world, max_world))
    if (
        pressure <= 0
        and efficiency is not None
        and efficiency < shrink_efficiency
        and shrink_streak >= hysteresis
        and world > min_world
    ):
        return (
            "shrink", rescale_plan(world, world // 2, min_world, max_world)
        )
    return ("hold", world)


# -- memory governance / backpressure (internals/memory.py,
# engine/runtime.py _service_connector_health) --------------------
# The host-plane degradation ladder and the source-pacing decisions it
# drives. The memory accountant samples per-component bytes, steps the
# ladder with ``mem_ladder``, and the runtime's connector-health pass
# engages/releases connector pause gates with ``pace_decide`` /
# ``pace_resume``. The pacing model checker
# (``analysis/meshcheck.py check_pacing``) explores the SAME functions,
# which is what makes "a paced source never blocks the wave that would
# unpause it" a checked property instead of a comment.
#
# The deadlock-freedom invariant lives in the SIGNATURES: pause and
# resume depend only on the ladder state (driven by total accounted
# bytes, which the engine drains regardless of paused subject threads)
# and on the engine-visible backlog — never on anything only the paused
# subject thread itself could advance (e.g. reaching its next commit()
# boundary). A resume condition gated on the subject's own progress is
# exactly the pause/drain deadlock the checker exists to rule out.

MEM_LADDER: tuple[str, ...] = ("ok", "pacing", "brownout", "abort")


def mem_ladder(
    total_bytes: int,
    low_bytes: int,
    high_bytes: int,
    budget_bytes: int,
    prev: str = "ok",
    over_streak: int = 0,
    abort_streak: int = 4,
) -> str:
    """One degradation-ladder step: ``"ok"`` | ``"pacing"`` |
    ``"brownout"`` | ``"abort"``.

    ``total_bytes`` is the accountant's summed component bytes;
    ``low_bytes < high_bytes <= budget_bytes`` are the resolved
    watermarks (``PATHWAY_MEM_BUDGET_MB`` scaled by ``PATHWAY_MEM_LOW``
    / ``PATHWAY_MEM_HIGH``).
    Semantics:

    * ``budget_bytes <= 0`` — governance disabled, always ``"ok"``
      (the legacy, un-governed behavior is preserved bit-for-bit);
    * at/above the budget for ``abort_streak`` consecutive samples →
      ``"abort"`` (epoch abort is the LAST resort: pacing + brownout
      had their chance to shed load first); a shorter excursion above
      the budget browns out serving immediately;
    * at/above ``high_bytes`` → ``"pacing"`` (or stays ``"brownout"``
      if already there — recovery walks DOWN the ladder one rung at a
      time, never teleports);
    * between the watermarks → hysteresis: a climbing system
      (``prev == "ok"``) stays ``"ok"``, a draining one stays at its
      rung until it crosses ``low_bytes`` — flapping pause/resume on a
      noisy signal is worse than either steady state;
    * ``"abort"`` is sticky: once the ladder decides the epoch must
      roll back, only the post-restore reset (a fresh accountant)
      clears it.

    Total over every input — no sample is ever left undecided."""
    if budget_bytes <= 0:
        return "ok"
    if prev == "abort":
        return "abort"
    if total_bytes >= budget_bytes:
        return "abort" if over_streak + 1 >= abort_streak else "brownout"
    if total_bytes >= high_bytes:
        return "brownout" if prev == "brownout" else "pacing"
    if total_bytes > low_bytes:
        return "ok" if prev == "ok" else prev
    return "ok"


def pace_decide(ladder_state: str, backlog_rows: int = 0,
                pause_rows: int = 0) -> bool:
    """Whether a pausable connector subject should STOP reading: True
    once the ladder leaves ``"ok"`` or (when a row-count pacing bound is
    set) the subject's queued-but-undrained backlog — rows put on the
    engine queue, not yet accepted by the main loop — reaches
    ``pause_rows``. Pausing stops the reader at its next ``emit`` —
    journal guarantees are untouched, which is the whole point: the
    alternative (the ``_BACKLOG_CAP`` overflow path) silently weakens
    delivery to at-least-once. Both inputs are engine-drainable: the
    ladder drains as the accounted queues/stores drain, the queued
    backlog drains as the main loop accepts entries — neither needs the
    paused thread itself to advance (the journal ledger, which only a
    subject commit can drain, is deliberately NOT an input here)."""
    return ladder_state != "ok" or (
        pause_rows > 0 and backlog_rows >= pause_rows
    )


def pace_resume(ladder_state: str, backlog_rows: int = 0,
                resume_rows: int = 0) -> bool:
    """Whether a paced subject may START reading again: only once the
    ladder is back to ``"ok"`` AND (when row pacing is configured) the
    backlog has drained to ``resume_rows`` — the release side of
    ``pace_decide``'s hysteresis. The ``never_resume`` mutant pins the
    liveness half: a pacing policy that can engage but not release
    deadlocks the paced source, and ``check_pacing`` must surface that
    as a minimal replayable trace, not a hung test."""
    return ladder_state == "ok" and (
        resume_rows <= 0 or backlog_rows <= resume_rows
    )


def pace_retry_after(
    backlog: int,
    drain_rate: float,
    default_s: float = 1.0,
    hi: float = 600.0,
) -> float:
    """Retry-After for 503s minted while the ladder is in
    ``pacing``/``brownout``: the honest answer is "come back once the
    backlog you are queueing behind has drained", i.e.
    ``backlog / drain_rate`` with the observed EWMA drain rate — not
    the instantaneous qps guess ``serve_retry_after`` uses for plain
    overload. A dead drain (``drain_rate <= 0``) answers ``hi``:
    claiming quick recovery while nothing drains is the dishonesty this
    helper exists to remove. Clamped to ``[default_s, hi]``."""
    if backlog <= 0:
        return default_s
    if drain_rate <= 0.0:
        return hi
    return max(default_s, min(hi, backlog / drain_rate))


# -- the transition table ---------------------------------------------------
# Single source of truth for the anti-drift pins: the engine modules
# bind their protocol decisions FROM this table at import, and
# tests/test_meshcheck.py asserts same-object identity between what the
# runtime drives and what the checker explores.
TRANSITIONS: dict[str, object] = {
    "wave_bits": wave_bits,
    "quiesce_candidates": quiesce_candidates,
    "wave_partition": wave_partition,
    "wave_send_targets": wave_send_targets,
    "wave_recv_sources": wave_recv_sources,
    "tree_fanout": tree_fanout,
    "tree_relay": tree_relay,
    "lockstep_plan": lockstep_plan,
    "commit_time": commit_time,
    "commit_plan": commit_plan,
    "hello_accept": hello_accept,
    "peer_liveness": peer_liveness,
    "classify_peer_loss": classify_peer_loss,
    "supervisor_decide": supervisor_decide,
    "shard_owner": shard_owner,
    "reshard_keep": reshard_keep,
    "rescale_plan": rescale_plan,
    "sink_may_finalize": sink_may_finalize,
    "sink_recover": sink_recover,
    "autoscale_decide": autoscale_decide,
    "serve_frontend_state": serve_frontend_state,
    "serve_admit": serve_admit,
    "serve_park": serve_park,
    "serve_replay_split": serve_replay_split,
    "serve_retry_after": serve_retry_after,
    "breaker_decide": breaker_decide,
    "index_cut_decide": index_cut_decide,
    "index_restore_verdict": index_restore_verdict,
    "device_dispatch_decide": device_dispatch_decide,
    "mem_ladder": mem_ladder,
    "pace_decide": pace_decide,
    "pace_resume": pace_resume,
    "pace_retry_after": pace_retry_after,
}
