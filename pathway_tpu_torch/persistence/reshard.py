"""Restore-side re-shard reader (elastic mesh).

A committed operator snapshot is a per-rank cut: rank *r* of an N-rank
mesh persists ``operator_snapshot/r{r}/{tag}`` holding exactly the
state entries whose keys the stable shard mint
(``parallel/procgroup.shard_hash`` → ``protocol.shard_owner``) assigns
to *r* at world N. Because the 64-bit blake2b digest is
world-INDEPENDENT, restoring that cut into a *different* world size M
is a pure re-bucketing: take the union of all N ranks' entries, keep on
new rank *m* exactly those with ``shard_owner(digest, M) == m``. The
kept sets form a partition of the union — no entry is lost, none is
duplicated — which is the exactly-once-across-rescale property
``python -m pathway_tpu_torch.analysis --mesh --rescale`` model-checks (the
``drop_reshard_shard`` mutant breaks precisely the keep filter here)
and ``tests/test_rescale.py`` pins as a round-trip property for
N, M ∈ {1..4} in both directions.

Node-state semantics (``engine/nodes.py`` declares the policy per node
class via ``Node.RESHARD`` / ``Node.RESHARD_ATTRS``):

* ``"keyed"`` — state containers are keyed by the node's upstream
  exchange shard key (frozen grouping values, join keys, or row
  Pointers for id-routed exchanges): union + keep-filter. This is every
  stateful node fed through a hash exchange — the keys the containers
  are addressed by ARE the values ``stable_shard`` routed on.
* ``"union"`` — plain first-wins union, no filter: rank-local source
  state (pk-upsert memos, scan dedup) whose entries are inert on ranks
  that will not re-read their keys, and replicated static state.
* ``"replicate"`` — identical on every old rank (broadcast-fed sides):
  adopt old rank 0's copy verbatim.

Connector scan states: a source that reads on rank 0 only carries one
state — it passes through. A partition-aware source
(``_distributed_partitioned``) owns a key/path shard per rank and must
implement ``reshard_scan_state(states: list) -> state`` to merge the
old ranks' states for the new world (``io/fs.py`` ships one for the
path-sharded scanner); without the hook the rescale is REFUSED with an
error naming the connector — silently re-reading or dropping a shard's
scan position would break exactly-once.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

from pathway_tpu_torch.engine.stream import MultisetState, TableState
from pathway_tpu_torch.parallel import protocol as _proto
from pathway_tpu_torch.parallel.procgroup import shard_hash


def keep_fn(rank: int, world: int) -> Callable[[Any], bool]:
    """The new-world keep filter over raw OR frozen key values: freezing
    is idempotent under the mint's canonical byte serialization, so
    ``keep(frozen_gvals) == keep(gvals)`` — one filter serves python
    stores (frozen keys) and native dumps (raw keys) alike. Drives the
    shared ``protocol.reshard_keep`` transition — the same function the
    rescale model checker explores."""
    return lambda value: _proto.reshard_keep(shard_hash(value), rank, world)


# -- generic container merge / filter ---------------------------------------

def merge_values(values: list):
    """First-wins union of one state attribute across the old ranks.
    Keyed containers of rank-partitioned state are key-disjoint by
    construction (each key lived on exactly one old rank) and
    replicated state is identical on every rank, so first-wins is
    either a true union or a no-op."""
    values = [v for v in values if v is not None]
    if not values:
        return None
    first = values[0]
    if isinstance(first, MultisetState):
        out = MultisetState()
        for v in values:
            for k, d in v.data.items():
                if k not in out.data:
                    out.data[k] = d
        return out
    if isinstance(first, TableState):
        out = TableState()
        for v in reversed(values):
            out.rows.update(v.rows)
        out.rows.update(first.rows)
        return out
    if isinstance(first, dict):
        out = {}
        for v in reversed(values):
            out.update(v)
        out.update(first)
        return out
    if isinstance(first, (set, frozenset)):
        out = set()
        for v in values:
            out |= v
        return out
    if isinstance(first, list):
        seen = set()
        out = []
        for v in values:
            for item in v:
                try:
                    marker = item if isinstance(item, (str, int, tuple)) \
                        else repr(item)
                except Exception:
                    marker = id(item)
                if marker not in seen:
                    seen.add(marker)
                    out.append(item)
        return out
    return first  # scalars: replicated or rank-equal


def filter_value(value, keep: Callable[[Any], bool]):
    """Keep-filter a keyed container by its keys; non-container values
    pass through (the merge already picked one copy)."""
    if isinstance(value, MultisetState):
        out = MultisetState()
        for k, d in value.data.items():
            if keep(k):
                out.data[k] = d
        return out
    if isinstance(value, TableState):
        out = TableState()
        out.rows = {k: r for k, r in value.rows.items() if keep(k)}
        return out
    if isinstance(value, dict):
        return {k: v for k, v in value.items() if keep(k)}
    if isinstance(value, (set, frozenset)):
        return type(value)(k for k in value if keep(k))
    return value


def reshard_node_state(
    node, states: list, rank: int, world: int
) -> dict | None:
    """One node's re-sharded state from the old ranks' state dicts.
    Dispatch order: a node-level ``reshard_state`` override (native
    store dumps need entry-level key access), then the class policy."""
    states = [s for s in states if s]
    if not states:
        return None
    keep = keep_fn(rank, world)
    override = getattr(node, "reshard_state", None)
    if override is not None:
        return override(states, keep)
    policy = getattr(node, "RESHARD", "keyed")
    per_attr = getattr(node, "RESHARD_ATTRS", None) or {}
    if policy == "refuse":
        if any(_state_nonempty(v) for s in states for v in s.values()):
            raise RuntimeError(
                f"rescale: node {type(node).__name__} holds rank-local "
                "state (release heaps / watermark stashes) whose "
                "placement cannot be re-derived from a key — this plan "
                "cannot rescale while that state is non-empty"
            )
        return None
    attrs = set()
    for s in states:
        attrs.update(s)
    if "__native__" in attrs:
        raise RuntimeError(
            f"rescale: node {type(node).__name__} persisted a native "
            "store dump but declares no reshard_state override — "
            "cannot re-bucket opaque entries"
        )
    out = {}
    for attr in attrs:
        pol = per_attr.get(attr, policy)
        values = [s.get(attr) for s in states]
        if pol == "replicate":
            merged = next((v for v in values if v is not None), None)
        else:
            merged = merge_values(values)
        if pol == "keyed" and merged is not None:
            merged = filter_value(merged, keep)
        out[attr] = merged
    return out


# -- whole-snapshot reader ---------------------------------------------------

EXCHANGE_NODE_NAME = "ExchangeNode"


def align_fingerprints(old_fp: list, new_fp: list) -> list:
    """new-node-index -> old-node-index (or None) across a world-size
    change. Exchange boundaries exist only in multi-rank lowerings
    (``Scope._exchange`` returns the input table at world 1) and are
    stateless, so a cut crossing the world==1 boundary aligns the
    remaining nodes by order and name; any other shape difference is a
    real program change and refuses."""
    old = [(i, n) for i, n in enumerate(old_fp) if n != EXCHANGE_NODE_NAME]
    new = [(i, n) for i, n in enumerate(new_fp) if n != EXCHANGE_NODE_NAME]
    if [n for _, n in old] != [n for _, n in new]:
        raise RuntimeError(
            "operator snapshot does not match this pipeline's graph "
            "shape across the rescale — the program changed since the "
            "cut was taken"
        )
    mapping: list = [None] * len(new_fp)
    for (oi, _), (ni, _) in zip(old, new):
        mapping[ni] = oi
    return mapping

def load_world_snapshots(
    persistence, tag: int, old_world: int, key_prefix: str = "operator_snapshot"
) -> list:
    """Every old rank's ``(node_states, subject_states, fingerprint)``
    at the committed tag — all-or-nothing: a missing rank snapshot
    under a marker that names the tag is a broken two-phase cut and
    raises (the caller's gather/bcast turns that into a clean abort)."""
    snaps = []
    for r in range(old_world):
        snap = persistence.load_operator_snapshot(
            key=f"{key_prefix}/r{r}/{tag}"
        )
        if snap is None:
            raise RuntimeError(
                f"rescale restore: commit marker names tag {tag} at world "
                f"{old_world} but rank {r}'s snapshot is missing — the "
                "two-phase cut is broken"
            )
        snaps.append(snap)
    return snaps


def reshard_subject_states(
    conn_names: Iterable[str],
    snaps: list,
    subjects: dict,
) -> dict:
    """Per-connector scan state for the new rank, from the union of the
    old ranks' subject states. A subject carrying a
    ``reshard_scan_state`` hook ALWAYS re-merges through it — even a
    single old state must be re-filtered for the new world (a 1→N grow
    hands every new rank the full old coverage otherwise, and a
    path-sharded scanner would then retract its peers' files as
    deleted). Without the hook, one claiming rank (non-partitioned
    sources read on rank 0 only) passes through; several claiming ranks
    refuse — refusing beats silently replaying or dropping a shard's
    scan position."""
    out = {}
    for name in conn_names:
        states = [
            snap[1][name] for snap in snaps
            if isinstance(snap[1], dict) and snap[1].get(name) is not None
        ]
        if not states:
            continue
        subject = subjects.get(name)
        hook = getattr(subject, "reshard_scan_state", None)
        if hook is not None:
            out[name] = hook(states)
            continue
        if len(states) == 1:
            out[name] = states[0]
            continue
        raise RuntimeError(
            f"rescale restore: connector {name!r} has scan state on "
            f"{len(states)} old ranks but its subject implements no "
            "reshard_scan_state(states) hook — cannot re-partition "
            "its scan position across a world-size change"
        )
    return out


def partition_roundtrip(keys: Iterable, n: int, m: int) -> bool:
    """Test helper for the pinned property: re-bucketing a committed
    store's keys from N to M shards is a partition (every key in
    exactly one new shard) and N→M→N round-trips bit-identical."""
    srt = lambda ks: sorted(ks, key=repr)  # noqa: E731 - mixed key types
    by_n = {r: srt(k for k in keys if _owner(k, n) == r)
            for r in range(n)}
    union = [k for r in range(n) for k in by_n[r]]
    by_m = {}
    for r in range(m):
        keep = keep_fn(r, m)
        by_m[r] = srt(k for k in union if keep(k))
    flat = [k for r in range(m) for k in by_m[r]]
    if srt(flat) != srt(union):
        return False  # lost or duplicated under N→M
    back = {}
    union_m = [k for r in range(m) for k in by_m[r]]
    for r in range(n):
        keep = keep_fn(r, n)
        back[r] = srt(k for k in union_m if keep(k))
    return back == by_n


def _owner(value, world: int) -> int:
    return _proto.shard_owner(shard_hash(value), world)


def _state_nonempty(value) -> bool:
    """Does a persisted state value hold anything a re-shard could
    misplace? Scalars (watermarks) merge harmlessly; containers count."""
    if value is None:
        return False
    if isinstance(value, (MultisetState,)):
        return bool(value.data)
    if isinstance(value, TableState):
        return bool(value.rows)
    if isinstance(value, (dict, set, frozenset, list, tuple)):
        return len(value) > 0
    return False
