"""Epoch-aligned incremental index snapshots (device fault
domain).

The mesh plane commits consistent cuts through a two-phase marker
(``persistence/__init__.py write_marker``); device-resident index state
(``ops/knn.KnnShard``, ``parallel/sharded_knn.ShardedKnnIndex``) rides
the SAME cut as *delta segments*: at each snapshot the index transfers
only the HBM rows touched since the last cut (device->host gather of the
dirty slots), writes them as one durable segment object, and returns a
tiny *manifest* (the segment chain) as its node state. The manifest is
what the runtime pickles into ``operator_snapshot/r{rank}/{tag}`` — it
becomes visible exactly when the marker moves, so a crash between
segment write and marker leaves only an orphan object the next cut at
the same tag atomically overwrites. Restore folds the committed chain
back into HBM instead of re-embedding the corpus (the ≥10x bar the
device chaos smoke pins), and an N→M re-shard re-buckets folded entries
through the same ``shard_hash``/``shard_owner`` mint the exchange plane
uses.

Cut/restore decisions are pure transitions in ``parallel/protocol.py``
(``index_cut_decide``, ``index_restore_verdict``) — identity-pinned by
tests so no second copy of the policy exists to drift:

* quiet epoch (nothing dirty) -> ``skip``: the manifest re-lists the
  existing chain, O(1) metadata, no device traffic (pinned by the
  quiet-epoch test);
* chain longer than ``PATHWAY_INDEX_SNAPSHOT_SEGMENTS`` -> ``fold``:
  one full base segment replaces the chain (the ``TxnDeltaSink``
  folded-manifest compaction pattern), superseded segments retire and
  are pruned with two-cut retention (the prune-race rule);
* otherwise -> ``delta``.

Segment objects live under ``index_segment/{name}/r{rank}/{tag}`` —
outside the runtime's ``operator_snapshot/`` prefix, so its tag pruning
never touches them; pruning the chain is this module's job.

The runtime arms a cut context (:func:`cut`) around every node
``state_dict``/``load_state`` pass; indexes opt in by calling
:func:`snapshot_index`/:func:`restore_index`. With no context armed (or
``PATHWAY_DEVICE_SNAPSHOT=0``) the index falls back to an inline full
state — the behavior before delta segments, still correct, just O(corpus).
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.internals import faults as _faults
from pathway_tpu_torch.parallel import protocol as _proto

# how many delta segments may chain before a cut folds them into one
# base segment (PATHWAY_INDEX_SNAPSHOT_SEGMENTS; <=0 disables folding)
_DEFAULT_MAX_SEGMENTS = 8

_SEGMENT_PREFIX = "index_segment"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _segments_enabled() -> bool:
    raw = str(os.environ.get("PATHWAY_DEVICE_SNAPSHOT", "1")).strip().lower()
    return raw not in ("0", "false", "no")


# -- cut context -------------------------------------------------------------

@dataclass
class CutContext:
    """One snapshot/restore pass: where segments go and under which tag.
    Armed by the runtime around node state_dict/load_state (every save
    and restore path shares this), read by the indexes — the Node API
    itself stays unchanged."""

    persistence: Any
    tag: int
    rank: int = 0
    world: int = 1
    stats: Any = None  # ProberStats for the index_* counters, or None


_LOCAL = threading.local()


def current() -> CutContext | None:
    return getattr(_LOCAL, "ctx", None)


class cut:
    """Context manager arming a :class:`CutContext` for the current
    thread. Re-entrant arming replaces (save paths never nest)."""

    def __init__(self, persistence, tag: int, rank: int = 0,
                 world: int = 1, stats: Any = None):
        self._ctx = CutContext(persistence, int(tag), int(rank),
                               int(world), stats)

    def __enter__(self) -> CutContext:
        self._prev = getattr(_LOCAL, "ctx", None)
        _LOCAL.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc) -> None:
        _LOCAL.ctx = self._prev


# -- index-name mint ---------------------------------------------------------

_NAME_LOCK = threading.Lock()
_NAME_COUNTS: dict[str, int] = {}


def next_index_name(prefix: str = "knn") -> str:
    """Deterministic per-process mint: graph construction order is
    deterministic for a given program, so a restarted run's indexes get
    the same names (their segment keys must line up across restarts)."""
    with _NAME_LOCK:
        n = _NAME_COUNTS.get(prefix, 0)
        _NAME_COUNTS[prefix] = n + 1
    return f"{prefix}{n}"


def reset_name_mint() -> None:
    """Test/driver hook: a fresh GraphRunner run re-mints from zero."""
    with _NAME_LOCK:
        _NAME_COUNTS.clear()


# -- segment store -----------------------------------------------------------

def segment_key(name: str, rank: int, tag: int) -> str:
    return f"{_SEGMENT_PREFIX}/{name}/r{rank}/{tag}"


def _write_segment(ctx: CutContext, name: str, payload: dict) -> tuple[str, int]:
    key = segment_key(name, ctx.rank, ctx.tag)
    data = pickle.dumps(payload)
    with ctx.persistence.lock:
        ctx.persistence.backend.write(key, data)
    return key, len(data)


def _read_segment(persistence, key: str) -> dict | None:
    raw = persistence.backend.read(key)
    return pickle.loads(raw) if raw else None


# -- snapshot ---------------------------------------------------------------

def _gather_rows(index, keys: list) -> np.ndarray:
    """Device->host transfer of ONLY the named keys' HBM rows (the
    whole point of delta segments: per-cut traffic scales with the
    epoch's dirty set, not corpus size)."""
    if not keys:
        return np.zeros((0, index.dimension), np.float32)
    import torch

    slots = torch.as_tensor(
        [index.key_to_slot[k] for k in keys], dtype=torch.int64,
        device=index.vectors.device,
    )
    return index.vectors[slots].to("cpu", torch.float32).numpy()


def _entries_payload(index, keys: list, extra) -> dict:
    return {
        "keys": list(keys),
        "seqs": np.asarray([index.key_seq[k] for k in keys], np.int64),
        "vectors": _gather_rows(index, keys),
        "extra": (
            {k: extra[k] for k in keys if k in extra}
            if extra is not None else None
        ),
    }


def snapshot_index(index, *, extra=None) -> dict:
    """Emit the index's node state for the current cut.

    ``extra`` is an optional key->payload mapping that rides the
    segments (the KNN adapter's per-key filter metadata) so no separate
    O(corpus) dict is pickled per cut. Caller must NOT hold
    ``index.lock`` — taken here.
    """
    with index.lock:
        _faults.fault_point("device.snapshot", phase="cut")
        ctx = current()
        if ctx is None or not _segments_enabled():
            # no persistence cut armed (direct state_dict calls, tests,
            # in-memory snapshots): inline full state, the shape before delta segments
            live = sorted(index.key_to_slot, key=lambda k: index.key_seq[k])
            state = _entries_payload(index, live, extra)
            state["__index_inline__"] = True
            state["next_seq"] = index._next_seq
            state["metric"] = index.metric.value
            state["dimension"] = index.dimension
            return state

        dirty_live = [k for k in index._dirty if k in index.key_to_slot]
        removed = list(index._dirty_removed)
        max_segments = _env_int(
            "PATHWAY_INDEX_SNAPSHOT_SEGMENTS", _DEFAULT_MAX_SEGMENTS
        )
        verdict = _proto.index_cut_decide(
            len(dirty_live) + len(removed), len(index._segments), max_segments
        )
        if verdict != "skip":
            if verdict == "fold":
                # compact: one base segment holding the full live corpus
                # replaces the chain; the replaced keys retire and are
                # pruned two cuts later (a crashed peer restoring the
                # PREVIOUS marker must still find its chain)
                keys = sorted(
                    index.key_to_slot, key=lambda k: index.key_seq[k]
                )
                payload = _entries_payload(index, keys, extra)
                payload["removes"] = []
                retired = [s["key"] for s in index._segments]
                index._segments = []
            else:
                dirty_live.sort(key=lambda k: index.key_seq[k])
                payload = _entries_payload(index, dirty_live, extra)
                payload["removes"] = removed
                retired = []
            key, nbytes = _write_segment(ctx, index.snapshot_name, payload)
            _faults.fault_point("device.snapshot", phase="post_segment")
            index._segments = index._segments + [{
                "key": key,
                "tag": ctx.tag,
                "rows": len(payload["keys"]),
                "removes": len(payload["removes"]),
                "bytes": nbytes,
            }]
            if retired:
                index._retired.append(retired)
            index._dirty.clear()
            index._dirty_removed.clear()
            if ctx.stats is not None:
                ctx.stats.on_index_snapshot_bytes(nbytes)
        # two-cut retention before deleting retired segments: the
        # previous marker may still name a manifest referencing them
        while len(index._retired) > 2:
            for key in index._retired.pop(0):
                ctx.persistence.delete_key(key)
        return {
            "__index_segments__": True,
            "name": index.snapshot_name,
            "dimension": index.dimension,
            "metric": index.metric.value,
            "count": len(index.key_to_slot),
            "next_seq": index._next_seq,
            "segments": list(index._segments),
            "retired": [list(r) for r in index._retired],
        }


# -- restore ----------------------------------------------------------------

def _fold_segments(persistence, manifest: dict) -> tuple[dict, int]:
    """Replay the committed chain into key -> (seq, row, extra_payload).
    Raises on a broken chain — the ``index_restore_verdict`` transition
    says ``refuse``: silently serving an index with holes would violate
    the zero-lost-entries bar the chaos grid pins."""
    segments = manifest.get("segments", ())
    missing = 0
    payloads = []
    for seg in segments:
        payload = _read_segment(persistence, seg["key"])
        if payload is None:
            missing += 1
        payloads.append(payload)
    verdict = _proto.index_restore_verdict(True, missing)
    if verdict == "refuse":
        raise RuntimeError(
            f"index restore: manifest {manifest.get('name')!r} names "
            f"{len(segments)} segment(s) but {missing} are missing from "
            "the persistence store — refusing to serve a partial index"
        )
    acc: dict[Any, tuple] = {}
    for payload in payloads:
        for k in payload.get("removes", ()):
            acc.pop(k, None)
        vecs = payload["vectors"]
        extra = payload.get("extra") or {}
        for i, k in enumerate(payload["keys"]):
            acc[k] = (int(payload["seqs"][i]), vecs[i], extra.get(k))
    return acc, int(manifest.get("next_seq", 0))


def _resolve_state(state: dict, persistence) -> tuple[dict, int, list, bool]:
    """Any accepted state shape -> (entries, next_seq, segment_chain,
    rebased). ``rebased`` means the restored corpus is NOT backed by a
    chain this rank can extend (inline or resharded state): the index
    must mark everything dirty so its next cut writes a fresh base."""
    if state.get("__index_reshard__"):
        keep = state["keep"]
        merged: dict[Any, tuple] = {}
        next_seq = 0
        for part in state["parts"]:
            entries, ns, _, _ = _resolve_state(part, persistence)
            next_seq = max(next_seq, ns)
            for k, v in entries.items():
                if keep is None or keep(k):
                    merged[k] = v
        return merged, next_seq, [], True
    if state.get("__index_segments__"):
        if persistence is None and state.get("segments"):
            raise RuntimeError(
                "index restore: state is a segment manifest but no "
                "persistence cut is armed — cannot read the chain"
            )
        entries, next_seq = _fold_segments(persistence, state)
        return entries, next_seq, list(state.get("segments", ())), False
    # inline full state (__index_inline__ or the legacy adapter shape)
    entries = {}
    vecs = state["vectors"]
    extra = state.get("extra") or {}
    seqs = state.get("seqs")
    for i, k in enumerate(state["keys"]):
        seq = int(seqs[i]) if seqs is not None else i
        entries[k] = (seq, np.asarray(vecs[i], np.float32), extra.get(k))
    return entries, int(state.get("next_seq", len(entries))), [], True


def restore_index(index, state: dict) -> dict:
    """Rebuild the index's HBM shards from a committed state; returns
    the folded per-key extra payloads (the adapter's metadata). Restored
    rows are re-written with ``normalize=False`` — segments carry the
    rows exactly as stored, so scores (and the ``key_seq`` tie-break)
    come back bit-identical to the uninterrupted run."""
    ctx = current()
    _faults.fault_point("device.restore", phase="restore")
    t0 = time.perf_counter()
    entries, next_seq, chain, rebased = _resolve_state(
        state, ctx.persistence if ctx is not None else None
    )
    dim = state.get("dimension")
    if dim is not None and int(dim) != index.dimension:
        raise RuntimeError(
            f"index restore: snapshot dimension {dim} != index "
            f"dimension {index.dimension}"
        )
    ordered = sorted(entries.items(), key=lambda kv: kv[1][0])
    with index.lock:
        index._load_entries(
            [(k, seq, row) for k, (seq, row, _x) in ordered]
        )
        index._next_seq = max(next_seq, index._next_seq)
        index._segments = chain
        index._retired = []
        if rebased:
            # not backed by an extendable chain: next cut writes a base
            index._dirty = dict.fromkeys(index.key_to_slot)
        else:
            index._dirty.clear()
        index._dirty_removed.clear()
    if ctx is not None and ctx.stats is not None:
        ctx.stats.on_index_restore_seconds(time.perf_counter() - t0)
    return {k: x for k, (_s, _r, x) in ordered if x is not None}
