"""Incremental dataflow operator nodes.

Re-derivation of the reference engine's operator suite (reference:
src/engine/dataflow.rs — differential-dataflow collections; src/engine/
dataflow/operators/*.rs) on a batch-at-a-timestamp execution model:

* every node consumes consolidated delta batches ``(key, row, diff)`` per
  logical timestamp, in timestamp order;
* stateful nodes use the *affected-group rediff* strategy: for every group
  touched by a batch we compute the group's output before and after applying
  the updates and emit the difference — this yields exact incremental
  (retraction-correct) semantics for joins, reductions, updates, sorts
  without hand-deriving per-operator delta rules;
* dense hot paths (expressions over numeric columns, KNN scoring) escape to
  numpy/JAX at the batch level.
"""

from __future__ import annotations

import itertools
import time as _time
from collections import defaultdict
from typing import Any, Callable, Iterable

import numpy as _np

from pathway_tpu_torch.internals.api import ERROR, Pointer, ref_scalar
from pathway_tpu_torch.analysis import eligibility as _elig
from pathway_tpu_torch.engine.stream import (
    ConsolidatedList,
    Delta,
    Key,
    MultisetState,
    Row,
    TableState,
    consolidate,
    freeze_row,
    get_fp,
    is_native_batch,
    negate,
)


def _split_deltas(deltas):
    """(keys, rows, diffs) — one C pass when the toolchain is present."""
    fp = get_fp()
    if fp is not None:
        return fp.split_deltas(deltas)
    return (
        [d[0] for d in deltas],
        [d[1] for d in deltas],
        [d[2] for d in deltas],
    )


class Node:
    """Base dataflow node: buffered inputs per timestamp, topo-ordered."""

    # device plane: True on node classes whose process() is
    # expected to issue JAX dispatches (ExternalIndexNode — KNN/top-k/
    # rerank scans, embedder forwards through an index adapter). The
    # flight recorder embeds it into node_meta so --profile joins each
    # such node's roofline verdict (compute/bandwidth/host-bound) onto
    # its span, and the trace-schema pin knows which node spans should
    # have correlated device spans. Dispatches from other nodes (a UDF
    # calling an encoder) still record — correlation comes from the
    # runtime's step context, this flag only drives the verdict join.
    device_node = False

    def __init__(self, scope, inputs: list["Node"]):
        self.scope = scope
        self.inputs = inputs
        self.n_inputs = len(inputs)
        self.node_id = scope.register(self)
        self.downstream: list[tuple[Node, int]] = []
        for port, inp in enumerate(inputs):
            inp.downstream.append((self, port))
        self.pending: dict[int, list[list[Delta]]] = {}
        # user stack frame that declared this operator (error attribution)
        self.trace = getattr(scope.runtime, "current_trace", None)

    # -- scheduling -------------------------------------------------------
    def accept(self, time: int, port: int, deltas: list[Delta]) -> None:
        if not deltas:
            return
        slot = self.pending.get(time)
        if slot is None:
            # per-port list of delivered batches: a single delivery keeps
            # its (possibly ConsolidatedList) identity so downstream
            # consolidate() calls pass through instead of re-hashing
            slot = [[] for _ in range(max(self.n_inputs, 1))]
            self.pending[time] = slot
            self.scope.runtime.mark_pending(time, self)
        slot[port].append(deltas)

    def take(self, time: int) -> list[list[Delta]]:
        slot = self.pending.pop(time, None)
        if slot is None:
            return [[] for _ in range(max(self.n_inputs, 1))]
        out = []
        for batches in slot:
            if not batches:
                out.append([])
            elif len(batches) == 1:
                out.append(batches[0])
            else:
                merged: list[Delta] = []
                for b in batches:
                    merged.extend(b)
                out.append(merged)
        return out

    def process(self, time: int, batches: list[list[Delta]]) -> list[Delta]:
        raise NotImplementedError

    def on_time_end(self, time: int) -> None:
        pass

    def on_input_closed(self) -> None:
        """Called once when all inputs are exhausted, BEFORE on_end: nodes
        holding buffered state (time buffers) flush here so the final
        batches still flow through the graph."""

    def on_end(self) -> None:
        pass

    # -- operator snapshots (reference: persistence/operator_snapshot.rs,
    # Persist trait; engine/dataflow/persist.rs) -------------------------
    STATE_ATTRS: tuple = ()

    # -- elastic-mesh rescale ---------------------------------
    # How this node's committed state re-partitions when the mesh is
    # restored into a DIFFERENT world size (persistence/reshard.py):
    #   "keyed"     — state containers are keyed by the value the
    #                 upstream exchange sharded on (frozen grouping
    #                 values, join keys, or row Pointers for id-routed
    #                 exchanges; rank-local row-keyed state also
    #                 qualifies: any deterministic unique placement is
    #                 correct because emissions re-route downstream):
    #                 union the old ranks' entries, keep those the
    #                 new-world mint assigns to this rank.
    #   "union"     — plain first-wins union, no filter: read-side memo
    #                 state whose entries are inert on ranks that never
    #                 see their keys (memoized rowwise outputs).
    #   "replicate" — identical on every old rank (broadcast-fed
    #                 state): adopt one old copy verbatim.
    #   "refuse"    — state whose placement cannot be re-derived from a
    #                 key (release heaps, watermark stashes): a rescale
    #                 restore fails with an error naming the node
    #                 rather than guessing.
    # RESHARD_ATTRS overrides the class policy per state attribute;
    # nodes owning native store dumps override reshard_state() instead
    # (entry-level key access).
    RESHARD: str = "keyed"
    RESHARD_ATTRS: dict | None = None

    def state_dict(self):
        """Picklable operator state at a commit boundary."""
        return {a: getattr(self, a) for a in self.STATE_ATTRS}

    def load_state(self, state) -> None:
        for a, v in state.items():
            setattr(self, a, v)

    def name(self) -> str:
        return type(self).__name__


class SourceNode(Node):
    """Data injected by the runtime (static tables or connectors)."""

    def __init__(self, scope, append_only: bool = False):
        super().__init__(scope, [])
        self.append_only = append_only

    def process(self, time, batches):
        # columnar batches from the C parser pass through untouched —
        # they are net form by construction and materialize lazily at the
        # first non-native consumer. THE FUSED-CHAIN CONTRACT: a
        # NativeBatch is an insert-only net-form delta batch that any
        # node may consume columnar (group-by via process_batch_nb, join
        # via join_batch_nb on either input port, plain-column selects
        # via nb_project) — and a join is also a valid fused PRODUCER:
        # join_batch_nb re-emits a NativeBatch in the steady streaming
        # state, so parse→join→exprs→groupby→capture runs with no
        # per-row Python objects. Every consumer must degrade gracefully
        # to the materialized (key, row, diff) view.
        if is_native_batch(batches[0]):
            return batches[0]
        return consolidate(batches[0])


class RowwiseNode(Node):
    """Batch map: fn(keys, rows) -> new rows; diff-preserving, stateless.

    The workhorse behind select/with_columns (reference: expression_table,
    dataflow.rs) — expressions are evaluated column-wise over the batch.

    ``nb_proj_idx`` marks a pure column projection (every output
    expression a plain column reference): a columnar NativeBatch input
    then stays columnar through this node (exec.cpp nb_project — keys
    preserved, columns copied), keeping a parse/join chain fused through
    the select hop. Anything else materializes the batch as usual.
    """

    def __init__(
        self,
        scope,
        input_node,
        batch_fn: Callable[[list[Key], list[Row]], list[Row]],
        nb_proj_idx=None,
        nb_blame=(),
        src_exprs=None,
    ):
        super().__init__(scope, [input_node])
        self.batch_fn = batch_fn
        self._nb_proj = tuple(nb_proj_idx) if nb_proj_idx is not None else None
        # construction-time fused verdict + blame (analysis/eligibility.py)
        self.nb_decision = _elig.decide_rowwise_nb(
            nb_proj_idx=nb_proj_idx, blame=nb_blame
        )
        self.src_exprs = src_exprs  # expression provenance (pw.analyze)
        self._nb_batches = 0  # chain-path spy counter (tests)
        self._nb_fallbacks = 0

    def process(self, time, batches):
        if self._nb_proj is not None and is_native_batch(batches[0]):
            from pathway_tpu_torch.native import get_pwexec

            ex = get_pwexec()
            if ex is not None and hasattr(ex, "nb_project"):
                try:
                    out = ex.nb_project(batches[0], self._nb_proj)
                except Exception as exc:
                    if _elig.nb_strict():
                        raise _elig.strict_error(
                            self, "fused projection failed", exc
                        ) from exc
                    # stateless, so the materialized path below recomputes
                    # this batch safely — but a projection that failed once
                    # will fail every batch: disable it for this node and
                    # say so, mirroring the native-build degradation log
                    import logging

                    logging.getLogger(__name__).warning(
                        "nb_project failed; disabling the fused projection "
                        "for this node",
                        exc_info=True,
                    )
                    self._nb_proj = None
                    # demotion is permanent: count ONE fallback for the
                    # node, not one per subsequent batch
                    self._nb_fallbacks += 1
                    self.scope.runtime.stats.on_nb_fallback()
                else:
                    self._nb_batches += 1
                    return out
        deltas = consolidate(batches[0])
        if not deltas:
            return []
        # Deterministic replay for retractions: recompute is fine for pure
        # expressions; non-deterministic UDFs route through AsyncApplyNode.
        keys, rows, diffs = _split_deltas(deltas)
        new_rows = self.batch_fn(keys, rows)
        fp = get_fp()
        out = (
            fp.rezip(deltas, new_rows)
            if fp is not None
            else [(k, nr, d) for (k, _, d), nr in zip(deltas, new_rows)]
        )
        # Pure-insert batches with distinct keys stay net form under any
        # row mapping — marking them skips the downstream (key,row)
        # re-hash (a key-set check is ~5x cheaper than consolidate).
        # Batches carrying retractions CAN collapse: a non-injective
        # expression maps an update's retract/insert pair onto identical
        # rows, which consolidate must cancel.
        if min(diffs, default=1) > 0 and len(set(keys)) == len(keys):
            return ConsolidatedList(out)
        return consolidate(out)


class MemoizedRowwiseNode(Node):
    """Rowwise map that memoizes outputs per (key, input-row) so retractions
    replay identical values even for non-deterministic fns (reference:
    map_named_async_with_consistent_deletions, dataflow.rs:1480)."""


    STATE_ATTRS = ("_memo",)
    # rescale: memo entries are read-only replay state keyed by row key;
    # rows arrive wherever their (re-sharded) source emits them, which
    # is NOT the row-key mint — keep the full union on every rank so a
    # replayed retraction always finds its memoized output (extra
    # entries are inert; the node emits only for arriving rows)
    RESHARD = "union"

    def __init__(self, scope, input_node, batch_fn):
        super().__init__(scope, [input_node])
        self.batch_fn = batch_fn
        self._memo: dict[Key, tuple[tuple, Row]] = {}  # key -> (frozen_in, out)

    def process(self, time, batches):
        deltas = consolidate(batches[0])
        if not deltas:
            return []
        out: list[Delta] = []
        to_compute: list[tuple[Key, Row, int]] = []
        for k, row, d in deltas:
            if d < 0:
                memo = self._memo.get(k)
                if memo is not None and memo[0] == freeze_row(row):
                    out.append((k, memo[1], d))
                    del self._memo[k]
                else:
                    to_compute.append((k, row, d))
            else:
                to_compute.append((k, row, d))
        if to_compute:
            new_rows = self.batch_fn(
                [k for k, _, _ in to_compute], [r for _, r, _ in to_compute]
            )
            for (k, row, d), nr in zip(to_compute, new_rows):
                if d > 0:
                    self._memo[k] = (freeze_row(row), nr)
                out.append((k, nr, d))
        return consolidate(out)


class FilterNode(Node):
    def __init__(self, scope, input_node, mask_fn: Callable[[list[Key], list[Row]], list[bool]]):
        super().__init__(scope, [input_node])
        self.mask_fn = mask_fn

    def process(self, time, batches):
        deltas = consolidate(batches[0])
        if not deltas:
            return []
        keys, rows, _ = _split_deltas(deltas)
        mask = self.mask_fn(keys, rows)
        if isinstance(mask, _np.ndarray):
            mask = mask.tolist()  # numpy bools -> Python bools
        fp = get_fp()
        if fp is not None:
            try:
                # a subset of a net-form batch is still net form
                return ConsolidatedList(fp.filter_deltas(deltas, mask))
            except TypeError:
                pass  # non-bool mask entries: general loop below
        # accept numpy bools from UDF-produced masks; anything non-boolean
        # (None, Error) drops the row, matching engine filter semantics
        return ConsolidatedList(
            d
            for d, m in zip(deltas, mask)
            if isinstance(m, (bool, _np.bool_)) and bool(m)
        )


class ReindexNode(Node):
    """Change row ids via key_fn(key, row) (reference: with_id / reindex)."""

    def __init__(self, scope, input_node, key_fn: Callable[[Key, Row], Key]):
        super().__init__(scope, [input_node])
        self.key_fn = key_fn

    def process(self, time, batches):
        deltas = consolidate(batches[0])
        return consolidate(
            (self.key_fn(k, row), row, d) for k, row, d in deltas
        )


class FlattenNode(Node):
    def __init__(self, scope, input_node, flatten_idx: int):
        super().__init__(scope, [input_node])
        self.flatten_idx = flatten_idx

    def process(self, time, batches):
        deltas = consolidate(batches[0])
        out = []
        for k, row, d in deltas:
            val = row[self.flatten_idx]
            if val is None:
                continue
            # strings flatten into characters, matching the reference
            # (dataflow.rs flatten_table: Value::String -> chars)
            items = list(val)
            for i, item in enumerate(items):
                new_row = row[: self.flatten_idx] + (item,) + row[self.flatten_idx + 1 :]
                out.append((ref_scalar(k, i), new_row, d))
        return consolidate(out)


class ConcatNode(Node):
    """Union of disjoint-id inputs (reference: Graph::concat — universes
    must be disjoint; a colliding id is a hard error, not a silent
    overwrite, and the user is pointed at concat_reindex). Live ids are
    tracked across timestamps so streaming collisions are caught too."""

    STATE_ATTRS = ("live",)

    def __init__(self, scope, input_nodes):
        super().__init__(scope, list(input_nodes))
        self.live: dict = {}  # key -> [frozen_row, count]

    def process(self, time, batches):
        out = consolidate(itertools.chain.from_iterable(batches))
        for k, row, d in out:
            slot = self.live.get(k)
            if d > 0:
                fr = freeze_row(row)
                if slot is None:
                    slot = [fr, 0]
                    self.live[k] = slot
                if slot[0] != fr or slot[1] + d > 1:
                    raise ValueError(
                        "concat received overlapping row ids — input "
                        "universes are not disjoint; use concat_reindex"
                    )
                slot[1] += d
            elif slot is not None:
                slot[1] += d
                if slot[1] <= 0:
                    del self.live[k]
        return out


class ExchangeNode(Node):
    """Shard-routing boundary for multi-process runs (reference: timely
    exchange pacts at groupby/join boundaries, dataflow.rs — shuffles
    are a streamed byte-level concern, not an interpreter concern).

    Hash mode partitions each delta batch by a key (the downstream
    stateful node's grouping/join key) via the process-stable shard hash,
    broadcast mode replicates the batch to every rank (small sides:
    external-index build side, gradual_broadcast thresholds), gather mode
    routes everything to rank 0 (outputs). Single-process runs never
    construct this node.

    Columnar path: when the input arrives as a NativeBatch and the shard
    key is plain columns (``nb_kidx``, or ``"id"`` for row-id routing),
    slicing happens in C (exec.cpp shard_partition_nb — GIL-free, exact
    stable_shard parity) and the slices ship as typed columnar buffers;
    the merged output is ONE NativeBatch (nb_concat), so the fused chain
    survives the rank boundary. Object columns, UDF outputs, retraction
    batches and ``PATHWAY_NO_NB_EXCHANGE=1`` degrade to the tuple path
    (per-row stable_shard_many + pickled slices) with identical routing.

    Scheduling: the runtime steps all ExchangeNodes of a timestamp as
    coalesced WAVES (engine/runtime.py _run_exchange_wave) — every rank
    marks the same lockstep exchange set pending and partitions it into
    the same waves, so all ranks join the same rendezvous in the same
    order even when they hold no local rows. process() below is the solo
    rendezvous for an exchange stepped outside the wave engine; it uses
    the identical framing, so both schedulers interoperate."""

    def __init__(
        self, scope, input_node, key_batch=None, mode="hash", nb_kidx=None,
        nb_blame=(),
    ):
        super().__init__(scope, [input_node])
        self.key_batch = key_batch
        self.mode = mode
        # plain-column shard key: tuple of column indices, "id" (route by
        # the row's own Pointer), or None (tuple path only)
        self.nb_kidx = nb_kidx
        # construction-time fused verdict + blame (analysis/eligibility.py
        # — the same predicate _slice gates the columnar path on)
        self.nb_decision = _elig.decide_exchange_nb(
            mode=mode, nb_kidx=nb_kidx, blame=nb_blame
        )
        self._nb_ok = not _elig.nb_exchange_forced_off()
        self._nb_batches = 0  # columnar batches through this boundary
        # non-empty batches that DE-OPTIMIZED to the tuple path: counted
        # only when the input was statically expected columnar
        # (eligibility.expects_native_batch) — tuple flow that was never
        # columnar (e.g. a gather of materialized groupby output) is the
        # plan's steady state, not a fallback, and pw.analyze verdicts
        # must agree with this counter
        self._fallbacks = 0

    @staticmethod
    def _pwexec():
        from pathway_tpu_torch.native import get_pwexec

        try:
            ex = get_pwexec()
        except Exception:
            return None
        if ex is None or not hasattr(ex, "shard_partition_nb"):
            return None
        return ex

    def _slice(self, batch):
        """Phase 1 (local, no communication): split this boundary's input
        into (own_part, {peer: part}) — parts are NativeBatch slices on
        the columnar path, delta lists on the tuple path. Empty parts are
        dropped from the send map (the coalesced frame's presence header
        elides them entirely)."""
        rt = self.scope.runtime
        pg = rt.procgroup
        world, rank = pg.world, pg.rank
        ex = None
        if (
            self._nb_ok
            and is_native_batch(batch)
            and (self.mode != "hash" or self.nb_kidx is not None)
        ):
            ex = self._pwexec()
        if ex is not None:
            if self.mode == "hash":
                kidx = None if self.nb_kidx == "id" else tuple(self.nb_kidx)
                slices = ex.shard_partition_nb(batch, kidx, world)
                own = slices[rank]
                sends = {
                    p: slices[p]
                    for p in range(world)
                    if p != rank and len(slices[p])
                }
            elif self.mode == "broadcast":
                own = batch
                sends = (
                    {p: batch for p in range(world) if p != rank}
                    if len(batch)
                    else {}
                )
            else:  # gather -> rank 0
                own = batch if rank == 0 else None
                sends = {0: batch} if rank != 0 and len(batch) else {}
            if len(batch):
                self._nb_batches += 1
            rt.stats.on_exchange_elided(world - 1 - len(sends))
            return own, sends
        deltas = consolidate(batch) if batch else []
        if deltas and _elig.expects_native_batch(self.inputs[0]):
            if _elig.nb_strict() and self.nb_decision.ok:
                raise _elig.strict_error(
                    self, "statically-columnar input fell to the pickled "
                    "tuple exchange path",
                )
            self._fallbacks += 1
            rt.stats.on_exchange_fallback()
        if self.mode == "hash":
            per_rank: list[list] = [[] for _ in range(world)]
            if deltas:
                from pathway_tpu_torch.parallel.procgroup import stable_shard_many

                pks = self.key_batch(
                    [d[0] for d in deltas], [d[1] for d in deltas]
                )
                for d, s in zip(deltas, stable_shard_many(pks, world)):
                    per_rank[s].append(d)
            own = per_rank[rank]
            sends = {
                p: per_rank[p]
                for p in range(world)
                if p != rank and per_rank[p]
            }
        elif self.mode == "broadcast":
            own = deltas
            sends = (
                {p: deltas for p in range(world) if p != rank}
                if deltas
                else {}
            )
        else:  # gather -> rank 0
            own = deltas if rank == 0 else None
            sends = {0: deltas} if rank != 0 and deltas else {}
        rt.stats.on_exchange_elided(world - 1 - len(sends))
        return own, sends

    def finish_exchange(self, own, parts):
        """Phase 2: merge the own slice with received peer parts (peer
        order ascending — the deterministic merge order every rank
        shares). All-columnar merges stay columnar: downstream fused
        consumers (groupby/join/select/capture) see ONE NativeBatch.
        Mixed or tuple merges materialize and consolidate exactly like
        the pre-columnar per-node all_to_all did."""
        merged_parts = []
        if own is not None and len(own):
            merged_parts.append(own)
        for p in parts:
            if len(p):
                merged_parts.append(p)
        if not merged_parts:
            return []
        if all(is_native_batch(p) for p in merged_parts):
            if len(merged_parts) == 1:
                return merged_parts[0]
            ex = self._pwexec()
            if ex is not None:
                return ex.nb_concat(merged_parts)
        mats = [
            p.materialize() if is_native_batch(p) else p
            for p in merged_parts
        ]
        merged: list = []
        for m in mats:
            merged.extend(m)
        # every part is net form by protocol (each rank slices a
        # consolidated batch). When the parts' KEY sets are disjoint —
        # the steady state: hash slices of content-routed keys, gathers
        # of key-sharded operator outputs — their concatenation is
        # already net, and re-consolidating 400k gathered deltas per run
        # was the single hottest line of the 2-rank profile. One int-set
        # pass checks disjointness; overlapping keys (cross-rank upsert
        # pairs, colliding minted keys) take the full consolidation.
        if len(mats) == 1:
            return ConsolidatedList(merged)
        per_part = sum(len({d[0] for d in m}) for m in mats)
        if len({d[0] for d in merged}) == per_part:
            return ConsolidatedList(merged)
        return consolidate(merged)

    def process(self, time, batches):
        # solo rendezvous (wave of one): identical framing to the wave
        # engine, so an exchange stepped through the generic topo loop on
        # every rank still lines up peer-to-peer
        pg = self.scope.runtime.procgroup
        own, sends = self._slice(batches[0])
        tag = ("xw", time, ("s", self.node_id))
        stats = self.scope.runtime.stats
        gather = self.mode == "gather"
        # same framing + compression + accounting as the wave engine
        # (send_exchange compresses per the link's negotiated codec and
        # feeds the frame/byte/compression counters itself), so a plan
        # that falls off the planned walk cannot silently lose the
        # compression knob or go dark on the byte matrix.
        # Topology stays flat here: the solo rendezvous is the generic
        # fallback, the tree path belongs to the wave engine.
        enc_cache = pg.make_enc_cache()
        for peer in range(pg.world):
            if peer == pg.rank or (gather and peer != 0):
                continue
            ent = sends.get(peer)
            pg.send_exchange(
                peer, tag,
                [(self.node_id, ent)] if ent is not None else [],
                enc_cache,
            )
        parts = []
        dl = pg.op_deadline()  # one deadline for the whole rendezvous
        for peer in range(pg.world):
            if peer == pg.rank or (gather and pg.rank != 0):
                continue
            # timed like the wave engine's recvs: the fallback path must
            # feed the same per-peer byte matrix and recv-wait straggler
            # signal, or a plan ineligible for the planned walk goes
            # blind on exactly the cluster view built to watch it
            t0 = _time.perf_counter()
            for _nid, part in pg.recv(peer, tag, deadline=dl):
                parts.append(part)
            stats.on_exchange_recv_wait(peer, _time.perf_counter() - t0)
        return self.finish_exchange(own, parts)


class GroupDiffNode(Node):
    """Base for stateful nodes using the affected-group rediff strategy."""

    # name of the native-store attribute on subclasses that own one
    # (JoinNode: _jstore; GroupByNode: _store) — used by _poison_demote
    _NATIVE_STORE_ATTR: str | None = None

    # fused-chain fallback accounting (JoinNode/GroupByNode set these in
    # their constructors; other GroupDiff subclasses have no fused path)
    _nb_fallbacks = 0
    _fallback_demoted = False

    def _count_nb_fallback(self, demoted: bool = False) -> None:
        """A batch that was expected columnar executed on the tuple path.
        Counted per batch while the node stays fused-eligible; a PERMANENT
        demotion (poison / unsupported-value migration) is counted exactly
        once — without the guard a poison-demoted node would re-count
        every subsequent batch of the run."""
        if self._fallback_demoted:
            return
        if demoted:
            self._fallback_demoted = True
        if not any(_elig.expects_native_batch(i) for i in self.inputs):
            # the input was never expected columnar (static tables, an
            # already-broken upstream chain): the tuple path is the plan's
            # steady state, not a de-optimization
            return
        self._nb_fallbacks += 1
        self.scope.runtime.stats.on_nb_fallback()

    def _poison_demote(self, already_counted: bool = False) -> None:
        """A non-Fallback error escaped the native executor after phase 1:
        the batch may be half-applied, so the store is poisoned for
        replay (native/exec.cpp replay invariant). Demote the node —
        salvage the store's (self-consistent) state into the Python path
        when possible, discard it otherwise — so no later call can
        re-apply the batch against it."""
        if already_counted:
            # the triggering batch already counted its fallback on entry
            # to the tuple path; just freeze the counter
            self._fallback_demoted = True
        else:
            self._count_nb_fallback(demoted=True)
        attr = self._NATIVE_STORE_ATTR
        try:
            if getattr(self, attr) is not None:
                self._migrate_to_python()
        except Exception:
            setattr(self, attr, None)
        self._native_ok = False
        self._nb_ok = False

    def group_of(self, port: int, key: Key, row: Row):
        raise NotImplementedError

    def apply_updates(self, batches: list[list[Delta]]) -> None:
        raise NotImplementedError

    def output_of_group(self, group) -> list[Delta]:
        raise NotImplementedError

    def process(self, time, batches):
        batches = [consolidate(b) for b in batches]
        affected = set()
        for port, batch in enumerate(batches):
            for k, row, d in batch:
                affected.add(self.group_of(port, k, row))
        if not affected:
            return []
        before: list[Delta] = []
        for g in affected:
            before.extend(self.output_of_group(g))
        self.apply_updates(batches)
        after: list[Delta] = []
        for g in affected:
            after.extend(self.output_of_group(g))
        return consolidate(after + negate(before))


class CheckedReindexNode(GroupDiffNode):
    """Re-key with duplicate detection (reference: reindex/with_id_from —
    test_errors.py:684 pins that a key claimed by several distinct source
    rows yields ONE row of ERROR cells plus a 'duplicated entries for
    key' warning, instead of silently stacking a multiset under the id).
    Plain ReindexNode (no per-key state) remains for internal rekeys
    where duplicates are legal (having/join projections)."""

    STATE_ATTRS = ("groups", "_warned")

    def __init__(self, scope, input_node, key_fn, width: int):
        super().__init__(scope, [input_node])
        self.key_fn = key_fn
        self.width = width
        # new_key -> {frozen_row: [row, count]}
        self.groups: dict = {}
        self._warned: set = set()

    def group_of(self, port, key, row):
        return self.key_fn(key, row)

    def apply_updates(self, batches) -> None:
        for k, row, d in batches[0]:
            nk = self.key_fn(k, row)
            slots = self.groups.setdefault(nk, {})
            fr = freeze_row(row)
            slot = slots.get(fr)
            if slot is None:
                slot = slots[fr] = [row, 0]
            slot[1] += d
            if slot[1] == 0:
                del slots[fr]
            if not slots:
                del self.groups[nk]

    def output_of_group(self, nk) -> list[Delta]:
        slots = self.groups.get(nk)
        if not slots:
            return []
        live = [s for s in slots.values() if s[1] != 0]
        total = sum(s[1] for s in live)
        if total <= 0:
            return []
        if len(live) == 1 and total == 1:
            return [(nk, live[0][0], 1)]
        if nk not in self._warned:
            self._warned.add(nk)
            import warnings

            warnings.warn(f"duplicated entries for key {nk!r}")
            self.scope.runtime.log_data_error(
                f"duplicated entries for key {nk!r}", nk
            )
        return [(nk, (ERROR,) * self.width, 1)]


class ReuniverseNode(GroupDiffNode):
    """with_universe_of with the reference's runtime checks
    (test_errors.py:573): output rows live on OTHER's key set — keys of
    other missing in self become ERROR rows ('key missing in input
    table'), keys of self missing in other are dropped ('key missing in
    output table'); both are logged. Valid promises pass through
    unchanged."""

    STATE_ATTRS = ("rows", "other_counts")

    def __init__(self, scope, self_node, other_node, width: int):
        super().__init__(scope, [self_node, other_node])
        self.width = width
        self.rows: dict = {}          # key -> [row, count] from self
        self.other_counts: dict = {}  # key -> count from other

    def group_of(self, port, key, row):
        return key

    def apply_updates(self, batches) -> None:
        for k, row, d in batches[0]:
            slot = self.rows.get(k)
            if slot is None:
                slot = self.rows[k] = [row, 0]
            if d > 0:
                # only additions carry the current row: an in-batch
                # update arrives (add new, retract old) and the retract
                # must not clobber the fresh row (TableState.apply's
                # any-order defense, stream.py:136)
                slot[0] = row
            slot[1] += d
            if slot[1] == 0:
                del self.rows[k]
        for k, _row, d in batches[1]:
            c = self.other_counts.get(k, 0) + d
            if c == 0:
                self.other_counts.pop(k, None)
            else:
                self.other_counts[k] = c

    def output_of_group(self, k) -> list[Delta]:
        # runtime.log_data_error dedups on (key, message): safe to call
        # on every rediff of an unhealed mismatch
        in_other = self.other_counts.get(k, 0) > 0
        slot = self.rows.get(k)
        in_self = slot is not None and slot[1] > 0
        if in_other and in_self:
            return [(k, slot[0], 1)]
        if in_other:
            self.scope.runtime.log_data_error(
                f"key missing in input table: {k!r}", k
            )
            return [(k, (ERROR,) * self.width, 1)]
        if in_self:
            self.scope.runtime.log_data_error(
                f"key missing in output table: {k!r}", k
            )
        return []


_JOIN_TYPE_CODES = {"inner": 0, "left": 1, "right": 2, "outer": 3}


class JoinNode(GroupDiffNode):
    """Incremental join — inner/left/right/outer (reference: Graph::join_tables
    graph.rs:480 JoinType; dataflow.rs join impl).

    The hot path is the sharded native DELTA-join executor (native/exec.cpp
    JoinStore): output deltas are computed directly as ΔL⋈R + L'⋈ΔR (plus
    pad transitions), so per-batch work is proportional to the OUTPUT
    change, not the size of touched join groups; shard maps update in
    parallel over PATHWAY_THREADS with the GIL released. Batches carrying
    values the serializer can't represent (ndarrays, Json, ERROR) demote
    the node to the Python whole-group-rediff path below.

    Fused-chain path: when the join keys are plain columns (nb_lkidx /
    nb_rkidx) and an input arrives as a columnar NativeBatch, the batch
    goes through join_batch_nb — probe/apply/emit with zero per-row
    Python objects, and the OUTPUT re-emitted as a NativeBatch in the
    steady streaming state so downstream fused consumers stay in C.
    Ineligible shapes (id= expressions, non-plain join keys, tuple-delta
    inputs, multi-process exchanges) use the tuple path above with
    identical results."""


    STATE_ATTRS = ("left", "right")
    _NATIVE_STORE_ATTR = "_jstore"

    def __init__(
        self,
        scope,
        left_node,
        right_node,
        left_key_fn,
        right_key_fn,
        join_type: str = "inner",
        left_width: int | None = None,
        right_width: int | None = None,
        id_from_left: bool = False,
        id_from_right: bool = False,
        left_id_fn=None,
        right_id_fn=None,
        exact_match: bool = False,
        lkey_batch=None,
        rkey_batch=None,
        nb_lkidx=None,
        nb_rkidx=None,
        nb_blame=(),
    ):
        super().__init__(scope, [left_node, right_node])
        self.left_key_fn = left_key_fn
        self.right_key_fn = right_key_fn
        self.join_type = join_type
        self.left = MultisetState()   # jk -> {(key, row): count}
        self.right = MultisetState()
        self.left_width = left_width
        self.right_width = right_width
        self.id_from_left = id_from_left
        self.id_from_right = id_from_right
        # id= with a pointer-valued column: output ids are the expression's
        # VALUES on that side, not the side's row ids
        self.left_id_fn = left_id_fn
        self.right_id_fn = right_id_fn
        # batch-wise join-key evaluation (column-oriented, one expression
        # call per batch instead of one closure call per row)
        self.lkey_batch = lkey_batch or (
            lambda keys, rows: [left_key_fn(k, r) for k, r in zip(keys, rows)]
        )
        self.rkey_batch = rkey_batch or (
            lambda keys, rows: [right_key_fn(k, r) for k, r in zip(keys, rows)]
        )
        self._native_ok = (
            join_type in _JOIN_TYPE_CODES
            and left_width is not None
            and right_width is not None
        )
        # fused-chain eligibility: plain-column join keys on both sides
        # and no per-row id= Python functions (id_from_left/right are
        # mintable natively). PATHWAY_NO_NB_JOIN=1 force-disables — the
        # parity batteries use it to pin fused-vs-tuple bit-identity.
        # The predicate + blame live in analysis/eligibility.py, shared
        # with pw.analyze.
        self.nb_decision = _elig.decide_join_nb(
            native_ok=self._native_ok,
            nb_lkidx=nb_lkidx,
            nb_rkidx=nb_rkidx,
            left_id_fn=left_id_fn,
            right_id_fn=right_id_fn,
            blame=nb_blame,
        )
        self._nb_ok = self.nb_decision.ok
        self._nb_lkidx = tuple(nb_lkidx) if nb_lkidx is not None else None
        self._nb_rkidx = tuple(nb_rkidx) if nb_rkidx is not None else None
        self._nb_batches = 0  # chain-path spy counter (tests/bench)
        self._nb_fallbacks = 0
        self._fallback_demoted = False
        self._exec = None
        self._jstore = None

    def group_of(self, port, key, row):
        return self.left_key_fn(key, row) if port == 0 else self.right_key_fn(key, row)

    def apply_updates(self, batches):
        for k, row, d in batches[0]:
            self.left.apply_one(self.left_key_fn(k, row), (k, row), d)
        for k, row, d in batches[1]:
            self.right.apply_one(self.right_key_fn(k, row), (k, row), d)

    # -- native delta-join path -------------------------------------------
    def _native_setup(self) -> bool:
        if self._jstore is not None:
            return True
        from pathway_tpu_torch.native import get_pwexec

        ex = get_pwexec()
        if ex is None or not hasattr(ex, "join_batch"):
            self._native_ok = False
            return False
        from pathway_tpu_torch.internals.config import get_pathway_config

        if self.left_id_fn is not None:
            id_mode = 3
        elif self.right_id_fn is not None:
            id_mode = 4
        elif self.id_from_left:
            id_mode = 1
        elif self.id_from_right:
            id_mode = 2
        else:
            id_mode = 0
        self._exec = ex
        self._jstore = ex.join_store_new(
            max(1, get_pathway_config().threads),
            _JOIN_TYPE_CODES[self.join_type],
            id_mode,
            self.left_width,
            self.right_width,
        )
        return True

    def _replay_entries(self, entries) -> None:
        """Load dumped native join state into the Python MultisetStates."""
        for jk, lentries, rentries in entries:
            for key, row, count in lentries:
                self.left.apply_one(jk, (key, row), count)
            for key, row, count in rentries:
                self.right.apply_one(jk, (key, row), count)

    def _migrate_to_python(self) -> None:
        """Convert the C++ join store into the Python MultisetStates
        (one-way: a batch with unrepresentable values permanently demotes
        this node)."""
        self._replay_entries(self._exec.join_store_dump(self._jstore))
        self._jstore = None
        self._native_ok = False

    def process(self, time, batches):
        nb_in = is_native_batch(batches[0]) or is_native_batch(batches[1])
        if (
            self._nb_ok
            and self._native_ok  # demotion (migrate/load_state) clears this
            and nb_in
            and (is_native_batch(batches[0]) or not batches[0])
            and (is_native_batch(batches[1]) or not batches[1])
            and self._native_setup()
            and hasattr(self._exec, "join_batch_nb")
        ):
            from pathway_tpu_torch.internals.api import Pointer

            try:
                res = self._exec.join_batch_nb(
                    self._jstore,
                    batches[0] if is_native_batch(batches[0]) else None,
                    batches[1] if is_native_batch(batches[1]) else None,
                    self._nb_lkidx,
                    self._nb_rkidx,
                    Pointer,
                )
            except self._exec.Fallback as fb:
                # phase 1 mutates nothing: replay the same batches on the
                # tuple path below (which materializes them)
                if _elig.nb_strict():
                    raise _elig.strict_error(
                        self, "columnar batch de-optimized to the tuple "
                        "path", fb,
                    ) from fb
            except Exception:
                self._poison_demote()
                raise
            else:
                self._nb_batches += 1
                if is_native_batch(res):
                    # fully fused: insert-only net form by construction
                    return res
                raw, dup_bump = res
                # nb inputs are insert-only, so the inner-join net-form
                # reasoning of the tuple path applies verbatim
                if self.join_type == "inner" and not dup_bump:
                    return ConsolidatedList(raw)
                return consolidate(raw)
        if nb_in:
            # columnar input executing on the tuple path: a fused-chain
            # de-optimization the analyzer must be able to predict
            self._count_nb_fallback()
        lb = consolidate(batches[0])
        rb = consolidate(batches[1])
        if not lb and not rb:
            return []
        if self._native_ok and self._native_setup():
            lkeys = [d[0] for d in lb]
            lrows = [d[1] for d in lb]
            rkeys = [d[0] for d in rb]
            rrows = [d[1] for d in rb]
            try:
                raw, dup_bump = self._exec.join_batch(
                    self._jstore,
                    list(self.lkey_batch(lkeys, lrows)),
                    lkeys,
                    lrows,
                    [d[2] for d in lb],
                    list(self.rkey_batch(rkeys, rrows)),
                    rkeys,
                    rrows,
                    [d[2] for d in rb],
                    # the raw C variadic mint when available: the join
                    # emits one pair key per OUTPUT row, so the python
                    # wrapper frame is a per-output cost
                    getattr(get_fp(), "ref_scalar_v", None) or ref_scalar,
                    self.left_id_fn or self.right_id_fn,
                )
            except self._exec.Fallback as fb:
                if _elig.nb_strict() and self.nb_decision.ok:
                    raise _elig.strict_error(
                        self, "native join store demoted to the Python "
                        "path", fb,
                    ) from fb
                # permanent demotion: this batch was already counted if it
                # arrived columnar; later batches must not re-count
                if not nb_in:
                    self._count_nb_fallback(demoted=True)
                self._fallback_demoted = True
                self._migrate_to_python()
            except Exception:
                # non-Fallback past phase 1 (e.g. a key fn raising in
                # emit): the batch is half-applied — demote so a replay
                # cannot double-count (native/exec.cpp replay invariant)
                self._poison_demote(already_counted=nb_in)
                raise
            else:
                # insert-only INNER batches are net form by construction:
                # every emitted (pair-key, row) is distinct (distinct
                # delta entries × distinct store entries) and all diffs
                # are positive — the streaming-append hot path skips the
                # full output re-hash. The ONE exception is a positive
                # multiplicity bump of an already-live (key, row) entry
                # (ΔL×R_old and L_new×ΔR can then hit the same 4-tuple),
                # which the executor reports as dup_bump. Pad transitions
                # (left/right/outer) and retractions can collide
                # retract+insert on one (key, row), so those still
                # consolidate.
                if (
                    self.join_type == "inner"
                    and not dup_bump
                    and all(d[2] > 0 for d in lb)
                    and all(d[2] > 0 for d in rb)
                ):
                    return ConsolidatedList(raw)
                return consolidate(raw)
        return super().process(time, [lb, rb])

    # operator snapshots mirror GroupByNode: native stores dump to a
    # picklable list; loading a python-format snapshot demotes the node
    def state_dict(self):
        if self._jstore is not None:
            return {"__native__": self._exec.join_store_dump(self._jstore)}
        return {a: getattr(self, a) for a in self.STATE_ATTRS}

    def reshard_state(self, states: list, keep) -> dict:
        """Elastic-mesh re-bucket (persistence/reshard.py): the store is
        keyed by the join key — exactly what the upstream exchanges
        sharded on — so the union of the old ranks' entries filtered by
        the new-world mint is this rank's state. Native dumps carry the
        join key at entry[0]; old ranks' key sets are disjoint (one
        owner per key at the old world), so concatenation IS the union.
        A mix of native and python-form snapshots (some old ranks
        demoted) merges on the python side via the same replay helper
        demotion uses."""
        native = [
            [e for e in s["__native__"] if keep(e[0])]
            for s in states
            if "__native__" in s
        ]
        py = [s for s in states if "__native__" not in s]
        if native and not py:
            return {"__native__": [e for part in native for e in part]}
        left, right = MultisetState(), MultisetState()
        for part in native:
            hold_l, hold_r = self.left, self.right
            self.left, self.right = left, right
            try:
                self._replay_entries(part)
            finally:
                self.left, self.right = hold_l, hold_r
        for s in py:
            for attr, tgt in (("left", left), ("right", right)):
                ms = s.get(attr)
                if ms is None:
                    continue
                for jk, d in ms.data.items():
                    if keep(jk) and jk not in tgt.data:
                        tgt.data[jk] = d
        return {"left": left, "right": right}

    def load_state(self, state) -> None:
        native = state.get("__native__") if isinstance(state, dict) else None
        if native is not None:
            if self._native_ok and self._native_setup():
                try:
                    self._exec.join_store_load(self._jstore, native)
                    return
                except self._exec.Fallback:
                    # partially-loaded store is discarded wholesale
                    self._jstore = None
            self._replay_entries(native)
            self._native_ok = False
            return
        for a, v in state.items():
            setattr(self, a, v)
        if self.left.data or self.right.data:
            self._native_ok = False

    def output_of_group(self, jk) -> list[Delta]:
        lrows = self.left.get(jk)
        rrows = self.right.get(jk)
        out: list[Delta] = []
        jt = self.join_type
        if lrows and rrows:
            for (lk, lrow), lc in lrows:
                for (rk, rrow), rc in rrows:
                    out.append(
                        (self._out_key(lk, lrow, rk, rrow), lrow + rrow, lc * rc)
                    )
        if not rrows and lrows and jt in ("left", "outer"):
            pad = (None,) * (self.right_width or 0)
            for (lk, lrow), lc in lrows:
                out.append((self._out_key(lk, lrow, None, None), lrow + pad, lc))
        if not lrows and rrows and jt in ("right", "outer"):
            pad = (None,) * (self.left_width or 0)
            for (rk, rrow), rc in rrows:
                out.append((self._out_key(None, None, rk, rrow), pad + rrow, rc))
        return out

    def _out_key(self, lk, lrow, rk, rrow) -> Key:
        if self.left_id_fn is not None:
            if lk is None:
                # reference errors when id= cannot be produced for a row
                raise ValueError(
                    "join id= references the left side but an outer/right "
                    "join produced a row with no left match"
                )
            return self.left_id_fn(lk, lrow)
        if self.right_id_fn is not None:
            if rk is None:
                raise ValueError(
                    "join id= references the right side but an outer/left "
                    "join produced a row with no right match"
                )
            return self.right_id_fn(rk, rrow)
        if self.id_from_left and lk is not None:
            return lk
        if self.id_from_right and rk is not None:
            return rk
        return ref_scalar(lk, rk)


class GroupByNode(GroupDiffNode):
    """Incremental groupby+reduce (reference: Graph::group_by_table
    graph.rs:885; reducers src/engine/reduce.rs).

    ``reducer_specs`` entries are either ``("full", fn)`` — fn(entries,
    slot) over the group's multiset — or ``("abelian", update, finish,
    init)`` maintaining O(1) running state per group (the reference's
    semigroup fast path, reduce.rs:40): abelian slots never rescan the
    multiset, and when EVERY slot is abelian the multiset isn't even
    stored."""


    STATE_ATTRS = ("groups",)
    _NATIVE_STORE_ATTR = "_store"

    def __init__(
        self,
        scope,
        input_node,
        grouping_fn,          # (key, row) -> tuple of grouping values
        args_fn,              # (key, row) -> tuple of reducer arg combos
        reducer_specs,        # list of ("full", fn) | ("abelian", upd, fin, init[, code])
        key_fn=None,          # grouping values -> output Pointer
        grouping_batch=None,  # (keys, rows) -> list of gvals tuples
        args_batch=None,      # (keys, rows) -> list of arg-combo tuples
        native_args=None,     # per spec: batch column fn | None (count)
        native_order=None,    # sort_by batch column fn (order tokens)
        nb_gidx=None,         # grouping column indices (NativeBatch path)
        nb_argidx=None,       # per spec: arg column index | None (count)
        nb_blame=(),          # lowering-time ineligibility blame
    ):
        super().__init__(scope, [input_node])
        self.grouping_fn = grouping_fn
        self.args_fn = args_fn
        # batch-wise evaluation: expression evaluators are column-oriented,
        # so computing grouping/arg columns once per batch skips two Python
        # closure calls per row (the relational-plane hot loop)
        self.grouping_batch = grouping_batch or (
            lambda keys, rows: [grouping_fn(k, r) for k, r in zip(keys, rows)]
        )
        self.args_batch = args_batch or (
            lambda keys, rows: [args_fn(k, r) for k, r in zip(keys, rows)]
        )
        self.specs = [
            s if isinstance(s, tuple) else ("full", s) for s in reducer_specs
        ]
        self.need_ms = any(s[0] == "full" for s in self.specs)
        self.key_fn = key_fn or (lambda gvals: ref_scalar(*gvals))
        # sharded native executor (native/exec.cpp): the multi-worker
        # relational core — PATHWAY_THREADS C++ threads over key shards,
        # GIL released during the apply phase. Eligible when every reducer
        # has a native code and args are single columns; ineligible or
        # unsupported-value batches fall back to the Python path below.
        # abelian specs carry their native code at index 4 (count/sum/avg);
        # full specs at index 2 (min/max keep an ordered value multiset
        # per group; tuple/sorted_tuple/unique/any/argmin/argmax/earliest/
        # latest recompute from the joint row multiset — which also lets
        # demotion rebuild the Python ms exactly). sort_by rides along as
        # an order column (native_order) instead of disqualifying the node.
        self.native_codes = [
            (s[4] if len(s) > 4 else None)
            if s[0] == "abelian"
            else (s[2] if len(s) > 2 else None)
            for s in self.specs
        ]
        self.native_args = native_args
        self.native_order = native_order
        self._native_ok = (
            len(self.specs) > 0
            and all(c is not None for c in self.native_codes)
            and native_args is not None
        )
        # fused-chain path: a columnar NativeBatch from the C parser is
        # taken through extract→apply→emit in ONE C call (zero per-row
        # Python). Abelian-only stores (count/sum/avg) with plain-column
        # grouping/args and no sort_by qualify; everything else
        # materializes the batch into the general native path below.
        # The predicate + blame live in analysis/eligibility.py, shared
        # with pw.analyze.
        self.nb_decision = _elig.decide_groupby_nb(
            native_ok=self._native_ok,
            nb_gidx=nb_gidx,
            nb_argidx=nb_argidx,
            native_order=native_order,
            native_codes=self.native_codes,
            blame=nb_blame,
        )
        self._nb_ok = self.nb_decision.ok
        self._nb_gidx = tuple(nb_gidx) if nb_gidx is not None else None
        self._nb_argidx = tuple(nb_argidx) if nb_argidx is not None else None
        self._nb_batches = 0  # chain-path spy counter (tests)
        self._nb_fallbacks = 0
        self._fallback_demoted = False
        self.src_exprs = None  # expression provenance (pw.analyze)
        self._exec = None
        self._store = None
        # frozen gvals -> [gvals, ms_or_None, abelian_states, total_count,
        #                  cached_output_key] — the output Pointer is a
        # content hash of the grouping values, stable for the group's
        # lifetime; hashing it once per group (not twice per batch) keeps
        # blake2b off the rediff hot path
        self.groups: dict[Any, list] = {}

    def group_of(self, port, key, row):
        return freeze_row(self.grouping_fn(key, row))

    # -- native path ------------------------------------------------------
    def _native_setup(self) -> bool:
        if self._store is not None:
            return True
        from pathway_tpu_torch.native import get_pwexec

        ex = get_pwexec()
        if ex is None:
            self._native_ok = False
            return False
        from pathway_tpu_torch.internals.config import get_pathway_config

        n_shards = max(1, get_pathway_config().threads)
        self._exec = ex
        self._store = ex.store_new(
            n_shards, tuple(self.native_codes),
            1 if self.native_order is not None else 0,
        )
        return True

    def _native_state_to_py(self, code, st):
        if code not in ("count", "sum", "avg"):
            return None  # full reducers read the (rebuilt) multiset
        cnt, isum, fsum, isfloat, err = st
        if code == "count":
            return cnt
        value = fsum + isum if isfloat else isum
        if code == "sum":
            return [cnt, value, err]
        return [float(fsum + isum), cnt, err]  # avg

    def _combos_of(self, key, vals, order=None):
        """Rebuild one args_fn row from a dumped joint-multiset entry:
        per spec ``(*args, order_token, row_key)`` — the order token is
        the dumped sort_by value when the store carried one, else the
        row key (the no-sort_by contract, groupbys.py args_fn)."""
        token = key if order is None else order
        return tuple(
            (token, key) if col is None else (vals[j], token, key)
            for j, col in enumerate(self.native_args)
        )

    def _groups_from_native_entries(self, entries) -> None:
        """Rebuild the Python groups dict from dumped native entries —
        shared by mid-stream demotion and snapshot-restore demotion so
        the two paths cannot drift. Dumped ms entries are (key, vals,
        count[, stamp, order]); stamps survive so earliest/latest keep
        their processing-time ranking across demotion."""
        for entry in entries:
            gvals, out_key, total, states = entry[:4]
            ab = [
                self._native_state_to_py(code, st)
                for code, st in zip(self.native_codes, states)
            ]
            ms = None
            if len(entry) > 4:
                ms = {}
                for me in entry[4]:
                    key, vals, count = me[0], me[1], me[2]
                    stamp = me[3] if len(me) > 3 else (0, 0)
                    order = me[4] if len(me) > 4 else None
                    args = self._combos_of(key, vals, order)
                    ms[freeze_row(args)] = [args, count, tuple(stamp)]
            elif self.need_ms:
                ms = {}
            self.groups[freeze_row(gvals)] = [gvals, ms, ab, total, out_key]

    def _migrate_to_python(self) -> None:
        """Convert C++ store state to the Python groups dict (one-way: a
        batch with values the native path can't represent permanently
        demotes this node)."""
        self._groups_from_native_entries(self._exec.store_dump(self._store))
        self._store = None
        self._native_ok = False

    def process(self, time, batches):
        nb_in = is_native_batch(batches[0])
        if (
            self._nb_ok
            and self._native_ok  # demotion (migrate/load_state) clears this
            and nb_in
            and self._native_setup()
        ):
            try:
                out = self._exec.process_batch_nb(
                    self._store, batches[0], self._nb_gidx,
                    self._nb_argidx, self.key_fn, ERROR, time,
                    ConsolidatedList,
                )
                self._nb_batches += 1
                return out
            except self._exec.Fallback as fb:
                # store stays valid (phase 1 mutates nothing): materialize
                # and run the general path — do NOT demote the node
                if _elig.nb_strict():
                    raise _elig.strict_error(
                        self, "columnar batch de-optimized to the tuple "
                        "path", fb,
                    ) from fb
            except Exception:
                # non-Fallback past phase 1: half-applied batch — demote
                # so a replay cannot double-count (replay invariant)
                self._poison_demote()
                raise
        if nb_in:
            # columnar input executing on the tuple path: a fused-chain
            # de-optimization the analyzer must be able to predict
            self._count_nb_fallback()
        batch = consolidate(batches[0])
        if not batch:
            return []
        keys, rows, diffs = _split_deltas(batch)
        if self._native_ok and self._native_setup():
            gvals_list = self.grouping_batch(keys, rows)
            valcols = tuple(
                f(keys, rows) if f is not None else None
                for f in self.native_args
            )
            ordercol = (
                self.native_order(keys, rows)
                if self.native_order is not None
                else None
            )
            skipped: list = []
            try:
                # distinct groups emit distinct rows, so the output is
                # already in net form
                out = ConsolidatedList(
                    self._exec.process_batch(
                        self._store,
                        list(gvals_list),
                        keys,
                        valcols,
                        diffs,
                        self.key_fn,
                        ERROR,
                        time,
                        ordercol,
                        skipped,
                    )
                )
                for k in skipped:
                    self.scope.runtime.log_data_error(
                        "Error value encountered in grouping columns, "
                        "skipping the row",
                        k,
                    )
                return out
            except self._exec.Fallback as fb:
                if _elig.nb_strict() and self.nb_decision.ok:
                    raise _elig.strict_error(
                        self, "native group store demoted to the Python "
                        "path", fb,
                    ) from fb
                # permanent demotion: counted once, not per batch
                if not nb_in:
                    self._count_nb_fallback(demoted=True)
                self._fallback_demoted = True
                self._migrate_to_python()
            except Exception:
                # non-Fallback past phase 1: half-applied batch — demote
                # so a replay cannot double-count (replay invariant)
                self._poison_demote(already_counted=nb_in)
                raise
        gvals_list = self.grouping_batch(keys, rows)
        # reference parity (test_errors.py): rows whose grouping values
        # are ERROR join no group — skipped and logged
        if any(
            any(v is ERROR for v in g) for g in gvals_list
        ):
            keep = []
            for i, g in enumerate(gvals_list):
                if any(v is ERROR for v in g):
                    self.scope.runtime.log_data_error(
                        "Error value encountered in grouping columns, "
                        "skipping the row",
                        keys[i],
                    )
                else:
                    keep.append(i)
            if not keep:
                return []
            batch = [batch[i] for i in keep]
            keys = [keys[i] for i in keep]
            rows = [rows[i] for i in keep]
            gvals_list = [gvals_list[i] for i in keep]
        args_list = self.args_batch(keys, rows)
        gfrozen_list = [freeze_row(g) for g in gvals_list]
        affected = dict.fromkeys(gfrozen_list)  # ordered, unique
        out_of = self.output_of_group
        before: list[Delta] = []
        for g in affected:
            before.extend(out_of(g))
        specs = self.specs
        need_ms = self.need_ms
        groups = self.groups
        abelian_idx = [i for i, s in enumerate(specs) if s[0] == "abelian"]
        for i, (k, row, d) in enumerate(batch):
            gfrozen = gfrozen_list[i]
            args = args_list[i]
            entry = groups.get(gfrozen)
            if entry is None:
                gvals = gvals_list[i]
                entry = [
                    gvals,
                    {} if need_ms else None,
                    [s[3] if s[0] == "abelian" else None for s in specs],
                    0,
                    self.key_fn(gvals),
                ]
                groups[gfrozen] = entry
            entry[3] += d
            states = entry[2]
            for j in abelian_idx:
                states[j] = specs[j][1](states[j], args[j], d)
            if need_ms:
                ms = entry[1]
                afrozen = freeze_row(args)
                slot = ms.get(afrozen)
                if slot is None:
                    # stamp = (engine time, batch position): the arrival
                    # order earliest/latest reducers rank by (reference:
                    # EarliestReducer orders by processing time)
                    slot = [args, 0, (time, i)]
                    ms[afrozen] = slot
                slot[1] += d
                if slot[1] == 0:
                    del ms[afrozen]
            if entry[3] == 0 and not (need_ms and entry[1]):
                del groups[gfrozen]
        after: list[Delta] = []
        for g in affected:
            after.extend(out_of(g))
        return consolidate(after + negate(before))

    # operator snapshots: native stores dump to a picklable list; loading a
    # python-format snapshot (or native into a python-only build) demotes
    # the node so state never splits across the two representations
    def state_dict(self):
        if self._store is not None:
            return {"__native__": self._exec.store_dump(self._store)}
        return {a: getattr(self, a) for a in self.STATE_ATTRS}

    def reshard_state(self, states: list, keep) -> dict:
        """Elastic-mesh re-bucket (persistence/reshard.py): groups are
        keyed by the grouping values — the exact value the upstream
        exchange sharded on (frozen forms hash identically under the
        mint's canonical serialization) — so union + new-world keep
        filter re-partitions the store. Native dump entries carry the
        raw grouping values at entry[0]; mixed native/python snapshots
        merge on the python side via the demotion replay helper."""
        native = [
            [e for e in s["__native__"] if keep(e[0])]
            for s in states
            if "__native__" in s
        ]
        py = [s for s in states if "__native__" not in s]
        if native and not py:
            return {"__native__": [e for part in native for e in part]}
        merged: dict = {}
        for part in native:
            hold = self.groups
            self.groups = {}
            try:
                self._groups_from_native_entries(part)
                for g, entry in self.groups.items():
                    merged.setdefault(g, entry)
            finally:
                self.groups = hold
        for s in py:
            for g, entry in (s.get("groups") or {}).items():
                if keep(g) and g not in merged:
                    merged[g] = entry
        return {"groups": merged}

    def load_state(self, state) -> None:
        native = state.get("__native__") if isinstance(state, dict) else None
        if native is not None:
            if self._native_ok and self._native_setup():
                try:
                    self._exec.store_load(self._store, native, ERROR)
                    return
                except self._exec.Fallback:
                    # partially-loaded store is discarded wholesale
                    self._store = None
            self._groups_from_native_entries(native)
            self._native_ok = False
            return
        for a, v in state.items():
            setattr(self, a, v)
        # pre-cached-key snapshots stored 4-element entries; pad with the
        # recomputed output key so output_of_group's unpack stays valid
        for entry in self.groups.values():
            if len(entry) == 4:
                entry.append(self.key_fn(entry[0]))
        if self.groups:
            self._native_ok = False

    def output_of_group(self, gfrozen) -> list[Delta]:
        entry = self.groups.get(gfrozen)
        if entry is None or entry[3] <= 0:
            return []
        gvals, ms, states, _total, out_key = entry
        entries = None
        values = []
        for i, spec in enumerate(self.specs):
            if spec[0] == "abelian":
                values.append(spec[2](states[i]))
            else:
                if entries is None:
                    entries = [tuple(slot) for slot in ms.values()]
                values.append(spec[1](entries, i))
        return [(out_key, gvals + tuple(values), 1)]


class UpdateRowsNode(GroupDiffNode):
    """right rows override left rows on the same key (reference:
    Graph::update_rows_table)."""


    STATE_ATTRS = ("left", "right")
    def __init__(self, scope, left_node, right_node):
        super().__init__(scope, [left_node, right_node])
        self.left = TableState()
        self.right = TableState()

    def group_of(self, port, key, row):
        return key

    def apply_updates(self, batches):
        self.left.apply(batches[0])
        self.right.apply(batches[1])

    def output_of_group(self, key) -> list[Delta]:
        if key in self.right.rows:
            return [(key, self.right.rows[key], 1)]
        if key in self.left.rows:
            return [(key, self.left.rows[key], 1)]
        return []


class UpdateCellsNode(GroupDiffNode):
    """Override selected columns from right where a right row exists
    (reference: Table.update_cells / Graph::update_cells)."""


    STATE_ATTRS = ("left", "right")
    def __init__(self, scope, left_node, right_node, positions: list[int]):
        # positions[i] = column index in left row replaced by right row col i
        super().__init__(scope, [left_node, right_node])
        self.left = TableState()
        self.right = TableState()
        self.positions = positions

    def group_of(self, port, key, row):
        return key

    def apply_updates(self, batches):
        self.left.apply(batches[0])
        self.right.apply(batches[1])

    def output_of_group(self, key) -> list[Delta]:
        if key not in self.left.rows:
            return []
        row = list(self.left.rows[key])
        rrow = self.right.rows.get(key)
        if rrow is not None:
            for i, pos in enumerate(self.positions):
                row[pos] = rrow[i]
        return [(key, tuple(row), 1)]


class IxNode(GroupDiffNode):
    """Pointer-indexing: for each keys-table row, look up source row by the
    pointer in column ``key_col_idx`` (reference: Graph::ix_table)."""


    STATE_ATTRS = ("source", "keys", "keys_by_target")

    def reshard_state(self, states: list, keep) -> dict:
        """Rescale re-bucket with MIXED keying: ``source`` rows and the
        ``keys_by_target`` index are keyed by the lookup TARGET (what
        both exchanges co-locate on), but ``keys`` rows are keyed by the
        query row's own id — so they follow their target's new owner,
        not their own id's."""
        source = TableState()
        keys = TableState()
        by_target: dict = defaultdict(set)
        for s in states:
            src = s.get("source")
            if src is not None:
                for k, row in src.rows.items():
                    if keep(k):
                        source.rows.setdefault(k, row)
            for target, qks in (s.get("keys_by_target") or {}).items():
                if keep(target):
                    by_target[target] |= set(qks)
        kept_qks = {qk for qks in by_target.values() for qk in qks}
        for s in states:
            krows = s.get("keys")
            if krows is not None:
                for qk, row in krows.rows.items():
                    if qk in kept_qks:
                        keys.rows.setdefault(qk, row)
        return {
            "source": source, "keys": keys,
            "keys_by_target": by_target,
        }

    def __init__(self, scope, source_node, keys_node, key_fn, optional=False, strict=True, source_width=0):
        super().__init__(scope, [source_node, keys_node])
        self.key_fn = key_fn  # (key,row) -> Pointer looked up in source
        self.optional = optional
        self.strict = strict
        self.source = TableState()
        self.keys = TableState()
        self.keys_by_target: dict[Key, set[Key]] = defaultdict(set)
        self.source_width = source_width

    def group_of(self, port, key, row):
        return key if port == 0 else self.key_fn(key, row)

    def apply_updates(self, batches):
        self.source.apply(batches[0])
        for k, row, d in batches[1]:
            target = self.key_fn(k, row)
            if d > 0:
                self.keys_by_target[target].add(k)
            else:
                s = self.keys_by_target.get(target)
                if s is not None:
                    s.discard(k)
                    if not s:
                        del self.keys_by_target[target]
        self.keys.apply(batches[1])

    def output_of_group(self, target) -> list[Delta]:
        out = []
        src_row = self.source.rows.get(target)
        for qk in self.keys_by_target.get(target, ()):
            if qk not in self.keys.rows:
                continue
            if src_row is not None:
                out.append((qk, src_row, 1))
            elif self.optional or target is None:
                out.append((qk, (None,) * self.source_width, 1))
            elif self.strict:
                raise KeyError(f"ix: missing key {target!r} in indexed table")
        return out


class IntersectNode(GroupDiffNode):
    """Restrict left to keys present in all other inputs."""


    STATE_ATTRS = ("left", "others")
    def __init__(self, scope, left_node, other_nodes):
        super().__init__(scope, [left_node, *other_nodes])
        self.left = TableState()
        self.others = [TableState() for _ in other_nodes]

    def group_of(self, port, key, row):
        return key

    def apply_updates(self, batches):
        self.left.apply(batches[0])
        for st, b in zip(self.others, batches[1:]):
            st.apply(b)

    def output_of_group(self, key) -> list[Delta]:
        if key in self.left.rows and all(key in st.rows for st in self.others):
            return [(key, self.left.rows[key], 1)]
        return []


class DifferenceNode(GroupDiffNode):

    STATE_ATTRS = ("left", "right")
    def __init__(self, scope, left_node, right_node):
        super().__init__(scope, [left_node, right_node])
        self.left = TableState()
        self.right = TableState()

    def group_of(self, port, key, row):
        return key

    def apply_updates(self, batches):
        self.left.apply(batches[0])
        self.right.apply(batches[1])

    def output_of_group(self, key) -> list[Delta]:
        if key in self.left.rows and key not in self.right.rows:
            return [(key, self.left.rows[key], 1)]
        return []


class SortNode(GroupDiffNode):
    """Maintains prev/next pointers per instance (reference:
    src/engine/dataflow/operators/prev_next.rs)."""


    STATE_ATTRS = ("by_instance",)
    def __init__(self, scope, input_node, key_fn, instance_fn):
        super().__init__(scope, [input_node])
        self.key_fn = key_fn          # (key,row) -> sort key value
        self.instance_fn = instance_fn  # (key,row) -> instance value
        # instance -> {row_key: sort_key}; per-instance index keeps updates
        # O(instance) instead of O(table)
        self.by_instance: dict[Any, dict[Key, Any]] = defaultdict(dict)

    def group_of(self, port, key, row):
        return self.instance_fn(key, row)

    def apply_updates(self, batches):
        for k, row, d in batches[0]:
            inst = self.instance_fn(k, row)
            idx = self.by_instance[inst]
            if d > 0:
                idx[k] = self.key_fn(k, row)
            else:
                idx.pop(k, None)
                if not idx:
                    del self.by_instance[inst]

    def output_of_group(self, instance) -> list[Delta]:
        rows = [(sk, k) for k, sk in self.by_instance.get(instance, {}).items()]
        rows.sort(key=lambda t: (t[0], t[1]))
        out = []
        for i, (_, k) in enumerate(rows):
            prev_k = rows[i - 1][1] if i > 0 else None
            next_k = rows[i + 1][1] if i + 1 < len(rows) else None
            out.append((k, (prev_k, next_k), 1))
        return out


class DeduplicateNode(Node):
    """Keep one accepted value per instance (reference:
    Graph::deduplicate, stdlib/stateful/deduplicate.py).  Ignores
    retractions — stateful-reducer semantics."""


    STATE_ATTRS = ("current",)
    def __init__(self, scope, input_node, instance_fn, value_fn, acceptor):
        super().__init__(scope, [input_node])
        self.instance_fn = instance_fn
        self.value_fn = value_fn
        self.acceptor = acceptor
        self.current: dict[Any, tuple[Key, Row]] = {}

    def process(self, time, batches):
        out: list[Delta] = []
        deltas = consolidate(batches[0])
        deltas.sort(key=lambda d: d[0])
        for k, row, d in deltas:
            if d <= 0:
                continue
            inst = self.instance_fn(k, row)
            new_val = self.value_fn(k, row)
            cur = self.current.get(inst)
            if cur is None:
                accept = True
            else:
                prev_val = self.value_fn(*cur)
                accept = bool(self.acceptor(new_val, prev_val))
            if accept:
                if cur is not None:
                    out.append((cur[0], cur[1], -1))
                self.current[inst] = (k, row)
                out.append((k, row, 1))
        return consolidate(out)


class StatefulReduceNode(Node):
    """pw.reducers.stateful_many over groups (reference:
    src/engine/dataflow/operators/stateful_reduce.rs). Insert-only."""


    STATE_ATTRS = ("state",)
    def __init__(self, scope, input_node, grouping_fn, args_fn, combine_many, key_fn=None):
        super().__init__(scope, [input_node])
        self.grouping_fn = grouping_fn
        self.args_fn = args_fn
        self.combine_many = combine_many
        self.key_fn = key_fn or (lambda gvals: ref_scalar(*gvals))
        self.state: dict[tuple, Any] = {}

    def process(self, time, batches):
        deltas = consolidate(batches[0])
        per_group: dict[tuple, list[tuple[tuple, int]]] = defaultdict(list)
        for k, row, d in deltas:
            per_group[self.grouping_fn(k, row)].append((self.args_fn(k, row), d))
        out: list[Delta] = []
        for gvals, rows in per_group.items():
            old = self.state.get(gvals)
            new = self.combine_many(old, rows)
            self.state[gvals] = new
            gkey = self.key_fn(gvals)
            if old is not None:
                out.append((gkey, gvals + (old,), -1))
            if new is not None:
                out.append((gkey, gvals + (new,), 1))
        return consolidate(out)


class GradualBroadcastNode(GroupDiffNode):
    """Append an apportioned threshold column (reference:
    src/engine/dataflow/operators/gradual_broadcast.rs): the threshold
    table carries one (lower, value, upper) triplet; every left row gets
    ``apx_value = min(lower + frac(key)*(upper-lower), value)`` — a fixed
    per-key point in [lower, upper] exposed gradually as `value` sweeps,
    so downstream cutoffs move row-by-row instead of all at once."""


    STATE_ATTRS = ("left", "threshold_rows", "_legacy_threshold")
    # rescale: left rows re-bucket by their key (any deterministic
    # unique placement works — emissions re-route downstream); the
    # broadcast-fed threshold is identical on every old rank
    RESHARD_ATTRS = {
        "threshold_rows": "replicate", "_legacy_threshold": "replicate",
    }
    _legacy_threshold: tuple | None = None

    def __init__(self, scope, left_node, threshold_node, triplet_fn):
        super().__init__(scope, [left_node, threshold_node])
        self.triplet_fn = triplet_fn  # (key,row) -> (lower, value, upper)
        self.left = TableState()
        # full table state for the threshold side: a retraction-only update
        # must clear the triplet, and a retract+insert commit must land on
        # the inserted row regardless of in-batch ordering
        self.threshold_rows = TableState()

    def group_of(self, port, key, row):
        return 0  # single group: threshold changes rediff everything

    def apply_updates(self, batches):
        self.left.apply(batches[0])
        if batches[1]:
            self._legacy_threshold = None
            self.threshold_rows.apply(batches[1])

    @property
    def threshold(self) -> tuple | None:
        for k, row in self.threshold_rows.rows.items():
            return self.triplet_fn(k, row)
        return getattr(self, "_legacy_threshold", None)

    def load_state(self, state) -> None:
        # pre-threshold_rows snapshots stored a bare 'threshold' triplet;
        # keep serving it until a live threshold-table commit replaces it
        state = dict(state)
        legacy = state.pop("threshold", None)
        super().load_state(state)
        if legacy is not None and not self.threshold_rows.rows:
            self._legacy_threshold = tuple(legacy)

    def output_of_group(self, _g) -> list[Delta]:
        threshold = self.threshold
        if threshold is None:
            return []
        lower, value, upper = threshold
        span = upper - lower
        out = []
        for k, row in self.left.rows.items():
            frac = (int(k) & ((1 << 64) - 1)) / float(1 << 64)
            apx = lower + frac * span if span else lower
            if apx > value:
                apx = value
            out.append((k, row + (apx,), 1))
        return out


class ForgetImmediatelyNode(Node):
    """Pass rows through and retract them at the next engine timestamp
    (reference: Table._forget_immediately — used by as-of-now query flows so
    transient queries don't accumulate in downstream state)."""


    STATE_ATTRS = ("_to_retract",)
    def __init__(self, scope, input_node):
        super().__init__(scope, [input_node])
        self._to_retract: dict[int, list[Delta]] = {}

    def process(self, time, batches):
        out = list(self._to_retract.pop(time, []))
        cur = consolidate(batches[0])
        if cur:
            out.extend(cur)
            nt = time + 1
            self._to_retract.setdefault(nt, []).extend(negate(cur))
            self.scope.runtime.mark_pending(nt, self)
        return consolidate(out)


class OutputNode(Node):
    """Terminal node delivering batches to a callback (reference:
    Graph::output_table / subscribe_table, graph.rs:569 SubscribeCallbacks)."""

    def __init__(
        self,
        scope,
        input_node,
        on_change=None,       # fn(key, row, time, diff)
        on_batch=None,        # fn(time, deltas)
        on_time_end=None,     # fn(time)
        on_end=None,          # fn()
        dict_cols=None,       # tuple of col names: on_change receives a
                              # {col: val} dict + bool diff (pw.io.subscribe)
        envelope=False,       # on_batch receives a DeliveryEnvelope
                              # (epoch, commit_ts, seq) instead of the bare
                              # time — the dedup handle for external
                              # systems (io/txn.py)
        on_batch_arrow=None,  # fn(time, pa.RecordBatch): the columnar
                              # egress consumer — NativeBatch
                              # deliveries export as Arrow record batches
                              # (zero row expansion); tuple deltas still
                              # route through on_batch
        arrow_cols=None,      # column names for the Arrow export schema
        arrow_key=False,      # include the _key fixed_size_binary(16)
                              # column in Arrow deliveries
    ):
        super().__init__(scope, [input_node])
        self._on_change = on_change
        self._on_batch = on_batch
        self._on_batch_arrow = on_batch_arrow
        self._arrow_cols = (
            tuple(arrow_cols) if arrow_cols is not None else None
        )
        self._arrow_key = bool(arrow_key)
        self._on_time_end = on_time_end
        self._on_end = on_end
        self._dict_cols = tuple(dict_cols) if dict_cols is not None else None
        self._seen_time = False
        self._envelope = bool(envelope)
        # per-node delivery sequence: strictly monotone within an epoch
        # (a rollback respawns the process, resetting it — the envelope's
        # epoch disambiguates), so (epoch, seq) identifies a delivery
        self._seq = 0
        self._epoch: int | None = None

    def _mesh_epoch(self) -> int:
        if self._epoch is None:
            # one shared parse (runtime.mesh_epoch): procgroup epoch
            # when a mesh formed, else the supervisor-stamped env
            self._epoch = self.scope.runtime.mesh_epoch()
        return self._epoch

    def _export_arrow(self, nb):
        """NativeBatch → pa.RecordBatch via the C-data-interface export
        (None = this batch can't export; the caller row-expands it)."""
        from pathway_tpu_torch.io._arrow import nb_to_arrow

        if _elig.nb_capture_forced_off() or self._arrow_cols is None:
            return None
        return nb_to_arrow(
            nb, self._arrow_cols, include_key=self._arrow_key,
            include_diff=True,
        )

    def process(self, time, batches):
        raw = batches[0]
        if (
            self._on_batch_arrow is not None
            and self._on_change is None
            and is_native_batch(raw)
            and len(raw)
        ):
            # columnar egress: the C-owned batch exports as
            # an Arrow record batch — no per-row Python objects at the
            # sink. Gated on on_change being absent: a per-row callback
            # needs the rows materialized regardless, so the arrow leg
            # would be pure extra work there.
            rb = self._export_arrow(raw)
            if rb is not None:
                n = rb.num_rows
                self._seen_time = True
                self.scope.runtime.stats.on_output(n)
                self.scope.runtime.stats.on_capture_arrow_batch(n)
                self.scope.runtime.note_output_emit(self, time, n)
                self._seq += 1
                if self._envelope:
                    from pathway_tpu_torch.io.txn import DeliveryEnvelope

                    self._on_batch_arrow(
                        DeliveryEnvelope(
                            self._mesh_epoch(), time, self._seq
                        ),
                        rb,
                    )
                else:
                    self._on_batch_arrow(time, rb)
                return []
            if _elig.nb_strict() and not _elig.nb_capture_forced_off():
                from pathway_tpu_torch.io._arrow import arrow_capable

                # strict only when the export had the means and THIS
                # batch still couldn't go (mixed-tag column): a process
                # without pyarrow/toolchain was never fused-eligible —
                # the plan says rows there, so rows is not a demotion
                if arrow_capable():
                    raise _elig.strict_error(
                        self, "columnar egress fell back to the row path"
                    )
        if (
            is_native_batch(raw)
            and len(raw)
            and self._on_batch is None
            and self._on_change is None
            and self._on_batch_arrow is None
        ):
            # callback-free probe (e.g. a neutered non-writer rank):
            # nothing needs rows — don't materialize (and cache) them
            self._seen_time = True
            self.scope.runtime.stats.on_output(len(raw))
            self.scope.runtime.note_output_emit(self, time, len(raw))
            return []
        # terminal read-only delivery: an already-net-form batch needs no
        # aliasing copy here (consolidate would clone it) — callbacks get
        # a shared view they must not mutate (documented on subscribe)
        deltas = (
            raw if type(raw) is ConsolidatedList else consolidate(raw)
        )
        if deltas and is_native_batch(raw):
            # an egress node materialized a C-owned columnar batch back
            # into Python rows — the row expansion the egress counters
            # (and the Plan Doctor's sink.row-expanding verdict) name
            self.scope.runtime.stats.on_capture_rows_expanded(len(deltas))
        if deltas:
            self._seen_time = True
            self.scope.runtime.stats.on_output(len(deltas))
            # event-time lag watermark: commit→emit freshness against
            # the connector's flush-time ingest stamp (flight recorder +
            # OpenMetrics output_lag_ms histogram)
            self.scope.runtime.note_output_emit(self, time, len(deltas))
            if self._on_batch is not None:
                self._seq += 1
                if self._envelope:
                    from pathway_tpu_torch.io.txn import DeliveryEnvelope

                    self._on_batch(
                        DeliveryEnvelope(
                            self._mesh_epoch(), time, self._seq
                        ),
                        deltas,
                    )
                else:
                    self._on_batch(time, deltas)
            if self._on_change is not None:
                # stable partition: retractions first, then insertions,
                # each in producer order (deterministic — node outputs are
                # insertion-ordered). Upsert sinks rely on retract-before-
                # insert; the C deliver loop also builds the subscriber's
                # row dicts when dict_cols is set
                fp = get_fp()
                if fp is not None:
                    fp.deliver(deltas, time, self._on_change, self._dict_cols)
                else:
                    ordered = [d for d in deltas if d[2] < 0] + [
                        d for d in deltas if d[2] >= 0
                    ]
                    if self._dict_cols is not None:
                        cols = self._dict_cols
                        for k, row, d in ordered:
                            self._on_change(
                                k, dict(zip(cols, row)), time, d > 0
                            )
                    else:
                        for k, row, d in ordered:
                            self._on_change(k, row, time, d)
        return []

    def on_time_end(self, time):
        if self._on_time_end is not None and self._seen_time:
            self._on_time_end(time)
        self._seen_time = False

    def on_end(self):
        if self._on_end is not None:
            self._on_end()


class CaptureNode(Node):
    """Accumulates final table state + update stream (reference:
    capture_table_data, python_api.rs:3214 — backbone of compute_and_print).

    Terminal of the fused chain: columnar NativeBatches are BUFFERED
    C-owned and expanded into the key->row dict / update history only on
    first read (or when a tuple-delta batch must apply after them), so
    the steady streaming state builds no per-row Python objects at the
    sink either. Readers go through the ``state``/``updates`` properties,
    which flush pending columnar chunks in arrival order first."""

    def __init__(self, scope, input_node):
        super().__init__(scope, [input_node])
        self._state = TableState()
        self._updates: list[tuple[Key, Row, int, int]] = []  # key,row,time,diff
        self._pending: list = []  # unexpanded (NativeBatch, time) chunks

    def _flush_pending(self) -> None:
        from pathway_tpu_torch.native import get_pwexec

        try:
            ex = get_pwexec()
        except Exception:
            ex = None
        fp = get_fp()
        expanded = 0
        for nb, time in self._pending:
            expanded += len(nb)
            if ex is not None and hasattr(ex, "capture_apply_nb"):
                ex.capture_apply_nb(self._state.rows, self._updates, nb, time)
            elif fp is not None and hasattr(fp, "capture_apply"):
                fp.capture_apply(
                    self._state.rows, self._updates, nb.materialize(), time
                )
            else:
                deltas = nb.materialize()
                self._state.apply(deltas)
                for k, row, d in deltas:
                    self._updates.append((k, row, time, d))
        self._pending.clear()
        if expanded:
            # deferred row expansion finally happened — the egress
            # counter the columnar readers (arrow_table) never move
            self.scope.runtime.stats.on_capture_rows_expanded(expanded)

    def arrow_table(self, cols=None):
        """Committed capture as ONE Arrow table — zero row expansion
        (exec.cpp capture_collect_nb → nb_export_arrow): value columns
        (named ``cols`` or ``c0..cN``), plus ``time`` (commit
        timestamp), ``diff`` (+1; pending chunks are insert-only net
        form) and the 16-byte ``_key`` column. Returns None when any
        part of the capture already lives in row form (tuple deltas
        arrived, or a reader expanded it), when a column can't export,
        or when pyarrow/toolchain are missing — the caller falls back
        to ``state``/``updates``. Non-consuming: ``state`` stays
        readable afterwards. The export is cached per (pending-length,
        names), so re-reads neither redo the C merge nor re-increment
        the ``capture_arrow_*`` counters the egress audit pins."""
        if _elig.nb_capture_forced_off():
            return None
        if self._state.rows or self._updates or not self._pending:
            return None
        cache = getattr(self, "_arrow_cache", None)
        if cache is not None and cache[0] == (
            len(self._pending), tuple(cols) if cols is not None else None,
        ):
            return cache[1]
        if not all(is_native_batch(nb) for nb, _t in self._pending):
            return None
        from pathway_tpu_torch.io._arrow import get_pyarrow, nb_to_arrow
        from pathway_tpu_torch.native import get_pwexec

        pa = get_pyarrow()
        try:
            ex = get_pwexec()
        except Exception:
            ex = None
        if pa is None or ex is None or not hasattr(ex, "capture_collect_nb"):
            return None
        merged = ex.capture_collect_nb(self._pending)
        w = merged.width() - 1  # last column = appended commit time
        names = list(cols) if cols is not None else [f"c{i}" for i in range(w)]
        if len(names) != w:
            raise ValueError(
                f"arrow_table: {len(names)} names for {w} columns"
            )
        rb = nb_to_arrow(
            merged, names + ["time"], include_key=True, include_diff=True
        )
        if rb is None:
            return None
        self.scope.runtime.stats.on_capture_arrow_batch(rb.num_rows)
        tbl = pa.Table.from_batches([rb])
        self._arrow_cache = (
            (len(self._pending), tuple(cols) if cols is not None else None),
            tbl,
        )
        return tbl

    @property
    def state(self) -> TableState:
        if self._pending:
            self._flush_pending()
        return self._state

    @property
    def updates(self) -> list:
        if self._pending:
            self._flush_pending()
        return self._updates

    def process(self, time, batches):
        if is_native_batch(batches[0]):
            self.scope.runtime.note_output_emit(
                self, time, len(batches[0])
            )
            self._pending.append((batches[0], time))
            return []
        deltas = consolidate(batches[0])
        if deltas:
            self.scope.runtime.note_output_emit(self, time, len(deltas))
        # tuple deltas (e.g. retractions) must land AFTER buffered
        # columnar chunks: expand those first, in arrival order
        if self._pending:
            self._flush_pending()
        fp = get_fp()
        if fp is not None and hasattr(fp, "capture_apply"):
            # the capture sink sees EVERY output row — one C pass does
            # the TableState apply and the update-history append
            fp.capture_apply(self._state.rows, self._updates, deltas, time)
            return []
        self._state.apply(deltas)
        for k, row, d in deltas:
            self._updates.append((k, row, time, d))
        return []
